"""SPARSE_SCHUR with a genuinely sparse reduced camera system.

The reference's SchurComplementSolver<...>::SolveReducedLinearSystem for
SPARSE_SCHUR (schur_complement_solver.cc:291) assembles the Schur
complement S = F'F - F'E (E'E)^-1 E'F as a BLOCK-SPARSE matrix over the
camera co-visibility pattern and factorizes it with a sparse Cholesky
(SuiteSparse/Eigen). The device/host split here mirrors the
SPARSE_NORMAL_CHOLESKY design (solvers/sparse_direct.py):

  * device: per-(point, camera-pair) block products over the chunk
    layout, segment-summed into the UNIQUE co-visibility pair blocks —
    one [npairs, t, t] tensor is all that crosses to the host;
  * host (native C++): scatter the pair blocks into a cached scalar CSC
    pattern (symbolic analysis done once), LDL^T refactor + solve per
    iteration (the CHOLMOD role, with RCM/AMD fill-reducing ordering).

Unlike the dense explicit-S path (`schur.py _assemble_S*`, the
device-native form for small camera counts), memory here is
O(co-visibility pairs * t^2), not O(nf^2): this is the regime past a few
thousand cameras, and it needs no [n, kf] one-hot anywhere.

Routing (see `use_sparse_schur`): SPARSE_SCHUR keeps the dense-S path
up to SPARSE_SCHUR_DENSE_NF tangent columns (where a [nf, nf] Cholesky is
faster than a host round-trip), switches to this path above it when the
structure is supported, and falls back to the ITERATIVE_SCHUR rewrite
(solver.py) otherwise. `CERES_TPU_FORCE_SPARSE_SCHUR=1` forces this path
at any size (used by tests).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import native
from ..types import LinearSolverType

# Below this many camera-space tangent columns, dense S on the device beats
# the host factorization round-trip; above it, O(nf^2) memory loses to the
# block-sparse pattern.
SPARSE_SCHUR_DENSE_NF = 1024

# Pattern-size cap: the [ne, K, K] pair-id tensor and the K scans of
# [ne, K, t, t] products must stay materializable.
_MAX_PAIR_IDS = int(2e8)


def _grouped_e_slots(meta):
    """[(bi, si, local)] for e-carrying buckets of the single f group,
    and [(bi, si, local)] for f-only buckets."""
    grp = meta.f_groups[0]
    e_slots, f_only = [], []
    for (bi, si, local) in grp["slots"]:
        bs = meta.buckets[bi]
        if bs.e_slot is not None:
            e_slots.append((bi, si, local))
        else:
            f_only.append((bi, si, local))
    return e_slots, f_only


def sparse_schur_supported(meta) -> bool:
    """Structure the block-sparse assembly can serve: one f group (uniform
    camera tangent size), one f slot per bucket (no intra-row F'F cross
    blocks), and chunk layout on every e-carrying f bucket."""
    if meta is None or len(meta.f_groups) != 1:
        return False
    per_bucket = {}
    for (bi, si, local) in meta.f_groups[0]["slots"]:
        per_bucket[bi] = per_bucket.get(bi, 0) + 1
    K = 0
    for bi, bs in enumerate(meta.buckets):
        if bs.f_cols is None:
            continue
        if per_bucket.get(bi, 0) != 1 or len(bs.f_slots) != 1:
            return False
        if bs.e_slot is not None:
            if bs.chunk_rows is None:
                return False
            K += bs.chunk_rows.shape[1]
    if meta.ne * K * K > _MAX_PAIR_IDS:
        return False
    return True


def use_sparse_schur(meta, options) -> bool:
    """True when SPARSE_SCHUR should take the block-sparse host
    factorization instead of the dense-S device path."""
    if options.linear_solver_type != LinearSolverType.SPARSE_SCHUR:
        return False
    if meta is None:
        return False
    if os.environ.get("CERES_TPU_FORCE_SPARSE_SCHUR"):
        return sparse_schur_supported(meta)
    return meta.nf > SPARSE_SCHUR_DENSE_NF and sparse_schur_supported(meta)


class SparseSchurContext:
    """Host-side symbolic state of the block-sparse S: the co-visibility
    pair set, device pair-id maps (registered as program constants), the
    scalar CSC expansion, and the reusable native LDL^T handle."""

    def __init__(self, meta, program, ordering: Optional[int] = None):
        grp = meta.f_groups[0]
        self.kf, self.t = int(grp["kf"]), int(grp["t"])
        kf, t = self.kf, self.t
        self.cols_flat = grp["cols"].reshape(-1).astype(np.int32)  # [kf*t]
        e_slots, f_only = _grouped_e_slots(meta)
        self.e_slots, self.f_only = e_slots, f_only

        # ---- co-visibility block-pair pattern ----
        # Lanes: per e-block (point), the concatenation of every bucket's
        # chunk lanes. loc_cat[n, i] = local camera id of lane i (0 for
        # padded lanes, which carry zero products).
        locs, masks = [], []
        for (bi, si, local) in e_slots:
            bs = meta.buckets[bi]
            locs.append(local[bs.chunk_rows].astype(np.int64))   # [ne, k]
            masks.append(bs.chunk_mask > 0.5)                    # [ne, k]
        if locs:
            loc_cat = np.concatenate(locs, axis=1)               # [ne, K]
            mask_cat = np.concatenate(masks, axis=1)
            K = loc_cat.shape[1]
        else:
            loc_cat = np.zeros((meta.ne, 0), dtype=np.int64)
            mask_cat = np.zeros((meta.ne, 0), dtype=bool)
            K = 0
        self.K = K

        keys = loc_cat[:, :, None] * kf + loc_cat[:, None, :]   # [ne,K,K]
        valid = mask_cat[:, :, None] & mask_cat[:, None, :]
        # Always include the full block diagonal: the D^2 damping keeps S
        # SPD even for camera blocks no surviving residual touches.
        diag_keys = np.arange(kf, dtype=np.int64) * kf + np.arange(kf)
        pair_keys = np.unique(np.concatenate(
            [keys[valid].reshape(-1), diag_keys]))
        self.npairs = int(pair_keys.size)

        # Device pair-id maps (trash slot npairs absorbs padded lanes).
        pid = np.searchsorted(pair_keys, keys).astype(np.int32)
        pid = np.where(valid, pid, np.int32(self.npairs))
        self.pid_np = pid
        program.register_const("schur.sp.pid", pid)
        self.diag_np, self.fonly_np = {}, {}
        off = 0
        for (bi, si, local) in e_slots:
            k = meta.buckets[bi].chunk_rows.shape[1]
            dkeys = loc_cat[:, off:off + k] * (kf + 1)
            dpid = np.searchsorted(pair_keys, dkeys).astype(np.int32)
            dpid = np.where(mask_cat[:, off:off + k], dpid,
                            np.int32(self.npairs))
            self.diag_np[bi] = dpid
            program.register_const(f"schur.sp.diag{bi}", dpid)
            off += k
        for (bi, si, local) in f_only:
            fpid = np.searchsorted(
                pair_keys, local.astype(np.int64) * (kf + 1)).astype(np.int32)
            self.fonly_np[bi] = fpid
            program.register_const(f"schur.sp.fonly{bi}", fpid)

        # ---- scalar CSC expansion (group-local ordering, n = kf*t) ----
        bi_of = (pair_keys // kf).astype(np.int64)
        bj_of = (pair_keys % kf).astype(np.int64)
        a = np.arange(t, dtype=np.int64)
        # broadcast rows/cols over the full [npairs, t, t] block layout
        rows = np.broadcast_to(
            bi_of[:, None, None] * t + a[None, :, None],
            (self.npairs, t, t)).reshape(-1)
        cols = np.broadcast_to(
            bj_of[:, None, None] * t + a[None, None, :],
            (self.npairs, t, t)).reshape(-1)
        n_sc = kf * t
        self.n_sc = n_sc
        order = np.lexsort((rows, cols))                 # CSC: col-major
        counts = np.zeros(n_sc + 1, dtype=np.int64)
        np.add.at(counts, cols + 1, 1)
        self.Ap = np.cumsum(counts)
        self.Ai = rows[order].astype(np.int32)
        # csc_of_block[flat (p, a, b)] = position in the CSC values array
        self.csc_of_block = np.empty(order.size, dtype=np.int64)
        self.csc_of_block[order] = np.arange(order.size, dtype=np.int64)
        # scalar diagonal positions (for the D^2 damping)
        diag_p = np.searchsorted(pair_keys,
                                 np.arange(kf, dtype=np.int64) * (kf + 1))
        flat_diag = (diag_p[:, None] * t * t + a[None, :] * t
                     + a[None, :]).reshape(-1)
        self.diag_pos = self.csc_of_block[flat_diag]
        self.chol = native.SparseCholesky(n_sc, self.Ap, self.Ai,
                                          ordering=ordering)

    def host_solve(self, d_sq_g: np.ndarray, rhs_g: np.ndarray,
                   vals: np.ndarray) -> np.ndarray:
        """vals [npairs, t, t] block values (FtF - correction, no damping);
        d_sq_g / rhs_g in group-local scalar order [kf*t]. Returns y or
        NaNs on factorization breakdown (invalid-step retry upstream)."""
        values = np.empty(self.csc_of_block.size, dtype=np.float64)
        values[self.csc_of_block] = np.asarray(
            vals, dtype=np.float64).reshape(-1)
        values[self.diag_pos] += np.asarray(d_sq_g, dtype=np.float64)
        if self.chol.factor(values) != 0:
            return np.full(self.n_sc, np.nan)
        return self.chol.solve(np.asarray(rhs_g, dtype=np.float64))


def get_sparse_schur_context(meta, program, options) -> SparseSchurContext:
    """Context cached on the meta (one per elimination structure), keyed
    by the native ordering knob."""
    from .sparse_direct import _native_ordering
    ordering = _native_ordering(options)
    cache = getattr(meta, "_sparse_ctx", None)
    if cache is None or cache[0] != ordering:
        ctx = SparseSchurContext(meta, program, ordering=ordering)
        meta._sparse_ctx = (ordering, ctx)
        return ctx
    return cache[1]


def sparse_schur_block_values(meta, jac, inv_ete, ctx):
    """Device assembly of the block-sparse S values (minus damping):
    [npairs, t, t]. Every product is a batched einsum over the chunk
    layout; duplicate (camera, point) rows and cross-bucket pairs land in
    the same pair block via the scatter-add (no one-hot needed — this is
    the large-camera regime where [n, kf] one-hots don't materialize)."""
    dtype = jac.buckets[0].J.dtype
    t = ctx.t
    vals = jnp.zeros((ctx.npairs + 1, t, t), dtype=dtype)

    A_parts = []
    for (bi, si, local) in ctx.e_slots:
        bs = meta.buckets[bi]
        bj = jac.buckets[bi]
        rows = meta.c(f"b{bi}.chunk_rows", bs.chunk_rows)
        mask = meta.c(f"b{bi}.chunk_mask", bs.chunk_mask).astype(dtype)
        Je_g = bj.slot_J(bs.e_slot)[rows] * mask[..., None, None]
        Jf_g = bj.slot_J(si)[rows] * mask[..., None, None]
        # F'F block-diagonal contribution, per lane
        Gf = jnp.einsum("nkrt,nkru->nktu", Jf_g, Jf_g)
        dpid = meta.c(f"sp.diag{bi}", ctx.diag_np[bi])
        vals = vals.at[dpid.reshape(-1)].add(Gf.reshape(-1, t, t))
        # cross block A = E'F per lane
        A_parts.append(jnp.einsum("nkre,nkrt->nket", Je_g, Jf_g))

    if A_parts:
        A = (A_parts[0] if len(A_parts) == 1
             else jnp.concatenate(A_parts, axis=1))       # [ne, K, te, t]
        Y = jnp.einsum("neu,nkut->nket", inv_ete, A)
        pid = meta.c("sp.pid", ctx.pid_np)                # [ne, K, K]
        for i in range(ctx.K):
            # correction blocks of lane i against every lane j
            Bi = jnp.einsum("net,nkeu->nktu", A[:, i], Y)
            vals = vals.at[pid[:, i, :].reshape(-1)].add(
                -Bi.reshape(-1, t, t))

    for (bi, si, local) in ctx.f_only:
        bj = jac.buckets[bi]
        Js = bj.slot_J(si)
        G = jnp.einsum("nrt,nru->ntu", Js, Js)
        fpid = meta.c(f"sp.fonly{bi}", ctx.fonly_np[bi])
        vals = vals.at[fpid].add(G)

    return vals[:ctx.npairs]


def sparse_schur_reduced_solve(meta, ops, ctx, rhs, D_f):
    """y = S^-1 rhs via the host LDL^T; rhs/D_f in global [nf] order."""
    vals = sparse_schur_block_values(meta, ops.jac, ops.inv_ete, ctx)
    cols_flat = meta.c("fg0.cols", meta.f_groups[0]["cols"]).reshape(-1)
    rhs_g = rhs[cols_flat]
    d_sq_g = (D_f * D_f)[cols_flat]

    def cb(d_sq, r, v):
        return ctx.host_solve(d_sq, r, v).astype(np.float64)

    y_g = jax.pure_callback(
        cb, jax.ShapeDtypeStruct((ctx.n_sc,), jnp.float64),
        d_sq_g.astype(jnp.float64), rhs_g.astype(jnp.float64),
        vals.astype(jnp.float64), vmap_method="sequential")
    y = jnp.zeros((meta.nf,), dtype=rhs.dtype)
    return y.at[cols_flat].set(y_g.astype(rhs.dtype))
