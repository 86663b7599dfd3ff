"""Schur-complement solvers: DENSE_SCHUR, SPARSE_SCHUR, ITERATIVE_SCHUR.

Capability parity with the reference's Schur machinery:
  * detect_structure.cc:121 + schur_templates.cc  -> detect_schur_structure
  * SchurEliminator (schur_eliminator_impl.h, chunked parallel elimination
    with per-thread buffers + rhs mutexes)       -> batched segment-summed
    Gram/cross products over shape-uniform buckets (no locks: pure scatter-add)
  * ImplicitSchurComplement (implicit_schur_complement.cc:49,:208)
                                                  -> matrix-free apply_S
  * SchurComplementSolver dense/sparse (schur_complement_solver.cc:181,:291)
                                                  -> explicit S (dense
    Cholesky on the device: the reduced camera system is a small dense
    matrix, replacing CHOLMOD supernodal factorization)
  * IterativeSchurComplementSolver (iterative_schur_complement_solver.cc:63)
                                                  -> PCG on apply_S
  * SchurJacobiPreconditioner (schur_jacobi_preconditioner.h:78) and
    block-Jacobi-of-F'F (JACOBI)                  -> batched block factors
  * PowerSeriesExpansionPreconditioner
    (power_series_expansion_preconditioner.h:44)  -> truncated Neumann series
    using block-diag(S) splitting, and SPSE warm start (:99-111).

The generated compile-time specializations (internal/ceres/generated/, 44
files keyed on (r,e,f) block sizes) map to XLA's shape specialization: each
(r,e,f) bucket shape triggers one compiled kernel automatically.

Partitioning note (SURVEY.md section 5.7/5.8): all row-indexed arrays
(bucket Jacobians, e_ids, f_cols) shard over the residual axis; e-block
arrays shard over points; the [nf]-sized f vectors and the dense S replicate;
the segment sums below become psum-reduced partial sums on a mesh. See
parallel/sharded.py.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np

from ..ops.bsr import BlockJacobian, RVec
from ..types import LinearSolverType, PreconditionerType


class _BucketSchur:
    __slots__ = ("e_slot", "e_ids", "f_cols", "f_slots",
                 "chunk_rows", "chunk_mask")


class SchurMeta:
    """Static E/F partition of the bucketed Jacobian."""

    def __init__(self):
        self.e_keys = set()
        self.ne = 0
        self.te = 0
        self.nf = 0
        self.f_global_cols = None    # np [nf] int32
        self.e_cols = None           # np [ne, te] int32
        self.buckets: List[_BucketSchur] = []
        self.f_groups = []           # [(t, kf, f_cols [kf,t], slots)]
        self.cluster_mask = None      # np [nf, nf], set for CLUSTER_* kinds
        self.cluster_mask_diag = None  # cluster-diagonal-only pattern
        self._program = None
        self._onehots = {}            # (gi, bi, si) -> np [n, kf] f32

    def bind(self, program):
        """Register the meta's index arrays as program constants so they
        are passed to jitted solves as device arguments (not HLO literals)."""
        self._program = program
        program.register_const("schur.e_cols", self.e_cols)
        program.register_const("schur.f_global", self.f_global_cols)
        for bi, bs in enumerate(self.buckets):
            if bs.e_ids is not None:
                program.register_const(f"schur.b{bi}.e_ids", bs.e_ids)
            if bs.f_cols is not None:
                program.register_const(f"schur.b{bi}.f_cols", bs.f_cols)
            if bs.chunk_rows is not None:
                program.register_const(f"schur.b{bi}.chunk_rows",
                                       bs.chunk_rows)
                program.register_const(f"schur.b{bi}.chunk_mask",
                                       bs.chunk_mask)
        # Grouped (chunk-layout) f-slot structures for e-buckets: the f
        # columns and the f-block one-hot of every chunk lane, all static.
        for gi, grp in enumerate(self.f_groups):
            for k, (bi, si, local) in enumerate(grp["slots"]):
                bs = self.buckets[bi]
                if bs.chunk_rows is None:
                    continue
                cols_rows = grp["cols"][local]            # [n, t]
                program.register_const(
                    f"schur.g{gi}_{bi}_{si}.cols",
                    cols_rows[bs.chunk_rows])             # [ne, k, t]
                program.register_const(
                    f"schur.g{gi}_{bi}_{si}.loc",
                    local[bs.chunk_rows].astype(np.int32))  # [ne, k]
                oh = self._build_onehot(gi, bi, si, local, grp["kf"])
                if oh is not None:
                    program.register_const(
                        f"schur.g{gi}_{bi}_{si}.oh",
                        oh[bs.chunk_rows])                # [ne, k, kf]
        for gi, grp in enumerate(self.f_groups):
            program.register_const(f"schur.fg{gi}.cols", grp["cols"])
            for k, (bbi, vsi, local) in enumerate(grp["slots"]):
                program.register_const(f"schur.fg{gi}.local{k}", local)
                oh = self._build_onehot(gi, bbi, vsi, local, grp["kf"])
                if oh is not None:
                    program.register_const(f"schur.oh{gi}_{bbi}_{vsi}", oh)

    def _build_onehot(self, gi, bi, si, local, kf):
        n = local.shape[0]
        if n * kf > 3e8:
            return None
        key = (gi, bi, si)
        if key not in self._onehots:
            oh = np.zeros((n, kf), dtype=np.float32)
            oh[np.arange(n), local] = 1.0
            self._onehots[key] = oh
        return self._onehots[key]

    def onehot(self, gi, bi, si, local, kf):
        """[n, kf] one-hot of each row's local f-block index (traced const
        when bound); None when too large to materialize."""
        oh = self._build_onehot(gi, bi, si, local, kf)
        if oh is None:
            return None
        if self._program is not None:
            return self._program.const(f"schur.oh{gi}_{bi}_{si}")
        return jnp.asarray(oh)

    def c(self, name, np_value):
        """Traced constant accessor (falls back to literal embedding when
        the meta is unbound, e.g. in unit tests)."""
        if self._program is not None:
            return self._program.const("schur." + name)
        return jnp.asarray(np_value)

    def grouped_fslot(self, gi, bi, si, local):
        """(cols [ne,k,t], onehot [ne,k,kf] or None) for an e-bucket's f
        slot in chunk layout."""
        bs = self.buckets[bi]
        grp = self.f_groups[gi]
        oh_np = self._build_onehot(gi, bi, si, local, grp["kf"])
        if self._program is not None:
            cols = self._program.const(f"schur.g{gi}_{bi}_{si}.cols")
            oh = (self._program.const(f"schur.g{gi}_{bi}_{si}.oh")
                  if oh_np is not None else None)
        else:
            cols = jnp.asarray(grp["cols"][local][bs.chunk_rows])
            oh = (jnp.asarray(oh_np[bs.chunk_rows])
                  if oh_np is not None else None)
        return cols, oh

    def grouped_loc(self, gi, bi, si, local):
        """[ne, k] local f-block row ids in chunk layout."""
        bs = self.buckets[bi]
        if self._program is not None:
            return self._program.const(f"schur.g{gi}_{bi}_{si}.loc")
        return jnp.asarray(local[bs.chunk_rows].astype(np.int32))


def _ordering_cache_key(options):
    """Content key of a user elimination ordering: the compiled program
    is shared across Solve calls with different options (program.py
    get_cached), so the cached meta must be invalidated when the user
    changes linear_solver_ordering between solves."""
    o = getattr(options, "linear_solver_ordering", None)
    if o is None:
        return None
    return tuple(sorted((g, tuple(sorted(d.keys())))
                        for g, d in o._groups.items()))


def detect_schur_structure(program, options) -> Optional[SchurMeta]:
    """Partition variable blocks into e-blocks (eliminated, group 0) and
    f-blocks. Returns None when no usable structure exists (the caller then
    downgrades the solver, trust_region_preprocessor.cc:75-107)."""
    okey = _ordering_cache_key(options)
    cached = getattr(program, "_schur_meta", "missing")
    if cached != "missing":
        if getattr(program, "_schur_meta_okey", None) == okey:
            return cached
        # Ordering changed on a shared program: the bound schur constants
        # and compiled executables were built for the OLD partition —
        # purge them (rare; solve() normally gets a per-ordering program
        # via get_cached's key).
        program._jit_cache.clear()
        program._device_consts.clear()
    meta = _detect_schur_structure(program, options)
    if meta is not None:
        meta.bind(program)
    program._schur_meta = meta
    program._schur_meta_okey = okey
    return meta


def _detect_schur_structure(program, options):
    from ..ordering import compute_schur_ordering

    problem = program.problem
    var_keys = {id(b.array) for b in program.variable_blocks}

    ordering = getattr(options, "linear_solver_ordering", None)
    if ordering is not None and ordering.num_groups > 1:
        g0 = ordering.min_non_zero_group()
        e_set = {k for k in ordering.group_element_keys(g0)
                 if k in var_keys}
        # Validity: no residual block may touch two e-blocks
        # (schur_eliminator.h structure requirement).
        for rb in problem._residual_records():
            if sum(1 for k in rb.param_keys if k in e_set) > 1:
                return None
    else:
        e_set = set(compute_schur_ordering(program))

    if not e_set:
        return None

    block_of = {id(b.array): b for b in program.variable_blocks}

    # Uniform e tangent size: keep the dominant size (detect_structure.cc
    # collapses ragged sizes to Eigen::Dynamic; here ragged e-sizes would
    # break batching, so minority sizes move to the f side).
    sizes = Counter(block_of[k].tangent_size for k in e_set)
    te = sizes.most_common(1)[0][0]
    e_set = {k for k in e_set if block_of[k].tangent_size == te}

    # Per-bucket slot purity: every (bucket, slot) must be all-e or
    # all-f; AND a bucket may not have two pure-e slots (two e-blocks per
    # residual, schur_eliminator.h). A demotion under either rule can
    # break the other in a different bucket, so BOTH run inside one
    # fixpoint — a post-hoc demotion pass would leave mixed slots behind.
    changed = True
    while changed and e_set:
        changed = False
        for bk in program.buckets:
            for si, sl in enumerate(bk.slots):
                if not sl.variable:
                    continue
                # recover the block keys of this slot across bucket rows
                flags = [rb_key in e_set
                         for rb_key in bk_slot_keys(program, bk, si)]
                if any(flags) and not all(flags):
                    for rb_key, f in zip(bk_slot_keys(program, bk, si),
                                         flags):
                        if f:
                            e_set.discard(rb_key)
                    changed = True
        for bk in program.buckets:
            e_slots = []
            for si, sl in enumerate(bk.slots):
                if sl.variable:
                    keys = bk_slot_keys(program, bk, si)
                    if keys and keys[0] in e_set:
                        e_slots.append(si)
            if len(e_slots) > 1:
                # demote all but the first e slot
                for si in e_slots[1:]:
                    for k in bk_slot_keys(program, bk, si):
                        if k in e_set:
                            e_set.discard(k)
                            changed = True
    if not e_set:
        return None

    meta = SchurMeta()
    meta.e_keys = e_set
    meta.te = te

    # e-block local indexing
    e_list = [k for k in (id(b.array) for b in program.variable_blocks)
              if k in e_set]
    e_index = {k: i for i, k in enumerate(e_list)}
    meta.ne = len(e_list)
    e_offs = np.fromiter((program.tan_offset[k] for k in e_list),
                         dtype=np.int32, count=meta.ne)
    meta.e_cols = e_offs[:, None] + np.arange(te, dtype=np.int32)[None, :]

    # f columns: every tangent column not in an e-block
    is_e = np.zeros(program.num_effective, dtype=bool)
    is_e[meta.e_cols.reshape(-1)] = True
    f_global = np.nonzero(~is_e)[0].astype(np.int32)
    meta.nf = int(f_global.size)
    if meta.nf == 0:
        return None
    meta.f_global_cols = f_global
    g2f = -np.ones(program.num_effective, dtype=np.int32)
    g2f[f_global] = np.arange(meta.nf, dtype=np.int32)

    # per-bucket partition, indexed over VARIABLE slots (jac.cols order)
    for bk in program.buckets:
        bs = _BucketSchur()
        bs.e_slot = None
        bs.e_ids = None
        bs.f_slots = []
        f_col_parts = []
        var_si = -1
        for si, sl in enumerate(bk.slots):
            if not sl.variable:
                continue
            var_si += 1
            keys = bk_slot_keys(program, bk, si)
            if keys and keys[0] in e_set:
                bs.e_slot = var_si
                bs.e_ids = np.asarray([e_index[k] for k in keys],
                                      dtype=np.int32)
            else:
                bs.f_slots.append(var_si)
                f_col_parts.append(g2f[sl.cols])
        bs.f_cols = (np.concatenate(f_col_parts, axis=1)
                     if f_col_parts else None)
        # Chunk grouping: rows of this bucket sorted into per-e-block
        # chunks, padded to the max chunk size (the reference's
        # schur_eliminator chunk layout, schur_eliminator_impl.h:195): the
        # padding buys fully dense einsums — no [n, 3]-shaped
        # gather/scatter in the CG body).
        bs.chunk_rows = None
        bs.chunk_mask = None
        if bs.e_slot is not None:
            e_ids = bs.e_ids
            n = e_ids.shape[0]
            order = np.argsort(e_ids, kind="stable")
            counts = np.bincount(e_ids, minlength=meta.ne)
            kmax = max(1, int(counts.max()))
            # Guard against pathological padding: one landmark seen by
            # thousands of cameras would inflate every [ne, kmax, ...]
            # chunk tensor by kmax/mean(k); fall back to the
            # observation-order path when padding exceeds ~4x.
            if meta.ne * kmax > 4 * n + 1024:
                bs.chunk_rows = None
                bs.chunk_mask = None
            else:
                starts = np.zeros(meta.ne, dtype=np.int64)
                starts[1:] = np.cumsum(counts)[:-1]
                sorted_e = e_ids[order]
                rank = np.arange(n, dtype=np.int64) - starts[sorted_e]
                chunk_rows = np.zeros((meta.ne, kmax), dtype=np.int32)
                chunk_mask = np.zeros((meta.ne, kmax), dtype=np.float32)
                chunk_rows[sorted_e, rank] = order.astype(np.int32)
                chunk_mask[sorted_e, rank] = 1.0
                bs.chunk_rows = chunk_rows
                bs.chunk_mask = chunk_mask
        meta.buckets.append(bs)

    # f-block groups (for SCHUR_JACOBI / JACOBI preconditioners)
    f_blocks = [b for b in program.variable_blocks
                if id(b.array) not in e_set]
    size_groups = {}
    for b in f_blocks:
        size_groups.setdefault(b.tangent_size, []).append(b)
    f_block_index = {}
    meta.f_groups = []
    for gi, (t, blks) in enumerate(sorted(size_groups.items())):
        cols = np.zeros((len(blks), t), dtype=np.int32)
        for li, b in enumerate(blks):
            to = program.tan_offset[id(b.array)]
            cols[li] = g2f[np.arange(to, to + t)]
            f_block_index[id(b.array)] = (gi, li)
        meta.f_groups.append({"t": t, "kf": len(blks), "cols": cols,
                              "slots": []})
    for bi, bk in enumerate(program.buckets):
        var_si = -1
        for si, sl in enumerate(bk.slots):
            if not sl.variable:
                continue
            var_si += 1
            keys = bk_slot_keys(program, bk, si)
            if keys and keys[0] in e_set:
                continue
            gi, _ = f_block_index[keys[0]]
            local = np.asarray([f_block_index[k][1] for k in keys],
                               dtype=np.int32)
            meta.f_groups[gi]["slots"].append((bi, var_si, local))
    return meta


def bk_slot_keys(program, bk, si):
    """Block keys (id(array)) at slot si for every row of bucket bk."""
    cache = getattr(bk, "_slot_keys", None)
    if cache is None:
        cache = {}
        bk._slot_keys = cache
    if si not in cache:
        residuals = program.problem._residual_records()
        by_index = {rb.index: rb for rb in residuals}
        cache[si] = [by_index[int(i)].param_keys[si]
                     for i in bk.orig_indices]
    return cache[si]


# ----------------------------------------------------------------------
# runtime (pure, jittable) Schur operations


def _batched_cho_solve(chol, b):
    """chol: [k, t, t] lower factors; b: [k, t] or [k, t, m]."""
    squeeze = b.ndim == 2
    if squeeze:
        b = b[..., None]
    y = jsl.solve_triangular(chol, b, lower=True)
    z = jsl.solve_triangular(jnp.swapaxes(chol, -1, -2), y, lower=False)
    return z[..., 0] if squeeze else z


class SchurOps:
    """Pure functions over (jac, D) for a fixed SchurMeta. Everything here
    traces into one XLA program per solve."""

    def __init__(self, meta: SchurMeta, jac: BlockJacobian, D):
        self.meta = meta
        self.jac = jac
        dtype = jac.buckets[0].J.dtype
        ne, te, nf = meta.ne, meta.te, meta.nf

        # ---- chunk-grouped layout (built once per linearization) ----
        # For each e-bucket: gather its rows into [ne, kmax, ...] chunk
        # tensors (the reference's schur_eliminator chunk layout). Every
        # CG-body operation then becomes a dense batched einsum instead of
        # per-observation [n, 3] scatters/gathers.
        # self._groups: bi -> dict(Je_g [ne,k,r,te],
        #                          fslots: [(gi, Jf_g, cols, onehot, kf, t)])
        self._groups = {}
        for gi, grp in enumerate(meta.f_groups):
            for (bi, si, local) in grp["slots"]:
                bs = meta.buckets[bi]
                if bs.chunk_rows is None:
                    continue
                bj = jac.buckets[bi]
                g = self._groups.get(bi)
                if g is None:
                    rows = meta.c(f"b{bi}.chunk_rows", bs.chunk_rows)
                    mask = meta.c(f"b{bi}.chunk_mask", bs.chunk_mask)
                    Je_g = bj.slot_J(bs.e_slot)[rows] \
                        * mask[..., None, None].astype(dtype)
                    g = {"Je_g": Je_g, "rows": rows, "mask": mask,
                         "fslots": [], "bi": bi}
                    self._groups[bi] = g
                cols, oh = meta.grouped_fslot(gi, bi, si, local)
                Jf_g = bj.slot_J(si)[g["rows"]] \
                    * g["mask"][..., None, None].astype(dtype)
                g["fslots"].append((gi, Jf_g, cols, oh, grp["kf"],
                                    grp["t"], si, local))
        # A bucket is grouped only if every f slot has a one-hot (else the
        # whole bucket takes the observation-order fallback).
        self._groups = {bi: g for bi, g in self._groups.items()
                        if all(f[3] is not None for f in g["fslots"])}

        # block diagonal of E^T E + D_e^2 (implicit_schur_complement Init),
        # assembled densely from the chunk tensors.
        ete = jnp.zeros((ne, te, te), dtype=dtype)
        for bi, (bj, bs) in enumerate(zip(jac.buckets, meta.buckets)):
            if bs.e_slot is None:
                continue
            g = self._groups.get(bi)
            if g is not None:
                ete = ete + jnp.einsum("nkrt,nkru->ntu", g["Je_g"],
                                       g["Je_g"])
            else:
                Je = bj.slot_J(bs.e_slot)
                G = jnp.einsum("nrt,nru->ntu", Je, Je)
                ete = ete.at[meta.c(f"b{bi}.e_ids", bs.e_ids)].add(G)
        d_e = D[meta.c("e_cols", meta.e_cols)]                # [ne, te]
        ete = ete + _embed_diag(d_e * d_e)
        self.chol_e = jnp.linalg.cholesky(ete)
        # Explicit (E^T E)^-1, formed once per linearization: each CG
        # iteration then applies it as one batched einsum
        # instead of 2*ne batched triangular solves. SPD 3x3..4x4 blocks
        # after the D^2 regularization invert stably via their Cholesky.
        eye = jnp.broadcast_to(jnp.eye(te, dtype=dtype), (ne, te, te))
        self.inv_ete = _batched_cho_solve(self.chol_e, eye)
        self.D_f = D[meta.c("f_global", meta.f_global_cols)]

    def esolve(self, u):
        return jnp.einsum("nij,nj->ni", self.inv_ete, u)

    def F_apply(self, v):
        """F v: [nf] -> RVec (residual space)."""
        parts = []
        for bi, (bj, bs) in enumerate(zip(self.jac.buckets,
                                          self.meta.buckets)):
            if bs.f_cols is None:
                parts.append(jnp.zeros((bj.n, bj.r), dtype=bj.J.dtype))
                continue
            Jf = _f_part(bj, bs)
            vb = v[self.meta.c(f"b{bi}.f_cols", bs.f_cols)]
            parts.append(jnp.einsum("nrt,nt->nr", Jf, vb))
        return RVec(parts)

    def Ft_apply(self, w: RVec):
        """F^T w. The reference accumulates per-cell with mutexes
        (partitioned_matrix_view LeftMultiplyAndAccumulateF); a scatter-add
        translation collides because every one of the ~n*t updates lands
        in the tiny [nf] output (83k x 9 adds into 144 slots). The matmul
        formulation: per f-group one-hot [n, kf] matmuls — the duplicate
        reduction IS the contraction."""
        meta, jac = self.meta, self.jac
        dtype = jac.buckets[0].J.dtype
        out = jnp.zeros((meta.nf,), dtype=dtype)
        for gi, grp in enumerate(meta.f_groups):
            kf, t = grp["kf"], grp["t"]
            acc = jnp.zeros((kf, t), dtype=dtype)
            for k, (bi, si, local) in enumerate(grp["slots"]):
                bj = jac.buckets[bi]
                wp = w.parts[bi]
                Js = bj.slot_J(si)                       # [n, r, t]
                contrib = jnp.einsum("nrt,nr->nt", Js, wp)
                oh = meta.onehot(gi, bi, si, local, kf)
                if oh is not None:
                    acc = acc + jnp.einsum("nk,nt->kt",
                                           oh.astype(dtype), contrib)
                else:  # one-hot too large; fall back to scatter
                    acc = acc.at[meta.c(f"fg{gi}.local{k}", local)
                                 ].add(contrib)
            out = out.at[meta.c(f"fg{gi}.cols", grp["cols"])].add(acc)
        return out

    def E_apply(self, z):
        """E z: [ne, te] -> RVec."""
        parts = []
        for bi, (bj, bs) in enumerate(zip(self.jac.buckets,
                                          self.meta.buckets)):
            if bs.e_slot is None:
                parts.append(jnp.zeros((bj.n, bj.r), dtype=bj.J.dtype))
                continue
            Je = bj.slot_J(bs.e_slot)
            zb = z[self.meta.c(f"b{bi}.e_ids", bs.e_ids)]
            parts.append(jnp.einsum("nrt,nt->nr", Je, zb))
        return RVec(parts)

    def Et_apply(self, w: RVec):
        out = jnp.zeros((self.meta.ne, self.meta.te),
                        dtype=self.jac.buckets[0].J.dtype)
        for bi, (bj, bs, wp) in enumerate(zip(self.jac.buckets,
                                              self.meta.buckets, w.parts)):
            if bs.e_slot is None:
                continue
            Je = bj.slot_J(bs.e_slot)
            contrib = jnp.einsum("nrt,nr->nt", Je, wp)
            out = out.at[self.meta.c(f"b{bi}.e_ids", bs.e_ids)].add(contrib)
        return out

    # ---- grouped building blocks ----

    def _grouped_Fv(self, g, v):
        """F v for one grouped e-bucket: [ne, k, r]. The f-values are
        fetched as rows of the tiny [kf, t] group matrix (contiguous row
        takes instead of the flat gather v[cols[ne,k,t]]) — numerically
        identical to indexing v directly."""
        meta = self.meta
        w_g = None
        for (gi, Jf_g, cols, oh, kf, t, si, local) in g["fslots"]:
            grp = meta.f_groups[gi]
            Vmat = v[meta.c(f"fg{gi}.cols", grp["cols"])]     # [kf, t]
            vb = Vmat[meta.grouped_loc(gi, g["bi"], si, local)]
            term = jnp.einsum("nkrt,nkt->nkr", Jf_g, vb)
            w_g = term if w_g is None else w_g + term
        return w_g

    def _grouped_Ft(self, g, w_g, accs):
        """Accumulate F^T w_g into the per-f-group accumulators."""
        dtype = w_g.dtype
        for (gi, Jf_g, cols, oh, kf, t, si, local) in g["fslots"]:
            contrib = jnp.einsum("nkrt,nkr->nkt", Jf_g, w_g)
            accs[gi] = accs[gi] + jnp.einsum("nkc,nkt->ct",
                                             oh.astype(dtype), contrib)
        return accs

    def _obs_Fv(self, bi, v):
        """F v for an ungrouped bucket, observation order: [n, r]."""
        meta, jac = self.meta, self.jac
        bj, bs = jac.buckets[bi], meta.buckets[bi]
        Jf = _f_part(bj, bs)
        vb = v[meta.c(f"b{bi}.f_cols", bs.f_cols)]
        return jnp.einsum("nrt,nt->nr", Jf, vb)

    def _obs_Ft(self, bi, w, accs):
        """Accumulate F^T w of an ungrouped bucket into accs (one-hot when
        available, scatter otherwise)."""
        meta, jac = self.meta, self.jac
        dtype = w.dtype
        for gi, grp in enumerate(meta.f_groups):
            for k, (bbi, si, local) in enumerate(grp["slots"]):
                if bbi != bi:
                    continue
                Js = jac.buckets[bi].slot_J(si)
                contrib = jnp.einsum("nrt,nr->nt", Js, w)
                oh = meta.onehot(gi, bi, si, local, grp["kf"])
                if oh is not None:
                    accs[gi] = accs[gi] + jnp.einsum(
                        "nk,nt->kt", oh.astype(dtype), contrib)
                else:
                    accs[gi] = accs[gi].at[
                        meta.c(f"fg{gi}.local{k}", local)].add(contrib)
        return accs

    def _ungrouped_f_buckets(self):
        return [bi for bi, bs in enumerate(self.meta.buckets)
                if bs.f_cols is not None and bi not in self._groups]

    def _place(self, accs):
        meta = self.meta
        out = jnp.zeros((meta.nf,),
                        dtype=self.jac.buckets[0].J.dtype)
        for gi, grp in enumerate(meta.f_groups):
            out = out.at[meta.c(f"fg{gi}.cols", grp["cols"])].add(accs[gi])
        return out

    def _zero_accs(self):
        dtype = self.jac.buckets[0].J.dtype
        return [jnp.zeros((grp["kf"], grp["t"]), dtype=dtype)
                for grp in self.meta.f_groups]

    def _Et_of_obs_w(self, bi, w, u):
        """Accumulate E^T w of an ungrouped e-bucket into u [ne, te]."""
        meta, jac = self.meta, self.jac
        bj, bs = jac.buckets[bi], meta.buckets[bi]
        if bs.e_slot is None:
            return u
        Je = bj.slot_J(bs.e_slot)
        return u.at[meta.c(f"b{bi}.e_ids", bs.e_ids)].add(
            jnp.einsum("nrt,nr->nt", Je, w))

    def apply_S(self, v):
        """Implicit S v = F^T F v + D_f^2 v - F^T E (E^T E)^-1 E^T F v
        (implicit_schur_complement.h:52-91) — dense einsums over the chunk
        layout; no gather/scatter in the CG body for grouped buckets."""
        meta = self.meta
        dtype = self.jac.buckets[0].J.dtype
        u = jnp.zeros((meta.ne, meta.te), dtype=dtype)
        w_gs = {}
        for bi, g in self._groups.items():
            w_g = self._grouped_Fv(g, v)
            w_gs[bi] = w_g
            u = u + jnp.einsum("nkrt,nkr->nt", g["Je_g"], w_g)
        ungrouped = self._ungrouped_f_buckets()
        w_obs = {}
        for bi in ungrouped:
            w = self._obs_Fv(bi, v)
            w_obs[bi] = w
            u = self._Et_of_obs_w(bi, w, u)
        z = self.esolve(u)
        accs = self._zero_accs()
        for bi, g in self._groups.items():
            w2_g = jnp.einsum("nkrt,nt->nkr", g["Je_g"], z)
            accs = self._grouped_Ft(g, w_gs[bi] - w2_g, accs)
        for bi in ungrouped:
            w = w_obs[bi]
            bs = meta.buckets[bi]
            if bs.e_slot is not None:
                Je = self.jac.buckets[bi].slot_J(bs.e_slot)
                eids = meta.c(f"b{bi}.e_ids", bs.e_ids)
                w = w - jnp.einsum("nrt,nt->nr", Je, z[eids])
            accs = self._obs_Ft(bi, w, accs)
        return self._place(accs) + (self.D_f * self.D_f) * v

    def rhs(self, b_e, b_f):
        """Reduced rhs: b_f - F^T E (E^T E)^-1 b_e."""
        z = self.esolve(b_e)
        accs = self._zero_accs()
        for bi, g in self._groups.items():
            w2_g = jnp.einsum("nkrt,nt->nkr", g["Je_g"], z)
            accs = self._grouped_Ft(g, w2_g, accs)
        for bi in self._ungrouped_f_buckets():
            bs = self.meta.buckets[bi]
            if bs.e_slot is None:
                continue
            Je = self.jac.buckets[bi].slot_J(bs.e_slot)
            eids = self.meta.c(f"b{bi}.e_ids", bs.e_ids)
            w2 = jnp.einsum("nrt,nt->nr", Je, z[eids])
            accs = self._obs_Ft(bi, w2, accs)
        return b_f - self._place(accs)

    def back_substitute(self, b_e, y):
        """d_e = (E^T E)^-1 (b_e - E^T F y)
        (implicit_schur_complement.cc:208)."""
        meta = self.meta
        dtype = self.jac.buckets[0].J.dtype
        u = jnp.zeros((meta.ne, meta.te), dtype=dtype)
        for bi, g in self._groups.items():
            u = u + jnp.einsum("nkrt,nkr->nt", g["Je_g"],
                               self._grouped_Fv(g, y))
        for bi in self._ungrouped_f_buckets():
            if self.meta.buckets[bi].e_slot is None:
                continue
            u = self._Et_of_obs_w(bi, self._obs_Fv(bi, y), u)
        return self.esolve(b_e - u)

    # ---- explicit S (DENSE_SCHUR / SPARSE_SCHUR,
    #      schur_complement_solver.cc) ----

    def explicit_S(self):
        """Dense S (and the A = E^T F tensor used to form it)."""
        S, _A = self._assemble_S()
        return S

    def explicit_S_and_rhs(self, b_e, b_f):
        S, A = self._assemble_S()
        rhs = b_f - jnp.einsum("itf,it->f", A, self.esolve(b_e))
        return S, rhs

    def _grouped_assemble_possible(self):
        """Fast explicit-S assembly requires: one f group, and every
        f-carrying bucket grouped with a single f slot."""
        if len(self.meta.f_groups) != 1:
            return False
        for bi, bs in enumerate(self.meta.buckets):
            if bs.f_cols is None:
                continue
            g = self._groups.get(bi)
            if bs.e_slot is not None:
                if g is None or len(g["fslots"]) != 1:
                    return False
            else:
                grp = self.meta.f_groups[0]
                slots_here = [s for s in grp["slots"] if s[0] == bi]
                if len(slots_here) != 1:
                    return False
                if self.meta.onehot(0, bi, slots_here[0][1],
                                    slots_here[0][2], grp["kf"]) is None:
                    return False
        return True

    def _assemble_S_grouped(self):
        """Explicit S over the chunk layout: every accumulation is a
        one-hot matmul — no scatters (the reference's
        SchurEliminator chunk products, schur_eliminator_impl.h:228,
        re-expressed as dense contractions)."""
        meta, jac = self.meta, self.jac
        dtype = jac.buckets[0].J.dtype
        ne, te, nf = meta.ne, meta.te, meta.nf
        grp = meta.f_groups[0]
        kf, t = grp["kf"], grp["t"]

        FtF_blocks = jnp.zeros((kf, t, t), dtype=dtype)
        # A = E^T F kept as [ne, te, kf*t]: a 144-wide minor dim tiles far
        # better than the 4-D [ne, te, kf, t] form (t=9 pads to a full
        # 128-lane tile).
        A = jnp.zeros((ne, te, kf * t), dtype=dtype)
        for bi, bs in enumerate(meta.buckets):
            if bs.f_cols is None:
                continue
            g = self._groups.get(bi)
            if g is not None:
                (gi, Jf_g, cols, oh, _kf, _t, si, local) = g["fslots"][0]
                ohd = oh.astype(dtype)
                Gf = jnp.einsum("nkrt,nkru->nktu", Jf_g, Jf_g)
                FtF_blocks = FtF_blocks + jnp.einsum("nkc,nktu->ctu",
                                                     ohd, Gf)
                Ge = jnp.einsum("nkru,nkrt->nkut", g["Je_g"], Jf_g)
                A = A + jnp.einsum("nkc,nkut->nuct", ohd,
                                   Ge).reshape(ne, te, kf * t)
            else:
                # f-only bucket: block-diagonal contribution via one-hot.
                slots_here = [s for s in grp["slots"] if s[0] == bi]
                (_, si, local) = slots_here[0]
                bj = jac.buckets[bi]
                Js = bj.slot_J(si)
                G = jnp.einsum("nrt,nru->ntu", Js, Js)
                oh = meta.onehot(0, bi, si, local, kf).astype(dtype)
                FtF_blocks = FtF_blocks + jnp.einsum("nc,ntu->ctu", oh, G)

        # S (group-local ordering) = blockdiag(FtF) - A^T (EtE)^-1 A,
        # with the correction as ONE [kf*t, ne*te] x [ne*te, kf*t] matmul.
        Y = jnp.einsum("nuv,nvf->nuf", self.inv_ete, A)
        S_corr = jnp.einsum("nuf,nug->fg", A, Y)
        ii = jnp.arange(kf)
        S_local = (-S_corr).reshape(kf, t, kf, t).at[ii, :, ii, :].add(
            FtF_blocks).reshape(kf * t, kf * t)
        pos = meta.c("fg0.cols", grp["cols"]).reshape(-1)    # [kf*t]
        S_local = S_local + jnp.diag((self.D_f * self.D_f)[pos])
        return S_local, A, pos

    def _assemble_S(self):
        if self._grouped_assemble_possible():
            S_local, A, pos = self._assemble_S_grouped()
            meta = self.meta
            dtype = S_local.dtype
            S = jnp.zeros((meta.nf, meta.nf), dtype=dtype)
            S = S.at[pos[:, None], pos[None, :]].add(S_local)
            A_glob = jnp.zeros((meta.ne, meta.te, meta.nf), dtype=dtype)
            A_glob = A_glob.at[:, :, pos].add(A)
            return S, A_glob
        meta, jac = self.meta, self.jac
        dtype = jac.buckets[0].J.dtype
        ne, te, nf = meta.ne, meta.te, meta.nf
        FtF = jnp.zeros((nf, nf), dtype=dtype)
        A = jnp.zeros((ne, te, nf), dtype=dtype)
        for bi, (bj, bs) in enumerate(zip(jac.buckets, meta.buckets)):
            if bs.f_cols is not None:
                Jf = _f_part(bj, bs)
                G = jnp.einsum("nrt,nru->ntu", Jf, Jf)
                c = meta.c(f"b{bi}.f_cols", bs.f_cols)
                n, t = c.shape
                rows = jnp.broadcast_to(c[:, :, None], (n, t, t))
                cols = jnp.broadcast_to(c[:, None, :], (n, t, t))
                FtF = FtF.at[rows, cols].add(G)
            if bs.e_slot is not None and bs.f_cols is not None:
                Je = bj.slot_J(bs.e_slot)
                Jf = _f_part(bj, bs)
                Gc = jnp.einsum("nrt,nru->ntu", Je, Jf)   # [n, te, tf]
                c = meta.c(f"b{bi}.f_cols", bs.f_cols)
                n, tf = c.shape
                eids = meta.c(f"b{bi}.e_ids", bs.e_ids)
                rows = jnp.broadcast_to(eids[:, None, None], (n, te, tf))
                mids = jnp.broadcast_to(
                    jnp.arange(te)[None, :, None], (n, te, tf))
                cols = jnp.broadcast_to(c[:, None, :], (n, te, tf))
                A = A.at[rows, mids, cols].add(Gc)
        FtF = FtF + jnp.diag(self.D_f * self.D_f)
        B = _batched_cho_solve(self.chol_e, A)             # [ne, te, nf]
        S = FtF - jnp.einsum("itf,itg->fg", A, B)
        return S, A

    # ---- preconditioners ----

    def make_preconditioner(self, kind: PreconditionerType):
        if kind == PreconditionerType.IDENTITY:
            return lambda v: v
        if kind == PreconditionerType.SCHUR_POWER_SERIES_EXPANSION:
            return self._make_power_series_preconditioner()
        if kind in (PreconditionerType.CLUSTER_JACOBI,
                    PreconditionerType.CLUSTER_TRIDIAGONAL):
            return self._make_cluster_preconditioner()
        subtract_cross = kind == PreconditionerType.SCHUR_JACOBI
        return self._make_block_diag_preconditioner(subtract_cross)

    def _make_cluster_preconditioner(self):
        """CLUSTER_JACOBI / CLUSTER_TRIDIAGONAL
        (visibility_based_preconditioner.h:127): S restricted to the
        camera-cluster sparsity (cluster-diagonal blocks, plus the degree-2
        spanning-forest off-diagonal blocks for tridiagonal), factorized
        densely. The clustering itself is host-side structure work
        (clustering.py), done once in make_schur_solver."""
        meta = self.meta
        mask = meta.c("cluster_mask", meta.cluster_mask)
        diag_mask = meta.c("cluster_mask_diag", meta.cluster_mask_diag)
        S = self.explicit_S()
        jitter = 1e-12 * jnp.diag(jnp.diag(S))
        # The forest-augmented pattern can be indefinite (the reference's
        # sparse factorization can fail there too and reports a
        # preconditioner update failure); fall back to the cluster-diagonal
        # pattern, which is PD (principal submatrices of SPD S).
        P1 = S * mask + jitter
        c1 = jnp.linalg.cholesky(P1)
        bad = jnp.any(jnp.isnan(c1))
        P2 = S * diag_mask + jitter
        c2 = jnp.linalg.cholesky(P2)
        chol = jnp.where(bad, c2, c1)

        def apply(v):
            y = jsl.solve_triangular(chol, v, lower=True)
            return jsl.solve_triangular(chol.T, y, lower=False)

        return apply

    def _block_diag_S(self, subtract_cross: bool):
        """Per-f-block diagonal blocks of S (or of F^T F when
        subtract_cross=False — the JACOBI option). Cross-row terms within one
        (e-block, f-block) pair are included per row (schur_jacobi
        semantics for BA structure where a camera observes a point once)."""
        meta, jac = self.meta, self.jac
        dtype = jac.buckets[0].J.dtype
        out = []
        for gi, grp in enumerate(meta.f_groups):
            t, kf = grp["t"], grp["kf"]
            acc = jnp.zeros((kf, t, t), dtype=dtype)
            for k, (bi, var_si, local) in enumerate(grp["slots"]):
                bj = jac.buckets[bi]
                bs = meta.buckets[bi]
                Jf = bj.slot_J(var_si)
                G = jnp.einsum("nrt,nru->ntu", Jf, Jf)
                if subtract_cross and bs.e_slot is not None:
                    Je = bj.slot_J(bs.e_slot)
                    Gc = jnp.einsum("nrt,nru->ntu", Je, Jf)  # [n, te, t]
                    eids = meta.c(f"b{bi}.e_ids", bs.e_ids)
                    MG = jnp.einsum("nij,njv->niv", self.inv_ete[eids], Gc)
                    G = G - jnp.einsum("ntu,ntv->nuv", Gc, MG)
                oh = meta.onehot(gi, bi, var_si, local, kf)
                if oh is not None:
                    # duplicate reduction as a one-hot contraction
                    acc = acc + jnp.einsum("nk,ntu->ktu",
                                           oh.astype(dtype), G)
                else:
                    acc = acc.at[meta.c(f"fg{gi}.local{k}", local)].add(G)
            cols = meta.c(f"fg{gi}.cols", grp["cols"])      # [kf, t]
            d = self.D_f[cols]
            acc = acc + _embed_diag(d * d)
            out.append((cols, acc))
        return out

    def _make_block_diag_preconditioner(self, subtract_cross: bool):
        # Invert the blocks ONCE at construction; the per-CG-iteration
        # apply is then a broadcast matmul instead of batched tiny
        # triangular solves (the same invert-once pattern as inv_ete and
        # preconditioners.py _block_jacobi_inverses — no batched tiny
        # triangular solves inside the CG body).
        inverses = []
        for cols, acc in self._block_diag_S(subtract_cross):
            chol = jnp.linalg.cholesky(acc)
            eye = jnp.broadcast_to(jnp.eye(acc.shape[-1], dtype=acc.dtype),
                                   acc.shape)
            inverses.append((cols, _batched_cho_solve(chol, eye)))

        def apply(v):
            out = jnp.zeros_like(v)
            for cols, inv in inverses:
                out = out.at[cols].set(
                    jnp.einsum("ntu,nu->nt", inv, v[cols]))
            return out

        return apply

    def _make_power_series_preconditioner(self):
        """Truncated Neumann series around the block-diagonal splitting
        S = P - U:  S^-1 ~= sum_k (P^-1 U)^k P^-1
        (power_series_expansion_preconditioner.h:44, Weber et al. power BA).
        """
        num_terms = 4
        p_apply = self._make_block_diag_preconditioner(subtract_cross=True)

        def apply(v):
            # M^-1 v = sum_{k=0..K} (I - P^-1 S)^k P^-1 v, evaluated by the
            # recursion y_{k+1} = y_k - P^-1 (S y_k). Each term is symmetric;
            # the truncated sum is SPD when rho(I - P^-1 S) < 1 (the
            # reference guards this with spse_tolerance; here the term count
            # is fixed and small).
            y = p_apply(v)
            acc = y
            for _ in range(num_terms):
                y = y - p_apply(self.apply_S(y))
                acc = acc + y
            return acc

        return apply


def _embed_diag(d):
    """[k, t] -> [k, t, t] diagonal matrices."""
    t = d.shape[-1]
    return d[..., :, None] * jnp.eye(t, dtype=d.dtype)[None]


def _f_part(bj, bs):
    """Concatenated F-slot sub-Jacobian [n, r, tf_bucket]."""
    parts = [bj.slot_J(s) for s in bs.f_slots]
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=2)


def make_schur_solver(program, options):
    """Returns solve(jac, res, D) -> (step, lin_iters) for the Schur family."""
    meta = detect_schur_structure(program, options)
    if meta is None:
        raise ValueError("Schur solver selected but no Schur structure; "
                         "the preprocessor should have downgraded")
    solver_type = options.linear_solver_type
    precond_kind = options.preconditioner_type
    max_it = options.max_linear_solver_iterations
    eta = options.eta
    nf = meta.nf

    if precond_kind in (PreconditionerType.CLUSTER_JACOBI,
                        PreconditionerType.CLUSTER_TRIDIAGONAL) and \
            meta.cluster_mask is None:
        from .clustering import cluster_membership
        membership, forest = cluster_membership(
            program, meta, precond_kind.name,
            clustering_type=getattr(options, "visibility_clustering_type",
                                    "CANONICAL_VIEWS"))
        col_cluster = np.zeros(nf, dtype=np.int64)
        flat = 0
        for grp in meta.f_groups:
            for li in range(grp["kf"]):
                col_cluster[grp["cols"][li]] = membership[flat]
                flat += 1
        diag_allowed = col_cluster[:, None] == col_cluster[None, :]
        allowed = diag_allowed.copy()
        if forest:
            for (a, b) in forest:
                allowed |= ((col_cluster[:, None] == a)
                            & (col_cluster[None, :] == b))
                allowed |= ((col_cluster[:, None] == b)
                            & (col_cluster[None, :] == a))
        meta.cluster_mask = allowed.astype(np.float64)
        meta.cluster_mask_diag = diag_allowed.astype(np.float64)
        if meta._program is not None:
            meta._program.register_const("schur.cluster_mask",
                                         meta.cluster_mask)
            meta._program.register_const("schur.cluster_mask_diag",
                                         meta.cluster_mask_diag)

    from .cg import conjugate_gradients
    from .schur_sparse import (use_sparse_schur, get_sparse_schur_context,
                               sparse_schur_reduced_solve)

    sparse_ctx = (get_sparse_schur_context(meta, program, options)
                  if use_sparse_schur(meta, options) else None)

    mixed = options.use_mixed_precision_solves

    def solve_b(jac, D, b):
        """Solve (J^T J + D^2) d = b via Schur elimination; jac/D/b share a
        dtype. Returns (d, lin_iters). Used both for the LM step (with
        b = -J^T r) and for mixed-precision refinement corrections."""
        out_dtype = jac.buckets[0].J.dtype
        if mixed:
            # Mixed precision (solver.h:572-589 use_mixed_precision_solves,
            # re-targeted): the LM inner solve runs in f32; the trust
            # region tolerates the inexact step (it is a descent
            # direction; radius control absorbs the rest), and
            # cost/gradient/convergence stay f64.
            from ..ops.bsr import BucketJacobian
            jac = BlockJacobian(
                [BucketJacobian(b_.J.astype(jnp.float32), b_.cols,
                                b_.row_offset, b_.onehots, b_.gcols,
                                b_.sorted_slot, b_.tlocals, b_.tslabs)
                 for b_ in jac.buckets],
                jac.num_rows, jac.num_cols)
            D = D.astype(jnp.float32)
            b = b.astype(jnp.float32)
        ops = SchurOps(meta, jac, D)
        b_e = b[meta.c("e_cols", meta.e_cols)]          # [ne, te]
        b_f = b[meta.c("f_global", meta.f_global_cols)]   # [nf]

        if solver_type in (LinearSolverType.DENSE_SCHUR,
                           LinearSolverType.SPARSE_SCHUR):
            if sparse_ctx is not None:
                # True block-sparse reduced system: device-assembled
                # co-visibility pair blocks, host LDL^T
                # (schur_complement_solver.cc:291 regime — see
                # schur_sparse.py).
                rhs = ops.rhs(b_e, b_f)
                y = sparse_schur_reduced_solve(meta, ops, sparse_ctx,
                                               rhs, ops.D_f)
            else:
                S, rhs = ops.explicit_S_and_rhs(b_e, b_f)
                c, lower = jsl.cho_factor(S)
                y = jsl.cho_solve((c, lower), rhs)
            iters = jnp.asarray(1, dtype=jnp.int32)
        else:
            rhs = ops.rhs(b_e, b_f)
            precond = ops.make_preconditioner(precond_kind)
            # Explicit-S operator (solver.h use_explicit_schur_complement):
            # for small camera counts, forming the dense S once and using a
            # [nf, nf] matvec per CG iteration beats the matrix-free chain
            # (the reference documents this for < ~100 cameras; here the
            # crossover is larger — each implicit apply walks the chunk
            # tensors, a dense matvec is one matrix-vector product).
            use_explicit = (options.use_explicit_schur_complement
                            or (nf <= 2048
                                and meta.ne * meta.te * nf <= 1e8))
            if use_explicit:
                S_exp = ops.explicit_S()
                # exact-f32 matvec: reduced-precision matmul passes (TF32,
                # ~1e-3 relative) stall PCG at the operator-error floor
                apply_S = lambda v: jnp.einsum(
                    "fg,g->f", S_exp, v,
                    precision=jax.lax.Precision.HIGHEST)
            else:
                apply_S = ops.apply_S
            x0 = jnp.zeros((nf,), dtype=rhs.dtype)
            if options.use_spse_initialization:
                # SPSE warm start (iterative_schur_complement_solver.cc:
                # 99-111): seed PCG with a truncated power-series estimate
                # of S^-1 rhs around the Schur-Jacobi splitting, iterating
                # until the correction drops below spse_tolerance.
                p_apply = ops._make_block_diag_preconditioner(True)
                spse_max = options.max_num_spse_iterations
                spse_tol = options.spse_tolerance

                def spse_cond(s):
                    xk, dx, i = s
                    return ((i < spse_max)
                            & (jnp.linalg.norm(dx)
                               > spse_tol * jnp.linalg.norm(xk)))

                def spse_body(s):
                    xk, _, i = s
                    dx = p_apply(rhs - apply_S(xk))
                    return (xk + dx, dx, i + 1)

                x0 = p_apply(rhs)
                x0, _, _ = jax.lax.while_loop(
                    spse_cond, spse_body,
                    (x0, x0, jnp.asarray(1, jnp.int32)))
            result = conjugate_gradients(
                apply_S, rhs, x0, apply_preconditioner=precond,
                max_iterations=max_it, q_tolerance=eta,
                min_iterations=options.min_linear_solver_iterations)
            y = result.x
            iters = result.num_iterations

        d_e = ops.back_substitute(b_e, y)
        d = jnp.zeros((program.num_effective,), dtype=y.dtype)
        d = d.at[meta.c("f_global", meta.f_global_cols)].set(y)
        d = d.at[meta.c("e_cols", meta.e_cols)].set(d_e)
        return d.astype(out_dtype), iters

    def solve(jac, res, D):
        return solve_b(jac, D, -jac.rmatvec(res))

    solve.solve_b = solve_b
    return solve
