"""Preconditioners for the iterative solvers.

Capability parity with the reference preconditioner family
(preconditioner.h:51): IDENTITY, (block) JACOBI
(block_jacobi_preconditioner.h:55), SCHUR_JACOBI and
SCHUR_POWER_SERIES_EXPANSION live in schur.py next to the eliminator;
SUBSET / CLUSTER_* are provided at the orchestration layer.

Block-Jacobi structure: per-parameter-block diagonal blocks of
J^T J + D^T D, grouped by tangent size and inverted as batched Cholesky
solves — the reference's per-cell loop becomes a handful of batched
[k, t, t] factorizations.
"""

from __future__ import annotations

import jax.numpy as jnp
import jax.scipy.linalg as jsl

from ..ops.bsr import BlockJacobian, block_diag_jtj


def make_block_jacobi_preconditioner(jac: BlockJacobian, D, groups):
    """Returns apply(v) = M^-1 v with M = blockdiag(J^T J + D^T D).

    `groups` is the program's GroupMeta list (variable blocks by tangent
    size). Each group's [k, t, t] blocks are Cholesky-factorized in one
    batched call (block_jacobi_preconditioner.cc's cell loop, batched).
    """
    diag_blocks = block_diag_jtj(jac, groups)
    factors = []
    for g, M in zip(groups, diag_blocks):
        cols = jnp.asarray(g.tan_cols)              # [k, t]
        d = D[cols]                                 # [k, t]
        M = M + jnp.einsum("kt,tu->ktu", d * d,
                           jnp.eye(g.tangent_size, dtype=M.dtype))
        # invert ONCE (Cholesky against the identity); the per-CG apply is
        # then a broadcast multiply-reduce — batched tiny triangular
        # solves inside the CG body cost milliseconds per application.
        chol = jnp.linalg.cholesky(M)
        eye = jnp.broadcast_to(jnp.eye(g.tangent_size, dtype=M.dtype),
                               M.shape)
        y = jsl.solve_triangular(chol, eye, lower=True)
        inv = jsl.solve_triangular(jnp.swapaxes(chol, -1, -2), y,
                                   lower=False)
        factors.append((cols, inv))

    def apply(v):
        out = jnp.zeros_like(v)
        for cols, inv in factors:
            z = jnp.sum(inv * v[cols][:, None, :], axis=-1)   # [k, t]
            out = out.at[cols].set(z)
        return out

    return apply


def make_subset_preconditioner_factory(program, options):
    """SUBSET preconditioner for CGNR (reference subset_preconditioner.h:70):
    M = Q^T Q + D^2 where Q is the rows of J belonging to the residual
    blocks in options.residual_blocks_for_subset_preconditioner. The device
    computes the subset Gram blocks; the host factors them once
    per linearization with the native LDL^T and applies backsolves per CG
    iteration (the SuiteSparse role). Returns make(jac, D) -> apply(v)."""
    import jax
    import numpy as np
    from .sparse_direct import SparseNormalCholeskyContext

    subset = options.residual_blocks_for_subset_preconditioner
    if not subset:
        raise ValueError(
            "SUBSET preconditioner requires "
            "residual_blocks_for_subset_preconditioner (solver.h)")
    subset_idx = np.asarray(sorted({rb.index for rb in subset}),
                            dtype=np.int64)
    lanes = []
    for bk in program.buckets:
        lanes.append(np.nonzero(np.isin(bk.orig_indices, subset_idx))[0]
                     .astype(np.int32))
    dtype = program.dtype

    # Device-dense variant: the host LDL^T needs a pure_callback INSIDE
    # the CG loop (the backsolve), which callback-less PJRT backends
    # cannot run and utils/hostsplit.py cannot split (callbacks
    # inside lax control flow have no sequential spelling). For moderate
    # column counts the subset normal matrix is factored ON DEVICE once
    # per linearization (lax Cholesky, outside the loop) and applied as
    # two triangular solves per CG iteration — no host round trips at
    # all. Selected automatically on callback-less backends; forceable
    # with CERES_TPU_SUBSET_DEVICE=1.
    import os as _os
    from ..utils.hostsplit import backend_supports_callbacks
    device_dense = (program.num_effective <= 4096
                    and (_os.environ.get("CERES_TPU_SUBSET_DEVICE")
                         or not backend_supports_callbacks()))
    if device_dense:
        import jax.scipy.linalg as jsl
        n = program.num_effective

        def make_dense(jac: BlockJacobian, D):
            M = jnp.zeros((n, n), dtype=jac.buckets[0].J.dtype)
            for bk_lanes, b in zip(lanes, jac.buckets):
                if bk_lanes.size == 0:
                    continue
                Js = b.J[bk_lanes]
                G = jnp.einsum("nrt,nru->ntu", Js, Js)
                cols = b.all_cols[bk_lanes]
                M = M.at[cols[:, :, None], cols[:, None, :]].add(G)
            M = M + jnp.diag((D * D).astype(M.dtype))
            c, lower = jsl.cho_factor(M)

            def apply(v):
                return jsl.cho_solve((c, lower),
                                     v.astype(c.dtype)).astype(dtype)

            return apply

        return make_dense

    ctx = SparseNormalCholeskyContext(program, lanes_per_bucket=lanes)

    def make(jac: BlockJacobian, D):
        grams = []
        for bk_lanes, b in zip(lanes, jac.buckets):
            if bk_lanes.size == 0:
                continue
            Js = b.J[bk_lanes]
            grams.append(jnp.einsum("nrt,nru->ntu", Js, Js))
        token = jax.pure_callback(
            lambda d_sq, *gs: ctx.host_factor(d_sq, *gs),
            jax.ShapeDtypeStruct((), jnp.int32),
            (D * D).astype(jnp.float64), *grams,
            vmap_method="sequential")

        def apply(v):
            # The token data-dependency orders the backsolve after the
            # factorization callback.
            out = jax.pure_callback(
                lambda b_, _t: ctx.host_apply(b_),
                jax.ShapeDtypeStruct((ctx.n,), jnp.float64),
                v.astype(jnp.float64), token, vmap_method="sequential")
            return out.astype(dtype)

        return apply

    # Restrict the gram maps to the nonempty buckets' order.
    ctx.maps = [m for m, ln in zip(ctx.maps, lanes) if ln.size > 0]
    return make


def make_identity_preconditioner():
    return lambda v: v
