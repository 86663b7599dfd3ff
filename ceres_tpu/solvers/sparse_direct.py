"""SPARSE_NORMAL_CHOLESKY via the native host factorization.

Device/host split of the reference's SparseNormalCholeskySolver
(sparse_normal_cholesky_solver.cc + inner_product_computer.cc +
suitesparse.cc): the device computes per-bucket Gram blocks
G_k = J_k^T J_k and the rhs J^T r in one fused jit; a `jax.pure_callback`
hands the Gram values to the host, where the native C++ runtime scatters
them into a cached CSC pattern (symbolic analysis done once — the
InnerProductComputer role) and runs a simplicial LDL^T refactor + solve
(the CHOLMOD role). Factorization breakdown returns NaNs, which the
trust-region loop treats as an invalid step and retries with a smaller
radius (LinearSolverTerminationType::FAILURE semantics,
linear_solver.h:57).
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import native
from ..ops.bsr import BlockJacobian, RVec


class SparseNormalCholeskyContext:
    """Host-side symbolic state: CSC pattern of J^T J, per-bucket scatter
    maps from flattened Gram tensors into the CSC values array, diagonal
    positions, and the reusable native factorization handle."""

    def __init__(self, program, use_rcm: bool = True,
                 lanes_per_bucket: Optional[List[np.ndarray]] = None,
                 dynamic: bool = False,
                 ordering: Optional[int] = None):
        """lanes_per_bucket: optional per-bucket arrays of residual-block
        lane indices restricting the pattern to a row subset (the
        SubsetPreconditioner case, subset_preconditioner.h:70); None uses
        every block.

        dynamic: re-analyze the sparsity pattern every factorization from
        the NUMERICAL nonzeros of this iteration's Gram (the
        dynamic_sparsity option — the
        DynamicSparseNormalCholeskySolver role,
        dynamic_sparse_normal_cholesky_solver.cc: AnalyzePattern +
        Factorize per call instead of cached symbolic analysis). The
        bucketed structural pattern is the superset; entries whose
        assembled value is exactly zero this iteration are dropped before
        a fresh symbolic analysis + LDL^T. Worth it when the structural
        pattern wildly overestimates the numerical one (e.g. costs whose
        active support moves between iterations)."""
        n = program.num_effective
        self.n = n
        bucket_cols: List[np.ndarray] = []
        for bi, bk in enumerate(program.buckets):
            cols = [sl.cols for sl in bk.slots if sl.variable]
            ac = (np.concatenate(cols, axis=1)
                  if len(cols) > 1 else cols[0])
            if lanes_per_bucket is not None:
                ac = ac[lanes_per_bucket[bi]]
            bucket_cols.append(ac)
        self.bucket_cols = bucket_cols

        # Keys of every Gram entry: (col * n + row), CSC (column-major).
        key_parts = []
        for ac in bucket_cols:
            rows = ac[:, :, None].astype(np.int64)       # [nb, t, 1]
            cols = ac[:, None, :].astype(np.int64)       # [nb, 1, t]
            key_parts.append((cols * n + rows).reshape(-1))
        # Union in the diagonal: always structurally present so the D^2
        # regularizer keeps the factor SPD even for columns the (possibly
        # subset) rows never touch.
        diag = np.arange(n, dtype=np.int64) * n + np.arange(n,
                                                            dtype=np.int64)
        all_keys = np.concatenate(key_parts + [diag])
        uniq = np.unique(all_keys)
        self.nnz = uniq.size
        # CSC structure.
        col_of = (uniq // n).astype(np.int64)
        row_of = (uniq % n).astype(np.int32)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, col_of + 1, 1)
        self.Ap = np.cumsum(indptr)
        self.Ai = row_of
        # Per-bucket maps: flattened Gram index -> CSC position.
        self.maps = [np.searchsorted(uniq, k).astype(np.int64)
                     for k in key_parts]
        self.diag_pos = np.searchsorted(uniq, diag).astype(np.int64)

        self.dynamic = bool(dynamic)
        self._use_rcm = use_rcm
        # explicit ordering override (OrderingType knob); None = legacy
        # use_rcm auto selection
        self._ordering = ordering
        self._col_of = col_of  # per-superset-entry column, for re-analysis
        self.chol = native.SparseCholesky(n, self.Ap, self.Ai,
                                          use_rcm=use_rcm,
                                          ordering=ordering)

    def host_factor(self, D_sq: np.ndarray, *gram_flats) -> np.ndarray:
        """Assemble + refactor; returns int32 status (0 = ok)."""
        values = np.zeros(self.nnz, dtype=np.float64)
        for flat, idx in zip(gram_flats, self.maps):
            native.scatter_add(values, idx,
                               np.asarray(flat, dtype=np.float64).reshape(-1))
        values[self.diag_pos] += np.asarray(D_sq, dtype=np.float64)
        if self.dynamic:
            keep = values != 0.0
            keep[self.diag_pos] = True
            # Per-iteration re-analysis uses a single AMD ordering pass:
            # the static path's ORDER_AUTO runs RCM + AMD + two symbolic
            # fills to pick a winner, which is fine once but triples the
            # host cost when repeated every factorization.
            if self._ordering == native.SparseCholesky.ORDER_NATURAL:
                order = native.SparseCholesky.ORDER_NATURAL
            else:
                order = (native.SparseCholesky.ORDER_AMD if self._use_rcm
                         else native.SparseCholesky.ORDER_NATURAL)
            if not keep.all():
                counts = np.zeros(self.n + 1, dtype=np.int64)
                np.add.at(counts, self._col_of[keep] + 1, 1)
                self.chol = native.SparseCholesky(
                    self.n, np.cumsum(counts), self.Ai[keep],
                    ordering=order)
                values = values[keep]
            elif self.chol._Ai.size != self.nnz:
                self.chol = native.SparseCholesky(self.n, self.Ap, self.Ai,
                                                  ordering=order)
        self._ok = (self.chol.factor(values) == 0)
        return np.int32(0 if self._ok else 1)

    def host_apply(self, b: np.ndarray) -> np.ndarray:
        """Backsolve; identity when the last factorization broke down (the
        preconditioner-update-failure fallback)."""
        b = np.asarray(b, dtype=np.float64)
        return self.chol.solve(b) if getattr(self, "_ok", False) else b

    def host_solve(self, D_sq: np.ndarray, rhs: np.ndarray,
                   *gram_flats) -> np.ndarray:
        status = self.host_factor(D_sq, *gram_flats)
        if int(status) != 0:
            return np.full(self.n, np.nan)
        return self.host_apply(rhs)


def _native_ordering(options) -> Optional[int]:
    """Map the public OrderingType knob to the native backend (see
    types.OrderingType docstring): NATURAL = identity; AMD and NESDIS
    both take ORDER_AUTO, which symbolically evaluates RCM and the
    quotient-graph minimum-degree (AMD role) and keeps the lesser fill
    — never worse than plain AMD; there is no METIS backend."""
    from ..types import OrderingType
    ot = getattr(options, "linear_solver_ordering_type", None)
    if ot == OrderingType.NATURAL:
        return native.SparseCholesky.ORDER_NATURAL
    if ot in (OrderingType.AMD, OrderingType.NESDIS):
        return native.SparseCholesky.ORDER_AUTO
    return None


def make_sparse_normal_cholesky_solver(program, options):
    """Returns solve(jac, res, D) -> (step, lin_iters), jit-safe."""
    ctx = SparseNormalCholeskyContext(
        program, dynamic=bool(getattr(options, "dynamic_sparsity", False)),
        ordering=_native_ordering(options))
    dtype = program.dtype

    def solve(jac: BlockJacobian, res: RVec, D):
        grams = [jnp.einsum("nrt,nru->ntu", b.J, b.J) for b in jac.buckets]
        rhs = -jac.rmatvec(res)
        D_sq = D * D

        def cb(d_sq, r, *gs):
            return ctx.host_solve(d_sq, r, *gs).astype(np.float64)

        step = jax.pure_callback(
            cb, jax.ShapeDtypeStruct((ctx.n,), jnp.float64),
            D_sq.astype(jnp.float64), rhs.astype(jnp.float64),
            *[g.astype(jnp.float64) for g in grams],
            vmap_method="sequential")
        return step.astype(dtype), jnp.asarray(0, jnp.int32)

    return solve
