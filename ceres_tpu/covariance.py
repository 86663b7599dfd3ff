"""Post-solve covariance estimation.

Capability parity with the reference's Covariance (include/ceres/
covariance.h:202, internal/ceres/covariance_impl.cc): computes blocks of
inverse(J'J) at the current parameter values, with the DENSE_SVD and
SPARSE_QR algorithms (types.h:465-468) and the rank-deficiency policy
(min_reciprocal_condition_number / null_space_rank, covariance.h:281-329).

Both algorithms run as dense device factorizations (SVD / QR via XLA);
the reference's SuiteSparse QR path (covariance_impl.cc:535) has no
analog here — SPARSE_QR means "QR of the Jacobian", which is exact and
dense-friendly at the problem sizes where covariances are requested.

Covariance blocks are returned in ambient coordinates (cov_ambient =
J_plus C_tangent J_plus^T) or tangent coordinates, matching
GetCovarianceBlock / GetCovarianceBlockInTangentSpace.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .program import CompiledProgram
from .types import CovarianceAlgorithmType


class CovarianceOptions:
    """covariance.h:247-331."""

    def __init__(self,
                 algorithm_type=CovarianceAlgorithmType.DENSE_SVD,
                 min_reciprocal_condition_number: float = 1e-14,
                 null_space_rank: int = 0,
                 apply_loss_function: bool = True,
                 num_threads: int = 1):
        self.algorithm_type = algorithm_type
        self.min_reciprocal_condition_number = (
            min_reciprocal_condition_number)
        self.null_space_rank = null_space_rank
        self.apply_loss_function = apply_loss_function
        self.num_threads = num_threads


class Covariance:
    Options = CovarianceOptions

    def __init__(self, options: Optional[CovarianceOptions] = None):
        self.options = options or CovarianceOptions()
        self._tangent_cov = None
        self._block_cov = None
        self._program = None
        self._message = ""

    @property
    def message(self):
        return self._message

    def compute(self, covariance_blocks: List[Tuple], problem) -> bool:
        """covariance_impl.cc:101. covariance_blocks: list of (block_a,
        block_b) numpy-array pairs.

        Algorithm selection: DENSE_SVD materializes the dense Jacobian and
        the full tangent covariance (exact, supports the rank-deficiency
        policy — covariance_impl.cc:704). SPARSE_QR on a large problem
        routes to the scalable path: only the REQUESTED block-pair
        covariances are computed, as batched back-solves against the
        factored undamped normal equations — Schur-eliminated when the
        problem has BA structure (the reference's sparse path role,
        covariance_impl.cc:360 sparsity + :535 sparse factorization,
        re-architected: dense J is never formed; memory is
        O(nnz + n * requested_cols))."""
        prog = CompiledProgram(problem,
                               apply_loss=self.options.apply_loss_function)
        self._program = prog
        self._block_cov = None
        for a, b in covariance_blocks:
            problem._get(a)
            problem._get(b)

        n = prog.num_effective
        opts = self.options
        if (opts.algorithm_type == CovarianceAlgorithmType.SPARSE_QR
                and n > 2000):
            return self._compute_sparse(covariance_blocks, prog)

        x = prog.initial_state()
        _, _, jac, _ = jax.jit(prog.linearize_fn)(x)
        J = jac.to_dense()

        if opts.algorithm_type == CovarianceAlgorithmType.DENSE_SVD:
            # SVD of J: J = U S V'; inv(J'J) = V S^-2 V'
            # (covariance_impl.cc:704 ComputeDenseSVDCovariance).
            _, s, vt = jnp.linalg.svd(J, full_matrices=False)
            s = np.asarray(s)
            max_s = s[0] if s.size else 0.0
            eps = opts.min_reciprocal_condition_number
            if opts.null_space_rank < 0:
                # automatic truncation: drop every value failing the
                # ratio test (covariance_impl.cc:739 automatic_truncation)
                keep = (s / max_s) ** 2 >= eps
            else:
                # drop the null_space_rank smallest unconditionally
                # (covariance_impl.cc:744 max_rank); if a KEPT value
                # still fails the ratio test, Compute fails
                # (covariance_impl.cc:749-767, covariance.h:316-321)
                keep = np.zeros_like(s, dtype=bool)
                keep[:max(len(s) - opts.null_space_rank, 0)] = True
                bad = keep & ((s / max_s) ** 2 < eps)
                if bad.any():
                    rcn = float((s[bad][0] / max_s) ** 2)
                    self._message = (
                        f"Rank deficient Jacobian: reciprocal condition "
                        f"number {rcn:e} < {eps:e}; increase "
                        f"null_space_rank to allow a pseudo-inverse.")
                    return False
            inv_s2 = np.where(keep, 1.0 / np.maximum(s, 1e-300) ** 2, 0.0)
            V = np.asarray(vt).T
            self._tangent_cov = (V * inv_s2[None, :]) @ V.T
        else:  # SPARSE_QR -> QR of J on device (R factor only)
            R = jnp.linalg.qr(J, mode="r")
            Rn = np.asarray(R)
            diag = np.abs(np.diag(Rn))
            if diag.min() <= 0 or (diag.min() / diag.max()) < np.sqrt(
                    opts.min_reciprocal_condition_number):
                self._message = ("Rank deficient Jacobian in QR "
                                 "factorization; use DENSE_SVD with "
                                 "null_space_rank.")
                return False
            Rinv = np.asarray(
                jax.scipy.linalg.solve_triangular(
                    R, jnp.eye(n, dtype=R.dtype), lower=False))
            self._tangent_cov = Rinv @ Rinv.T
        return True

    def _compute_sparse(self, covariance_blocks, prog) -> bool:
        """Requested-blocks-only covariance at scale: factor the undamped
        normal equations once (Schur-eliminated for BA structure; native
        LDL^T otherwise), then batched unit-vector back-solves for the
        union of requested SECOND blocks. Cov(a, b) = rows a of
        inverse(J'J) columns b; symmetry gives the block from either
        factor. Never materializes dense J or the full covariance."""
        import jax.scipy.linalg as jsl
        from .solvers.schur import SchurOps, detect_schur_structure

        x = prog.initial_state()
        n = prog.num_effective
        opts = self.options

        # distinct second blocks -> their tangent column ranges; pairs
        # touching a CONSTANT block get a zero block without a solve
        # (covariance_impl.cc:139-158,:412)
        b_blocks = {}
        var_pairs, zero_pairs = [], []
        for a, b in covariance_blocks:
            oa, ta, _ = self._tangent_slice(a)
            ob, tb, _ = self._tangent_slice(b)
            if oa is None or ob is None:
                zero_pairs.append((a, ta, b, tb))
                continue
            var_pairs.append((a, b))
            if id(b) not in b_blocks:
                b_blocks[id(b)] = (ob, tb)

        if not b_blocks:
            self._block_cov = {(id(a), id(b)): np.zeros((ta, tb))
                               for a, ta, b, tb in zero_pairs}
            return True
        cols = np.concatenate([np.arange(off, off + tb)
                               for off, tb in b_blocks.values()])
        col_of_block = {}
        pos = 0
        for key, (off, tb) in b_blocks.items():
            col_of_block[key] = (pos, tb)
            pos += tb

        meta = detect_schur_structure(prog, None)
        X = None
        if meta is not None:
            _, _, jac, _ = jax.jit(prog.linearize_fn)(x)
            D = jnp.zeros((n,), dtype=prog.dtype)
            ops = SchurOps(meta, jac, D)
            S = ops.explicit_S()
            c, lower = jsl.cho_factor(S)
            if bool(jnp.any(jnp.isnan(c))):
                self._message = ("Rank deficient normal equations in the "
                                 "Schur covariance path (gauge freedom?); "
                                 "hold a gauge or use DENSE_SVD.")
                return False
            # Rank policy (covariance.h:281-329 semantics): the Cholesky
            # diagonal squares to the pivots of S, so (min/max)^2 is a
            # cheap reciprocal-condition estimate of the reduced normal
            # equations. NEAR-singular S (gauge freedom damped only by
            # rounding) must fail like the dense path, not return
            # garbage covariances.
            cd = np.abs(np.asarray(jnp.diagonal(c)))
            rcn = float((cd.min() / cd.max()) ** 2) if cd.size else 0.0
            if rcn < opts.min_reciprocal_condition_number:
                self._message = (
                    f"Rank deficient normal equations: reciprocal "
                    f"condition number estimate {rcn:e} < "
                    f"{opts.min_reciprocal_condition_number:e} "
                    f"(Schur covariance path). Hold a gauge, or use "
                    f"DENSE_SVD with null_space_rank.")
                return False
            e_cols = meta.c("e_cols", meta.e_cols)
            f_global = meta.c("f_global", meta.f_global_cols)

            def solve_one(col):
                b_vec = jnp.zeros((n,), dtype=prog.dtype).at[col].set(1.0)
                b_e = b_vec[e_cols]
                b_f = b_vec[f_global]
                rhs = ops.rhs(b_e, b_f)
                y = jsl.cho_solve((c, lower), rhs)
                d_e = ops.back_substitute(b_e, y)
                out = jnp.zeros((n,), dtype=prog.dtype)
                out = out.at[f_global].set(y)
                out = out.at[e_cols].set(d_e)
                return out

            # pad to a full batch multiple (repeat the last column) so
            # every dispatch shares ONE compiled shape, then trim
            batch = min(256, len(cols))
            m = len(cols)
            m_pad = int(np.ceil(m / batch) * batch)
            cols_pad = np.concatenate([cols, np.repeat(cols[-1:],
                                                       m_pad - m)])
            parts = []
            cols_j = jnp.asarray(cols_pad)
            solve_batch = jax.jit(jax.vmap(solve_one))
            for s0 in range(0, m_pad, batch):
                parts.append(np.asarray(solve_batch(
                    cols_j[s0:s0 + batch])))
            X = np.concatenate(parts, axis=0)[:m]    # [m, n]
        else:
            from . import native as _native
            if not _native.available():
                self._message = ("No scalable covariance backend: no Schur "
                                 "structure and native library unavailable.")
                return False
            from .solvers.sparse_direct import SparseNormalCholeskyContext
            ctx = SparseNormalCholeskyContext(prog)
            _, _, jac, _ = jax.jit(prog.linearize_fn)(x)
            grams = [np.asarray(jnp.einsum("nrt,nru->ntu", b.J, b.J),
                                dtype=np.float64) for b in jac.buckets]
            status = ctx.host_factor(np.zeros(n), *grams)
            if int(status) != 0:
                self._message = ("Rank deficient normal equations in the "
                                 "sparse covariance path.")
                return False
            # Rank policy from the LDL^T inertia (covariance.h:281-329):
            # the normal equations are SPSD, so any negative pivot or a
            # tiny pivot ratio is numerical rank deficiency.
            dmin, dmax, nneg = ctx.chol.diag_stats()
            rcn = dmin / dmax if dmax > 0 else 0.0
            if nneg > 0 or rcn < opts.min_reciprocal_condition_number:
                self._message = (
                    f"Rank deficient normal equations: LDL^T inertia "
                    f"({nneg} negative pivots), reciprocal condition "
                    f"number estimate {rcn:e} < "
                    f"{opts.min_reciprocal_condition_number:e}. Use "
                    f"DENSE_SVD with null_space_rank.")
                return False
            X = np.zeros((len(cols), n))
            for i, colv in enumerate(cols):
                e = np.zeros(n)
                e[colv] = 1.0
                X[i] = ctx.host_apply(e)
        if not np.all(np.isfinite(X)):
            self._message = "Non-finite covariance back-solve."
            return False

        # extract requested pairs
        self._block_cov = {}
        for a, ta, b, tb in zero_pairs:
            self._block_cov[(id(a), id(b))] = np.zeros((ta, tb))
        for a, b in var_pairs:
            oa, ta, _ = self._tangent_slice(a)
            p0, tb = col_of_block[id(b)]
            Cab = X[p0:p0 + tb][:, oa:oa + ta].T     # [ta, tb]
            self._block_cov[(id(a), id(b))] = Cab
        return True

    def _tangent_slice(self, values):
        """(tangent offset, tangent size, block); offset is None for a
        CONSTANT block — its covariance is identically zero
        (covariance_impl.cc:139-158)."""
        prog = self._program
        key = id(values)
        if key not in prog.problem._blocks:
            raise KeyError("parameter block is not in the problem")
        blk = prog.problem._blocks[key]
        # as-if-variable tangent width (Block.tangent_size is 0 when the
        # block is constant; the zero covariance block keeps full shape)
        tsz = blk.manifold.tangent_size if blk.manifold else blk.size
        if key not in prog.tan_offset:
            return None, tsz, blk
        return prog.tan_offset[key], tsz, blk

    def get_covariance_block_in_tangent_space(self, a, b) -> np.ndarray:
        if self._block_cov is not None:
            C = self._block_cov.get((id(a), id(b)))
            if C is None:
                Ct = self._block_cov.get((id(b), id(a)))
                if Ct is None:
                    raise KeyError(
                        "block pair was not requested in compute() "
                        "(sparse covariance computes requested pairs only, "
                        "covariance.h GetCovarianceBlock contract)")
                C = Ct.T
            return C
        oa, ta, _ = self._tangent_slice(a)
        ob, tb, _ = self._tangent_slice(b)
        if oa is None or ob is None:
            # either block constant -> zero covariance
            # (covariance_impl.cc:139-158)
            return np.zeros((ta, tb))
        return self._tangent_cov[oa:oa + ta, ob:ob + tb]

    def get_covariance_matrix_in_tangent_space(self, blocks) -> np.ndarray:
        """Dense covariance of the given blocks, tangent space
        (covariance.h:458 GetCovarianceMatrixInTangentSpace). With the
        sparse path, every (i, j) pair over `blocks` must have been
        requested in compute()."""
        sizes = [self._tangent_slice(b)[1] for b in blocks]
        offs = np.concatenate([[0], np.cumsum(sizes)])
        out = np.zeros((offs[-1], offs[-1]))
        for i, a in enumerate(blocks):
            for j, b in enumerate(blocks):
                out[offs[i]:offs[i + 1], offs[j]:offs[j + 1]] = \
                    self.get_covariance_block_in_tangent_space(a, b)
        return out

    def get_covariance_matrix(self, blocks) -> np.ndarray:
        """Dense covariance of the given blocks, ambient space
        (covariance.h:441 GetCovarianceMatrix)."""
        sizes = [self._tangent_slice(b)[2].size for b in blocks]
        offs = np.concatenate([[0], np.cumsum(sizes)])
        out = np.zeros((offs[-1], offs[-1]))
        for i, a in enumerate(blocks):
            for j, b in enumerate(blocks):
                out[offs[i]:offs[i + 1], offs[j]:offs[j + 1]] = \
                    self.get_covariance_block(a, b)
        return out

    def get_covariance_block(self, a, b) -> np.ndarray:
        """Ambient-space block: J_plus(a) C J_plus(b)^T."""
        oa, ta, blk_a = self._tangent_slice(a)
        ob, tb, blk_b = self._tangent_slice(b)
        C = self.get_covariance_block_in_tangent_space(a, b)
        Ja = (np.asarray(blk_a.manifold.plus_jacobian(jnp.asarray(a)))
              if blk_a.manifold else np.eye(ta))
        Jb = (np.asarray(blk_b.manifold.plus_jacobian(jnp.asarray(b)))
              if blk_b.manifold else np.eye(tb))
        return Ja @ C @ Jb.T
