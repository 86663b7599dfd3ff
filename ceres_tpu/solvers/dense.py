"""Dense linear solvers: DENSE_QR and DENSE_NORMAL_CHOLESKY.

Capability parity with the reference's DenseQRSolver
(internal/ceres/dense_qr_solver.cc, dense_qr.cc) and
DenseNormalCholeskySolver (dense_normal_cholesky_solver.cc,
dense_cholesky.cc). The Eigen/LAPACK/cuSOLVER backends collapse into
jnp.linalg / jax.scipy.linalg, which XLA lowers to the device's
factorization libraries (cuSOLVER on the GPU).

Both solve the damped least-squares step
    min_d ||J d + r||^2 + ||diag(D) d||^2
(the (J; D) augmented system of levenberg_marquardt_strategy.cc:68).
"""

from __future__ import annotations

import jax.numpy as jnp
import jax.scipy.linalg as jsl

from ..ops.bsr import BlockJacobian, RVec


def solve_dense_qr(jac: BlockJacobian, res: RVec, D):
    """QR on the augmented matrix [J; diag(D)] (dense_qr.cc EigenDenseQR)."""
    J = jac.to_dense()
    m, n = J.shape
    A = jnp.concatenate([J, jnp.diag(D)], axis=0)
    b = jnp.concatenate([-res.flatten(), jnp.zeros((n,), dtype=J.dtype)])
    Q, R = jnp.linalg.qr(A)
    d = jsl.solve_triangular(R, Q.T @ b, lower=False)
    return d, jnp.asarray(1, dtype=jnp.int32)


def solve_dense_normal_cholesky(jac: BlockJacobian, res: RVec, D,
                                mixed_precision: bool = False,
                                refinement_iterations: int = 0):
    """Cholesky of J^T J + D^T D (dense_normal_cholesky_solver.cc).

    mixed_precision + iterative refinement mirrors the reference's
    RefinedDenseCholesky / CUDADenseCholeskyMixedPrecision
    (dense_cholesky.h:174,:246): factorize in f32, refine the f64 solution.
    """
    H = jac.jtj_dense() + jnp.diag(D * D)
    g = -jac.rmatvec(res)
    if not mixed_precision:
        c, lower = jsl.cho_factor(H)
        d = jsl.cho_solve((c, lower), g)
        return d, jnp.asarray(1, dtype=jnp.int32)
    # f32 factorization, f64 refinement (iterative_refiner.cc).
    H32 = H.astype(jnp.float32)
    c, lower = jsl.cho_factor(H32)

    def refine(d):
        resid = g - H @ d
        corr = jsl.cho_solve((c, lower), resid.astype(jnp.float32))
        return d + corr.astype(H.dtype)

    d = jsl.cho_solve((c, lower), g.astype(jnp.float32)).astype(H.dtype)
    for _ in range(max(1, refinement_iterations)):
        d = refine(d)
    return d, jnp.asarray(1, dtype=jnp.int32)
