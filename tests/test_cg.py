"""Conjugate gradients (solvers/cg.py): the PCG loop against a direct
solve, its termination rules, the CGNR normal-equations operator, and the
fused ITERATIVE_SCHUR solve that runs it on the reduced camera system.
Reference semantics: conjugate_gradients_solver.h:109 (Q-based
forcing-sequence termination, indefiniteness guard, residual refresh)."""

import jax.numpy as jnp
import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.io.bal import synthetic_bal_problem, build_bal_ceres_problem
from ceres_tpu.solvers.cg import conjugate_gradients, solve_cgnr


def _spd(rng, m):
    A = rng.standard_normal((m, m))
    return A @ A.T + m * np.eye(m)


def _block_jacobi(S, tf):
    kf = S.shape[0] // tf
    blocks = np.stack([S[i * tf:(i + 1) * tf, i * tf:(i + 1) * tf]
                       for i in range(kf)])
    inv = jnp.asarray(np.linalg.inv(blocks))

    def prec(v):
        return jnp.sum(inv * v.reshape(kf, 1, tf), axis=-1).reshape(-1)

    return prec


@pytest.mark.parametrize("m,precond", [(144, "block_jacobi"),
                                       (144, "identity"),
                                       (64, "block_jacobi"),
                                       (296, "block_jacobi")])
def test_cg_matches_direct_solve(m, precond):
    rng = np.random.default_rng(3)
    S = _spd(rng, m)
    b = rng.standard_normal(m)
    Sj, bj = jnp.asarray(S), jnp.asarray(b)
    res = conjugate_gradients(
        lambda v: Sj @ v, bj, jnp.zeros_like(bj),
        apply_preconditioner=(_block_jacobi(S, 8)
                              if precond == "block_jacobi" else None),
        max_iterations=4 * m, r_tolerance=1e-12)
    ref = np.linalg.solve(S, b)
    np.testing.assert_allclose(np.asarray(res.x), ref, rtol=1e-8,
                               atol=1e-10)
    assert 0 < int(res.num_iterations) <= 4 * m


def test_cg_q_tolerance_stops_early():
    """The forcing-sequence rule ends the solve long before convergence;
    the partial solution still reduces the residual."""
    rng = np.random.default_rng(7)
    m = 128
    S = _spd(rng, m)
    b = rng.standard_normal(m)
    Sj, bj = jnp.asarray(S), jnp.asarray(b)
    loose = conjugate_gradients(lambda v: Sj @ v, bj, jnp.zeros_like(bj),
                                max_iterations=200, q_tolerance=0.1)
    tight = conjugate_gradients(lambda v: Sj @ v, bj, jnp.zeros_like(bj),
                                max_iterations=200, r_tolerance=1e-12)
    assert int(loose.num_iterations) < int(tight.num_iterations)
    assert float(loose.final_norm) < np.linalg.norm(b)


def test_cg_indefinite_guard():
    """p^T A p <= 0 stops the loop with a finite iterate."""
    A = jnp.asarray(np.diag([1.0, -1.0, 2.0]))
    b = jnp.asarray(np.array([0.0, 1.0, 0.0]))
    res = conjugate_gradients(lambda v: A @ v, b, jnp.zeros_like(b),
                              max_iterations=10)
    assert np.isfinite(np.asarray(res.x)).all()
    assert int(res.num_iterations) == 1


def test_cgnr_matches_dense_normal_equations(rng):
    """CGNR over the bucketed BlockJacobian solves (J^T J + D^2) d =
    -J^T r like a dense solve of the same normal equations."""
    import sys
    sys.path.insert(0, "tests")
    from test_linear_solvers import make_random_block_jacobian
    jac, res, _ = make_random_block_jacobian(rng)
    J = np.asarray(jac.to_dense())
    r = np.asarray(res.flatten())
    D = jnp.asarray(0.1 + rng.random(jac.num_cols))
    d, iters = solve_cgnr(jac, res, D, max_iterations=500, q_tolerance=0.0,
                          r_tolerance=1e-12)
    H = J.T @ J + np.diag(np.asarray(D) ** 2)
    ref = np.linalg.solve(H, -J.T @ r)
    np.testing.assert_allclose(np.asarray(d), ref, rtol=1e-7, atol=1e-9)


def test_fused_iterative_schur_mixed_matches_f64():
    """End to end: the fused ITERATIVE_SCHUR solve (explicit reduced
    system, XLA CG loop) in mixed precision against the f64 host loop."""

    def build():
        bal = synthetic_bal_problem(num_cameras=6, num_points=200,
                                    num_observations=800, seed=3,
                                    pixel_noise=0.5)
        bal.perturb(rotation_sigma=0.05, translation_sigma=0.3,
                    point_sigma=0.2, seed=5)
        return build_bal_ceres_problem(bal)[0]

    def opts(mixed):
        return ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
            use_mixed_precision_solves=mixed, fused_iterations=mixed,
            max_num_iterations=30, function_tolerance=1e-6)

    s_f64 = ct.solve(opts(False), build())
    s_mixed = ct.solve(opts(True), build())
    assert s_mixed.termination_type == ct.TerminationType.CONVERGENCE
    assert s_f64.termination_type == ct.TerminationType.CONVERGENCE
    np.testing.assert_allclose(s_mixed.final_cost, s_f64.final_cost,
                               rtol=1e-5)
