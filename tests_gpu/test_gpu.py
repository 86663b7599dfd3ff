"""Device checks of the solve paths on an NVIDIA GPU: fused BAL solve,
batched solves, the implicit fused ITERATIVE_SCHUR, SPARSE_SCHUR with its
host factorization, and the fused line-search loop. Each compares with a
reference solve or a known answer."""

import os

import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.io.bal import build_bal_ceres_problem, synthetic_bal_problem

pytestmark = pytest.mark.gpu


def test_bal_step_and_solve():
    """Mixed-precision fused DENSE_SCHUR solve on a mid-size BAL."""
    bal = synthetic_bal_problem(num_cameras=8, num_points=2000,
                                num_observations=8000, seed=5,
                                pixel_noise=1.0)
    bal.perturb(rotation_sigma=0.05, translation_sigma=0.5,
                point_sigma=0.2, seed=6)
    problem, _, _ = build_bal_ceres_problem(bal)
    s = ct.solve(ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
        use_mixed_precision_solves=True,
        max_num_iterations=30, function_tolerance=1e-6), problem)
    assert s.termination_type == ct.TerminationType.CONVERGENCE
    assert s.final_cost < s.initial_cost


def test_batched_solves_on_device():
    """ct.solve_batched (batch.py): a multi-start batch of BA solves as
    one vmapped fused program on the chip, each element matching its
    individual solve."""
    options = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
        use_mixed_precision_solves=True,
        max_num_iterations=30, function_tolerance=1e-6,
        fused_iterations=True)

    def build(perturb_seed):
        bal = synthetic_bal_problem(num_cameras=4, num_points=300,
                                    num_observations=1200, seed=11,
                                    pixel_noise=0.5)
        bal.perturb(rotation_sigma=0.05, translation_sigma=0.2,
                    point_sigma=0.1, seed=perturb_seed)
        return build_bal_ceres_problem(bal)[0]

    seeds = [1, 2, 3, 4]
    refs = [ct.solve(options, build(s)) for s in seeds]
    summaries = ct.solve_batched(options, [build(s) for s in seeds])
    for s_ref, s_b in zip(refs, summaries):
        assert s_b.termination_type == ct.TerminationType.CONVERGENCE
        np.testing.assert_allclose(s_b.final_cost, s_ref.final_cost,
                                   rtol=1e-6)


def test_implicit_fused_iterative_schur_on_device():
    """The one-hot-free implicit fused ITERATIVE_SCHUR mode (camera-chunk
    reductions) on hardware, forced at small size."""
    bal = synthetic_bal_problem(num_cameras=8, num_points=1000,
                                num_observations=4000, seed=3,
                                pixel_noise=1.0)
    bal.perturb(rotation_sigma=0.05, translation_sigma=0.3,
                point_sigma=0.1, seed=4)
    problem, _, _ = build_bal_ceres_problem(bal)
    ref_problem, _, _ = build_bal_ceres_problem(bal)
    s_ref = ct.solve(ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
        max_num_iterations=40, function_tolerance=1e-9), ref_problem)
    os.environ["CERES_TPU_FORCE_IMPLICIT"] = "1"
    try:
        opts_impl = ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
            use_mixed_precision_solves=True,
            max_num_iterations=40, function_tolerance=1e-9,
            fused_iterations=True)
        s = ct.solve(opts_impl, problem)
    finally:
        del os.environ["CERES_TPU_FORCE_IMPLICIT"]
    assert s.termination_type == ct.TerminationType.CONVERGENCE
    rel = abs(s.final_cost - s_ref.final_cost) / s_ref.final_cost
    assert rel < 1e-5, rel


def test_sparse_schur_on_device(monkeypatch):
    """Block-sparse SPARSE_SCHUR (schur_sparse.py): device pair-block
    assembly + host LDL^T round-trip per iteration, forced at small size,
    must reach the dense-S final cost on hardware."""
    def build():
        bal = synthetic_bal_problem(num_cameras=8, num_points=1000,
                                    num_observations=4000, seed=9,
                                    pixel_noise=1.0)
        bal.perturb(rotation_sigma=0.05, translation_sigma=0.3,
                    point_sigma=0.1, seed=10)
        return build_bal_ceres_problem(bal)[0]

    opts = dict(max_num_iterations=40, function_tolerance=1e-9,
                use_mixed_precision_solves=False)
    s_ref = ct.solve(ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR, **opts),
        build())
    monkeypatch.setenv("CERES_TPU_FORCE_SPARSE_SCHUR", "1")
    s = ct.solve(ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.SPARSE_SCHUR, **opts),
        build())
    assert s.termination_type == ct.TerminationType.CONVERGENCE
    rel = abs(s.final_cost - s_ref.final_cost) / s_ref.final_cost
    assert rel < 1e-8, rel


def test_fused_line_search_on_device():
    """Whole L-BFGS + Wolfe loop as one device dispatch
    (minimizers/line_search_fused.py)."""
    params = np.array([-1.2, 1.0])

    class Rosen(ct.FirstOrderFunction):
        def cost(self, x):
            return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2

    s = ct.solve_gradient_problem(
        ct.SolverOptions(minimizer_type=ct.MinimizerType.LINE_SEARCH,
                         max_num_iterations=200, fused_iterations=True),
        ct.GradientProblem(Rosen(2)), params)
    assert s.is_solution_usable(), s.message
    np.testing.assert_allclose(params, [1.0, 1.0], atol=1e-5)
