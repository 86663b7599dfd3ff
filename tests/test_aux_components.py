"""Covariance, GradientChecker, CubicInterpolator, TinySolver,
GradientProblemSolver (reference covariance_test.cc, gradient_checker_test,
cubic_interpolation_test, tiny_solver_test, gradient_problem_solver_test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ceres_tpu as ct


# ---------------- Covariance ----------------

def linear_gaussian_problem():
    """r_i = A_i x - b_i with known covariance inverse(J'J)."""
    rng = np.random.default_rng(5)
    x = np.zeros(3)
    problem = ct.Problem()
    As, bs = [], []

    class Lin:
        def __init__(self, A, b):
            self.A = A
            self.b = b

        def __call__(self, x):
            return self.A @ x - self.b

    for _ in range(10):
        A = rng.normal(size=(2, 3))
        b = rng.normal(size=2)
        As.append(A)
        bs.append(b)
        problem.add_residual_block(
            ct.AutoDiffCostFunction(Lin(A, b), 2, [3]), None, x)
    J = np.concatenate(As, axis=0)
    return problem, x, np.linalg.inv(J.T @ J)


@pytest.mark.parametrize("algorithm", [
    ct.CovarianceAlgorithmType.DENSE_SVD,
    ct.CovarianceAlgorithmType.SPARSE_QR])
def test_covariance_linear(algorithm):
    problem, x, expected = linear_gaussian_problem()
    cov = ct.Covariance(ct.CovarianceOptions(algorithm_type=algorithm))
    assert cov.compute([(x, x)], problem), cov.message
    got = cov.get_covariance_block(x, x)
    np.testing.assert_allclose(got, expected, rtol=1e-8)


def test_covariance_rank_deficient_policy():
    """Duplicate column -> rank deficiency: strict policy fails, SVD with
    null_space_rank succeeds (covariance.h:281-329)."""
    x = np.zeros(2)

    def f(v):
        return jnp.stack([v[0] + v[1], 2.0 * (v[0] + v[1])])

    problem = ct.Problem()
    problem.add_residual_block(ct.AutoDiffCostFunction(f, 2, [2]), None, x)
    cov = ct.Covariance(ct.CovarianceOptions(
        algorithm_type=ct.CovarianceAlgorithmType.DENSE_SVD))
    assert not cov.compute([(x, x)], problem)
    cov2 = ct.Covariance(ct.CovarianceOptions(
        algorithm_type=ct.CovarianceAlgorithmType.DENSE_SVD,
        null_space_rank=-1))
    assert cov2.compute([(x, x)], problem)
    got = cov2.get_covariance_block(x, x)
    assert np.all(np.isfinite(got))


def test_covariance_with_manifold_tangent_space():
    q = np.array([1.0, 0.0, 0.0, 0.0])

    def f(qq):
        from ceres_tpu import rotation as rot
        # two observed directions -> full-rank (3) tangent Jacobian
        r1 = rot.unit_quaternion_rotate_point(
            qq, jnp.asarray([1.0, 0.0, 0.0])) - jnp.asarray([0.0, 1.0, 0.0])
        r2 = rot.unit_quaternion_rotate_point(
            qq, jnp.asarray([0.0, 1.0, 0.0])) - jnp.asarray([0.0, 0.0, 1.0])
        return jnp.concatenate([r1, r2])

    problem = ct.Problem()
    problem.add_residual_block(ct.AutoDiffCostFunction(f, 6, [4]), None, q)
    problem.set_manifold(q, ct.QuaternionManifold())
    cov = ct.Covariance()
    assert cov.compute([(q, q)], problem), cov.message
    Ct = cov.get_covariance_block_in_tangent_space(q, q)
    assert Ct.shape == (3, 3)
    Ca = cov.get_covariance_block(q, q)
    assert Ca.shape == (4, 4)


# ---------------- GradientChecker ----------------

def test_gradient_checker_passes_on_correct_jacobian():
    class Good(ct.SizedCostFunction):
        def residuals(self, x):
            return jnp.stack([x[0] * x[1], x[0] + x[1]])

        def jacobians(self, x):
            return [jnp.asarray([[x[1], x[0]], [1.0, 1.0]])]

    checker = ct.GradientChecker(Good(2, [2]))
    res = checker.probe([np.array([1.5, -2.0])], 1e-8)
    assert res.return_value, res.error_log


def test_gradient_checker_catches_wrong_jacobian():
    class Bad(ct.SizedCostFunction):
        def residuals(self, x):
            return jnp.stack([x[0] * x[1], x[0] + x[1]])

        def jacobians(self, x):
            return [jnp.asarray([[x[1], x[0]], [1.0, 2.0]])]  # wrong 2.0

    checker = ct.GradientChecker(Bad(2, [2]))
    res = checker.probe([np.array([1.5, -2.0])], 1e-8)
    assert not res.return_value
    assert "disagrees" in res.error_log


def test_check_gradients_solve_mode():
    class Bad(ct.SizedCostFunction):
        def residuals(self, x):
            return x * 2.0

        def jacobians(self, x):
            return [jnp.asarray([[3.0]])]  # wrong

    x = np.array([1.0])
    problem = ct.Problem()
    problem.add_residual_block(Bad(1, [1]), None, x)
    summary = ct.solve(ct.SolverOptions(check_gradients=True), problem)
    assert summary.termination_type == ct.TerminationType.FAILURE
    assert "Gradient check failed" in summary.message


# ---------------- Cubic interpolation ----------------

def test_cubic_interpolator_reproduces_quadratics():
    """Catmull-Rom reproduces polynomials up to degree 2 on the interior
    (cubic_interpolation_test.cc checks constant/linear/quadratic)."""
    xs = np.arange(10.0)
    for coeffs in ([0.0, 0.0, 1.0], [-0.2, 0.3, 1.0], [0.4, 0.0, -2.0]):
        poly = np.polynomial.Polynomial(coeffs[::-1])
        interp = ct.CubicInterpolator(ct.Grid1D(poly(xs)))
        for x in np.linspace(1.0, 8.0, 23):
            np.testing.assert_allclose(float(interp.evaluate(x)), poly(x),
                                       rtol=1e-10, atol=1e-10)


def test_cubic_interpolator_differentiable():
    xs = np.arange(10.0)
    vals = np.sin(xs)
    interp = ct.CubicInterpolator(ct.Grid1D(vals))
    g = jax.grad(lambda x: interp.evaluate(x))(jnp.asarray(3.3))
    eps = 1e-6
    fd = (float(interp.evaluate(3.3 + eps))
          - float(interp.evaluate(3.3 - eps))) / (2 * eps)
    np.testing.assert_allclose(float(g), fd, atol=1e-6)


def test_bicubic_interpolator():
    r, c = np.meshgrid(np.arange(8.0), np.arange(9.0), indexing="ij")
    f = 2.0 * r - 3.0 * c + 0.5 * r * c  # bilinear: reproduced exactly
    interp = ct.BiCubicInterpolator(ct.Grid2D(f))
    for rr, cc in [(2.5, 3.5), (1.2, 6.7), (5.9, 2.1)]:
        np.testing.assert_allclose(
            float(interp.evaluate(rr, cc)),
            2.0 * rr - 3.0 * cc + 0.5 * rr * cc, rtol=1e-10)


def test_interpolator_in_cost_function():
    """sampled_function.cc pattern: interpolated data inside an AD cost."""
    xs = np.arange(10.0)
    vals = (xs - 4.5) ** 2
    interp = ct.CubicInterpolator(ct.Grid1D(vals))
    x = np.array([1.0])

    def f(xx):
        return interp.evaluate(xx[0])

    problem = ct.Problem()
    problem.add_residual_block(ct.AutoDiffCostFunction(f, 1, [1]), None, x)
    # cost = 0.5 interp(x)^2 ~ 0.5 (x-4.5)^4: quartic basin, so gradient
    # tolerance triggers while still ~1e-3 away; that matches the reference
    # sampled_function behavior.
    summary = ct.solve(ct.SolverOptions(max_num_iterations=200), problem)
    np.testing.assert_allclose(x[0], 4.5, atol=1e-2)


# ---------------- TinySolver ----------------

def test_tiny_solver_rosenbrock_ls():
    def f(x):
        return jnp.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])

    result = ct.tiny_solve(f, jnp.asarray([-1.2, 1.0]),
                           ct.TinySolverOptions(max_num_iterations=200))
    np.testing.assert_allclose(np.asarray(result.x), [1.0, 1.0], atol=1e-6)
    assert float(result.final_cost) < 1e-12


def test_tiny_solver_vmapped_batch():
    """The accelerator win: solve thousands of tiny problems in one batched call."""
    targets = jnp.asarray(np.random.default_rng(0).normal(size=(64, 2)))

    def solve_one(t):
        f = lambda x: x - t
        return ct.tiny_solve(f, jnp.zeros(2)).x

    xs = jax.vmap(solve_one)(targets)
    np.testing.assert_allclose(np.asarray(xs), np.asarray(targets),
                               atol=1e-10)


# ---------------- GradientProblemSolver ----------------

def test_gradient_problem_rosenbrock():
    """rosenbrock.cc: LBFGS on the scalar Rosenbrock function."""

    class Rosenbrock(ct.FirstOrderFunction):
        def cost(self, x):
            return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2

    params = np.array([-1.2, 1.0])
    gp = ct.GradientProblem(Rosenbrock(2))
    summary = ct.solve_gradient_problem(
        ct.SolverOptions(minimizer_type=ct.MinimizerType.LINE_SEARCH,
                         max_num_iterations=200), gp, params)
    assert summary.is_solution_usable(), summary.message
    np.testing.assert_allclose(params, [1.0, 1.0], atol=1e-5)


@pytest.mark.parametrize("direction", [
    ct.LineSearchDirectionType.STEEPEST_DESCENT,
    ct.LineSearchDirectionType.NONLINEAR_CONJUGATE_GRADIENT,
    ct.LineSearchDirectionType.BFGS,
    ct.LineSearchDirectionType.LBFGS])
def test_line_search_directions_on_quadratic(direction):
    class Quad(ct.FirstOrderFunction):
        def cost(self, x):
            return jnp.sum((x - jnp.asarray([1.0, -2.0, 3.0])) ** 2
                           * jnp.asarray([1.0, 10.0, 100.0]))

    params = np.zeros(3)
    gp = ct.GradientProblem(Quad(3))
    opts = ct.SolverOptions(
        minimizer_type=ct.MinimizerType.LINE_SEARCH,
        line_search_direction_type=direction,
        max_num_iterations=500, function_tolerance=1e-14,
        gradient_tolerance=1e-12)
    summary = ct.solve_gradient_problem(opts, gp, params)
    np.testing.assert_allclose(params, [1.0, -2.0, 3.0], atol=1e-4)


def test_covariance_null_space_rank_policy_details():
    """covariance_impl.cc:744-767: null_space_rank k >= 0 drops the k
    smallest singular values unconditionally, but Compute FAILS if a
    KEPT value still violates min_reciprocal_condition_number; k beyond
    the spectrum size drops everything (max_rank clamps at 0)."""
    x = np.zeros(2)

    def f(v):
        # rank-1: singular values (s, 0)
        return jnp.stack([v[0] + v[1], 2.0 * (v[0] + v[1])])

    def build():
        problem = ct.Problem()
        problem.add_residual_block(
            ct.AutoDiffCostFunction(f, 2, [2]), None, x)
        return problem

    # k=1 removes exactly the null direction -> pseudo-inverse succeeds
    cov = ct.Covariance(ct.CovarianceOptions(
        algorithm_type=ct.CovarianceAlgorithmType.DENSE_SVD,
        null_space_rank=1))
    assert cov.compute([(x, x)], build()), cov.message
    C1 = cov.get_covariance_block(x, x)
    assert np.all(np.isfinite(C1))

    # rank-1 with THREE columns: k=1 keeps a below-threshold value ->
    # the reference policy fails Compute
    y = np.zeros(3)

    def g(v):
        # 4x3 rank-1 J: singular values (s, ~0, ~0) — k=1 still keeps a
        # below-threshold value
        s = v[0] + v[1] + v[2]
        return jnp.stack([s, 2.0 * s, 3.0 * s, 4.0 * s])

    problem = ct.Problem()
    problem.add_residual_block(ct.AutoDiffCostFunction(g, 4, [3]), None, y)
    cov2 = ct.Covariance(ct.CovarianceOptions(
        algorithm_type=ct.CovarianceAlgorithmType.DENSE_SVD,
        null_space_rank=1))
    assert not cov2.compute([(y, y)], problem)
    assert "Rank deficient" in cov2.message

    # k > num singular values -> everything dropped -> zero covariance
    cov3 = ct.Covariance(ct.CovarianceOptions(
        algorithm_type=ct.CovarianceAlgorithmType.DENSE_SVD,
        null_space_rank=99))
    assert cov3.compute([(x, x)], build()), cov3.message
    np.testing.assert_allclose(cov3.get_covariance_block(x, x), 0.0)


def test_covariance_constant_block_is_zero():
    """covariance_impl.cc:139-158: pairs touching a CONSTANT parameter
    block yield a zero covariance block and Compute succeeds."""
    problem, x, expected = linear_gaussian_problem()
    z = np.array([1.0, 2.0])

    def h(a, b):
        return jnp.stack([a[0] - b[0], a[1] - b[1] + b[2]])

    problem.add_residual_block(
        ct.AutoDiffCostFunction(h, 2, [2, 3]), None, z, x)
    problem.set_parameter_block_constant(z)

    cov = ct.Covariance(ct.CovarianceOptions(
        algorithm_type=ct.CovarianceAlgorithmType.DENSE_SVD))
    assert cov.compute([(x, x), (z, x), (z, z)], problem), cov.message
    np.testing.assert_allclose(cov.get_covariance_block(z, x), 0.0)
    np.testing.assert_allclose(cov.get_covariance_block(z, z), 0.0)
    assert cov.get_covariance_block(z, z).shape == (2, 2)
    assert np.all(np.isfinite(cov.get_covariance_block(x, x)))


def test_grid_declared_end_clamps_reads():
    """cubic_interpolation.h Grid1D/Grid2D clamp indices to the DECLARED
    [begin, end) range, which may be tighter than the backing array."""
    from ceres_tpu.interpolation import (Grid1D, CubicInterpolator,
                                         Grid2D, BiCubicInterpolator)
    g = Grid1D(np.arange(10.0), begin=0, end=5)
    assert float(np.asarray(g(7)).squeeze()) == 4.0    # clamped to end-1
    ci = CubicInterpolator(g)
    v = float(np.asarray(ci.evaluate(3.5)))
    assert v <= 4.0 + 1e-9, v                          # never reads data[5:]

    data2 = np.arange(36.0).reshape(6, 6)
    g2 = Grid2D(data2, row_begin=0, row_end=3, col_begin=0, col_end=3)
    assert float(np.asarray(g2(5, 5)).squeeze()) == data2[2, 2]
    bi = BiCubicInterpolator(g2)
    assert np.isfinite(float(np.asarray(bi.evaluate(2.0, 2.0))))


def test_subset_evaluate_cached_across_calls():
    """evaluate_residual_block in a loop must reuse the compiled subset
    program (problem_impl.cc Evaluate is microseconds per call)."""
    problem, x, _ = linear_gaussian_problem()
    rbs = problem.residual_blocks()
    c1 = problem.evaluate(residual_blocks=[rbs[0]])[0]
    c2 = problem.evaluate(residual_blocks=[rbs[0]])[0]
    assert c1 == c2
    assert len(problem._subset_eval_cache) == 1
    problem.evaluate(residual_blocks=[rbs[1]])
    assert len(problem._subset_eval_cache) == 2
