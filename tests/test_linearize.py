"""Linearization (program.py): the vmap(jacfwd) tangent-space Jacobian of
every functor family the library ships against f64 central differences of
residual(Plus(x, delta)), plus the f32 (mixed-precision) pass against f64
and end-to-end mixed solves of the non-BA functors.

Reference role: the Jet autodiff of include/ceres/internal/autodiff.h:307
chained with the manifold PlusJacobian (residual_block.cc:134-157).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.cost import AutoDiffCostFunction, DynamicAutoDiffCostFunction
from ceres_tpu.program import CompiledProgram


# ------------------------------------------------------------ problem zoo

def _circle():
    from ceres_tpu.examples.circle_fit import (DistanceFromCircleCost,
                                               synthesize)
    x, y, m = np.array([0.1]), np.array([-0.2]), np.array([1.0])
    problem = ct.Problem()
    for xx, yy in synthesize(num_points=30):
        problem.add_residual_block(
            AutoDiffCostFunction(DistanceFromCircleCost(float(xx),
                                                        float(yy)),
                                 1, [1, 1, 1]), None, x, y, m)
    return problem


def _snavely():
    from ceres_tpu.io.bal import (build_bal_ceres_problem,
                                  synthetic_bal_problem)
    bal = synthetic_bal_problem(3, 40, 120, seed=0, pixel_noise=0.5)
    return build_bal_ceres_problem(bal)[0]


def _pose3d():
    from ceres_tpu.examples.slam import build_pose_graph_3d_problem
    from ceres_tpu.io.g2o import synthetic_pose_graph_3d
    poses, constraints, _ = synthetic_pose_graph_3d(num_poses=12, seed=4,
                                                    loop_every=5)
    return build_pose_graph_3d_problem(poses, constraints)[0]


def _pose2d():
    from ceres_tpu.examples.slam import build_pose_graph_2d_problem
    from ceres_tpu.io.g2o import synthetic_pose_graph_2d
    poses, constraints, _ = synthetic_pose_graph_2d(num_poses=20, seed=6)
    return build_pose_graph_2d_problem(poses, constraints)[0]


class _FoEPatch:
    """FoE-class linear filter over a 25-slot patch (fields_of_experts.h
    shape, autodiff variant): the many-slot case."""

    def __init__(self, coef):
        self.coef = np.asarray(coef)

    def __call__(self, *pixels):
        patch = jnp.stack([p[0] for p in pixels])
        return jnp.dot(self.coef, patch)[None]


def _foe_patch():
    rng = np.random.default_rng(1)
    pix = [np.array([float(i) * 0.3]) for i in range(25)]
    coef = rng.standard_normal(25)
    problem = ct.Problem()
    for k in range(10):
        problem.add_residual_block(
            AutoDiffCostFunction(_FoEPatch(coef * (1 + 0.01 * k)),
                                 1, [1] * 25), None, *pix)
    return problem


def _dynamic():
    from ceres_tpu.examples.robot_pose_mle import RangeConstraint
    blocks = [np.array([0.5 + 0.01 * i]) for i in range(3)]
    problem = ct.Problem()
    for k in range(12):
        cost = DynamicAutoDiffCostFunction(
            RangeConstraint(10.0 + 0.1 * k, 0.01, 30.0))
        for _ in range(3):
            cost.add_parameter_block(1)
        cost.set_num_residuals(1)
        problem.add_residual_block(cost, None, *blocks)
    return problem


class _WeightedPinhole:
    """A non-Snavely reprojection functor: 6-parameter camera (angle-axis
    + translation), 3-parameter point, per-functor weight."""

    def __init__(self, ox, oy, w):
        self.ox, self.oy, self.w = float(ox), float(oy), float(w)

    def __call__(self, cam, pt):
        from ceres_tpu.rotation import angle_axis_rotate_point
        p = angle_axis_rotate_point(cam[0:3], pt) + cam[3:6]
        return jnp.stack([self.w * (-p[0] / p[2] - self.ox),
                          self.w * (-p[1] / p[2] - self.oy)])


def _pinhole(seed=0, npts=20):
    """Observations projected from ground truth, parameters perturbed, so
    the solve converges back to ~zero cost."""
    from ceres_tpu.rotation import angle_axis_rotate_point
    rng = np.random.default_rng(seed)
    ncam = 5
    cams_true = [np.concatenate([0.05 * rng.standard_normal(3),
                                 [0.1 * c, -0.1, 4.0]])
                 for c in range(ncam)]
    pts_true = [0.5 * rng.standard_normal(3) for _ in range(npts)]

    def project(cam, pt):
        p = np.asarray(angle_axis_rotate_point(
            jnp.asarray(cam[0:3]), jnp.asarray(pt))) + cam[3:6]
        return -p[0] / p[2], -p[1] / p[2]

    cams = [c + 0.01 * rng.standard_normal(6) for c in cams_true]
    pts = [p + 0.02 * rng.standard_normal(3) for p in pts_true]
    problem = ct.Problem()
    for j in range(npts):
        for c in rng.choice(ncam, size=3, replace=False):
            ox, oy = project(cams_true[c], pts_true[j])
            problem.add_residual_block(
                AutoDiffCostFunction(
                    _WeightedPinhole(ox, oy, 1.0 + 0.1 * (c % 3)),
                    2, [6, 3]),
                None, cams[c], pts[j])
    return problem


class _Sorty:
    """Data-dependent selection (sort)."""

    def __call__(self, p):
        return jnp.sort(p * p)[:1] - 0.5


def _sorty():
    p = np.array([1.0, 2.0])
    problem = ct.Problem()
    for _ in range(4):
        problem.add_residual_block(
            AutoDiffCostFunction(_Sorty(), 1, [2]), None, p)
    return problem


class _TracedIndex:
    """A table lookup whose index depends on the parameter value."""

    def __call__(self, p):
        idx = jnp.clip(jnp.floor(p[0]).astype(jnp.int32), 0, 1)
        tbl = jnp.stack([p[0] * 2.0, p[1] * 3.0 * p[1]])
        return tbl[idx][None] - 1.0


def _traced_index():
    p = np.array([0.3, 0.7])
    problem = ct.Problem()
    for _ in range(4):
        problem.add_residual_block(
            AutoDiffCostFunction(_TracedIndex(), 1, [2]), None, p)
    return problem


def _exponential():
    from ceres_tpu.examples.tutorial import ExponentialResidual
    m, c = np.array([0.1]), np.array([0.05])
    problem = ct.Problem()
    for x in np.linspace(0.0, 5.0, 25):
        problem.add_residual_block(
            AutoDiffCostFunction(
                ExponentialResidual(float(x), float(np.exp(0.3 * x + 0.1))),
                1, [1, 1]), None, m, c)
    return problem


PROBLEMS = {
    "circle_fit": _circle, "snavely": _snavely, "pose3d": _pose3d,
    "pose2d": _pose2d, "foe_patch": _foe_patch, "dynamic": _dynamic,
    "pinhole": _pinhole, "sort": _sorty, "traced_index": _traced_index,
    "exponential": _exponential,
}


def _perturbed_state(program, scale=0.02, seed=0):
    x0 = np.asarray(program.initial_state(), dtype=np.float64)
    rng = np.random.default_rng(seed)
    return jnp.asarray(x0 + scale * rng.standard_normal(x0.shape))


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_jacfwd_linearize_matches_central_differences(name):
    """Tangent-space J from vmap(jacfwd) equals the central difference
    of residual(Plus(x, delta)) in each tangent direction (f64, step
    1e-6: truncation and rounding both stay below 1e-8 of max |J|)."""
    program = CompiledProgram(PROBLEMS[name]())
    x = _perturbed_state(program)
    _, _, jac, _ = jax.jit(program.linearize_fn)(x)
    J = np.asarray(jac.to_dense())

    h = 1e-6

    def col(e):
        def r(d):
            return program.residuals_fn(program.plus(x, d)).flatten()
        return (r(h * e) - r(-h * e)) / (2 * h)

    eye = jnp.eye(program.num_effective, dtype=x.dtype)
    J_fd = np.asarray(jax.jit(jax.vmap(col, out_axes=1))(eye))
    assert J.shape == J_fd.shape
    scale = max(float(np.max(np.abs(J_fd))), 1.0)
    err = float(np.max(np.abs(J - J_fd))) / scale
    assert err < 1e-6, (name, err)


@pytest.mark.parametrize("name", ["snavely", "pose3d"])
def test_mixed_linearize_f32_matches_f64(name):
    """The mixed-precision Jacobian pass (functor evaluated in f32) against
    the f64 pass, bucket by bucket."""
    program = CompiledProgram(PROBLEMS[name]())
    x = _perturbed_state(program)
    for bk in program.buckets:
        _, J64 = program._bucket_linearize(bk, x)
        _, J32 = program._bucket_linearize(bk, x, cast_dtype=jnp.float32)
        assert J32.dtype == jnp.float32
        scale = max(float(jnp.max(jnp.abs(J64))), 1.0)
        err = float(jnp.max(jnp.abs(J32.astype(J64.dtype) - J64))) / scale
        assert err < 1e-5, (name, err)


def test_custom_jvp_rule_honored():
    """A functor with a user JVP rule (custom_jvp) is differentiated
    through that rule: at p = 0 the regularized derivative is finite."""

    @jax.custom_jvp
    def safe_sqrt(x):
        return jnp.sqrt(x)

    @safe_sqrt.defjvp
    def safe_sqrt_jvp(primals, tangents):
        (x,), (t,) = primals, tangents
        return jnp.sqrt(x), t * 0.5 / jnp.sqrt(x + 1e-6)

    class CustomCost:
        def __call__(self, p):
            return safe_sqrt(p * p) - 2.0

    p = np.array([0.5, 1.5])
    problem = ct.Problem()
    for _ in range(4):
        problem.add_residual_block(
            AutoDiffCostFunction(CustomCost(), 2, [2]), None, p)
    program = CompiledProgram(problem)
    x0 = jnp.zeros_like(program.initial_state())
    _, J = program._bucket_linearize(program.buckets[0], x0,
                                     cast_dtype=jnp.float32)
    assert np.isfinite(np.asarray(J)).all()


def test_custom_functor_ba_fused_mixed_matches_f64():
    """A non-Snavely two-slot BA functor through the fused DENSE_SCHUR
    loop in mixed precision and through the f64 host loop: both converge
    back to ~zero cost."""
    def opts(mixed):
        return ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
            use_mixed_precision_solves=mixed, fused_iterations=mixed,
            max_num_iterations=30, function_tolerance=1e-8)

    s_mixed = ct.solve(opts(True), _pinhole(npts=60))
    s_f64 = ct.solve(opts(False), _pinhole(npts=60))
    for s in (s_mixed, s_f64):
        assert s.termination_type == ct.TerminationType.CONVERGENCE
        assert s.final_cost <= 1e-10, s.final_cost


def test_pose3d_mixed_cgnr_solve_matches_f64():
    """SE3 pose graph, CGNR: mixed-precision solve vs the f64 solve."""
    from ceres_tpu.examples.slam import build_pose_graph_3d_problem
    from ceres_tpu.io.g2o import synthetic_pose_graph_3d
    poses, constraints, _ = synthetic_pose_graph_3d(num_poses=25, seed=4,
                                                    loop_every=5)

    def solve(mixed):
        problem, _, _ = build_pose_graph_3d_problem(poses, constraints)
        return ct.solve(ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.CGNR,
            use_mixed_precision_solves=mixed, max_num_iterations=30),
            problem)

    s_mixed, s_f64 = solve(True), solve(False)
    assert s_mixed.is_solution_usable()
    assert abs(s_mixed.final_cost - s_f64.final_cost) <= \
        1e-4 * max(1.0, s_f64.final_cost), \
        (s_mixed.final_cost, s_f64.final_cost)
