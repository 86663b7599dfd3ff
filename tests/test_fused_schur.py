"""Fused Schur elimination step (solvers/schur_fused.py): equivalence with
the generic SchurOps path and the f64 reference, the dense reduced solve,
and the sharded fused whole-solve (parallel/sharded_fused.py).

Reference parity anchors: schur_eliminator_impl.h (elimination),
schur_complement_solver.cc:181 (dense reduced solve),
iterative_schur_complement_solver.cc:63 (PCG on S).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu import solver as solver_mod
from ceres_tpu.io.bal import build_bal_ceres_problem, synthetic_bal_problem
from ceres_tpu.program import CompiledProgram


def small_bal():
    bal = synthetic_bal_problem(num_cameras=6, num_points=300,
                                num_observations=1500, seed=3,
                                pixel_noise=1.0)
    bal.perturb(rotation_sigma=0.02, translation_sigma=0.1,
                point_sigma=0.05, seed=4)
    return bal


@pytest.fixture(scope="module")
def bal():
    return small_bal()


@pytest.mark.parametrize("solver_name", ["DENSE_SCHUR", "ITERATIVE_SCHUR"])
def test_fused_step_matches_generic_f64(bal, solver_name):
    problem, _, _ = build_bal_ceres_problem(bal)
    options = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType[solver_name],
        preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI)
    program = CompiledProgram.get_cached(problem, options)
    x0 = program.initial_state()
    radius = jnp.asarray(1e4, program.dtype)
    ex = (program.example_x(), program.example_scalar(),
          program.example_delta())
    scale = solver_mod.make_scale_fn(program, options)(x0)

    step_new = program.jit_with_consts(
        solver_mod.make_step_impl(program, options), ex)
    a = step_new(x0, radius, scale)
    os.environ["CERES_TPU_NO_FUSED_SCHUR"] = "1"
    try:
        step_old = program.jit_with_consts(
            solver_mod.make_step_impl(program, options), ex)
        b = step_old(x0, radius, scale)
    finally:
        del os.environ["CERES_TPU_NO_FUSED_SCHUR"]

    for k in ["cost", "gradient_max_norm", "delta", "model_cost_change",
              "step_norm"]:
        va, vb = np.asarray(a[k]), np.asarray(b[k])
        rel = np.max(np.abs(va - vb)) / (np.max(np.abs(vb)) + 1e-300)
        assert rel < 1e-9, (k, rel)


def test_fused_solve_mixed_matches_f64_cost(bal):
    problem, _, _ = build_bal_ceres_problem(bal)
    base = dict(linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
                max_num_iterations=50, function_tolerance=1e-9)
    s64 = ct.solve(ct.SolverOptions(**base), problem)
    problem2, _, _ = build_bal_ceres_problem(bal)
    s32 = ct.solve(ct.SolverOptions(use_mixed_precision_solves=True,
                                    **base), problem2)
    assert s64.termination_type == ct.TerminationType.CONVERGENCE
    assert s32.termination_type == ct.TerminationType.CONVERGENCE
    assert abs(s32.final_cost - s64.final_cost) / s64.final_cost < 1e-5


@pytest.mark.parametrize("m", [3, 24, 144])
def test_spd_solve_dense_matches_numpy(m):
    """The reduced-system solve (dense Cholesky) at f32 against an f64
    solve of the same system."""
    from ceres_tpu.solvers.schur_fused import _spd_solve_dense
    rng = np.random.default_rng(0)
    A = rng.standard_normal((m, m + 4)).astype(np.float32)
    S = A @ A.T + m * np.eye(m, dtype=np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    y = np.asarray(_spd_solve_dense(jnp.asarray(S), jnp.asarray(b)))
    ref = np.linalg.solve(S.astype(np.float64), b)
    rel = np.max(np.abs(y - ref)) / np.max(np.abs(ref))
    assert rel < 1e-4, (m, rel)


def test_spd_solve_dense_indefinite_gives_nan():
    """An indefinite S yields NaN, which the LM loop treats as an invalid
    step and retries with more damping."""
    from ceres_tpu.solvers.schur_fused import _spd_solve_dense
    S = jnp.asarray(np.diag([1.0, -1.0, 2.0]).astype(np.float32))
    b = jnp.asarray(np.ones(3, dtype=np.float32))
    y = np.asarray(_spd_solve_dense(S, b))
    assert np.isnan(y).any()


@pytest.mark.parametrize("solver_name,mixed", [
    ("DENSE_SCHUR", False),
    ("DENSE_SCHUR", True),
    ("ITERATIVE_SCHUR", False),
])
def test_sharded_fused_solve_matches_single_device(bal, solver_name,
                                                   mixed):
    from jax.sharding import Mesh
    problem, _, _ = build_bal_ceres_problem(bal)
    base = dict(linear_solver_type=ct.LinearSolverType[solver_name],
                preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
                max_num_iterations=50, function_tolerance=1e-9)
    s1 = ct.solve(ct.SolverOptions(**base), problem)

    problem2, _, _ = build_bal_ceres_problem(bal)
    ndev = min(8, len(jax.devices()))
    mesh = Mesh(np.array(jax.devices()[:ndev]), axis_names=("data",))
    s2 = ct.solve(ct.SolverOptions(mesh=mesh,
                                   use_mixed_precision_solves=mixed,
                                   **base), problem2)
    assert "sharded fused" in s2.message
    assert s2.termination_type == ct.TerminationType.CONVERGENCE
    rel = abs(s2.final_cost - s1.final_cost) / s1.final_cost
    assert rel < (1e-5 if mixed else 1e-6), rel


@pytest.mark.parametrize("mixed", [False, True])
def test_sharded_fused_implicit_matches_single_device(bal, mixed):
    """Matrix-free sharded ITERATIVE_SCHUR (the production large-camera
    multi-chip configuration): A is never materialized, the CG operator
    walks the shard-local chunk tensors with one psum per application.
    Forced at small size, compared against the single-device solve."""
    from jax.sharding import Mesh
    problem, _, _ = build_bal_ceres_problem(bal)
    base = dict(linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
                preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
                max_num_iterations=50, function_tolerance=1e-9)
    s1 = ct.solve(ct.SolverOptions(**base), problem)

    problem2, _, _ = build_bal_ceres_problem(bal)
    ndev = min(8, len(jax.devices()))
    mesh = Mesh(np.array(jax.devices()[:ndev]), axis_names=("data",))
    os.environ["CERES_TPU_FORCE_IMPLICIT"] = "1"
    try:
        s2 = ct.solve(ct.SolverOptions(
            mesh=mesh, use_mixed_precision_solves=mixed, **base),
            problem2)
    finally:
        del os.environ["CERES_TPU_FORCE_IMPLICIT"]
    assert "sharded fused" in s2.message
    assert s2.termination_type == ct.TerminationType.CONVERGENCE
    rel = abs(s2.final_cost - s1.final_cost) / s1.final_cost
    assert rel < (1e-5 if mixed else 1e-6), rel


def _two_bucket_bal_problem():
    """Heterogeneous-cost BA: half the observations robust (HuberLoss),
    half plain — two e-buckets sharing the same cameras and points."""
    from ceres_tpu.examples.snavely import SnavelyReprojectionError
    bal = synthetic_bal_problem(num_cameras=4, num_points=100,
                                num_observations=400, seed=2,
                                pixel_noise=0.5)
    bal.perturb(rotation_sigma=0.02, translation_sigma=0.1,
                point_sigma=0.05, seed=3)
    cams = [bal.cameras[i].copy() for i in range(bal.num_cameras)]
    pts = [bal.points[i].copy() for i in range(bal.num_points)]
    problem = ct.Problem()
    for i in range(bal.num_observations):
        ox, oy = bal.observations[i]
        cost = ct.AutoDiffCostFunction(
            SnavelyReprojectionError(ox, oy), 2, [9, 3])
        loss = ct.HuberLoss(2.0) if i % 2 == 0 else None
        problem.add_residual_block(cost, loss,
                                   cams[bal.camera_index[i]],
                                   pts[bal.point_index[i]])
    return problem


def test_multi_bucket_fused_sharded_implicit_agree():
    """Two-bucket (mixed-loss) BA through every production path: fused
    DENSE_SCHUR, fused implicit ITERATIVE_SCHUR, sharded explicit, and
    sharded implicit must all reach the host-loop reference cost."""
    from jax.sharding import Mesh
    base = dict(max_num_iterations=50, function_tolerance=1e-9)
    ref = ct.solve(ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
        fused_iterations=False, **base), _two_bucket_bal_problem())
    assert ref.termination_type == ct.TerminationType.CONVERGENCE

    def run(**kw):
        env = kw.pop("env", None)
        if env:
            os.environ[env] = "1"
        try:
            return ct.solve(ct.SolverOptions(**base, **kw),
                            _two_bucket_bal_problem())
        finally:
            if env:
                del os.environ[env]

    mesh = Mesh(np.array(jax.devices()[:min(8, len(jax.devices()))]),
                axis_names=("data",))
    cases = {
        "fused dense": run(
            linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
            fused_iterations=True),
        "fused implicit": run(
            linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
            fused_iterations=True, env="CERES_TPU_FORCE_IMPLICIT"),
        "sharded explicit": run(
            linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
            mesh=mesh),
        "sharded implicit": run(
            linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
            mesh=mesh, env="CERES_TPU_FORCE_IMPLICIT"),
    }
    for name, s in cases.items():
        assert s.termination_type == ct.TerminationType.CONVERGENCE, name
        rel = abs(s.final_cost - ref.final_cost) / ref.final_cost
        assert rel < 1e-6, (name, rel)
    for name in ("sharded explicit", "sharded implicit"):
        assert "sharded fused" in cases[name].message, cases[name].message


def test_sj_chunk_blocks_exact_with_duplicate_cameras():
    """Implicit SCHUR_JACOBI assembly: when a camera observes the same
    point through several rows, the S block diagonal has within-chunk
    cross terms (A_c = sum_k Ge_k, so A_c^T inv A_c has k1 != k2 pairs).
    _sj_chunk_blocks(dup=True) must equal the dense per-camera
    computation; the per-lane form (dup=False) must not."""
    from ceres_tpu.solvers.schur_fused import (_sj_chunk_blocks,
                                               _spd_inv_small,
                                               chunk_has_dup_cams)
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    ne, k, te, tf, kf = 4, 3, 2, 3, 2     # k > kf forces duplicates
    Ge = jnp.asarray(rng.standard_normal((ne, k, te, tf)))
    fids_np = rng.integers(0, kf, size=(ne, k))
    fids = jnp.asarray(fids_np)
    B = rng.standard_normal((ne, te, te))
    spd = jnp.asarray(B @ np.swapaxes(B, -1, -2)
                      + 3.0 * np.eye(te)[None])
    inv = _spd_inv_small(spd)
    assert chunk_has_dup_cams(fids_np, np.ones((ne, k)))

    # dense reference: per-camera aggregated cross blocks
    ref = np.zeros((kf, tf, tf))
    for n in range(ne):
        for c in range(kf):
            A_c = np.zeros((te, tf))
            for kk in range(k):
                if fids_np[n, kk] == c:
                    A_c += np.asarray(Ge[n, kk])
            ref[c] += A_c.T @ np.asarray(inv[n]) @ A_c

    M = jnp.einsum("nij,nkjt->nkit", inv, Ge)
    # transposed layout [tf*tf, k, ne]: view back as [ne, k, tf, tf] for
    # the dense check
    contribT = _sj_chunk_blocks(Ge, M, fids, dup=True)
    assert contribT.shape == (tf * tf, k, ne)
    contrib = np.asarray(contribT).reshape(tf, tf, k, ne).transpose(
        3, 2, 0, 1)
    got = np.zeros((kf, tf, tf))
    for n in range(ne):
        for kk in range(k):
            got[fids_np[n, kk]] += contrib[n, kk]
    np.testing.assert_allclose(got, ref, rtol=1e-10)

    lanewise = _sj_chunk_blocks(Ge, M, fids, dup=False)
    assert not np.allclose(np.asarray(jnp.sum(contribT, axis=(1, 2))),
                           np.asarray(jnp.sum(lanewise, axis=(1, 2))))


def test_sharded_mesh_int_option(bal):
    """options.mesh accepts a device count."""
    problem, _, _ = build_bal_ceres_problem(bal)
    s = ct.solve(ct.SolverOptions(
        mesh=min(4, len(jax.devices())),
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
        max_num_iterations=30, function_tolerance=1e-9), problem)
    assert s.termination_type == ct.TerminationType.CONVERGENCE


def test_sparse_covariance_matches_dense():
    """Scalable covariance (Schur back-solve) vs DENSE_SVD ground truth
    on a gauge-fixed BA problem (reference covariance_impl.cc:360,:535
    sparse path role)."""
    from ceres_tpu.covariance import Covariance, CovarianceOptions
    from ceres_tpu.types import CovarianceAlgorithmType

    bal = synthetic_bal_problem(num_cameras=6, num_points=800,
                                num_observations=4000, seed=11,
                                pixel_noise=0.5)
    problem, cams, pts = build_bal_ceres_problem(bal)
    # fix the gauge: one camera + one point held constant
    problem.set_parameter_block_constant(cams[0])
    problem.set_parameter_block_constant(pts[0])
    assert 6 * 9 + 800 * 3 - 12 > 2000  # sparse path threshold

    pairs = [(cams[1], cams[1]), (cams[1], cams[2]), (pts[5], pts[5]),
             (cams[3], pts[7])]

    cov_sparse = Covariance(CovarianceOptions(
        algorithm_type=CovarianceAlgorithmType.SPARSE_QR))
    assert cov_sparse.compute(pairs, problem), cov_sparse.message
    assert cov_sparse._block_cov is not None  # scalable path taken

    cov_dense = Covariance(CovarianceOptions(
        algorithm_type=CovarianceAlgorithmType.DENSE_SVD))
    assert cov_dense.compute(pairs, problem), cov_dense.message

    for a, b in pairs:
        Cs = cov_sparse.get_covariance_block_in_tangent_space(a, b)
        Cd = cov_dense.get_covariance_block_in_tangent_space(a, b)
        rel = np.max(np.abs(Cs - Cd)) / (np.max(np.abs(Cd)) + 1e-300)
        assert rel < 1e-6, rel
    # symmetry access: (b, a) of a requested (a, b)
    Cba = cov_sparse.get_covariance_block_in_tangent_space(cams[2], cams[1])
    Cab = cov_sparse.get_covariance_block_in_tangent_space(cams[1], cams[2])
    np.testing.assert_allclose(Cba, Cab.T)


def test_covariance_matrix_batch_api():
    """GetCovarianceMatrix / GetCovarianceMatrixInTangentSpace
    (covariance.h:441,:458)."""
    from ceres_tpu.covariance import Covariance, CovarianceOptions

    rng = np.random.default_rng(0)
    a = rng.standard_normal(2)
    b = rng.standard_normal(3)
    problem = ct.Problem()

    class R:
        def __call__(self, a, b):
            return jnp.concatenate([
                a * 2.0 - b[:2], (b * 1.5)]) + 0.1 * jnp.concatenate(
                    [a, b]) ** 2

    problem.add_residual_block(
        ct.AutoDiffCostFunction(R(), 5, [2, 3]), None, a, b)
    cov = Covariance(CovarianceOptions())
    assert cov.compute([(a, a), (a, b), (b, b)], problem), cov.message
    M = cov.get_covariance_matrix_in_tangent_space([a, b])
    assert M.shape == (5, 5)
    np.testing.assert_allclose(
        M[:2, :2], cov.get_covariance_block_in_tangent_space(a, a))
    np.testing.assert_allclose(
        M[:2, 2:], cov.get_covariance_block_in_tangent_space(a, b))
    np.testing.assert_allclose(M, M.T, atol=1e-12)
    Ma = cov.get_covariance_matrix([a, b])
    assert Ma.shape == (5, 5)


def test_sharded_fused_multihost_mesh(bal):
    """2-D {host, chip} mesh: rows shard over the flattened product of
    both axes; collectives reduce over both (the multi-host story on the
    virtual CPU mesh, SURVEY.md section 5.8)."""
    from jax.sharding import Mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    problem, _, _ = build_bal_ceres_problem(bal)
    base = dict(linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
                max_num_iterations=50, function_tolerance=1e-9)
    s1 = ct.solve(ct.SolverOptions(**base), problem)
    problem2, _, _ = build_bal_ceres_problem(bal)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                axis_names=("host", "chip"))
    s2 = ct.solve(ct.SolverOptions(mesh=mesh, **base), problem2)
    assert "sharded fused" in s2.message
    rel = abs(s2.final_cost - s1.final_cost) / s1.final_cost
    assert rel < 1e-6, rel


def test_fused_implicit_iterative_matches_generic(bal):
    """Matrix-free fused ITERATIVE_SCHUR (the large-camera regime where
    A/dense-S are unaffordable; implicit_schur_complement.h role) —
    forced at small size, compared against the generic SchurOps step and
    an end-to-end solve."""
    problem, _, _ = build_bal_ceres_problem(bal)
    options = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
        max_num_iterations=50, function_tolerance=1e-9)
    s_ref = ct.solve(ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
        max_num_iterations=50, function_tolerance=1e-9), problem)

    os.environ["CERES_TPU_FORCE_IMPLICIT"] = "1"
    try:
        problem2, _, _ = build_bal_ceres_problem(bal)
        s_imp = ct.solve(options, problem2)
    finally:
        del os.environ["CERES_TPU_FORCE_IMPLICIT"]
    assert s_imp.termination_type == ct.TerminationType.CONVERGENCE
    rel = abs(s_imp.final_cost - s_ref.final_cost) / s_ref.final_cost
    assert rel < 1e-6, rel


def test_single_f_block_two_view():
    """SchurEliminatorForOneFBlock (schur_eliminator.h:365) role: two-view
    BA with one free camera reduces to a single f block (kf=1); the fused
    eliminator takes its one-f-block specialization (every one-hot is
    identically 1, so the selector matmuls collapse to plain sums and no
    [n, kf] one-hot is built at all — schur_fused.py `kf == 1` branches).
    A weak prior on the free camera adds an f-only bucket so the
    specialization's f-only branch runs too. Structural check: the fused
    step equals the generic SchurOps step exactly, and a short solve
    strictly decreases the cost."""
    bal = synthetic_bal_problem(num_cameras=2, num_points=120,
                                num_observations=240, seed=9,
                                pixel_noise=0.2)
    bal.perturb(rotation_sigma=0.002, translation_sigma=0.01,
                point_sigma=0.005, seed=10)
    problem, cams, pts = build_bal_ceres_problem(bal)
    problem.set_parameter_block_constant(cams[0])
    problem.set_parameter_block_constant(pts[0])
    problem.add_residual_block(
        ct.NormalPrior(0.01 * np.eye(9), cams[1].copy()), None, cams[1])
    options = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR)
    program = CompiledProgram.get_cached(problem, options)
    from ceres_tpu.solvers.schur import detect_schur_structure
    from ceres_tpu.solvers.schur_fused import fused_schur_supported
    meta = detect_schur_structure(program, options)
    assert meta is not None and meta.f_groups[0]["kf"] == 1
    assert fused_schur_supported(program, options, meta)

    x0 = program.initial_state()
    radius = jnp.asarray(1e4, program.dtype)
    ex = (program.example_x(), program.example_scalar(),
          program.example_delta())
    scale = solver_mod.make_scale_fn(program, options)(x0)
    a = program.jit_with_consts(
        solver_mod.make_step_impl(program, options), ex)(x0, radius, scale)
    os.environ["CERES_TPU_NO_FUSED_SCHUR"] = "1"
    try:
        b = program.jit_with_consts(
            solver_mod.make_step_impl(program, options), ex)(x0, radius,
                                                             scale)
    finally:
        del os.environ["CERES_TPU_NO_FUSED_SCHUR"]
    for k in ["cost", "delta", "model_cost_change"]:
        va, vb = np.asarray(a[k]), np.asarray(b[k])
        rel = np.max(np.abs(va - vb)) / (np.max(np.abs(vb)) + 1e-300)
        assert rel < 1e-9, (k, rel)

    s = ct.solve(ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
        max_num_iterations=10), problem)
    assert s.final_cost < s.initial_cost


def test_sharded_fused_solve_with_constant_camera(bal):
    """Observations of a constant camera form an e-only bucket (point
    variable, camera fixed) — the sharded fused path must carry it
    (EtE / g_e / cost contributions only) and match the single-device
    result, not fall back."""
    from jax.sharding import Mesh
    from ceres_tpu.solvers.schur import detect_schur_structure
    from ceres_tpu.parallel.sharded_fused import sharded_fused_supported
    base = dict(linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
                max_num_iterations=50, function_tolerance=1e-9)

    problem, cams, _ = build_bal_ceres_problem(bal)
    problem.set_parameter_block_constant(cams[0])
    s1 = ct.solve(ct.SolverOptions(**base), problem)

    problem2, cams2, _ = build_bal_ceres_problem(bal)
    problem2.set_parameter_block_constant(cams2[0])
    opts = ct.SolverOptions(mesh=min(8, len(jax.devices())), **base)
    program = CompiledProgram.get_cached(problem2, opts)
    meta = detect_schur_structure(program, opts)
    assert any(bs.e_slot is not None and bs.f_cols is None
               for bs in meta.buckets)          # e-only bucket exists
    assert sharded_fused_supported(program, opts, meta)
    s2 = ct.solve(opts, problem2)
    assert "sharded fused" in s2.message
    assert s2.termination_type == ct.TerminationType.CONVERGENCE
    rel = abs(s2.final_cost - s1.final_cost) / s1.final_cost
    assert rel < 1e-6, rel


def _step(problem, options, env=None):
    """One jitted LM step from x0; env names a variable set during the
    build (e.g. CERES_TPU_NO_FUSED_SCHUR for the generic SchurOps step)."""
    program = CompiledProgram.get_cached(problem, options)
    x0 = program.initial_state()
    radius = jnp.asarray(1e4, program.dtype)
    ex = (program.example_x(), program.example_scalar(),
          program.example_delta())
    scale = solver_mod.make_scale_fn(program, options)(x0)
    if env:
        os.environ[env] = "1"
    try:
        return program.jit_with_consts(
            solver_mod.make_step_impl(program, options), ex)(x0, radius,
                                                             scale)
    finally:
        if env:
            del os.environ[env]


def _assert_mixed_step_close(a, b):
    """Mixed fused step vs the f64 generic step: the cost is an f64
    residual pass in both; the f32 Jacobian and solve leave ~1e-4 on the
    step (measured <= 1.6e-4 on these problems) and ~1e-7 on the gradient
    and the model cost change."""
    tols = dict(cost=1e-12, gradient_max_norm=1e-5, delta=5e-4,
                model_cost_change=1e-5, step_norm=5e-4)
    for k, tol in tols.items():
        va, vb = np.asarray(a[k]), np.asarray(b[k])
        rel = np.max(np.abs(va - vb)) / (np.max(np.abs(vb)) + 1e-300)
        assert rel < tol, (k, rel)


def _bal_options(solver_name, mixed, **kw):
    return ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType[solver_name],
        preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
        use_mixed_precision_solves=mixed, **kw)


@pytest.mark.parametrize("solver_name", ["DENSE_SCHUR", "ITERATIVE_SCHUR"])
def test_fused_mixed_step_matches_f64(bal, solver_name):
    """The mixed-precision fused lin phase + solve against the f64 generic
    SchurOps step on the same problem."""
    problem, _, _ = build_bal_ceres_problem(bal)
    a = _step(problem, _bal_options(solver_name, True))
    b = _step(problem, _bal_options(solver_name, False),
              env="CERES_TPU_NO_FUSED_SCHUR")
    _assert_mixed_step_close(a, b)


def test_fused_mixed_step_robust_loss_matches_f64(bal):
    """Huber loss: the corrector runs row-wise on the f32 Jacobian in the
    fused lin phase; the step must match the f64 generic step."""
    problem, _, _ = build_bal_ceres_problem(bal, loss=ct.HuberLoss(1.0))
    a = _step(problem, _bal_options("DENSE_SCHUR", True))
    b = _step(problem, _bal_options("DENSE_SCHUR", False),
              env="CERES_TPU_NO_FUSED_SCHUR")
    _assert_mixed_step_close(a, b)


def test_fused_mixed_step_degenerate_point():
    """A point at world z == 0 observed fewer times than the chunk width:
    its padded chunk lanes are masked, and the step must stay finite and
    match the f64 generic step."""
    bal = synthetic_bal_problem(num_cameras=3, num_points=40,
                                num_observations=100, seed=13,
                                pixel_noise=0.5)
    counts = np.bincount(bal.point_index, minlength=bal.num_points)
    assert counts.min() < counts.max(), "need masked lanes"
    j = int(np.argmin(counts))
    bal.points[j] = np.array([0.3, 0.2, 0.0])
    problem, _, _ = build_bal_ceres_problem(bal)
    a = _step(problem, _bal_options("DENSE_SCHUR", True))
    assert np.isfinite(np.asarray(a["delta"])).all()
    b = _step(problem, _bal_options("DENSE_SCHUR", False),
              env="CERES_TPU_NO_FUSED_SCHUR")
    _assert_mixed_step_close(a, b)


def test_fused_mixed_iterative_solve_matches_f64_host_loop(bal):
    """End to end: mixed-precision fused ITERATIVE_SCHUR against the f64
    host loop on the generic step path."""
    base = dict(max_num_iterations=50, function_tolerance=1e-9)
    problem, _, _ = build_bal_ceres_problem(bal)
    s1 = ct.solve(_bal_options("ITERATIVE_SCHUR", True,
                               fused_iterations=True, **base), problem)
    problem2, _, _ = build_bal_ceres_problem(bal)
    s2 = ct.solve(_bal_options("ITERATIVE_SCHUR", False,
                               fused_iterations=False, **base), problem2)
    assert s1.termination_type == ct.TerminationType.CONVERGENCE
    assert s2.termination_type == ct.TerminationType.CONVERGENCE
    rel = abs(s1.final_cost - s2.final_cost) / s2.final_cost
    assert rel < 1e-5, rel


def test_fused_split_rejection_path(bal):
    """The fused loop's rejected-step fast path (cached linearization,
    re-solve with a smaller radius) must agree with the host loop. A huge
    initial radius forces early rejections."""
    base = dict(linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
                use_mixed_precision_solves=True,
                initial_trust_region_radius=1e8,
                max_num_iterations=60, function_tolerance=1e-9)
    problem, _, _ = build_bal_ceres_problem(bal)
    s_fused = ct.solve(ct.SolverOptions(fused_iterations=True, **base),
                       problem)
    problem2, _, _ = build_bal_ceres_problem(bal)
    s_host = ct.solve(ct.SolverOptions(fused_iterations=False, **base),
                      problem2)
    assert s_fused.termination_type == ct.TerminationType.CONVERGENCE
    assert s_fused.num_unsuccessful_steps > 0  # rejections exercised
    rel = abs(s_fused.final_cost - s_host.final_cost) / s_host.final_cost
    assert rel < 1e-6, rel


def test_mesh_with_bounds_falls_back_to_host_loop(bal):
    """Host-loop-only features (bounds here) must NOT be silently lost
    inside the sharded device loop: options.mesh + bounds routes to the
    single-device host-loop minimizer (projected gradient convergence
    test, trust_region_minimizer.cc:101,:288)."""
    from jax.sharding import Mesh
    problem, cams, pts = build_bal_ceres_problem(bal)
    # a box around the current point values (inactive but present)
    p0 = pts[0]
    problem.set_parameter_lower_bound(p0, 0, float(p0[0]) - 100.0)
    problem.set_parameter_upper_bound(p0, 0, float(p0[0]) + 100.0)
    ndev = min(4, len(jax.devices()))
    mesh = Mesh(np.array(jax.devices()[:ndev]), axis_names=("data",))
    s = ct.solve(ct.SolverOptions(
        mesh=mesh,
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
        max_num_iterations=30, function_tolerance=1e-9), problem)
    assert s.termination_type == ct.TerminationType.CONVERGENCE
    assert "sharded fused" not in s.message


def test_detect_cross_bucket_dups():
    from ceres_tpu.solvers.schur_fused import detect_cross_bucket_dups
    f1 = np.array([[0, 1], [2, 0]])
    v1 = np.ones((2, 2), bool)
    # bucket 2 shares (point 1, cam 2) with bucket 1
    f2 = np.array([[3, 3], [2, 3]])
    v2 = np.ones((2, 2), bool)
    # bucket 3 shares nothing (same cams, different points -> keys differ)
    f3 = np.array([[2, 3], [1, 1]])
    v3 = np.array([[True, False], [False, False]])
    pairs = detect_cross_bucket_dups([(f1, v1), (f2, v2), (f3, v3)])
    assert (0, 1) in pairs
    assert (0, 2) not in pairs
    # masked-out lanes don't count
    v2b = np.array([[True, True], [False, True]])
    assert detect_cross_bucket_dups([(f1, v1), (f2, v2b)]) == []


def test_sj_cross_pair_blocks_exact():
    """Cross-bucket S-diagonal correction: per-bucket _sj_chunk_blocks
    plus _sj_cross_pair_blocks must equal the dense per-camera
    computation over the UNION of both buckets' rows."""
    from ceres_tpu.solvers.schur_fused import (_sj_chunk_blocks,
                                               _sj_cross_pair_blocks,
                                               _spd_inv_small)
    import jax.numpy as jnp
    rng = np.random.default_rng(9)
    ne, k1, k2, te, tf, kf = 5, 3, 2, 2, 3, 3
    Ge1 = jnp.asarray(rng.standard_normal((ne, k1, te, tf)))
    Ge2 = jnp.asarray(rng.standard_normal((ne, k2, te, tf)))
    f1_np = rng.integers(0, kf, size=(ne, k1))
    f2_np = rng.integers(0, kf, size=(ne, k2))
    f1, f2 = jnp.asarray(f1_np), jnp.asarray(f2_np)
    B = rng.standard_normal((ne, te, te))
    spd = jnp.asarray(B @ np.swapaxes(B, -1, -2) + 3.0 * np.eye(te)[None])
    inv = _spd_inv_small(spd)

    # dense reference over the union of rows
    ref = np.zeros((kf, tf, tf))
    for n in range(ne):
        for c in range(kf):
            A_c = np.zeros((te, tf))
            for kk in range(k1):
                if f1_np[n, kk] == c:
                    A_c += np.asarray(Ge1[n, kk])
            for kk in range(k2):
                if f2_np[n, kk] == c:
                    A_c += np.asarray(Ge2[n, kk])
            ref[c] += A_c.T @ np.asarray(inv[n]) @ A_c

    def untranspose(cT, kk_, ne_):
        # [tf*tf, k, ne] -> [ne, k, tf, tf]
        return np.asarray(cT).reshape(tf, tf, kk_, ne_).transpose(
            3, 2, 0, 1)

    got = np.zeros((kf, tf, tf))
    for Ge, f_np, f in ((Ge1, f1_np, f1), (Ge2, f2_np, f2)):
        M = jnp.einsum("nij,nkjt->nkit", inv, Ge)
        contrib = untranspose(_sj_chunk_blocks(Ge, M, f, dup=True),
                              f_np.shape[1], ne)
        for n in range(ne):
            for kk in range(f_np.shape[1]):
                got[f_np[n, kk]] += contrib[n, kk]
    cross = untranspose(_sj_cross_pair_blocks(Ge1, Ge2, inv, f1, f2),
                        k1, ne)
    for n in range(ne):
        for kk in range(k1):
            got[f1_np[n, kk]] += cross[n, kk]
    np.testing.assert_allclose(got, ref, rtol=1e-9)


def _cross_dup_bal_problem():
    """Every observation enters TWICE — once robust, once plain — so the
    same (camera, point) pair has rows in two different buckets (the
    cross-bucket duplicate case for the implicit SCHUR_JACOBI)."""
    from ceres_tpu.examples.snavely import SnavelyReprojectionError
    bal = synthetic_bal_problem(num_cameras=3, num_points=100,
                                num_observations=200, seed=4,
                                pixel_noise=0.5)
    bal.perturb(rotation_sigma=0.02, translation_sigma=0.1,
                point_sigma=0.05, seed=5)
    cams = [bal.cameras[i].copy() for i in range(bal.num_cameras)]
    pts = [bal.points[i].copy() for i in range(bal.num_points)]
    problem = ct.Problem()
    for i in range(bal.num_observations):
        ox, oy = bal.observations[i]
        for loss in (ct.HuberLoss(2.0), None):
            cost = ct.AutoDiffCostFunction(
                SnavelyReprojectionError(ox, oy), 2, [9, 3])
            problem.add_residual_block(cost, loss,
                                       cams[bal.camera_index[i]],
                                       pts[bal.point_index[i]])
    return problem


def test_cross_bucket_dup_implicit_schur_jacobi():
    """The implicit fused + sharded ITERATIVE_SCHUR with SCHUR_JACOBI on
    a cross-bucket-duplicate problem: exercises _sj_cross_pair_blocks in
    both wirings and must reach the host DENSE_SCHUR reference cost."""
    from jax.sharding import Mesh
    base = dict(max_num_iterations=50, function_tolerance=1e-9)
    ref = ct.solve(ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
        fused_iterations=False, **base), _cross_dup_bal_problem())
    assert ref.termination_type == ct.TerminationType.CONVERGENCE

    os.environ["CERES_TPU_FORCE_IMPLICIT"] = "1"
    try:
        fused = ct.solve(ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
            fused_iterations=True, **base), _cross_dup_bal_problem())
        mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("data",))
        sharded = ct.solve(ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
            mesh=mesh, **base), _cross_dup_bal_problem())
    finally:
        del os.environ["CERES_TPU_FORCE_IMPLICIT"]
    for name, s in (("fused", fused), ("sharded", sharded)):
        assert s.termination_type == ct.TerminationType.CONVERGENCE, name
        rel = abs(s.final_cost - ref.final_cost) / ref.final_cost
        assert rel < 1e-6, (name, rel)


def test_sharded_fused_per_row_loss_attrs(bal):
    """Per-row loss parameters (same loss class, different scalars per
    residual block -> bk.loss_attrs stacked planes) through the SHARDED
    fused path: the chunk-layout [nloc, k] attr planes must be flattened
    to the [nloc*k] row layout the loss evaluation uses. Regression for
    a trace-time shape mismatch in parallel/sharded_fused.bucket_loss."""
    from jax.sharding import Mesh
    from ceres_tpu.examples.snavely import SnavelyReprojectionError
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")

    def build():
        problem = ct.Problem()
        cams = [c.copy() for c in bal.cameras]
        pts = [p.copy() for p in bal.points]
        for i in range(bal.num_observations):
            ox, oy = bal.observations[i]
            cost = ct.AutoDiffCostFunction(
                SnavelyReprojectionError(ox, oy), 2, [9, 3])
            # varying delta per residual block -> stacked loss_attrs
            problem.add_residual_block(
                cost, ct.HuberLoss(1.0 + 0.5 * (i % 3)),
                cams[bal.camera_index[i]], pts[bal.point_index[i]])
        return problem

    base = dict(linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
                max_num_iterations=30, function_tolerance=1e-9)
    s1 = ct.solve(ct.SolverOptions(**base), build())
    # confirm the per-row attrs actually materialized
    prog = CompiledProgram.get_cached(build(), ct.SolverOptions(**base))
    assert any(bk.loss_attrs for bk in prog.buckets), \
        "test setup no longer produces stacked loss_attrs"

    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("data",))
    s2 = ct.solve(ct.SolverOptions(mesh=mesh, **base), build())
    assert "sharded fused" in s2.message, s2.message
    rel = abs(s2.final_cost - s1.final_cost) / s1.final_cost
    assert rel < 1e-6, rel


def test_sparse_covariance_rank_policy_free_gauge():
    """A BA problem with NO gauge fixed has a 7-dimensional null space;
    the scalable covariance path must return False with the reference's
    rank-deficiency semantics (covariance.h:281-329), not garbage blocks."""
    from ceres_tpu.covariance import Covariance, CovarianceOptions
    from ceres_tpu.types import CovarianceAlgorithmType

    bal = synthetic_bal_problem(num_cameras=6, num_points=800,
                                num_observations=4000, seed=11,
                                pixel_noise=0.5)
    problem, cams, pts = build_bal_ceres_problem(bal)
    assert 6 * 9 + 800 * 3 > 2000       # scalable-path threshold

    cov = Covariance(CovarianceOptions(
        algorithm_type=CovarianceAlgorithmType.SPARSE_QR))
    ok = cov.compute([(cams[1], cams[1])], problem)
    assert not ok
    assert "Rank deficient" in cov.message, cov.message


@pytest.mark.parametrize("loss", [None, "huber"])
def test_fused_mixed_lin_cost_matches_cost_fn(bal, loss):
    """The mixed lin phase's cost (the f64 residual pass beside the f32
    Jacobian) equals program.cost_fn at perturbed states."""
    from ceres_tpu.solvers import schur_fused
    from ceres_tpu.solvers.schur import detect_schur_structure
    problem, _, _ = build_bal_ceres_problem(
        bal, loss=ct.HuberLoss(1.0) if loss else None)
    options = _bal_options("DENSE_SCHUR", True)
    program = CompiledProgram.get_cached(problem, options)
    meta = detect_schur_structure(program, options)
    step = schur_fused.make_fused_schur_lm_step(program, options, meta)
    lin = program.jit_with_consts(
        lambda x, sc: step.linearize(x, sc)["cost"],
        (program.example_x(), program.example_delta()))
    cost = program.jit_with_consts(program.cost_fn, (program.example_x(),))
    x0 = np.asarray(program.initial_state())
    scale = jnp.ones((program.num_effective,), program.dtype)
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = jnp.asarray(x0 * (1.0 + 1e-3 * rng.standard_normal(x0.shape)))
        c_lin, c_64 = float(lin(x, scale)), float(cost(x))
        assert abs(c_lin - c_64) <= 1e-12 * abs(c_64), (c_lin, c_64)


def test_fused_implicit_mixed_step_matches_f64(bal):
    """The matrix-free (implicit) fused ITERATIVE_SCHUR step in mixed
    precision against the f64 generic step."""
    problem, _, _ = build_bal_ceres_problem(bal)
    a = _step(problem, _bal_options("ITERATIVE_SCHUR", True),
              env="CERES_TPU_FORCE_IMPLICIT")
    b = _step(problem, _bal_options("ITERATIVE_SCHUR", False),
              env="CERES_TPU_NO_FUSED_SCHUR")
    _assert_mixed_step_close(a, b)
