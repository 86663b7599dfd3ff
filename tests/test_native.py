"""Native host runtime tests: RCM ordering, simplicial LDL^T, scatter_add,
and the SPARSE_NORMAL_CHOLESKY device->host solve path (reference
suitesparse.cc / sparse_normal_cholesky_solver.cc capability)."""

import numpy as np
import pytest

from ceres_tpu import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")


def _random_spd(n, density, seed):
    rng = np.random.default_rng(seed)
    import scipy.sparse as sp
    B = sp.random(n, n, density=density, random_state=seed)
    A = (B @ B.T + sp.eye(n) * n).tocsc()
    A.sort_indices()
    return A


def test_sparse_cholesky_solves():
    A = _random_spd(200, 0.03, 0)
    chol = native.SparseCholesky(200, A.indptr, A.indices)
    assert chol.factor(A.data) == 0
    rng = np.random.default_rng(1)
    for _ in range(3):
        b = rng.normal(size=200)
        x = chol.solve(b)
        np.testing.assert_allclose(A @ x, b, atol=1e-10)


def test_sparse_cholesky_refactor_same_pattern():
    A = _random_spd(150, 0.04, 2)
    chol = native.SparseCholesky(150, A.indptr, A.indices)
    b = np.ones(150)
    for scale in [1.0, 3.7, 0.2]:
        vals = A.data * scale
        assert chol.factor(vals) == 0
        x = chol.solve(b)
        np.testing.assert_allclose((A * scale) @ x, b, atol=1e-9)


def test_sparse_cholesky_detects_breakdown():
    import scipy.sparse as sp
    # Singular matrix: a zero row/column.
    A = sp.eye(10).tocsc()
    A = A.tolil()
    A[5, 5] = 0.0
    A = A.tocsc()
    A.sort_indices()
    chol = native.SparseCholesky(10, A.indptr, A.indices)
    assert chol.factor(A.data) != 0


def test_rcm_reduces_band():
    # A ring graph with one chord; RCM yields a valid permutation.
    import scipy.sparse as sp
    n = 50
    rows, cols = [], []
    for i in range(n):
        for j in (i, (i + 1) % n):
            rows += [i, j]
            cols += [j, i]
    A = sp.coo_matrix((np.ones(len(rows)), (rows, cols)),
                      shape=(n, n)).tocsc()
    A.sort_indices()
    perm = native.rcm_order(A.indptr, A.indices, n)
    assert sorted(perm.tolist()) == list(range(n))


def test_scatter_add_skips_negative():
    out = np.zeros(5)
    idx = np.array([0, 2, -1, 2], dtype=np.int64)
    vals = np.array([1.0, 2.0, 100.0, 3.0])
    native.scatter_add(out, idx, vals)
    np.testing.assert_allclose(out, [1.0, 0.0, 5.0, 0.0, 0.0])


def test_sparse_normal_cholesky_matches_dense():
    """The host sparse path and the on-device dense path must produce the
    same LM steps (same final cost, same iterations)."""
    import jax
    import ceres_tpu as ct
    from ceres_tpu.io.g2o import synthetic_pose_graph_2d
    from ceres_tpu.examples.slam import build_pose_graph_2d_problem

    poses, constraints, gt = synthetic_pose_graph_2d(num_poses=120, seed=4)
    results = {}
    for solver in ["SPARSE_NORMAL_CHOLESKY", "DENSE_NORMAL_CHOLESKY"]:
        pr, pos, yaws = build_pose_graph_2d_problem(poses, constraints)
        options = ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType[solver],
            max_num_iterations=50)
        s = ct.solve(options, pr)
        assert s.is_solution_usable()
        results[solver] = s
    np.testing.assert_allclose(
        results["SPARSE_NORMAL_CHOLESKY"].final_cost,
        results["DENSE_NORMAL_CHOLESKY"].final_cost, rtol=1e-8)


def test_subset_preconditioner_cgnr():
    """SUBSET preconditioner (subset_preconditioner.h:70): CGNR
    preconditioned by Q^T Q from the odometry-chain rows converges to the
    same optimum as block-Jacobi."""
    import ceres_tpu as ct
    from ceres_tpu.io.g2o import synthetic_pose_graph_2d
    from ceres_tpu.examples.slam import build_pose_graph_2d_problem

    poses, constraints, gt = synthetic_pose_graph_2d(num_poses=60, seed=4)
    pr, pos, yaws = build_pose_graph_2d_problem(poses, constraints)
    rbs = pr.residual_blocks()[:59]
    options = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.CGNR,
        preconditioner_type=ct.PreconditionerType.SUBSET,
        residual_blocks_for_subset_preconditioner=rbs,
        max_num_iterations=60)
    s = ct.solve(options, pr)
    assert s.is_solution_usable()

    pr2, _, _ = build_pose_graph_2d_problem(poses, constraints)
    s2 = ct.solve(ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.CGNR,
        preconditioner_type=ct.PreconditionerType.JACOBI,
        max_num_iterations=60), pr2)
    np.testing.assert_allclose(s.final_cost, s2.final_cost, rtol=1e-3)


def test_pose_graph_3d_sparse_at_scale():
    """300-pose 3D pose graph (2100 params, quaternion manifolds) through
    the native sparse path converges."""
    import ceres_tpu as ct
    from ceres_tpu.io.g2o import synthetic_pose_graph_3d
    from ceres_tpu.examples.slam import build_pose_graph_3d_problem

    poses, constraints, gt = synthetic_pose_graph_3d(num_poses=300, seed=2)
    pr, pos, quats = build_pose_graph_3d_problem(poses, constraints)
    s = ct.solve(ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY,
        max_num_iterations=60), pr)
    assert s.is_solution_usable()
    assert s.final_cost < 0.5 * s.initial_cost
    for q in quats.values():
        np.testing.assert_allclose(np.linalg.norm(q), 1.0, rtol=1e-9)


def test_dynamic_sparsity_reanalyzes_numerical_pattern():
    """dynamic_sparsity=True (DynamicSparseNormalCholeskySolver role,
    dynamic_sparse_normal_cholesky_solver.cc): the host factorization
    re-runs symbolic analysis from THIS iteration's numerical nonzeros.
    Gram entries that are exactly zero this iteration must drop out of the
    factored pattern, and the solve must still match the dense answer."""
    import ceres_tpu as ct
    from ceres_tpu.io.g2o import synthetic_pose_graph_2d
    from ceres_tpu.examples.slam import build_pose_graph_2d_problem
    from ceres_tpu.program import CompiledProgram
    from ceres_tpu.solvers.sparse_direct import SparseNormalCholeskyContext

    poses, constraints, gt = synthetic_pose_graph_2d(num_poses=80, seed=9)
    pr, pos, yaws = build_pose_graph_2d_problem(poses, constraints)
    program = CompiledProgram.get_cached(pr, ct.SolverOptions())
    ctx = SparseNormalCholeskyContext(program, dynamic=True)
    n = ctx.n

    rng = np.random.default_rng(3)
    # Gram blocks with HALF the buckets' blocks numerically zeroed:
    # the structural superset stays, the numerical pattern shrinks.
    gram_flats = []
    for ac in ctx.bucket_cols:
        nb, t = ac.shape
        B = rng.normal(size=(nb, t, 2 * t))
        G = np.einsum("ntr,nur->ntu", B, B)     # PSD blocks
        G[::2] = 0.0                            # kill every other block
        gram_flats.append(G)
    D_sq = np.full(n, 1e-2)

    status = ctx.host_factor(D_sq, *gram_flats)
    assert int(status) == 0
    assert ctx.chol._Ai.size < ctx.nnz          # pattern actually shrank

    # Dense reference: assemble the same matrix densely.
    A = np.zeros((n, n))
    for G, ac in zip(gram_flats, ctx.bucket_cols):
        for blk, cols in zip(G, ac):
            A[np.ix_(cols, cols)] += blk
    A[np.diag_indices(n)] += D_sq
    b = rng.normal(size=n)
    x = ctx.host_apply(b)
    np.testing.assert_allclose(A @ x, b, atol=1e-8)

    # Second call with a different zero set re-analyzes again.
    gram_flats2 = [G.copy() for G in gram_flats]
    for G in gram_flats2:
        G[:] = rng.normal(size=G.shape)
        G[:] = np.einsum("ntr,nur->ntu", G, G)[:]
    assert int(ctx.host_factor(D_sq, *gram_flats2)) == 0
    assert ctx.chol._Ai.size == ctx.nnz         # full pattern is back


def test_dynamic_sparsity_end_to_end_matches_static():
    """ct.solve with dynamic_sparsity=True converges to the static-path
    answer (ellipse_approximation.cc workload semantics)."""
    import ceres_tpu as ct
    from ceres_tpu.io.g2o import synthetic_pose_graph_2d
    from ceres_tpu.examples.slam import build_pose_graph_2d_problem

    poses, constraints, gt = synthetic_pose_graph_2d(num_poses=120, seed=4)
    finals = []
    for dyn in (False, True):
        pr, pos, yaws = build_pose_graph_2d_problem(poses, constraints)
        s = ct.solve(ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY,
            dynamic_sparsity=dyn, max_num_iterations=50), pr)
        assert s.is_solution_usable()
        finals.append(s.final_cost)
    np.testing.assert_allclose(finals[0], finals[1], rtol=1e-8)


def test_linear_solver_ordering_type_knob():
    """OrderingType knob routes the sparse direct path: NATURAL vs AMD
    give identical solutions; NATURAL forces the identity permutation."""
    import ceres_tpu as ct
    from ceres_tpu.solvers.sparse_direct import _native_ordering
    from ceres_tpu import native

    assert (_native_ordering(ct.SolverOptions(
        linear_solver_ordering_type=ct.OrderingType.NATURAL))
        == native.SparseCholesky.ORDER_NATURAL)
    assert (_native_ordering(ct.SolverOptions(
        linear_solver_ordering_type=ct.OrderingType.AMD))
        == native.SparseCholesky.ORDER_AUTO)
    assert (_native_ordering(ct.SolverOptions(
        linear_solver_ordering_type=ct.OrderingType.NESDIS))
        == native.SparseCholesky.ORDER_AUTO)

    def make():
        rng = np.random.default_rng(3)
        xs = [np.array([float(i), 0.0]) for i in range(12)]
        problem = ct.Problem()
        for i in range(11):
            obs = float(i) + rng.normal(0, 0.01)

            def rel(a, b, o=obs):
                return (b - a) - o

            problem.add_residual_block(
                ct.AutoDiffCostFunction(rel, 2, [2, 2]), None,
                xs[i], xs[i + 1])
        problem.set_parameter_block_constant(xs[0])
        return problem, xs

    results = []
    for ot in (ct.OrderingType.NATURAL, ct.OrderingType.AMD):
        problem, xs = make()
        s = ct.solve(ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY,
            linear_solver_ordering_type=ot, max_num_iterations=20), problem)
        assert s.termination_type == ct.TerminationType.CONVERGENCE
        results.append(np.concatenate(xs))
    np.testing.assert_allclose(results[0], results[1], rtol=1e-10)


def test_sparse_cholesky_diag_stats_rank_policy():
    """LDL^T inertia/conditioning surface for the covariance rank policy
    (reference covariance.h:281-329 failure semantics)."""
    import scipy.sparse as sp
    # well-conditioned SPD: no negative pivots, healthy ratio
    A = _random_spd(100, 0.05, 3)
    chol = native.SparseCholesky(100, A.indptr, A.indices)
    assert chol.factor(A.data) == 0
    dmin, dmax, nneg = chol.diag_stats()
    assert nneg == 0 and dmin > 0 and dmin / dmax > 1e-10

    # NEAR-singular SPD (rank deficiency damped only by epsilon): factor
    # succeeds but the pivot ratio exposes the deficiency
    B = sp.eye(10, format="csc")
    B = B.tolil()
    B[5, 5] = 1e-18
    B = B.tocsc()
    B.sort_indices()
    chol2 = native.SparseCholesky(10, B.indptr, B.indices,
                                  ordering=native.SparseCholesky.ORDER_NATURAL)
    assert chol2.factor(B.data) == 0
    dmin, dmax, nneg = chol2.diag_stats()
    assert nneg == 0
    assert dmin / dmax < 1e-14        # fails the rank policy threshold

    # indefinite matrix: negative pivot count > 0
    C = sp.eye(10, format="csc").tolil()
    C[3, 3] = -1.0
    C = C.tocsc()
    C.sort_indices()
    chol3 = native.SparseCholesky(10, C.indptr, C.indices,
                                  ordering=native.SparseCholesky.ORDER_NATURAL)
    assert chol3.factor(C.data) == 0
    _, _, nneg = chol3.diag_stats()
    assert nneg == 1


def test_subset_preconditioner_device_dense_matches_host():
    """Device-dense SUBSET variant (callback-less backends: factor the
    subset normal matrix on device once per linearization, triangular
    solves per CG iteration — no pure_callback anywhere). Must converge
    to the host-LDL^T path's optimum."""
    import os
    import ceres_tpu as ct
    from ceres_tpu.io.g2o import synthetic_pose_graph_2d
    from ceres_tpu.examples.slam import build_pose_graph_2d_problem

    poses, constraints, gt = synthetic_pose_graph_2d(num_poses=60, seed=4)

    def run():
        pr, pos, yaws = build_pose_graph_2d_problem(poses, constraints)
        rbs = pr.residual_blocks()[:59]
        return ct.solve(ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.CGNR,
            preconditioner_type=ct.PreconditionerType.SUBSET,
            residual_blocks_for_subset_preconditioner=rbs,
            max_num_iterations=60), pr)

    os.environ["CERES_TPU_SUBSET_DEVICE"] = "1"
    try:
        s_dev = run()
    finally:
        del os.environ["CERES_TPU_SUBSET_DEVICE"]
    s_host = run()
    assert s_dev.is_solution_usable()
    np.testing.assert_allclose(s_dev.final_cost, s_host.final_cost,
                               rtol=1e-6)
