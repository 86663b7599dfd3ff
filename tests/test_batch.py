"""Batched solves (ceres_tpu/batch.py): N structurally-identical
problems in one vmapped fused device program. No reference analog — a
accelerator-native capability (RANSAC hypotheses, per-frame refinement,
multi-start). Correctness anchor: every batch element must match its own
individual ct.solve() run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.io.bal import build_bal_ceres_problem, synthetic_bal_problem


class _ExpResidual:
    def __init__(self, x, y):
        self.x, self.y = float(x), float(y)

    def __call__(self, m, c):
        return self.y - jnp.exp(m[0] * self.x + c[0])


def _curve_problem(rng, m_true, c_true):
    m = np.array([0.0])
    c = np.array([0.0])
    prob = ct.Problem()
    for x in np.linspace(0, 5, 25):
        y = float(np.exp(m_true * x + c_true) + 0.01 * rng.standard_normal())
        prob.add_residual_block(
            ct.AutoDiffCostFunction(_ExpResidual(x, y), 1, [1, 1]),
            None, m, c)
    return prob, m, c


def test_batched_curve_fit_matches_individual():
    rng = np.random.default_rng(3)
    truths = [(0.3, 0.1), (0.25, 0.4), (0.5, -0.2), (0.1, 0.8)]
    # fused_iterations so the individual reference runs the same fused
    # while-loop algorithm the batched path always uses
    options = ct.SolverOptions(max_num_iterations=40,
                               function_tolerance=1e-12,
                               fused_iterations=True)

    # individual reference runs (fresh problems: solve writes back)
    rng_a = np.random.default_rng(3)
    refs = []
    for mt, ct_ in truths:
        prob, m, c = _curve_problem(rng_a, mt, ct_)
        s = ct.solve(options, prob)
        refs.append((s, m.copy(), c.copy()))

    rng_b = np.random.default_rng(3)
    built = [_curve_problem(rng_b, mt, ct_) for mt, ct_ in truths]
    summaries = ct.solve_batched(options, [b[0] for b in built])

    assert len(summaries) == len(truths)
    for (s_ref, m_ref, c_ref), s_b, (prob, m, c) in zip(refs, summaries,
                                                        built):
        assert s_b.termination_type == ct.TerminationType.CONVERGENCE
        assert s_b.num_iterations == s_ref.num_iterations, \
            (s_b.num_iterations, s_ref.num_iterations)
        np.testing.assert_allclose(s_b.final_cost, s_ref.final_cost,
                                   rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(m, m_ref, rtol=1e-8)
        np.testing.assert_allclose(c, c_ref, rtol=1e-8)


def test_batched_bal_schur_multistart():
    """Same BA graph, different initial perturbations (multi-start): the
    batched DENSE_SCHUR fused solve must match per-problem solves."""
    options = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
        max_num_iterations=40, function_tolerance=1e-9,
        fused_iterations=True)

    def build(perturb_seed):
        bal = synthetic_bal_problem(num_cameras=4, num_points=150,
                                    num_observations=600, seed=11,
                                    pixel_noise=0.5)
        bal.perturb(rotation_sigma=0.02, translation_sigma=0.1,
                    point_sigma=0.05, seed=perturb_seed)
        return build_bal_ceres_problem(bal)

    seeds = [1, 2, 3]
    refs = [ct.solve(options, build(s)[0]) for s in seeds]
    probs = [build(s)[0] for s in seeds]
    summaries = ct.solve_batched(options, probs)
    for s_ref, s_b in zip(refs, summaries):
        assert s_b.termination_type == ct.TerminationType.CONVERGENCE
        np.testing.assert_allclose(s_b.final_cost, s_ref.final_cost,
                                   rtol=1e-9)
        assert s_b.num_iterations == s_ref.num_iterations


def test_batched_rejects_different_structure():
    """Different observation graphs (sparsity) must be rejected loudly."""
    options = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR)

    def build(seed):
        # 6 cameras / 3-camera covisibility windows: the per-point window
        # start is seed-dependent, so different seeds give different
        # observation graphs (not just different data)
        bal = synthetic_bal_problem(num_cameras=6, num_points=40,
                                    num_observations=120, seed=seed,
                                    pixel_noise=0.5)
        return build_bal_ceres_problem(bal)[0]

    with pytest.raises(ValueError, match="structure|constant"):
        ct.solve_batched(options, [build(1), build(2)])


def test_batched_single_and_empty():
    assert ct.solve_batched(ct.SolverOptions(), []) == []
    rng = np.random.default_rng(0)
    prob, m, c = _curve_problem(rng, 0.3, 0.1)
    (s,) = ct.solve_batched(ct.SolverOptions(), [prob])
    assert s.termination_type == ct.TerminationType.CONVERGENCE


def test_template_registry_reuses_executable():
    """Serving pattern: a SECOND round of FRESH same-structure problems
    must hit the structural template registry (no retrace/recompile) and
    still produce correct per-problem solutions."""
    from ceres_tpu import batch as batch_mod

    options = ct.SolverOptions(max_num_iterations=40,
                               function_tolerance=1e-12,
                               fused_iterations=True)
    truths = [(0.3, 0.1), (0.25, 0.4), (0.5, -0.2)]

    def build_round(seed):
        rng = np.random.default_rng(seed)
        return [_curve_problem(rng, mt, ct_) for mt, ct_ in truths]

    batch_mod._TEMPLATE_REGISTRY.clear()
    round1 = build_round(3)
    ct.solve_batched(options, [b[0] for b in round1])
    assert len(batch_mod._TEMPLATE_REGISTRY) == 1
    entry = batch_mod._TEMPLATE_REGISTRY[0]
    fn1 = entry["solve_jit"]

    # fresh problems, same structure, different data
    round2 = build_round(7)
    sums = ct.solve_batched(options, [b[0] for b in round2])
    assert len(batch_mod._TEMPLATE_REGISTRY) == 1
    assert batch_mod._TEMPLATE_REGISTRY[0]["solve_jit"] is fn1

    # correctness: rebuild round2's problems deterministically (same rng
    # stream) and compare each element against its own individual solve
    refs = []
    rng_ref = np.random.default_rng(7)
    for mt, ct_ in truths:
        prob_r, m_r, c_r = _curve_problem(rng_ref, mt, ct_)
        s_r = ct.solve(options, prob_r)
        refs.append((s_r, m_r.copy(), c_r.copy()))
    for (s_ref, m_ref, c_ref), s_b, (prob, m, c) in zip(refs, sums, round2):
        assert s_b.termination_type == ct.TerminationType.CONVERGENCE
        np.testing.assert_allclose(s_b.final_cost, s_ref.final_cost,
                                   rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(m, m_ref, rtol=1e-8)
        np.testing.assert_allclose(c, c_ref, rtol=1e-8)


def test_registry_structural_const_guard_unit():
    """_same_structural_consts: integer (structural) constants must be
    bitwise equal for registry reuse; float data may differ freely."""
    import types as pytypes
    from ceres_tpu.batch import _same_structural_consts

    a = pytypes.SimpleNamespace(consts_np={
        "idx": np.array([1, 2, 3], np.int32),
        "w": np.ones(3, np.float64)})
    b = pytypes.SimpleNamespace(consts_np={
        "idx": np.array([1, 3, 2], np.int32),       # same shape, new graph
        "w": np.zeros(3, np.float64)})
    assert _same_structural_consts(a, a, ["idx", "w"])
    assert _same_structural_consts(a, b, ["w"])      # floats may differ
    assert not _same_structural_consts(a, b, ["idx", "w"])


def test_registry_not_reused_across_different_graphs():
    """Two serving rounds of BAL problems with IDENTICAL const shapes but
    DIFFERENT observation graphs (integer wiring): the template registry
    must recompile, not silently reuse an executable specialized to the
    old graph, and every element must match its own individual solve."""
    from ceres_tpu import batch as batch_mod

    options = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
        max_num_iterations=40, function_tolerance=1e-9,
        fused_iterations=True)

    def build(graph_seed, perturb_seed):
        bal = synthetic_bal_problem(num_cameras=6, num_points=40,
                                    num_observations=120, seed=graph_seed,
                                    pixel_noise=0.5)
        bal.perturb(rotation_sigma=0.02, translation_sigma=0.1,
                    point_sigma=0.05, seed=perturb_seed)
        return build_bal_ceres_problem(bal)[0]

    batch_mod._TEMPLATE_REGISTRY.clear()
    # precondition: the two graphs are the dangerous case — identical
    # shapes/dtypes but different integer wiring
    from ceres_tpu.program import CompiledProgram
    pa = CompiledProgram.get_cached(build(1, 1), options)
    pb = CompiledProgram.get_cached(build(2, 1), options)
    assert batch_mod._validate_same_structure([pa, pb]) is None
    common = sorted(set(pa.consts_np) & set(pb.consts_np))
    assert not batch_mod._same_structural_consts(pa, pb, common)

    ct.solve_batched(options, [build(1, s) for s in (1, 2)])
    assert len(batch_mod._TEMPLATE_REGISTRY) == 1

    sums = ct.solve_batched(options, [build(2, s) for s in (1, 2)])
    # the graph changed -> a NEW registry entry (no reuse)
    assert len(batch_mod._TEMPLATE_REGISTRY) == 2
    for s_b, seed in zip(sums, (1, 2)):
        ref = ct.solve(options, build(2, seed))
        assert s_b.termination_type == ct.TerminationType.CONVERGENCE
        np.testing.assert_allclose(s_b.final_cost, ref.final_cost,
                                   rtol=1e-9)


def test_batched_bal_mixed_matches_single():
    """A BAL-shaped mixed-precision batch after a single solve has
    compiled and cached the template's program: each batch element
    matches its own single mixed solve (same fused step, vmapped)."""
    options = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
        use_mixed_precision_solves=True,
        max_num_iterations=40, function_tolerance=1e-9,
        fused_iterations=True)

    def build(perturb_seed):
        bal = synthetic_bal_problem(num_cameras=4, num_points=60,
                                    num_observations=240, seed=11,
                                    pixel_noise=0.5)
        bal.perturb(rotation_sigma=0.02, translation_sigma=0.1,
                    point_sigma=0.05, seed=perturb_seed)
        return build_bal_ceres_problem(bal)[0]

    warm = build(1)
    s0 = ct.solve(options, warm)
    assert s0.is_solution_usable()
    sums = ct.solve_batched(options, [build(s) for s in (1, 2, 3)])
    for s_b, seed in zip(sums, (1, 2, 3)):
        ref = ct.solve(options, build(seed))
        assert s_b.termination_type == ct.TerminationType.CONVERGENCE
        np.testing.assert_allclose(s_b.final_cost, ref.final_cost,
                                   rtol=1e-6)
