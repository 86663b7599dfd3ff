"""IterationCallback / EvaluationCallback / checkpointing / dumping
(reference iteration_callback.h, evaluation_callback.h:63, solver.h:785
update_state_every_iteration, SURVEY.md section 5.4)."""

import os

import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.checkpoint import (CheckpointCallback, dump_linear_problem,
                                  load_state, save_state)


def quad_problem(x0=5.0):
    x = np.array([x0])

    def f(v):
        return v - 3.0

    problem = ct.Problem()
    problem.add_residual_block(ct.AutoDiffCostFunction(f, 1, [1]), None, x)
    return problem, x


def test_iteration_callback_receives_summaries():
    problem, x = quad_problem()
    seen = []

    def cb(it):
        seen.append((it.iteration, it.cost))
        return ct.CallbackReturnType.SOLVER_CONTINUE

    ct.solve(ct.SolverOptions(callbacks=[cb]), problem)
    assert len(seen) >= 2
    assert seen[0][0] == 0
    assert seen[-1][1] <= seen[0][1]


def test_callback_early_termination():
    problem, x = quad_problem()

    def cb(it):
        return (ct.CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY
                if it.iteration >= 1 else
                ct.CallbackReturnType.SOLVER_CONTINUE)

    summary = ct.solve(ct.SolverOptions(callbacks=[cb]), problem)
    assert summary.termination_type == ct.TerminationType.USER_SUCCESS
    assert summary.num_iterations <= 2


def test_evaluation_callback_invoked():
    problem, x = quad_problem()

    class EvalCb:
        def __init__(self):
            self.calls = []

        def prepare_for_evaluation(self, evaluate_jacobians,
                                   new_evaluation_point):
            self.calls.append((evaluate_jacobians, new_evaluation_point))

    ecb = EvalCb()
    ct.solve(ct.SolverOptions(evaluation_callback=ecb), problem)
    assert any(j for j, _ in ecb.calls)       # jacobian evaluations
    assert any(not j for j, _ in ecb.calls)   # residual-only evaluations


def test_checkpoint_roundtrip(tmp_path):
    problem, x = quad_problem()
    save_state(str(tmp_path / "s.npz"), problem, iteration=7,
               trust_region_radius=123.0)
    x[0] = -100.0
    state = load_state(str(tmp_path / "s.npz"), problem)
    assert x[0] == 5.0
    assert state["iteration"] == 7 and state["trust_region_radius"] == 123.0


def test_checkpoint_callback_and_update_state(tmp_path):
    problem, x = quad_problem()
    cb = CheckpointCallback(problem, str(tmp_path), every_k_iterations=1)
    summary = ct.solve(
        ct.SolverOptions(callbacks=[cb], update_state_every_iteration=True),
        problem)
    files = sorted(os.listdir(tmp_path))
    assert files, "no checkpoints written"
    # resume from the last checkpoint: parameters land near the optimum
    x[0] = 99.0
    load_state(str(tmp_path / files[-1]), problem)
    assert abs(x[0] - 3.0) < 1.0


def test_dump_linear_problem(tmp_path):
    problem, x = quad_problem()
    from ceres_tpu.program import CompiledProgram
    import jax
    prog = CompiledProgram(problem)
    _, _, jac, res = jax.jit(prog.linearize_fn)(prog.initial_state())
    import jax.numpy as jnp
    dump_linear_problem(str(tmp_path / "lsqp.npz"), jac, res,
                        jnp.ones(1), prog.initial_state())
    data = np.load(tmp_path / "lsqp.npz")
    assert data["jacobian"].shape == (1, 1)
    np.testing.assert_allclose(data["rhs"], [2.0])


def test_trust_region_problem_dump(tmp_path):
    """solver.h:724-734: per-iteration (J, residuals, gradient, x, delta,
    radius) dumps in npz format (the role of
    DumpLinearLeastSquaresProblem)."""
    import glob
    import jax.numpy as jnp

    def f(x):
        return jnp.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])

    x = np.array([-1.2, 1.0])
    problem = ct.Problem()
    problem.add_residual_block(ct.AutoDiffCostFunction(f, 2, [2]), None, x)
    options = ct.SolverOptions(
        max_num_iterations=5,
        fused_iterations=False,
        trust_region_problem_dump_directory=str(tmp_path))
    ct.solve(options, problem)
    files = sorted(glob.glob(str(tmp_path / "ceres_tpu_iteration_*.npz")))
    assert len(files) >= 2
    d = np.load(files[0])
    assert d["J"].shape == (2, 2)
    assert d["residuals"].shape == (2,)
    assert np.isfinite(d["radius"])


def test_trust_region_dump_iteration_filter_and_console(tmp_path, capsys):
    """solver.h:706-734: trust_region_minimizer_iterations_to_dump limits
    which iterations dump; CONSOLE format logs instead of writing files."""
    import glob
    import jax.numpy as jnp

    def f(x):
        return jnp.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])

    x = np.array([-1.2, 1.0])
    problem = ct.Problem()
    problem.add_residual_block(ct.AutoDiffCostFunction(f, 2, [2]), None, x)
    ct.solve(ct.SolverOptions(
        max_num_iterations=6, fused_iterations=False,
        trust_region_problem_dump_directory=str(tmp_path),
        trust_region_minimizer_iterations_to_dump=[2, 3]), problem)
    files = sorted(glob.glob(str(tmp_path / "ceres_tpu_iteration_*.npz")))
    assert [f[-7:-4] for f in files] == ["002", "003"]

    x2 = np.array([-1.2, 1.0])
    problem2 = ct.Problem()
    problem2.add_residual_block(ct.AutoDiffCostFunction(f, 2, [2]), None, x2)
    ct.solve(ct.SolverOptions(
        max_num_iterations=3, fused_iterations=False,
        trust_region_problem_dump_directory=str(tmp_path / "console"),
        trust_region_problem_dump_format_type=ct.DumpFormatType.CONSOLE),
        problem2)
    out = capsys.readouterr().out
    assert "ceres_tpu iteration 1" in out
    assert not glob.glob(str(tmp_path / "console" / "*.npz"))


def test_console_dump_needs_no_directory(capsys):
    """solver.h: the dump directory is only used by TEXTFILE; CONSOLE
    logging works without one (and routes to the host loop)."""
    import jax.numpy as jnp

    def f(x):
        return jnp.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])

    x = np.array([-1.2, 1.0])
    problem = ct.Problem()
    problem.add_residual_block(ct.AutoDiffCostFunction(f, 2, [2]), None, x)
    ct.solve(ct.SolverOptions(
        max_num_iterations=2,
        trust_region_problem_dump_format_type=ct.DumpFormatType.CONSOLE),
        problem)
    out = capsys.readouterr().out
    assert "ceres_tpu iteration 1" in out
