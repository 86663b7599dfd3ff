"""Trust-region minimizer: the outer LM/Dogleg loop.

Capability parity with the reference's TrustRegionMinimizer
(trust_region_minimizer.cc:66-135), LevenbergMarquardtStrategy
(levenberg_marquardt_strategy.cc:68), and TrustRegionStepEvaluator
(trust_region_step_evaluator.h:78, nonmonotonic acceptance after
Conn/Gould/Toint section 10.1).

Structure: the outer loop stays in host Python (dynamic iteration counts,
callbacks, wall-clock budgets — matching the reference's split between
preprocessing and per-iteration work); each iteration issues exactly two
jitted device calls: `linearize_and_step` (evaluate J,r,g + linear solve)
and `try_step` (Plus + cost). Per-iteration host traffic is a handful of
scalars. A fully fused lax.while_loop path for benchmarking lives in
fused.py.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..types import (CallbackReturnType, IterationSummary, SolverSummary,
                     TerminationType, TrustRegionStrategyType)


class TrustRegionStepEvaluator:
    """Nonmonotonic step acceptance (trust_region_step_evaluator.h:78).

    With max_consecutive_nonmonotonic_steps = 0 this reduces to classic
    monotone acceptance."""

    def __init__(self, initial_cost: float,
                 max_consecutive_nonmonotonic_steps: int):
        self.max_consecutive_nonmonotonic_steps = (
            max_consecutive_nonmonotonic_steps)
        self.minimum_cost = initial_cost
        self.current_cost = initial_cost
        self.reference_cost = initial_cost
        self.candidate_cost = initial_cost
        self.accumulated_reference_model_cost_change = 0.0
        self.accumulated_candidate_model_cost_change = 0.0
        self.num_consecutive_nonmonotonic_steps = 0

    def step_quality(self, cost: float, model_cost_change: float) -> float:
        relative_decrease = (self.current_cost - cost) / model_cost_change
        historical_relative_decrease = (
            (self.reference_cost - cost)
            / (self.accumulated_reference_model_cost_change
               + model_cost_change))
        return max(relative_decrease, historical_relative_decrease)

    def step_accepted(self, cost: float, model_cost_change: float):
        self.current_cost = cost
        self.accumulated_candidate_model_cost_change += model_cost_change
        self.accumulated_reference_model_cost_change += model_cost_change
        if self.current_cost < self.minimum_cost:
            self.minimum_cost = self.current_cost
            self.num_consecutive_nonmonotonic_steps = 0
            self.candidate_cost = self.current_cost
            self.accumulated_candidate_model_cost_change = 0.0
        else:
            self.num_consecutive_nonmonotonic_steps += 1
            if self.current_cost > self.candidate_cost:
                self.candidate_cost = self.current_cost
                self.accumulated_candidate_model_cost_change = 0.0
        if (self.num_consecutive_nonmonotonic_steps
                == self.max_consecutive_nonmonotonic_steps):
            self.reference_cost = self.candidate_cost
            self.accumulated_reference_model_cost_change = (
                self.accumulated_candidate_model_cost_change)


class LevenbergMarquardtStrategy:
    """Radius bookkeeping (levenberg_marquardt_strategy.cc:68)."""

    def __init__(self, options):
        self.radius = options.initial_trust_region_radius
        self.max_radius = options.max_trust_region_radius
        self.decrease_factor = 2.0

    def step_accepted(self, step_quality: float):
        self.radius = self.radius / max(
            1.0 / 3.0, 1.0 - (2.0 * step_quality - 1.0) ** 3)
        self.radius = min(self.max_radius, self.radius)
        self.decrease_factor = 2.0

    def step_rejected(self):
        self.radius = self.radius / self.decrease_factor
        self.decrease_factor *= 2.0


class DoglegRadiusStrategy:
    """Dogleg radius bookkeeping (dogleg_strategy.cc). The dogleg radius is
    the trust region itself; on rejection halve, on strong acceptance grow."""

    def __init__(self, options):
        self.radius = options.initial_trust_region_radius
        self.max_radius = options.max_trust_region_radius

    def step_accepted(self, step_quality: float):
        if step_quality > 0.75:
            self.radius = min(self.max_radius, 3.0 * self.radius)

    def step_rejected(self):
        self.radius *= 0.5


def make_projected_line_search_fn(program, options):
    """Projected Armijo line search along the trust-region step
    (trust_region_minimizer.cc:101-106 + DoLineSearch :587): phi(s) =
    cost(Plus(x, s*delta)); Plus projects onto the bound box, so the search
    enforces feasibility while improving step quality. Backtracks with
    quadratic interpolation (line_search.cc ArmijoLineSearch), all inside one
    jitted lax.while_loop. Returns (x_new, new_cost, s_used, n_evals,
    state_norm(x_new))."""
    suff = options.line_search_sufficient_function_decrease
    max_iters = options.max_num_line_search_step_size_iterations
    min_step = options.min_line_search_step_size
    max_contract = options.max_line_search_step_contraction
    min_contract = options.min_line_search_step_contraction

    def ls(x, delta, cost0, gradient):
        dphi0 = jnp.vdot(gradient, delta)

        def phi(s):
            return program.cost_fn(program.plus(x, s * delta))

        def cond(state):
            s, it, success, dead = state
            return (~success) & (~dead) & (it < max_iters)

        def body(state):
            s, it, _, _ = state
            f_s = phi(s)
            ok = f_s <= cost0 + suff * s * dphi0
            denom = 2.0 * (f_s - cost0 - dphi0 * s)
            s_quad = jnp.where(denom > 0.0,
                               -dphi0 * s * s / denom, 0.5 * s)
            s_next = jnp.clip(s_quad, max_contract * s, min_contract * s)
            s_new = jnp.where(ok, s, s_next)
            return (s_new, it + 1, ok, s_new < min_step)

        one = jnp.asarray(1.0, dtype=program.dtype)
        s, n_evals, success, _ = jax.lax.while_loop(
            cond, body, (one, jnp.asarray(0, jnp.int32),
                         jnp.asarray(False), jnp.asarray(False)))
        # On failure keep the full step (reference DoLineSearch: delta is
        # only rescaled when the search succeeds).
        s_used = jnp.where(success, s, one)
        x_new = program.plus(x, s_used * delta)
        # state norm returned from INSIDE the jitted search — an eager
        # per-iteration norm would dispatch extra device programs
        return (x_new, program.cost_fn(x_new), s_used, n_evals,
                program.state_norm(x_new))

    return ls


def minimize_trust_region(program, options, step_fn: Callable,
                          summary: SolverSummary,
                          x0=None) -> np.ndarray:
    """Run the trust-region loop.

    step_fn(x, radius) -> dict of device scalars/arrays:
        cost, gradient (tangent), delta, model_cost_change, step_norm,
        lin_iters — one jitted call doing linearize + scale + linear solve
        (built by solver.py for the chosen linear solver).
    """
    t_start = time.time()
    dtype = program.dtype

    ex_x, ex_d = program.example_x(), program.example_delta()
    cost_eval = program.cached_jit(
        "cost_fn",
        lambda: program.jit_with_consts(program.cost_fn, (ex_x,)))
    plus = program.cached_jit(
        "plus", lambda: program.jit_with_consts(program.plus, (ex_x, ex_d)))

    def _try_step(xx, dd):
        """Candidate point + its cost + its norm in ONE device program, so
        the host pulls one tuple per iteration (each separate scalar pull
        is a full device roundtrip)."""
        x_new = program.plus(xx, dd)
        return x_new, program.cost_fn(x_new), program.state_norm(x_new)

    try_step = program.cached_jit(
        "try_step",
        lambda: program.jit_with_consts(_try_step, (ex_x, ex_d)))
    if program.has_bounds:
        def _pg_norm(x, grad):
            # Projected gradient max-norm: ||Plus(x, -g) - x||_inf
            return jnp.max(jnp.abs(program.plus(x, -grad) - x))
        pg_norm = program.cached_jit(
            "pg_norm",
            lambda: program.jit_with_consts(_pg_norm, (ex_x, ex_d)))
    else:
        pg_norm = None

    from ..types import DumpFormatType
    dump_dir = options.trust_region_problem_dump_directory
    console_dump = (options.trust_region_problem_dump_format_type
                    == DumpFormatType.CONSOLE)
    dump_fn = None
    if dump_dir or console_dump:
        # Per-iteration inner-problem dump (solver.h:724-734,
        # trust_region_minimizer.cc:383-392 DumpLinearLeastSquaresProblem):
        # the format here is one .npz per iteration with the dense
        # Jacobian, residuals, gradient, state, step and radius. CONSOLE
        # needs no directory (solver.h: directory only used by TEXTFILE).
        if dump_dir and not console_dump:
            import os as _os
            _os.makedirs(dump_dir, exist_ok=True)

        def _dump_arrays(xx):
            cost, grad, jac, res = program.linearize_fn(xx)
            return jac.to_dense(), res.flatten(), grad

        dump_fn = program.cached_jit(
            "dump_fn",
            lambda: program.jit_with_consts(_dump_arrays, (ex_x,)))

    proj_ls = None
    if (program.has_bounds
            and options.max_num_line_search_step_size_iterations > 0):
        ex_c = jnp.asarray(0.0, dtype=dtype)
        proj_ls = program.cached_jit(
            ("proj_ls", options.cache_key()),
            lambda: program.jit_with_consts(
                make_projected_line_search_fn(program, options),
                (ex_x, ex_d, ex_c, ex_d)))

    x = program.initial_state() if x0 is None else x0

    inner_fn = None
    if options.use_inner_iterations:
        from .coordinate_descent import make_inner_iteration_fn
        inner_fn = program.cached_jit(
            ("inner", options.cache_key()),
            lambda: program.jit_with_consts(
                make_inner_iteration_fn(program, options),
                (program.example_x(),)))

    if options.trust_region_strategy_type == \
            TrustRegionStrategyType.LEVENBERG_MARQUARDT:
        strategy = LevenbergMarquardtStrategy(options)
    else:
        strategy = DoglegRadiusStrategy(options)

    num_consecutive_invalid_steps = 0
    iteration = 0
    total_cost_eval_time = 0.0
    total_jacobian_time = 0.0
    total_solver_time = 0.0

    # Jacobi scaling fixed at iteration 0 for the whole solve
    # (trust_region_minimizer.cc:261-277 jacobian_scaling_).
    from ..solver import make_scale_fn
    scale0 = make_scale_fn(program, options)(x)

    # Iteration 0: pure evaluation (trust_region_minimizer IterationZero).
    t0 = time.time()
    cost = float(cost_eval(x))
    total_cost_eval_time += time.time() - t0
    summary.num_residual_evaluations += 1
    if not math.isfinite(cost):
        summary.termination_type = TerminationType.FAILURE
        summary.message = "Initial cost is not finite."
        return x
    summary.initial_cost = cost

    step_evaluator = TrustRegionStepEvaluator(
        cost,
        options.max_consecutive_nonmonotonic_steps
        if options.use_nonmonotonic_steps else 0)

    it0 = IterationSummary(
        iteration=0, cost=cost, step_is_valid=True,
        step_is_successful=True,
        trust_region_radius=strategy.radius,
        iteration_time_in_seconds=time.time() - t_start,
        cumulative_time_in_seconds=time.time() - t_start)
    summary.iterations.append(it0)

    def log_line(it: IterationSummary):
        if options.minimizer_progress_to_stdout:
            if it.iteration == 0:
                print("iter      cost      cost_change  |gradient|   |step|  "
                      "  tr_ratio  tr_radius  ls_iter  iter_time  total_time")
            print(f"{it.iteration:4d} {it.cost: 8.6e} "
                  f"{it.cost_change: 8.2e} {it.gradient_max_norm:8.2e} "
                  f"{it.step_norm:8.2e} {it.relative_decrease: 8.2e} "
                  f"{it.trust_region_radius:8.2e} "
                  f"{it.linear_solver_iterations:7d} "
                  f"{it.iteration_time_in_seconds:9.2e} "
                  f"{it.cumulative_time_in_seconds:10.2e}")

    log_line(it0)

    def run_callbacks(it: IterationSummary) -> Optional[TerminationType]:
        for cb in options.callbacks:
            ret = cb(it)
            if ret == CallbackReturnType.SOLVER_ABORT:
                summary.message = "Terminated by callback (abort)."
                return TerminationType.USER_FAILURE
            if ret == CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY:
                summary.message = "Terminated by callback."
                return TerminationType.USER_SUCCESS
        return None

    term = run_callbacks(it0)
    if term is not None:
        summary.termination_type = term
        summary.final_cost = cost
        return x

    x_norm = float(program.state_norm(x))
    reuse_linearization = False
    step_out = None

    while True:
        iteration += 1
        it_start = time.time()
        if iteration > options.max_num_iterations:
            summary.termination_type = TerminationType.NO_CONVERGENCE
            summary.message = "Maximum number of iterations reached."
            break
        if time.time() - t_start > options.max_solver_time_in_seconds:
            summary.termination_type = TerminationType.NO_CONVERGENCE
            summary.message = "Maximum solver time reached."
            break

        # Linearize + solve the trust-region subproblem (one device call).
        t0 = time.time()
        if options.evaluation_callback is not None:
            # evaluation_callback.h: jacobians will be evaluated at a new
            # point (x changed iff the last step was accepted).
            options.evaluation_callback.prepare_for_evaluation(
                evaluate_jacobians=True, new_evaluation_point=True)
        step_out = step_fn(x, jnp.asarray(strategy.radius, dtype=dtype),
                           scale0)
        pulls = {k: step_out[k] for k in
                 ("cost", "model_cost_change", "step_norm",
                  "gradient_norm", "lin_iters")}
        if program.has_bounds:
            pulls["grad_max"] = pg_norm(x, step_out["gradient_full"])
        else:
            pulls["grad_max"] = step_out["gradient_max_norm"]
        host = jax.device_get(pulls)   # ONE roundtrip for all scalars
        lin_cost = float(host["cost"])
        mcc = float(host["model_cost_change"])
        step_norm = float(host["step_norm"])
        grad_max = float(host["grad_max"])
        grad_norm = float(host["gradient_norm"])
        lin_iters = int(host["lin_iters"])
        t_solve = time.time() - t0
        total_solver_time += t_solve
        summary.num_linear_solves += 1
        summary.num_linear_solver_iterations += lin_iters
        summary.num_residual_evaluations += 1   # linearize includes r
        summary.num_jacobian_evaluations += 1

        it = IterationSummary(
            iteration=iteration, cost=cost,
            gradient_max_norm=grad_max, gradient_norm=grad_norm,
            trust_region_radius=strategy.radius,
            linear_solver_iterations=lin_iters,
            step_solver_time_in_seconds=t_solve)

        dump_this = dump_fn is not None and (
            not options.trust_region_minimizer_iterations_to_dump
            or iteration
            in options.trust_region_minimizer_iterations_to_dump)
        if dump_this:
            import os as _os
            from ..types import DumpFormatType
            Jd, rd, gd = jax.device_get(dump_fn(x))
            if (options.trust_region_problem_dump_format_type
                    == DumpFormatType.CONSOLE):
                # solver.h CONSOLE: log the inner problem (shapes + norms
                # here; the dense arrays would flood stdout at scale)
                print(f"ceres_tpu iteration {iteration}: J {Jd.shape} "
                      f"|J|_F={np.linalg.norm(Jd):.6e} "
                      f"|r|={np.linalg.norm(rd):.6e} "
                      f"|g|={np.linalg.norm(gd):.6e} "
                      f"radius={strategy.radius:.6e}")
            else:
                np.savez(
                    _os.path.join(
                        dump_dir,
                        f"ceres_tpu_iteration_{iteration:03d}.npz"),
                    J=Jd, residuals=rd, gradient=gd, x=np.asarray(x),
                    delta=np.asarray(step_out["delta"]),
                    radius=strategy.radius)

        # Gradient convergence (checked on the fresh linearization).
        if grad_max <= options.gradient_tolerance:
            summary.termination_type = TerminationType.CONVERGENCE
            summary.message = (
                f"Gradient tolerance reached. Gradient max norm: "
                f"{grad_max:e} <= {options.gradient_tolerance:e}")
            break

        step_is_valid = (math.isfinite(mcc) and mcc > 0.0
                         and math.isfinite(step_norm))
        if step_is_valid:
            # the counter tracks CONSECUTIVE invalid steps: any valid
            # step resets it, accepted or not
            # (trust_region_minimizer.cc:449)
            num_consecutive_invalid_steps = 0
        if not step_is_valid:
            # HandleInvalidStep (trust_region_minimizer.cc:464).
            if (math.isfinite(mcc)
                    and abs(mcc) <= options.function_tolerance * cost):
                # The model predicts no possible decrease beyond rounding:
                # this is convergence, not failure (resolves the
                # reference's TODO at trust_region_minimizer.cc:465-468 —
                # "model_cost_change ~ 0.0, but just slightly negative").
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = (
                    "Function tolerance reached. Model cost change "
                    f"{mcc:e} is negligible relative to the cost.")
                break
            num_consecutive_invalid_steps += 1
            if (num_consecutive_invalid_steps
                    >= options.max_num_consecutive_invalid_steps):
                summary.termination_type = TerminationType.FAILURE
                summary.message = (
                    f"Number of consecutive invalid steps more than "
                    f"{options.max_num_consecutive_invalid_steps}")
                break
            strategy.step_rejected()
            if strategy.radius < options.min_trust_region_radius:
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = "Minimum trust region radius reached."
                break
            it.step_is_valid = False
            it.step_is_successful = False
            it.iteration_time_in_seconds = time.time() - it_start
            it.cumulative_time_in_seconds = time.time() - t_start
            summary.iterations.append(it)
            summary.num_unsuccessful_steps += 1
            log_line(it)
            continue

        # Candidate evaluation.
        t0 = time.time()
        if options.evaluation_callback is not None:
            options.evaluation_callback.prepare_for_evaluation(
                evaluate_jacobians=False, new_evaluation_point=True)
        if proj_ls is not None:
            # Projected line search enforces bounds and improves the step
            # (trust_region_minimizer.cc:101-106).
            x_new, nc, s_used, n_evals, xn_new = proj_ls(
                x, step_out["delta"], step_out["cost"],
                step_out["gradient_full"])
            h2 = jax.device_get((nc, s_used, n_evals, xn_new))
            new_cost = float(h2[0])
            it.step_size = float(h2[1])
            it.line_search_function_evaluations = int(h2[2]) + 1
            new_x_norm = float(h2[3])
            step_norm = step_norm * it.step_size
            summary.num_residual_evaluations += int(h2[2]) + 1
        else:
            x_new, nc, xn = try_step(x, step_out["delta"])
            h2 = jax.device_get((nc, xn))
            new_cost = float(h2[0])
            new_x_norm = float(h2[1])
            summary.num_residual_evaluations += 1
        # Inner iterations refine the candidate before acceptance
        # (trust_region_minimizer.cc:506 DoInnerIterationsIfNeeded).
        if inner_fn is not None and math.isfinite(new_cost):
            t_in = time.time()
            x_refined = inner_fn(x_new)
            refined_cost = float(cost_eval(x_refined))
            summary.num_residual_evaluations += 1
            if math.isfinite(refined_cost) and refined_cost < new_cost:
                x_new, new_cost = x_refined, refined_cost
                # the accepted state changed: the parameter-tolerance
                # test and next iteration's x_norm must see the refined x
                new_x_norm = float(program.state_norm(x_new))
            summary.num_inner_iteration_steps += 1
            summary.inner_iteration_time_in_seconds += time.time() - t_in
        total_cost_eval_time += time.time() - t0

        if not math.isfinite(new_cost):
            relative_decrease = -1.0
        else:
            relative_decrease = step_evaluator.step_quality(new_cost, mcc)

        it.step_norm = step_norm
        it.relative_decrease = relative_decrease
        it.cost_change = cost - new_cost
        it.step_is_valid = True

        # Tolerance tests run on the CANDIDATE, before the accept/reject
        # decision (trust_region_minimizer.cc:110-116) — this is what ends
        # solves cleanly once candidate costs stop moving, even when the
        # step would be rejected.
        if math.isfinite(new_cost):
            if (summary.num_successful_steps > 0
                    and step_norm <= options.parameter_tolerance
                    * (x_norm + options.parameter_tolerance)):
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = "Parameter tolerance reached."
                it.iteration_time_in_seconds = time.time() - it_start
                it.cumulative_time_in_seconds = time.time() - t_start
                summary.iterations.append(it)
                log_line(it)
                break
            # A rejected candidate with a tiny cost change terminates only
            # when the model ALSO predicts negligible decrease — otherwise
            # a smaller radius can still make progress (keeps the solver
            # polishing on ill-conditioned problems; NIST tails).
            would_accept = relative_decrease > options.min_relative_decrease
            if (abs(cost - new_cost) <= options.function_tolerance * cost
                    and (would_accept
                         or abs(mcc) <= options.function_tolerance * cost)):
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = (
                    f"Function tolerance reached. |cost_change|/cost: "
                    f"{abs(cost - new_cost) / max(cost, 1e-300):e} <= "
                    f"{options.function_tolerance:e}")
                # Keep the candidate when it improves the cost (the
                # reference keeps x_, which equals the candidate when the
                # step was successful).
                if new_cost < cost:
                    x, cost = x_new, new_cost
                    x_norm = new_x_norm
                    it.cost = cost
                    it.step_is_successful = True
                    summary.num_successful_steps += 1
                it.iteration_time_in_seconds = time.time() - it_start
                it.cumulative_time_in_seconds = time.time() - t_start
                summary.iterations.append(it)
                log_line(it)
                break

        if relative_decrease > options.min_relative_decrease:
            # Accepted.
            num_consecutive_invalid_steps = 0
            it.step_is_successful = True
            it.step_is_nonmonotonic = new_cost > step_evaluator.minimum_cost
            strategy.step_accepted(relative_decrease)
            step_evaluator.step_accepted(new_cost, mcc)
            summary.num_successful_steps += 1

            # Convergence tests on the accepted step
            # (trust_region_minimizer.cc:314-358).
            cost_change = cost - new_cost
            x = x_new
            prev_cost = cost
            cost = new_cost
            x_norm = new_x_norm
            it.cost = cost
            if options.update_state_every_iteration:
                # solver.h:785: keep the user's arrays in sync so callbacks
                # observe the current state.
                program.write_back(x)

            if (abs(cost_change)
                    <= options.function_tolerance * prev_cost):
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = (
                    f"Function tolerance reached. |cost_change|/cost: "
                    f"{abs(cost_change) / max(prev_cost, 1e-300):e} <= "
                    f"{options.function_tolerance:e}")
                it.iteration_time_in_seconds = time.time() - it_start
                it.cumulative_time_in_seconds = time.time() - t_start
                summary.iterations.append(it)
                log_line(it)
                break
            if step_norm <= options.parameter_tolerance * (
                    x_norm + options.parameter_tolerance):
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = "Parameter tolerance reached."
                it.iteration_time_in_seconds = time.time() - it_start
                it.cumulative_time_in_seconds = time.time() - t_start
                summary.iterations.append(it)
                log_line(it)
                break
        else:
            it.step_is_successful = False
            strategy.step_rejected()
            summary.num_unsuccessful_steps += 1
            if strategy.radius < options.min_trust_region_radius:
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = "Minimum trust region radius reached."
                it.iteration_time_in_seconds = time.time() - it_start
                it.cumulative_time_in_seconds = time.time() - t_start
                summary.iterations.append(it)
                log_line(it)
                break

        it.trust_region_radius = strategy.radius
        it.iteration_time_in_seconds = time.time() - it_start
        it.cumulative_time_in_seconds = time.time() - t_start
        summary.iterations.append(it)
        log_line(it)

        term = run_callbacks(it)
        if term is not None:
            summary.termination_type = term
            break

    summary.final_cost = cost
    summary.linear_solver_time_in_seconds = total_solver_time
    summary.residual_evaluation_time_in_seconds = total_cost_eval_time
    summary.minimizer_time_in_seconds = time.time() - t_start
    return x
