"""Fused trust-region solve: the ENTIRE LM loop as one lax.while_loop in one
jitted device program.

No reference analog — the reference's minimizer is a host loop by nature
(trust_region_minimizer.cc); on an accelerator the dominant cost of a host
loop is dispatch and synchronization latency per iteration, so the
production path fuses linearize + scale + damp + linear solve + Plus +
cost + accept/reject + radius update + convergence tests into a single XLA
while loop. One device call per SOLVE, not per iteration.

Semantics match the host-loop minimizer for the common configuration:
LM (or dogleg) strategy, monotone steps, no callbacks, no bounds line
search, no inner iterations. The host loop remains the general path
(callbacks, nonmonotonic steps, logging, per-iteration summaries).

Termination codes: 0 running, 1 gradient tol, 2 function tol, 3 parameter
tol, 4 min trust-region radius, 5 max iterations, 6 too many invalid steps.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..types import TerminationType

TERMINATION_BY_CODE = {
    1: (TerminationType.CONVERGENCE, "Gradient tolerance reached."),
    2: (TerminationType.CONVERGENCE, "Function tolerance reached."),
    3: (TerminationType.CONVERGENCE, "Parameter tolerance reached."),
    4: (TerminationType.CONVERGENCE, "Minimum trust region radius reached."),
    5: (TerminationType.NO_CONVERGENCE, "Maximum number of iterations reached."),
    6: (TerminationType.FAILURE,
        "Number of consecutive invalid steps exceeded the maximum."),
}


class FusedResult(NamedTuple):
    """Host-side view of a fused solve result.

    On device the solve returns (x, stats[8]) — the scalars packed into ONE
    f64 vector, because each extra pytree leaf costs a separate transfer in
    jax.device_get. int64 linear-iteration counts are exact in f64 up to
    2^53."""
    x: jnp.ndarray
    cost: float
    initial_cost: float
    iterations: int
    successful_steps: int
    unsuccessful_steps: int
    termination_code: int
    gradient_max_norm: float
    total_linear_iterations: int

    @classmethod
    def unpack(cls, x, stats):
        s = [float(v) for v in stats]
        return cls(x=x, cost=s[0], initial_cost=s[1], iterations=int(s[2]),
                   successful_steps=int(s[3]), unsuccessful_steps=int(s[4]),
                   termination_code=int(s[5]), gradient_max_norm=s[6],
                   total_linear_iterations=int(s[7]))


def make_fused_tr_solve(program, options, freeze_done: bool = False):
    """Returns a raw (unjitted) fused solve: x0 -> FusedResult.

    freeze_done=True makes the loop body a no-op for a state whose
    termination code is already set. Single solves never need it (the
    while condition guards the body), but under vmap (batch.py) the loop
    runs until EVERY batch element terminates, and without the guard a
    finished element would keep taking (tiny) steps."""
    from ..solver import make_scale_impl, make_step_impl

    step_impl = make_step_impl(program, options)
    scale_impl = make_scale_impl(program, options)
    cost_eval = program.cost_fn
    dtype = program.dtype
    gtol = options.gradient_tolerance
    ftol = options.function_tolerance
    ptol = options.parameter_tolerance
    min_rel_decrease = options.min_relative_decrease
    max_iters = options.max_num_iterations
    min_radius = options.min_trust_region_radius
    max_radius = options.max_trust_region_radius
    max_invalid = options.max_num_consecutive_invalid_steps
    from ..types import TrustRegionStrategyType
    lm_strategy = (options.trust_region_strategy_type
                   == TrustRegionStrategyType.LEVENBERG_MARQUARDT)

    # Rejected-step fast path: when the step implementation exposes
    # radius-independent linearization artifacts (schur_fused split
    # phases), re-linearize only after ACCEPTED steps — rejections redo
    # just the damped solve, matching the reference's Jacobian/diagonal
    # reuse across rejections (levenberg_marquardt_strategy.cc
    # reuse_diagonal_).
    split = bool(getattr(step_impl, "split_ok", False))

    def solve(x0):
        cost0 = cost_eval(x0)
        if split:
            # Seed the carry with a ZERO art and relin=True: iteration 1
            # then linearizes inside the loop's cond, so the lin-phase
            # graph is traced exactly once. (An outside-the-loop
            # linearize would be a second full copy of the biggest
            # subgraph — XLA cannot CSE across the while_loop boundary —
            # and measurably inflates the compile.) The iteration-0
            # Jacobi scaling (trust_region_minimizer.cc:261-277) is
            # likewise derived INSIDE the first linearize from its own
            # Gram diagonals and carried via art["s_e"]/["s_f"] — a
            # scale pass at x0 would be yet another linearize copy.
            scale0 = None
            se_sd, sf_sd = step_impl.scale_carry_example
            art0 = jax.tree_util.tree_map(
                lambda sd: jnp.zeros(sd.shape, sd.dtype),
                jax.eval_shape(step_impl.linearize_carry, x0,
                               se_sd, sf_sd,
                               jax.ShapeDtypeStruct((), jnp.bool_),
                               jax.ShapeDtypeStruct((), dtype)))
        else:
            # Jacobi scaling fixed at iteration 0 for the whole solve.
            scale0 = scale_impl(x0)
            art0 = None

        def cond(s):
            return s["code"] == 0

        def body(s):
            if split:
                # s["cost"] is the f64 cost at s["x"] (iteration 0: the
                # outside-the-loop cost0; later: the accepted candidate's
                # cost) — carried into the linearize so the lin phase
                # skips its own f64 residual pass.
                # Unconditional relinearize is the DEFAULT: the lax.cond
                # that skips the lin phase on rejected steps costs a
                # conditional and an art-carry pass-through EVERY
                # iteration, while the extra linearize at the UNCHANGED
                # x of a rejected step is paid only on rejections.
                # Relinearizing at the same x is deterministic, so the
                # trajectory is identical either way.
                # CERES_TPU_RELIN_COND=1 restores the conditional.
                import os as _os
                if _os.environ.get("CERES_TPU_RELIN_COND"):
                    art = jax.lax.cond(
                        s["relin"],
                        lambda _: step_impl.linearize_carry(
                            s["x"], s["art"]["s_e"], s["art"]["s_f"],
                            s["iter"] == 0, s["cost"]),
                        lambda _: s["art"],
                        operand=None)
                else:
                    art = step_impl.linearize_carry(
                        s["x"], s["art"]["s_e"], s["art"]["s_f"],
                        s["iter"] == 0, s["cost"])
                out = step_impl.solve_from(art, s["radius"])
            else:
                art = None
                out = step_impl(s["x"], s["radius"], scale0)
            cost = out["cost"]
            grad_max = out["gradient_max_norm"]
            mcc = out["model_cost_change"]
            step_norm = out["step_norm"]

            step_valid = (jnp.isfinite(mcc) & (mcc > 0.0)
                          & jnp.isfinite(step_norm))
            x_new = program.plus(s["x"], out["delta"])
            new_cost = cost_eval(x_new)
            rel_dec = (cost - new_cost) / jnp.where(mcc == 0, 1.0, mcc)
            accept = (step_valid & jnp.isfinite(new_cost)
                      & (rel_dec > min_rel_decrease))

            if lm_strategy:
                # LM radius update (levenberg_marquardt_strategy.cc).
                grow = s["radius"] / jnp.maximum(
                    1.0 / 3.0, 1.0 - (2.0 * rel_dec - 1.0) ** 3)
                radius_acc = jnp.minimum(grow, max_radius)
                radius_rej = s["radius"] / s["decrease_factor"]
                radius = jnp.where(accept, radius_acc, radius_rej)
                decrease_factor = jnp.where(accept, 2.0,
                                            2.0 * s["decrease_factor"])
            else:
                # Dogleg radius rules (dogleg_strategy.cc): grow 3x on a
                # strong step, halve on rejection.
                radius_acc = jnp.where(rel_dec > 0.75,
                                       jnp.minimum(3.0 * s["radius"],
                                                   max_radius),
                                       s["radius"])
                radius = jnp.where(accept, radius_acc, 0.5 * s["radius"])
                decrease_factor = s["decrease_factor"]

            invalid = jnp.where(step_valid, 0, s["invalid"] + 1)
            it = s["iter"] + 1

            candidate_ok = step_valid & jnp.isfinite(new_cost)
            had_success = (s["ok_steps"] > 0) | accept

            code = jnp.asarray(0, jnp.int32)
            # priority mirrors the host loop / reference check order
            # (tolerances tested on the CANDIDATE, before accept/reject,
            # trust_region_minimizer.cc:110-116).
            code = jnp.where((code == 0) & (grad_max <= gtol), 1, code)
            code = jnp.where(
                (code == 0) & candidate_ok
                & (jnp.abs(cost - new_cost) <= ftol * cost)
                & (accept | (jnp.abs(mcc) <= ftol * cost)), 2, code)
            # Negligible model cost change on an invalid step = converged
            # at rounding level, not a failure.
            code = jnp.where(
                (code == 0) & ~step_valid & jnp.isfinite(mcc)
                & (jnp.abs(mcc) <= ftol * cost), 2, code)
            code = jnp.where(
                (code == 0) & candidate_ok & had_success
                & (step_norm <= ptol * (program.state_norm(s["x"])
                                        + ptol)),
                3, code)
            code = jnp.where((code == 0) & (radius < min_radius), 4, code)
            code = jnp.where((code == 0) & (it >= max_iters), 5, code)
            code = jnp.where((code == 0) & (invalid >= max_invalid), 6, code)

            # Keep the candidate when accepted, or when terminating on
            # function tolerance with an improving candidate.
            take = accept | ((code == 2) & candidate_ok
                             & (new_cost < cost))
            x_out = jnp.where(take, x_new, s["x"])
            cost_out = jnp.where(take, new_cost, cost)

            nxt = {
                "x": x_out,
                "cost": cost_out,
                "radius": radius,
                "decrease_factor": decrease_factor,
                "iter": it,
                "invalid": invalid,
                "code": code,
                "ok_steps": s["ok_steps"] + jnp.where(accept, 1, 0),
                "bad_steps": s["bad_steps"] + jnp.where(accept, 0, 1),
                "grad_max": grad_max,
                "lin_iters": s["lin_iters"]
                + out["lin_iters"].astype(jnp.int64),
            }
            if split:
                nxt["art"] = art
                nxt["relin"] = accept   # x changed -> re-linearize next
            if freeze_done:
                live = s["code"] == 0
                nxt = jax.tree_util.tree_map(
                    lambda n, o: jnp.where(live, n, o), nxt, s)
            return nxt

        init = {
            "x": x0,
            "cost": cost0,
            "radius": jnp.asarray(options.initial_trust_region_radius,
                                  dtype=dtype),
            "decrease_factor": jnp.asarray(2.0, dtype=dtype),
            "iter": jnp.asarray(0, jnp.int32),
            "invalid": jnp.asarray(0, jnp.int32),
            "code": jnp.asarray(
                0 if options.max_num_iterations > 0 else 5, jnp.int32),
            "ok_steps": jnp.asarray(0, jnp.int32),
            "bad_steps": jnp.asarray(0, jnp.int32),
            "grad_max": jnp.asarray(jnp.inf, dtype=dtype),
            "lin_iters": jnp.asarray(0, jnp.int64),
        }
        if split:
            init["art"] = art0
            init["relin"] = jnp.asarray(True)
        s = jax.lax.while_loop(cond, body, init)
        stats = jnp.stack([
            s["cost"].astype(jnp.float64),
            cost0.astype(jnp.float64),
            s["iter"].astype(jnp.float64),
            s["ok_steps"].astype(jnp.float64),
            s["bad_steps"].astype(jnp.float64),
            s["code"].astype(jnp.float64),
            s["grad_max"].astype(jnp.float64),
            s["lin_iters"].astype(jnp.float64),
        ])
        return s["x"], stats

    return solve


def run_fused(program, options, summary):
    """Execute the fused solve and fill the summary. Returns final x."""
    import time

    t0 = time.time()
    solve = program.cached_jit(
        ("fused", options.cache_key()),
        lambda: program.jit_with_consts(
            make_fused_tr_solve(program, options), (program.example_x(),)))
    x_dev, stats_dev = solve(program.initial_state())
    # ONE host transfer for the whole result: the summary scalars come
    # back packed in a single f64 vector alongside x. With deferred
    # write-back only the stats vector is downloaded; x stays
    # device-resident until summary.write_back().
    if options.defer_parameter_writeback:
        stats = jax.device_get(stats_dev)
        result = FusedResult.unpack(x_dev, stats)
    else:
        stats, x_host = jax.device_get((stats_dev, x_dev))
        result = FusedResult.unpack(x_host, stats)
    summary.minimizer_time_in_seconds = time.time() - t0
    summary.initial_cost = float(result.initial_cost)
    summary.final_cost = float(result.cost)
    summary.num_successful_steps = int(result.successful_steps)
    summary.num_unsuccessful_steps = int(result.unsuccessful_steps)
    summary.num_linear_solves = int(result.iterations)
    summary.num_linear_solver_iterations = int(
        result.total_linear_iterations)
    summary.num_iterations_fused = int(result.iterations)
    # Evaluator call counts, derived from the device-loop statistics:
    # one fused linearize per accepted step (+ the initial one), one
    # candidate residual pass per iteration (+ iteration 0).
    summary.num_jacobian_evaluations = int(result.successful_steps) + 1
    summary.num_residual_evaluations = int(result.iterations) + 1
    code = int(result.termination_code)
    term, msg = TERMINATION_BY_CODE.get(
        code, (TerminationType.FAILURE, f"unknown code {code}"))
    summary.termination_type = term
    summary.message = msg + " (fused mode: per-iteration summaries disabled)"
    return result.x
