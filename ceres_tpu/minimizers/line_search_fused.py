"""Fused line-search minimizer: the WHOLE steepest-descent / NLCG /
L-BFGS / BFGS loop — including the Armijo / Wolfe searches — inside one
`lax.while_loop`, so a general minimization runs as a single device
dispatch (the line-search analog of minimizers/fused.py; the reference's
LineSearchMinimizer, line_search_minimizer.cc:85, has one host round
trip per function probe).

The control logic mirrors minimizers/line_search.py statement-for-
statement — same initial-step policy, direction-restart ladder, Wolfe
bracket + zoom (Nocedal & Wright alg. 3.5/3.6), Armijo backtracking
with cubic/quadratic interpolation (polynomial.cc role) — but in traced
arithmetic: every host `if` becomes `jnp.where` / `lax.cond`, the LBFGS
history a fixed `[m, n]` rolling buffer with masked two-loop recursion.

No reference analog runs the minimizer on an accelerator; this is the
device-loop extension for gradient-problem serving (one dispatch per
solve instead of one per probe).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

from ..types import (LineSearchDirectionType,
                     LineSearchInterpolationType, LineSearchType,
                     NonlinearConjugateGradientType, SolverSummary,
                     TerminationType)

# Termination codes packed into the device stats vector.
_RUNNING = 0
_CONV_GRADIENT = 1
_CONV_FUNCTION = 2
_CONV_PARAMETER = 3
_MAX_ITERATIONS = 4
_LS_FAILURE = 5
_RESTART_FAILURE = 6

_MESSAGES = {
    _CONV_GRADIENT: "Gradient tolerance reached.",
    _CONV_FUNCTION: "Function tolerance reached.",
    _CONV_PARAMETER: "Parameter tolerance reached.",
    _MAX_ITERATIONS: "Maximum number of iterations reached.",
    _LS_FAILURE: "Line search failed to find a valid step.",
    _RESTART_FAILURE: "Line search direction failure: too many restarts.",
}


def _t_min_cubic(a_x, a_f, a_g, b_x, b_f, b_g, lo, hi):
    """Traced _min_cubic (line_search.py:35): minimizer of the cubic
    through (x, f, g) at two points, clamped to [lo, hi]; bisection on
    degeneracy."""
    half = 0.5 * (lo + hi)
    dx = a_x - b_x
    d1 = a_g + b_g - 3.0 * (a_f - b_f) / jnp.where(dx == 0, 1.0, dx)
    disc = d1 * d1 - a_g * b_g
    d2 = jnp.sign(b_x - a_x) * jnp.sqrt(jnp.maximum(disc, 0.0))
    denom = b_g - a_g + 2.0 * d2
    t = b_x - (b_x - a_x) * (b_g + d2 - d1) / jnp.where(denom == 0, 1.0,
                                                        denom)
    bad = ((disc < 0) | (a_x == b_x) | (denom == 0)
           | ~jnp.isfinite(t))
    return jnp.where(bad, half, jnp.clip(t, lo, hi))


def _t_min_quadratic(a_x, a_f, a_g, b_x, b_f, lo, hi):
    half = 0.5 * (lo + hi)
    denom = 2.0 * (b_f - a_f - a_g * (b_x - a_x))
    t = a_x - a_g * (b_x - a_x) ** 2 / jnp.where(denom == 0, 1.0, denom)
    bad = (denom <= 0) | (a_x == b_x) | ~jnp.isfinite(t)
    return jnp.where(bad, half, jnp.clip(t, lo, hi))


def make_fused_ls_solve(program, options):
    """Returns a raw (unjitted) fused line-search solve:
    x0 -> (x, stats[7]) with stats = [final_cost, initial_cost,
    iterations, successful_steps, function_evaluations, termination_code,
    gradient_max_norm]."""
    dtype = program.dtype
    n = program.num_effective
    dir_type = options.line_search_direction_type
    want_wolfe = options.line_search_type == LineSearchType.WOLFE
    interp = options.line_search_interpolation_type
    c1 = options.line_search_sufficient_function_decrease
    c2 = options.line_search_sufficient_curvature_decrease
    ls_iters = options.max_num_line_search_step_size_iterations
    min_step = options.min_line_search_step_size
    max_expand = options.max_line_search_step_expansion
    max_contract = options.max_line_search_step_contraction
    min_contract = options.min_line_search_step_contraction
    max_restarts = options.max_num_line_search_direction_restarts
    gtol = options.gradient_tolerance
    ftol = options.function_tolerance
    ptol = options.parameter_tolerance
    max_iters = options.max_num_iterations
    use_scaling = options.use_approximate_eigenvalue_bfgs_scaling
    m = options.max_lbfgs_rank
    cg_type = options.nonlinear_conjugate_gradient_type

    SD = LineSearchDirectionType.STEEPEST_DESCENT
    NLCG = LineSearchDirectionType.NONLINEAR_CONJUGATE_GRADIENT
    LBFGS = LineSearchDirectionType.LBFGS
    BFGS = LineSearchDirectionType.BFGS

    if hasattr(program, "cost_and_gradient_fn"):
        cost_and_grad = program.cost_and_gradient_fn
    else:
        def cost_and_grad(x):
            c, g, _, _ = program.linearize_fn(x)
            return c, g
    plus = program.plus

    # ---- direction-model state (fixed shapes) ----
    def model_init():
        if dir_type == LBFGS:
            return dict(S=jnp.zeros((m, n), dtype),
                        Y=jnp.zeros((m, n), dtype),
                        rho=jnp.zeros((m,), dtype),
                        k=jnp.asarray(0, jnp.int32))
        if dir_type == BFGS:
            return dict(H=jnp.eye(n, dtype=dtype),
                        first=jnp.asarray(True))
        return dict()

    def model_update(st, s, y):
        """Secant update; skipped when s'y is not positive enough
        (low_rank_inverse_hessian.cc:70 / BFGS first-update scaling)."""
        sy = jnp.vdot(s, y)
        ok = sy > 1e-14
        if dir_type == LBFGS:
            S, Y, rho, k = st["S"], st["Y"], st["rho"], st["k"]
            full = k == m
            S2 = jnp.where(full, jnp.roll(S, -1, axis=0), S)
            Y2 = jnp.where(full, jnp.roll(Y, -1, axis=0), Y)
            r2 = jnp.where(full, jnp.roll(rho, -1), rho)
            idx = jnp.where(full, m - 1, k)
            S2 = S2.at[idx].set(s)
            Y2 = Y2.at[idx].set(y)
            r2 = r2.at[idx].set(1.0 / jnp.where(ok, sy, 1.0))
            k2 = jnp.minimum(k + 1, m)
            return dict(S=jnp.where(ok, S2, S), Y=jnp.where(ok, Y2, Y),
                        rho=jnp.where(ok, r2, rho),
                        k=jnp.where(ok, k2, k))
        if dir_type == BFGS:
            H, first = st["H"], st["first"]
            Hs = jnp.where(first & ok & use_scaling,
                           H * (sy / jnp.vdot(y, y)), H)
            rho_s = 1.0 / jnp.where(ok, sy, 1.0)
            I = jnp.eye(n, dtype=dtype)
            V = I - rho_s * jnp.outer(s, y)
            Hn = V @ Hs @ V.T + rho_s * jnp.outer(s, s)
            return dict(H=jnp.where(ok, Hn, H),
                        first=jnp.where(ok, False, first))
        return st

    def model_apply(st, g):
        """Two-loop recursion over the masked rolling history
        (low_rank_inverse_hessian.cc:87), or dense H g."""
        if dir_type == LBFGS:
            S, Y, rho, k = st["S"], st["Y"], st["rho"], st["k"]

            def bwd(i, carry):
                q, alphas = carry
                j = m - 1 - i
                valid = j < k
                a = jnp.where(valid, rho[j] * jnp.vdot(S[j], q), 0.0)
                return q - a * Y[j], alphas.at[j].set(a)

            q, alphas = jax.lax.fori_loop(
                0, m, bwd, (g, jnp.zeros((m,), dtype)))
            if use_scaling:
                last = jnp.maximum(k - 1, 0)
                gamma = jnp.where(
                    k > 0,
                    jnp.vdot(S[last], Y[last])
                    / jnp.maximum(jnp.vdot(Y[last], Y[last]), 1e-300),
                    1.0)
                q = q * gamma

            def fwd(j, q):
                valid = j < k
                b = jnp.where(valid, rho[j] * jnp.vdot(Y[j], q), 0.0)
                return q + (alphas[j] - b) * S[j]

            return jax.lax.fori_loop(0, m, fwd, q)
        if dir_type == BFGS:
            return st["H"] @ g
        return g

    # ---- line searches (phi(a) = cost/dir-gradient along direction) ----
    def make_phi(x, direction):
        def phi(a):
            xa = plus(x, a * direction)
            c, g = cost_and_grad(xa)
            return c, jnp.vdot(g, direction)
        return phi

    def armijo(phi, phi0, dphi0, step0):
        """Backtracking with interpolation (line_search.py:162-184).
        Returns (step, f, evals); step=0 signals failure."""
        def body(state):
            a, a_prev, f_prev, g_prev, i, step, f_acc, evals = state
            f, df = phi(a)
            evals = evals + 1
            ok = jnp.isfinite(f) & (f <= phi0 + c1 * a * dphi0)
            lo = a * max_contract
            hi = a * min_contract
            if interp == LineSearchInterpolationType.CUBIC:
                a_interp = _t_min_cubic(a_prev, f_prev, g_prev, a,
                                        jnp.where(jnp.isfinite(f), f, phi0),
                                        jnp.where(jnp.isfinite(df), df, 0.0),
                                        lo, hi)
                a_new = jnp.where(jnp.isfinite(f) & jnp.isfinite(df),
                                  a_interp, 0.5 * (lo + hi))
            elif interp == LineSearchInterpolationType.QUADRATIC:
                a_new = jnp.where(
                    jnp.isfinite(f),
                    _t_min_quadratic(0.0, phi0, dphi0, a,
                                     jnp.where(jnp.isfinite(f), f, phi0),
                                     lo, hi),
                    0.5 * (lo + hi))
            else:
                a_new = 0.5 * (lo + hi)
            step = jnp.where(ok, a, 0.0)
            f_acc = jnp.where(ok, f, f_acc)
            # stop on success or when the step underflows
            i = jnp.where(ok | (a_new < min_step), ls_iters, i + 1)
            return (a_new, a, f, df, i, step, f_acc, evals)

        def cond(state):
            return state[4] < ls_iters

        init = (jnp.asarray(step0, dtype), jnp.asarray(0.0, dtype),
                phi0, dphi0, jnp.asarray(0, jnp.int32),
                jnp.asarray(0.0, dtype), phi0, jnp.asarray(0, jnp.int32))
        out = jax.lax.while_loop(cond, body, init)
        return out[5], out[6], out[7]

    def wolfe(phi, phi0, dphi0, step0):
        """Bracket + zoom (line_search.py:186-232). Returns
        (step, f, evals); step=0 signals failure."""
        # --- bracketing phase ---
        # state: a_prev,f_prev,g_prev, a, i, status(0 run,1 success,
        #        2 bracketed), bracket 6-tuple, evals
        def b_body(st):
            (a_prev, f_prev, g_prev, a, i, status, br, evals) = st
            f, df = phi(a)
            evals = evals + 1
            fail_hi = (~jnp.isfinite(f)) | (f > phi0 + c1 * a * dphi0) \
                | ((a_prev > 0) & (f >= f_prev))
            curv_ok = jnp.abs(df) <= c2 * jnp.abs(dphi0)
            pos_slope = df >= 0
            br_hi = (a_prev, f_prev, g_prev, a, f, df)
            br_pos = (a, f, df, a_prev, f_prev, g_prev)
            new_status = jnp.where(
                fail_hi, 2, jnp.where(curv_ok, 1,
                                      jnp.where(pos_slope, 2, 0)))
            pick = jnp.where(fail_hi, 0.0, 1.0)   # 0 -> br_hi, 1 -> br_pos
            br = tuple(jnp.where(new_status == 2,
                                 jnp.where(pick == 0.0, h, p), b)
                       for h, p, b in zip(br_hi, br_pos, br))
            # accepted point (status 1) is carried in a/f via br[3]/br[4]?
            # store it in the bracket slots 0/1 for uniform extraction
            br = tuple(jnp.where(new_status == 1, v, b)
                       for v, b in zip((a, f, df, a, f, df), br))
            cont = new_status == 0
            a_prev2 = jnp.where(cont, a, a_prev)
            f_prev2 = jnp.where(cont, f, f_prev)
            g_prev2 = jnp.where(cont, df, g_prev)
            # expand toward the reference's bracketing bound
            # step_{k+1} <= step_k * max_step_expansion (line_search.cc:641)
            a2 = jnp.where(cont, a * max_expand, a)
            i2 = jnp.where(cont, i + 1, ls_iters)
            return (a_prev2, f_prev2, g_prev2, a2, i2,
                    jnp.maximum(status, new_status), br, evals)

        def b_cond(st):
            return st[4] < ls_iters

        zero = jnp.asarray(0.0, dtype)
        init = (zero, phi0, dphi0, jnp.asarray(step0, dtype),
                jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
                (zero, phi0, dphi0, zero, phi0, dphi0),
                jnp.asarray(0, jnp.int32))
        (a_prev, f_prev, g_prev, _a, _i, status, br, evals) = \
            jax.lax.while_loop(b_cond, b_body, init)

        # status 0: expansion budget exhausted — accept the last
        # Armijo-valid probe if any (line_search.py:204-208)
        no_br_ok = (f_prev <= phi0 + c1 * a_prev * dphi0) & (a_prev > 0)
        ls_step0 = jnp.where(
            status == 1, br[0],
            jnp.where((status == 0) & no_br_ok, a_prev, 0.0))
        ls_f0 = jnp.where(status == 1, br[1],
                          jnp.where((status == 0) & no_br_ok, f_prev,
                                    phi0))

        # --- zoom phase (only when status == 2) ---
        def z_body(st):
            lo_x, lo_f, lo_g, hi_x, hi_f, hi_g, i, step, facc, evals = st
            width_done = jnp.abs(hi_x - lo_x) < min_step
            mid_lo = jnp.minimum(lo_x, hi_x)
            mid_hi = jnp.maximum(lo_x, hi_x)
            width = mid_hi - mid_lo
            if interp == LineSearchInterpolationType.CUBIC:
                a = _t_min_cubic(lo_x, lo_f, lo_g, hi_x, hi_f,
                                 jnp.where(jnp.isfinite(hi_g), hi_g, 0.0),
                                 mid_lo + 0.1 * width,
                                 mid_hi - 0.1 * width)
            else:
                a = 0.5 * (lo_x + hi_x)
            f, df = phi(a)
            evals = evals + 1
            hi_cond = (~jnp.isfinite(f)) | (f > phi0 + c1 * a * dphi0) \
                | (f >= lo_f)
            curv_ok = (~hi_cond) & (jnp.abs(df) <= c2 * jnp.abs(dphi0))
            swap = (~hi_cond) & (df * (hi_x - lo_x) >= 0)
            hi_x2 = jnp.where(hi_cond, a, jnp.where(swap, lo_x, hi_x))
            hi_f2 = jnp.where(hi_cond, f, jnp.where(swap, lo_f, hi_f))
            hi_g2 = jnp.where(hi_cond, df, jnp.where(swap, lo_g, hi_g))
            lo_x2 = jnp.where(hi_cond, lo_x, a)
            lo_f2 = jnp.where(hi_cond, lo_f, f)
            lo_g2 = jnp.where(hi_cond, lo_g, df)
            step = jnp.where(curv_ok, a, step)
            facc = jnp.where(curv_ok, f, facc)
            i2 = jnp.where(curv_ok | width_done, ls_iters, i + 1)
            return (lo_x2, lo_f2, lo_g2, hi_x2, hi_f2, hi_g2, i2, step,
                    facc, evals)

        def z_cond(st):
            return st[6] < ls_iters

        def run_zoom(evals):
            lo_x, lo_f, lo_g, hi_x, hi_f, hi_g = br
            out = jax.lax.while_loop(
                z_cond, z_body,
                (lo_x, lo_f, lo_g, hi_x, hi_f, hi_g,
                 jnp.asarray(0, jnp.int32), zero, phi0, evals))
            lo_x2, lo_f2 = out[0], out[1]
            step, facc, evals2 = out[7], out[8], out[9]
            # zoom exhausted: accept lo endpoint when it improves
            # (line_search.py:230-231)
            fallback = (step == 0.0) & (lo_x2 > 0) & (lo_f2 < phi0)
            return (jnp.where(fallback, lo_x2, step),
                    jnp.where(fallback, lo_f2, facc), evals2)

        step_z, f_z, evals_z = jax.lax.cond(
            status == 2, run_zoom,
            lambda e: (ls_step0, ls_f0, e), evals)
        return step_z, f_z, evals_z

    line_search = wolfe if want_wolfe else armijo

    # ---- the outer loop ----
    def solve(x0):
        cost0, grad0 = cost_and_grad(x0)
        gmax0 = jnp.max(jnp.abs(grad0))
        gnsq0 = jnp.vdot(grad0, grad0)
        code0 = jnp.where(gmax0 <= gtol, _CONV_GRADIENT, _RUNNING
                          ).astype(jnp.int32)

        state0 = dict(
            x=x0, cost=cost0, prev_cost=cost0, grad=grad0,
            gnsq=gnsq0, gmax=gmax0, direction=-grad0,
            model=model_init(),
            restarts=jnp.asarray(0, jnp.int32),
            iteration=jnp.asarray(0, jnp.int32),
            evals=jnp.asarray(0, jnp.int32),
            successful=jnp.asarray(0, jnp.int32),
            code=code0,
        )

        def cond(st):
            return (st["code"] == _RUNNING) & (st["iteration"] < max_iters)

        def body(st):
            it = st["iteration"] + 1
            x, cost, grad = st["x"], st["cost"], st["grad"]
            direction = st["direction"]
            dphi0 = jnp.vdot(grad, direction)

            # direction restart (line_search.py:302-314)
            need_restart = dphi0 >= 0
            restarts = st["restarts"] + jnp.where(need_restart, 1, 0)
            too_many = restarts > max_restarts
            model = jax.tree_util.tree_map(
                lambda a, b: jnp.where(need_restart, a, b),
                model_init(), st["model"]) if st["model"] else st["model"]
            direction = jnp.where(need_restart, -grad, direction)
            dphi0 = jnp.where(need_restart, -st["gnsq"], dphi0)

            # initial step (line_search.py:316-326)
            if dir_type in (SD, NLCG):
                guess = 2.0 * (cost - st["prev_cost"]) / jnp.where(
                    dphi0 == 0, 1.0, dphi0)
                later = jnp.where(
                    (dphi0 != 0) & (cost != st["prev_cost"])
                    & (guess > 0) & jnp.isfinite(guess),
                    jnp.minimum(1.0, guess), 1.0)
            else:
                later = jnp.asarray(1.0, dtype)
            step0 = jnp.where(
                it == 1,
                jnp.minimum(1.0, 1.0 / jnp.sqrt(
                    jnp.maximum(st["gmax"], 1e-300))),
                later)

            phi = make_phi(x, direction)
            step, f_new, evals = line_search(phi, cost, dphi0, step0)
            ls_failed = step == 0.0

            delta = step * direction
            x_new = plus(x, delta)
            new_cost, new_grad = cost_and_grad(x_new)
            new_gmax = jnp.max(jnp.abs(new_grad))
            new_gnsq = jnp.vdot(new_grad, new_grad)
            step_norm = jnp.linalg.norm(delta)
            x_norm = (program.state_norm(x_new)
                      if hasattr(program, "state_norm")
                      else jnp.linalg.norm(x_new))
            cost_change = cost - new_cost

            # direction update (line_search.py:354-373)
            if dir_type == SD:
                new_direction = -new_grad
                new_model = model
            elif dir_type == NLCG:
                if cg_type == NonlinearConjugateGradientType.FLETCHER_REEVES:
                    beta = new_gnsq / st["gnsq"]
                elif cg_type == NonlinearConjugateGradientType.POLAK_RIBIERE:
                    beta = jnp.maximum(
                        jnp.vdot(new_grad, new_grad - grad) / st["gnsq"],
                        0.0)
                else:
                    dy = new_grad - grad
                    denom = jnp.vdot(direction, dy)
                    beta = jnp.where(denom == 0, 0.0,
                                     jnp.vdot(new_grad, dy)
                                     / jnp.where(denom == 0, 1.0, denom))
                new_direction = -new_grad + beta * direction
                new_model = model
            else:
                new_model = model_update(model, delta, new_grad - grad)
                new_direction = -model_apply(new_model, new_grad)

            # convergence tests (line_search.py:406-421)
            code = jnp.where(
                new_gmax <= gtol, _CONV_GRADIENT,
                jnp.where(
                    jnp.abs(cost_change) <= ftol * jnp.abs(cost),
                    _CONV_FUNCTION,
                    jnp.where(step_norm <= ptol * (x_norm + ptol),
                              _CONV_PARAMETER, _RUNNING))).astype(jnp.int32)
            code = jnp.where(ls_failed, _LS_FAILURE, code)
            code = jnp.where(too_many, _RESTART_FAILURE, code)

            accept = ~(ls_failed | too_many)

            def keep(new, old):
                return jnp.where(accept, new, old)

            return dict(
                x=keep(x_new, x), cost=keep(new_cost, cost),
                prev_cost=keep(cost, st["prev_cost"]),
                grad=keep(new_grad, grad),
                gnsq=keep(new_gnsq, st["gnsq"]),
                gmax=keep(new_gmax, st["gmax"]),
                direction=keep(new_direction, direction),
                model=(jax.tree_util.tree_map(keep, new_model, model)
                       if new_model else new_model),
                restarts=restarts, iteration=it,
                # count in-line-search probe evaluations only — the
                # outer-loop cost_and_grad at x_new is not a line-search
                # step (host path: line_search.py num_line_search_steps)
                evals=st["evals"] + evals,
                successful=st["successful"] + jnp.where(accept, 1, 0),
                code=code,
            )

        st = jax.lax.while_loop(cond, body, state0)
        code = jnp.where(st["code"] == _RUNNING, _MAX_ITERATIONS,
                         st["code"])
        stats = jnp.stack([
            st["cost"].astype(dtype), cost0.astype(dtype),
            st["iteration"].astype(dtype), st["successful"].astype(dtype),
            st["evals"].astype(dtype), code.astype(dtype),
            st["gmax"].astype(dtype)])
        return st["x"], stats

    return solve


def fused_line_search_ok(program, options) -> bool:
    """Configurations the device loop can serve (host-loop-only features
    mirror solver.py's device_loop_ok gate)."""
    return (not options.callbacks
            and not options.minimizer_progress_to_stdout
            and options.evaluation_callback is None
            and not options.update_state_every_iteration
            and options.max_solver_time_in_seconds >= 1e9
            and not getattr(program, "has_bounds", False))


def run_fused_line_search(program, options, summary: SolverSummary):
    """Jit + run the fused solve; unpack into the SolverSummary."""
    t0 = time.time()
    solve = make_fused_ls_solve(program, options)
    x0 = program.initial_state()
    jit_solve = getattr(program, "jit_with_consts", None)
    fn = (jit_solve(solve, (x0,)) if jit_solve is not None
          else jax.jit(solve))
    x, stats = fn(x0)
    stats = [float(v) for v in stats]
    summary.initial_cost = stats[1]
    summary.final_cost = stats[0]
    summary.num_successful_steps = int(stats[3])
    summary.num_line_search_steps = int(stats[4])
    code = int(stats[5])
    summary.termination_type = (
        TerminationType.CONVERGENCE if code in (
            _CONV_GRADIENT, _CONV_FUNCTION, _CONV_PARAMETER)
        else TerminationType.NO_CONVERGENCE if code == _MAX_ITERATIONS
        else TerminationType.FAILURE)
    summary.message = _MESSAGES.get(code, "")
    summary.minimizer_time_in_seconds = time.time() - t0
    # like minimizers/fused.py: no per-iteration records in the device
    # loop; the aggregate count feeds SolverSummary.num_iterations
    summary.num_iterations_fused = int(stats[2])
    return x
