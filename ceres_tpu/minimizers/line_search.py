"""Line-search minimizer: steepest descent / NLCG / L-BFGS / BFGS with
Armijo / Wolfe line searches.

Capability parity with the reference's LineSearchMinimizer
(line_search_minimizer.cc:85), LineSearchDirection
(line_search_direction.cc: STEEPEST_DESCENT, NONLINEAR_CONJUGATE_GRADIENT
FR/PR/HS, LBFGS, BFGS), LowRankInverseHessian (low_rank_inverse_hessian.cc:
two-loop recursion + Oren eigenvalue scaling), and the Armijo/Wolfe line
searches with polynomial interpolation (line_search.cc:71, polynomial.cc).

Direction updates are O(n) vector math on device; the bracketing logic is
host-side scalars (matching the reference's control structure, where each
probe is one function/gradient evaluation = one jitted device call here).
"""

from __future__ import annotations

import math
import time
from functools import lru_cache
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..types import (CallbackReturnType, IterationSummary,
                     LineSearchDirectionType, LineSearchInterpolationType,
                     LineSearchType, NonlinearConjugateGradientType,
                     SolverSummary, TerminationType)


# ----------------------------------------------------------------------
# polynomial interpolation (reference polynomial.cc MinimizePolynomial)

def _min_cubic(a_x, a_f, a_g, b_x, b_f, b_g, lo, hi):
    """Minimize the cubic interpolating (x,f,g) at two points; return the
    minimizer clamped to [lo, hi]. Falls back to bisection on degeneracy."""
    d1 = a_g + b_g - 3 * (a_f - b_f) / (a_x - b_x)
    disc = d1 * d1 - a_g * b_g
    if disc < 0 or a_x == b_x:
        return 0.5 * (lo + hi)
    d2 = math.copysign(math.sqrt(disc), b_x - a_x)
    denom = b_g - a_g + 2 * d2
    if denom == 0:
        return 0.5 * (lo + hi)
    t = b_x - (b_x - a_x) * (b_g + d2 - d1) / denom
    if not math.isfinite(t):
        return 0.5 * (lo + hi)
    return min(max(t, lo), hi)


def _min_quadratic(a_x, a_f, a_g, b_x, b_f, lo, hi):
    denom = 2.0 * (b_f - a_f - a_g * (b_x - a_x))
    if denom <= 0 or a_x == b_x:
        return 0.5 * (lo + hi)
    t = a_x - a_g * (b_x - a_x) ** 2 / denom
    if not math.isfinite(t):
        return 0.5 * (lo + hi)
    return min(max(t, lo), hi)


@lru_cache(maxsize=None)
def _lbfgs_two_loop(use_scaling: bool):
    """Jitted two-loop recursion over stacked correction pairs
    (low_rank_inverse_hessian.cc): the rank is static per trace, so the
    loops unroll into one fused device program."""

    @jax.jit
    def f(S, Y, rho, g):
        k = S.shape[0]
        q = g
        alphas = []
        for i in range(k - 1, -1, -1):
            a = rho[i] * jnp.vdot(S[i], q)
            alphas.append(a)
            q = q - a * Y[i]
        if use_scaling:
            # Oren's gamma = s'y / y'y scaling of the initial Hessian.
            q = (jnp.vdot(S[-1], Y[-1]) / jnp.vdot(Y[-1], Y[-1])) * q
        for i, a in zip(range(k), reversed(alphas)):
            b = rho[i] * jnp.vdot(Y[i], q)
            q = q + (a - b) * S[i]
        return q

    return f


class _LBFGS:
    """Two-loop recursion (low_rank_inverse_hessian.cc)."""

    def __init__(self, max_rank: int, use_eigenvalue_scaling: bool):
        self.max_rank = max_rank
        self.use_scaling = use_eigenvalue_scaling
        self.s_list = []
        self.y_list = []
        self.rho_list = []

    def update(self, s, y):
        sy = float(jnp.vdot(s, y))
        if sy <= 1e-14:
            return False
        if len(self.s_list) == self.max_rank:
            self.s_list.pop(0)
            self.y_list.pop(0)
            self.rho_list.pop(0)
        self.s_list.append(s)
        self.y_list.append(y)
        self.rho_list.append(1.0 / sy)
        return True

    def apply(self, g):
        # ONE jitted device program per rank (<= max_rank compiles of a
        # tiny graph) instead of 2*rank synchronous host pulls — each
        # float(vdot) is a full device roundtrip.
        if not self.s_list:
            return g
        S = jnp.stack(self.s_list)
        Y = jnp.stack(self.y_list)
        rho = jnp.asarray(self.rho_list, dtype=g.dtype)
        return _lbfgs_two_loop(self.use_scaling)(S, Y, rho, g)

    def reset(self):
        self.s_list, self.y_list, self.rho_list = [], [], []


class _BFGS:
    """Dense BFGS inverse-Hessian update (line_search_direction.cc BFGS)."""

    def __init__(self, n: int, use_eigenvalue_scaling: bool):
        self.H = jnp.eye(n, dtype=jnp.float64)
        self.first = True
        self.use_scaling = use_eigenvalue_scaling

    def update(self, s, y):
        sy = float(jnp.vdot(s, y))
        if sy <= 1e-14:
            return False
        if self.first and self.use_scaling:
            self.H = self.H * (sy / float(jnp.vdot(y, y)))
        self.first = False
        rho = 1.0 / sy
        I = jnp.eye(self.H.shape[0], dtype=self.H.dtype)
        V = I - rho * jnp.outer(s, y)
        self.H = V @ self.H @ V.T + rho * jnp.outer(s, s)
        return True

    def apply(self, g):
        return self.H @ g

    def reset(self):
        n = self.H.shape[0]
        self.H = jnp.eye(n, dtype=self.H.dtype)
        self.first = True


def _line_search(phi, phi0: float, dphi0: float, step0: float, options,
                 want_wolfe: bool):
    """Armijo backtracking or Wolfe bracketing-zoom search
    (line_search.cc ArmijoLineSearch / WolfeLineSearch).

    phi(a) -> (f, df) along the direction. Returns (step, f, evals) or
    (None, None, evals)."""
    c1 = options.line_search_sufficient_function_decrease
    c2 = options.line_search_sufficient_curvature_decrease
    max_iters = options.max_num_line_search_step_size_iterations
    min_step = options.min_line_search_step_size
    interp = options.line_search_interpolation_type
    max_expand = options.max_line_search_step_expansion

    evals = 0

    def probe(a):
        nonlocal evals
        evals += 1
        f, df = phi(a)
        return float(f), float(df)

    if not want_wolfe:
        # Armijo backtracking with interpolation.
        a = step0
        a_prev, f_prev, g_prev = 0.0, phi0, dphi0
        for _ in range(max_iters):
            f, df = probe(a)
            if math.isfinite(f) and f <= phi0 + c1 * a * dphi0:
                return a, f, evals
            lo = a * options.max_line_search_step_contraction
            hi = a * options.min_line_search_step_contraction
            if interp == LineSearchInterpolationType.CUBIC and \
                    math.isfinite(f) and math.isfinite(df):
                a_new = _min_cubic(a_prev, f_prev, g_prev, a, f, df, lo, hi)
            elif interp != LineSearchInterpolationType.BISECTION and \
                    math.isfinite(f):
                a_new = _min_quadratic(0.0, phi0, dphi0, a, f, lo, hi)
            else:
                a_new = 0.5 * (lo + hi)
            a_prev, f_prev, g_prev = a, f, df
            a = a_new
            if a < min_step:
                return None, None, evals
        return None, None, evals

    # Wolfe: bracketing phase then zoom (Nocedal & Wright alg. 3.5/3.6).
    a_prev, f_prev, g_prev = 0.0, phi0, dphi0
    a = step0
    bracket = None
    for _ in range(max_iters):
        f, df = probe(a)
        if (not math.isfinite(f)) or f > phi0 + c1 * a * dphi0 or \
                (a_prev > 0 and f >= f_prev):
            bracket = (a_prev, f_prev, g_prev, a, f, df)
            break
        if abs(df) <= c2 * abs(dphi0):
            return a, f, evals
        if df >= 0:
            bracket = (a, f, df, a_prev, f_prev, g_prev)
            break
        a_prev, f_prev, g_prev = a, f, df
        # expand toward the reference's bracketing bound
        # step_{k+1} <= step_k * max_step_expansion (line_search.cc:641)
        a = a * max_expand
    if bracket is None:
        # ran out of expansion budget; accept last Armijo-valid point if any
        if f_prev <= phi0 + c1 * a_prev * dphi0 and a_prev > 0:
            return a_prev, f_prev, evals
        return None, None, evals

    lo_x, lo_f, lo_g, hi_x, hi_f, hi_g = bracket
    for _ in range(max_iters):
        if abs(hi_x - lo_x) < min_step:
            break
        mid_lo, mid_hi = (min(lo_x, hi_x), max(lo_x, hi_x))
        width = mid_hi - mid_lo
        a = _min_cubic(lo_x, lo_f, lo_g, hi_x, hi_f,
                       hi_g if math.isfinite(hi_g) else 0.0,
                       mid_lo + 0.1 * width, mid_hi - 0.1 * width) \
            if interp == LineSearchInterpolationType.CUBIC else \
            0.5 * (lo_x + hi_x)
        f, df = probe(a)
        if (not math.isfinite(f)) or f > phi0 + c1 * a * dphi0 or f >= lo_f:
            hi_x, hi_f, hi_g = a, f, df
        else:
            if abs(df) <= c2 * abs(dphi0):
                return a, f, evals
            if df * (hi_x - lo_x) >= 0:
                hi_x, hi_f, hi_g = lo_x, lo_f, lo_g
            lo_x, lo_f, lo_g = a, f, df
    if lo_x > 0 and lo_f < phi0:
        return lo_x, lo_f, evals
    return None, None, evals


def minimize_line_search(program, options, summary: SolverSummary,
                         x0=None):
    """The outer loop (line_search_minimizer.cc:85)."""
    if options.fused_iterations and x0 is None:
        from .line_search_fused import (fused_line_search_ok,
                                        run_fused_line_search)
        if fused_line_search_ok(program, options):
            # write-back is the caller's job (solver.py /
            # solve_gradient_problem), as on the host-loop fallthrough
            return run_fused_line_search(program, options, summary)
    t_start = time.time()

    @jax.jit
    def cost_and_grad(x):
        c, g, _, _ = program.linearize_fn(x)
        return c, g

    # GradientProblem programs expose cost_and_gradient directly.
    if hasattr(program, "cost_and_gradient_fn"):
        cost_and_grad = jax.jit(program.cost_and_gradient_fn)

    plus = jax.jit(program.plus)
    x = program.initial_state() if x0 is None else x0

    dtype = program.dtype
    dir_type = options.line_search_direction_type
    n = program.num_effective

    if dir_type == LineSearchDirectionType.LBFGS:
        model = _LBFGS(options.max_lbfgs_rank,
                       options.use_approximate_eigenvalue_bfgs_scaling)
    elif dir_type == LineSearchDirectionType.BFGS:
        model = _BFGS(n, options.use_approximate_eigenvalue_bfgs_scaling)
    else:
        model = None

    cost, grad = cost_and_grad(x)
    summary.num_residual_evaluations += 1
    summary.num_jacobian_evaluations += 1
    cost = float(cost)
    summary.initial_cost = cost
    grad_norm_sq = float(jnp.vdot(grad, grad))
    grad_max = float(jnp.max(jnp.abs(grad)))

    it0 = IterationSummary(iteration=0, cost=cost,
                           gradient_max_norm=grad_max,
                           gradient_norm=math.sqrt(grad_norm_sq),
                           cumulative_time_in_seconds=time.time() - t_start)
    summary.iterations.append(it0)

    if grad_max <= options.gradient_tolerance:
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = "Gradient tolerance reached (initial point)."
        summary.final_cost = cost
        program.write_back(x)
        return x

    direction = -grad
    prev_grad = grad
    prev_direction = direction
    num_restarts = 0
    iteration = 0

    while True:
        iteration += 1
        it_t0 = time.time()
        if iteration > options.max_num_iterations:
            summary.termination_type = TerminationType.NO_CONVERGENCE
            summary.message = "Maximum number of iterations reached."
            break
        if time.time() - t_start > options.max_solver_time_in_seconds:
            summary.termination_type = TerminationType.NO_CONVERGENCE
            summary.message = "Maximum solver time reached."
            break

        dphi0 = float(jnp.vdot(grad, direction))
        if dphi0 >= 0:
            # Not a descent direction: restart with steepest descent
            # (line_search_minimizer.cc direction-restart logic).
            num_restarts += 1
            if num_restarts > options.max_num_line_search_direction_restarts:
                summary.termination_type = TerminationType.FAILURE
                summary.message = ("Line search direction failure: too many "
                                   "restarts.")
                break
            if model is not None:
                model.reset()
            direction = -grad
            dphi0 = -grad_norm_sq

        # Initial step size (line_search_minimizer.cc:200-230).
        if iteration == 1:
            step0 = min(1.0, 1.0 / math.sqrt(max(grad_max, 1e-300)))
        elif dir_type == LineSearchDirectionType.STEEPEST_DESCENT or \
                dir_type == LineSearchDirectionType.NONLINEAR_CONJUGATE_GRADIENT:
            step0 = min(1.0, 2.0 * (cost - prev_cost) / dphi0) \
                if dphi0 != 0 and cost != prev_cost else 1.0
            if step0 <= 0 or not math.isfinite(step0):
                step0 = 1.0
        else:
            step0 = 1.0

        def phi(a):
            xa = plus(x, a * direction)
            c, g = cost_and_grad(xa)
            return c, jnp.vdot(g, direction)

        want_wolfe = (options.line_search_type == LineSearchType.WOLFE)
        t_ls = time.time()
        step, f_new, evals = _line_search(phi, cost, dphi0, step0, options,
                                          want_wolfe)
        # phi evaluations are fused value_and_grad calls: the time is
        # reported under cost_evaluation, gradient stays 0 (solver.h
        # split not separable here; see SolverSummary field comment).
        summary.line_search_total_time_in_seconds += time.time() - t_ls
        summary.line_search_cost_evaluation_time_in_seconds += \
            time.time() - t_ls
        summary.num_line_search_steps += evals
        summary.num_residual_evaluations += evals
        summary.num_jacobian_evaluations += evals

        if step is None:
            summary.termination_type = TerminationType.FAILURE
            summary.message = ("Line search failed to find a valid step "
                               f"at iteration {iteration}.")
            break

        delta = step * direction
        x_new = plus(x, delta)
        new_cost, new_grad = cost_and_grad(x_new)
        summary.num_residual_evaluations += 1
        summary.num_jacobian_evaluations += 1
        new_cost = float(new_cost)
        new_grad_max = float(jnp.max(jnp.abs(new_grad)))
        new_grad_norm_sq = float(jnp.vdot(new_grad, new_grad))
        step_norm = float(jnp.linalg.norm(delta))
        x_norm = float(program.state_norm(x_new)
                       if hasattr(program, "state_norm")
                       else jnp.linalg.norm(x_new))
        cost_change = cost - new_cost

        # Direction update.
        if dir_type == LineSearchDirectionType.STEEPEST_DESCENT:
            new_direction = -new_grad
        elif dir_type == LineSearchDirectionType.NONLINEAR_CONJUGATE_GRADIENT:
            t = options.nonlinear_conjugate_gradient_type
            if t == NonlinearConjugateGradientType.FLETCHER_REEVES:
                beta = new_grad_norm_sq / grad_norm_sq
            elif t == NonlinearConjugateGradientType.POLAK_RIBIERE:
                beta = float(jnp.vdot(new_grad, new_grad - grad)) \
                    / grad_norm_sq
                beta = max(beta, 0.0)
            else:  # HESTENES_STIEFEL
                dy = new_grad - grad
                denom = float(jnp.vdot(direction, dy))
                beta = float(jnp.vdot(new_grad, dy)) / denom \
                    if denom != 0 else 0.0
            new_direction = -new_grad + beta * direction
        else:  # LBFGS / BFGS
            ok = model.update(delta, new_grad - grad)
            new_direction = -model.apply(new_grad)

        prev_cost = cost
        x, cost, grad = x_new, new_cost, new_grad
        grad_norm_sq = new_grad_norm_sq
        grad_max = new_grad_max
        direction = new_direction
        summary.num_successful_steps += 1

        it = IterationSummary(
            iteration=iteration, cost=cost, cost_change=cost_change,
            gradient_max_norm=grad_max, gradient_norm=math.sqrt(grad_norm_sq),
            step_norm=step_norm, step_size=step,
            line_search_function_evaluations=evals,
            step_is_valid=True, step_is_successful=True,
            iteration_time_in_seconds=time.time() - it_t0,
            cumulative_time_in_seconds=time.time() - t_start)
        summary.iterations.append(it)

        for cb in options.callbacks:
            ret = cb(it)
            if ret == CallbackReturnType.SOLVER_ABORT:
                summary.termination_type = TerminationType.USER_FAILURE
                summary.message = "Terminated by callback (abort)."
                summary.final_cost = cost
                return x
            if ret == CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY:
                summary.termination_type = TerminationType.USER_SUCCESS
                summary.message = "Terminated by callback."
                summary.final_cost = cost
                program.write_back(x)
                return x

        # Convergence tests.
        if grad_max <= options.gradient_tolerance:
            summary.termination_type = TerminationType.CONVERGENCE
            summary.message = (
                f"Gradient tolerance reached: {grad_max:e} <= "
                f"{options.gradient_tolerance:e}")
            break
        if abs(cost_change) <= options.function_tolerance * abs(prev_cost):
            summary.termination_type = TerminationType.CONVERGENCE
            summary.message = "Function tolerance reached."
            break
        if step_norm <= options.parameter_tolerance * (
                x_norm + options.parameter_tolerance):
            summary.termination_type = TerminationType.CONVERGENCE
            summary.message = "Parameter tolerance reached."
            break

    summary.final_cost = cost
    summary.minimizer_time_in_seconds = time.time() - t_start
    return x
