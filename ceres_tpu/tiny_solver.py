"""TinySolver: self-contained dense LM for small problems.

Capability parity with the reference's tiny_solver.h:133 (header-only dense
LM over a single parameter vector, no Problem object), plus the
tiny_solver_autodiff_function.h role (derivatives from the residual functor
automatically — here jax.jacfwd). The whole solve is one jitted
lax.while_loop; call it inside larger jitted programs (e.g. batched across
thousands of tiny problems with vmap — the use the reference's
TinySolver hints at).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class TinySolverOptions(NamedTuple):
    """tiny_solver.h Options."""
    max_num_iterations: int = 50
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    function_tolerance: float = 1e-6
    initial_trust_region_radius: float = 1e4


class TinySolverResult(NamedTuple):
    x: jnp.ndarray
    initial_cost: jnp.ndarray
    final_cost: jnp.ndarray
    iterations: jnp.ndarray
    converged: jnp.ndarray


def tiny_solve(residual_fn: Callable, x0,
               options: TinySolverOptions = TinySolverOptions(),
               jacobian_fn: Callable = None) -> TinySolverResult:
    """Minimize 0.5 ||residual_fn(x)||^2 with dense LM. Traceable: use under
    jit/vmap. jacobian_fn defaults to jax.jacfwd(residual_fn)."""
    if jacobian_fn is None:
        jacobian_fn = jax.jacfwd(residual_fn)

    x0 = jnp.asarray(x0)
    n = x0.shape[0]

    def cost_of(x):
        r = residual_fn(x)
        return 0.5 * jnp.vdot(r, r)

    cost0 = cost_of(x0)

    def cond(s):
        x, cost, radius, it, done = s
        return (~done) & (it < options.max_num_iterations)

    def body(s):
        x, cost, radius, it, done = s
        r = residual_fn(x)
        J = jacobian_fn(x)
        g = J.T @ r
        grad_ok = jnp.max(jnp.abs(g)) <= options.gradient_tolerance
        JtJ = J.T @ J
        diag = jnp.clip(jnp.diag(JtJ), 1e-6, 1e32)
        H = JtJ + jnp.diag(diag) / radius
        # solve via Cholesky; fall back to gradient step on failure
        L = jnp.linalg.cholesky(H)
        d = jax.scipy.linalg.cho_solve((L, True), -g)
        d = jnp.where(jnp.all(jnp.isfinite(d)), d,
                      -g / jnp.maximum(jnp.max(jnp.abs(g)), 1.0))
        x_new = x + d
        new_cost = cost_of(x_new)
        mcc = -(jnp.vdot(d, g) + 0.5 * jnp.vdot(d, JtJ @ d))
        rho = (cost - new_cost) / jnp.where(mcc == 0, 1.0, mcc)
        accept = jnp.isfinite(new_cost) & (rho > 1e-3) & (mcc > 0)
        radius = jnp.where(
            accept,
            jnp.minimum(radius / jnp.maximum(1.0 / 3.0,
                                             1.0 - (2.0 * rho - 1.0) ** 3),
                        1e16),
            radius * 0.5)
        step_ok = jnp.linalg.norm(d) <= options.parameter_tolerance * (
            jnp.linalg.norm(x_new) + options.parameter_tolerance)
        f_ok = accept & (jnp.abs(cost - new_cost)
                         <= options.function_tolerance * cost)
        x = jnp.where(accept, x_new, x)
        cost = jnp.where(accept, new_cost, cost)
        done = grad_ok | (accept & (step_ok | f_ok)) | (radius < 1e-32)
        return (x, cost, radius, it + 1, done)

    init = (x0, cost0,
            jnp.asarray(options.initial_trust_region_radius,
                        dtype=x0.dtype),
            jnp.asarray(0, jnp.int32), jnp.asarray(False))
    x, cost, radius, it, done = jax.lax.while_loop(cond, body, init)
    return TinySolverResult(x=x, initial_cost=cost0, final_cost=cost,
                            iterations=it, converged=done)


class TinySolver:
    """Object API mirroring tiny_solver.h usage."""

    Options = TinySolverOptions

    def __init__(self, options: TinySolverOptions = TinySolverOptions()):
        self.options = options

    def solve(self, residual_fn, x0, jacobian_fn=None) -> TinySolverResult:
        return tiny_solve(residual_fn, x0, self.options, jacobian_fn)
