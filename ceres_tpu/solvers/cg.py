"""Preconditioned conjugate gradients + CGNR.

Capability parity with the reference's templated PCG
(conjugate_gradients_solver.h:109 — one implementation over an abstract
linear operator, used for both CGNR and implicit-Schur) and CgnrSolver
(cgnr_solver.cc:145 CPU, :218-333 CUDA). The whole CG loop is a single
lax.while_loop inside the jitted step: no host round-trips per iteration
(the reference's CUDA path has the same goal via streams).

Termination follows the reference: the Q-based stopping rule
    i * (Q_i - Q_{i-1}) / Q_i < q_tolerance
with Q_i = -0.5 (x^T (A x - 2 b)) (conjugate_gradients_solver.h:200-230),
plus an r-norm tolerance and max_iterations.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class CGResult(NamedTuple):
    x: jnp.ndarray
    num_iterations: jnp.ndarray
    final_norm: jnp.ndarray


def conjugate_gradients(
        apply_A: Callable,
        b,
        x0,
        apply_preconditioner: Callable = None,
        max_iterations: int = 100,
        min_iterations: int = 0,
        q_tolerance: float = 0.0,
        r_tolerance: float = 0.0,
        residual_reset_period: int = 10) -> CGResult:
    """Solve A x = b, A SPD, matrix-free."""
    if apply_preconditioner is None:
        apply_preconditioner = lambda v: v

    norm_b = jnp.linalg.norm(b)
    tol_r = r_tolerance * norm_b

    r0 = b - apply_A(x0)

    def init():
        z0 = apply_preconditioner(r0)
        rho0 = jnp.vdot(r0, z0)
        # Q at the INITIAL point (conjugate_gradients_solver.h:157-159
        # Q0 = -x'(b + r)); nonzero for warm starts (SPSE), so the first
        # iteration's forcing-sequence test measures actual progress.
        Q_init = 0.5 * jnp.vdot(x0, r0 + b).astype(b.dtype)
        return (x0, r0, z0, z0, rho0,
                jnp.asarray(0, jnp.int32),
                Q_init,                            # Q_{i-1}
                jnp.asarray(False))

    def cond(state):
        x, r, z, p, rho, i, Q0, done = state
        return (~done) & (i < max_iterations)

    def body(state):
        x, r, z, p, rho, i, Q0, done = state
        Ap = apply_A(p)
        pAp = jnp.vdot(p, Ap)
        # Indefiniteness guard (conjugate_gradients_solver.h:159).
        bad = (pAp <= 0) | ~jnp.isfinite(pAp)
        alpha = jnp.where(bad, 0.0, rho / jnp.where(pAp == 0, 1.0, pAp))
        x_new = x + alpha * p
        # Residual refresh (reference residual_reset_period). lax.cond,
        # NOT jnp.where: where evaluates both branches, paying a second
        # full operator apply EVERY iteration — the exact cost the
        # reference's comment warns "would double the complexity of the
        # CG algorithm" (conjugate_gradients_solver.h:231-236). Under
        # vmap (batched solves) cond lowers to select and both branches
        # run — no worse than where was.
        i1 = i + 1
        r_new = lax.cond((i1 % residual_reset_period) == 0,
                         lambda: b - apply_A(x_new),
                         lambda: r - alpha * Ap)
        z_new = apply_preconditioner(r_new)
        rho_new = jnp.vdot(r_new, z_new)
        beta = rho_new / jnp.where(rho == 0, 1.0, rho)
        p_new = z_new + beta * p

        # Q-based termination (forcing sequence, Nash & Sofer):
        # Q = -0.5 x^T (A x - 2 b) = 0.5 x^T (r + b) since r = b - A x.
        Q1 = 0.5 * jnp.vdot(x_new, r_new + b)
        zeta = i1.astype(b.dtype) * (Q1 - Q0) / jnp.where(Q1 == 0, 1.0, Q1)
        q_done = (i1 >= max(min_iterations, 1)) & (Q1 != 0) & \
            (jnp.abs(zeta) < q_tolerance) if q_tolerance > 0 else \
            jnp.asarray(False)
        r_done = jnp.linalg.norm(r_new) <= tol_r if r_tolerance > 0 \
            else jnp.asarray(False)
        done_new = bad | q_done | r_done
        return (x_new, r_new, z_new, p_new, rho_new, i1, Q1, done_new)

    state = lax.while_loop(cond, body, init())
    x, r, z, p, rho, i, Q0, done = state
    return CGResult(x=x, num_iterations=i, final_norm=jnp.linalg.norm(r))


def solve_cgnr(jac, res, D, apply_preconditioner=None,
               max_iterations: int = 100, q_tolerance: float = 1e-1,
               r_tolerance: float = 0.0, min_iterations: int = 0):
    """CGNR: CG on the normal equations (J^T J + D^T D) d = -J^T r
    (cgnr_solver.cc; math doc cgnr_linear_operator semantics z = A^T A x +
    D^T D x). Fully matrix-free over the bucketed BlockJacobian: each
    application is J v followed by J^T (J v), two batched einsums."""

    def apply_A(v):
        return jac.rmatvec(jac.matvec(v)) + (D * D) * v

    b = -jac.rmatvec(res)
    x0 = jnp.zeros_like(b)
    result = conjugate_gradients(
        apply_A, b, x0, apply_preconditioner=apply_preconditioner,
        max_iterations=max_iterations, min_iterations=min_iterations,
        q_tolerance=q_tolerance, r_tolerance=r_tolerance)
    return result.x, result.num_iterations
