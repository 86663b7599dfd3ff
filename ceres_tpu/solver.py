"""Solver::Solve orchestration.

Capability parity with the reference's solve path (internal/ceres/solver.cc:710:
validate -> preprocess -> minimize -> summarize) and the trust-region
preprocessor (trust_region_preprocessor.cc:374: reduced program, linear
solver selection + downgrades :75-107, evaluator setup).

The design compiles one jitted `linearize_and_step` function per
(problem structure, options) pair: Jacobian evaluation, Jacobi scaling, LM
damping, and the linear solve all fuse into a single device program; the
host loop sees only scalars.
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .minimizers.trust_region import minimize_trust_region
from .program import CompiledProgram
from .types import (DumpFormatType, LinearSolverType, MinimizerType,
                    PreconditionerType,
                    SolverOptions, SolverSummary, TerminationType,
                    TrustRegionStrategyType, DoglegType)
from .solvers import dense as dense_solvers
from .solvers.cg import conjugate_gradients, solve_cgnr
from .solvers.preconditioners import make_block_jacobi_preconditioner


def _make_linear_solver(program, options):
    """Returns solve(jac_scaled, res, D) -> (step, lin_iters).

    Minimizes ||J d + r||^2 + ||diag(D) d||^2 (LinearSolver::Solve with
    PerSolveOptions.D, linear_solver.h:233-318)."""
    t = options.linear_solver_type
    if t == LinearSolverType.DENSE_QR:
        return lambda jac, res, D: dense_solvers.solve_dense_qr(jac, res, D)
    if t in (LinearSolverType.DENSE_NORMAL_CHOLESKY,
             LinearSolverType.SPARSE_NORMAL_CHOLESKY):
        # SPARSE_NORMAL_CHOLESKY, large problems: the device computes Gram
        # blocks + rhs; a host callback scatters them into a cached CSC
        # pattern and runs the native C++ LDL^T (the SuiteSparse role; see
        # solvers/sparse_direct.py). Small problems: the dense device
        # factorization IS the fast path. dynamic_sparsity=True re-analyzes the numerical pattern
        # each factorization on the native path (sparse_direct.py).
        if t == LinearSolverType.SPARSE_NORMAL_CHOLESKY:
            from . import native as _native
            if program.num_effective >= 200 and _native.available():
                from .solvers.sparse_direct import (
                    make_sparse_normal_cholesky_solver)
                return make_sparse_normal_cholesky_solver(program, options)
        mixed = options.use_mixed_precision_solves
        refine = options.max_num_refinement_iterations
        return lambda jac, res, D: dense_solvers.solve_dense_normal_cholesky(
            jac, res, D, mixed_precision=mixed,
            refinement_iterations=refine)
    if t == LinearSolverType.CGNR:
        max_it = options.max_linear_solver_iterations
        eta = options.eta
        pk = options.preconditioner_type
        subset_factory = None
        if pk == PreconditionerType.SUBSET:
            from .solvers.preconditioners import (
                make_subset_preconditioner_factory)
            subset_factory = make_subset_preconditioner_factory(program,
                                                                options)

        def solve(jac, res, D):
            if subset_factory is not None:
                precond = subset_factory(jac, D)
            elif pk != PreconditionerType.IDENTITY:
                precond = make_block_jacobi_preconditioner(
                    jac, D, program.traced_groups())
            else:
                precond = None
            return solve_cgnr(jac, res, D, apply_preconditioner=precond,
                              max_iterations=max_it, q_tolerance=eta,
                              min_iterations=options.min_linear_solver_iterations)

        return solve
    if t in (LinearSolverType.DENSE_SCHUR, LinearSolverType.SPARSE_SCHUR,
             LinearSolverType.ITERATIVE_SCHUR):
        from .solvers.schur import make_schur_solver
        return make_schur_solver(program, options)
    raise ValueError(f"unsupported linear solver {t}")


def make_scale_impl(program, options):
    """Raw scale(x) -> [num_effective] Jacobi column scaling, computed from
    the Jacobian at x. The reference computes this ONCE at iteration 0 and
    reuses the same vector for the whole solve
    (trust_region_minimizer.cc:261-277 jacobian_scaling_); the minimizers
    call this with the initial state and pass the result to every step."""
    if not options.jacobi_scaling:
        def ones(x):
            return jnp.ones((program.num_effective,), dtype=program.dtype)
        return ones

    if options.use_mixed_precision_solves:
        def scale(x):
            # one-time per solve; the f32 Jacobian pass is ~12x cheaper
            # than emulated-f64 and f32 column norms are plenty for a
            # conditioning heuristic
            _, _, jac, _ = program.linearize_fn_mixed(x)
            return (1.0 / (1.0 + jnp.sqrt(jac.squared_column_norms()))
                    ).astype(program.dtype)
        return scale

    def scale(x):
        _, _, jac, _ = program.linearize_fn(x)
        return 1.0 / (1.0 + jnp.sqrt(jac.squared_column_norms()))

    return scale


def make_scale_fn(program, options):
    return program.cached_jit(
        # mixed precision changes WHICH scale is computed (f32 vs f64
        # Jacobian pass) — it must discriminate the cache entry.
        ("scale", options.jacobi_scaling,
         options.use_mixed_precision_solves),
        lambda: program.jit_with_consts(
            make_scale_impl(program, options), (program.example_x(),)))


def make_step_fn(program, options):
    """Build the jitted (x, radius[, scale]) -> step dict function (cached
    on the program so repeated solves reuse the XLA executable; structural
    index arrays are passed as device arguments, not HLO literals).
    When scale is omitted it is computed from the Jacobian at x (identical
    to the fixed iteration-0 scaling for a first step from x)."""
    jitted = program.cached_jit(
        ("step", options.cache_key()),
        lambda: program.jit_with_consts(
            make_step_impl(program, options),
            (program.example_x(), program.example_scalar(),
             program.example_delta())))
    scale_fn = make_scale_fn(program, options)

    def call(x, radius, scale=None):
        if scale is None:
            scale = scale_fn(x)
        return jitted(x, radius, scale)

    return call


def make_step_impl(program, options):
    """Raw (unjitted) step closure — also the body of the fused solve."""
    import os as _os
    if (options.trust_region_strategy_type
            == TrustRegionStrategyType.LEVENBERG_MARQUARDT
            and options.linear_solver_type in (
                LinearSolverType.DENSE_SCHUR, LinearSolverType.SPARSE_SCHUR,
                LinearSolverType.ITERATIVE_SCHUR)
            and not (options.use_mixed_precision_solves
                     and options.max_num_refinement_iterations > 0)
            and not _os.environ.get("CERES_TPU_NO_FUSED_SCHUR")):
        from .solvers.schur import detect_schur_structure
        from .solvers.schur_fused import (fused_schur_supported,
                                          make_fused_schur_lm_step)
        from .solvers.schur_sparse import use_sparse_schur
        meta = detect_schur_structure(program, options)
        if (meta is not None and not use_sparse_schur(meta, options)
                and fused_schur_supported(program, options, meta)):
            return make_fused_schur_lm_step(program, options, meta)
    linear_solve = _make_linear_solver(program, options)
    dtype = program.dtype
    use_jacobi_scaling = options.jacobi_scaling
    min_diag = options.min_lm_diagonal
    max_diag = options.max_lm_diagonal
    strategy = options.trust_region_strategy_type

    mixed = options.use_mixed_precision_solves

    refine_iters = options.max_num_refinement_iterations
    solve_b = getattr(linear_solve, "solve_b", None)
    # Direct solvers return (J'J + D^2) d = b exactly, so
    # ||J_s d||^2 = d.b - ||D d||^2 — the extra J matvec for the model
    # cost change is unnecessary. The subtraction cancels catastrophically
    # near convergence, so use it only in mixed mode, where the f32 step
    # already bounds the achievable tail accuracy and the saved matvec is
    # material; full-f64 solves keep the exact product (NIST tail digits).
    exact_solver = mixed and options.linear_solver_type in (
        LinearSolverType.DENSE_QR, LinearSolverType.DENSE_NORMAL_CHOLESKY,
        LinearSolverType.SPARSE_NORMAL_CHOLESKY,
        LinearSolverType.DENSE_SCHUR, LinearSolverType.SPARSE_SCHUR)

    def lm_step(x, radius, scale):
        if mixed and refine_iters == 0:
            # Mixed precision: the jacfwd tangent chains run in f32;
            # cost keeps f64 meaning via a residual-only f64 pass inside
            # linearize_fn_mixed.
            cost, grad, jac, res = program.linearize_fn_mixed(x)
            jac64 = res64 = grad64 = None
            scale = scale.astype(jnp.float32)
        elif mixed:
            # Refinement needs the f64 Jacobian: linearize in f64, run
            # the J-wide pipeline in f32.
            cost, grad64, jac, res = program.linearize_fn(x)
            jac64, res64 = jac, res
            from .ops.bsr import BlockJacobian, BucketJacobian, RVec
            jac = BlockJacobian(
                [BucketJacobian(b.J.astype(jnp.float32), b.cols,
                                b.row_offset, b.onehots, b.gcols,
                                b.sorted_slot, b.tlocals, b.tslabs)
                 for b in jac.buckets],
                jac.num_rows, jac.num_cols)
            res = RVec([p.astype(jnp.float32) for p in res.parts])
            grad = jac.rmatvec(res)
            scale = scale.astype(jnp.float32)
        else:
            cost, grad, jac, res = program.linearize_fn(x)
            jac64, res64, grad64 = jac, res, None   # grad already f64
        jac_s = jac.scale_columns(scale)
        grad_s = grad * scale
        # LM diagonal (levenberg_marquardt_strategy.cc:80-92).
        diag = jnp.clip(jac_s.squared_column_norms(), min_diag, max_diag)
        D = jnp.sqrt(diag / radius.astype(jac_s.buckets[0].J.dtype))
        d, lin_iters = linear_solve(jac_s, res, D)
        if mixed and refine_iters > 0 and solve_b is not None:
            # Mixed-precision iterative refinement (solver.h:572-589 +
            # iterative_refiner.h): the f64 residual of the damped normal
            # equations drives f32 correction solves, recovering
            # f64-quality steps from the fast f32 factorization.
            scale64 = scale.astype(dtype)
            jac64_s = jac64.scale_columns(scale64)
            D64 = D.astype(dtype)
            # J_s^T r = scale * (J^T r) = scale * grad64 (already paid)
            b64 = -(grad64 * scale64)
            d64 = d.astype(dtype)
            for _ in range(refine_iters):
                Hd = jac64_s.rmatvec(jac64_s.matvec(d64)) \
                    + (D64 * D64) * d64
                rn = b64 - Hd
                dc, it2 = solve_b(jac_s, D, rn)
                d64 = d64 + dc.astype(dtype)
                lin_iters = lin_iters + it2
            d = d64
        if exact_solver:
            Dd = D.astype(d.dtype) * d
            Jd_sq = -jnp.vdot(d, grad_s) - jnp.vdot(Dd, Dd)
            mcc = -(jnp.vdot(d, grad_s) + 0.5 * Jd_sq)
        else:
            Jd = jac_s.matvec(d)
            mcc = -(jnp.vdot(d, grad_s) + 0.5 * Jd.squared_norm())
        delta = (scale * d).astype(dtype)
        # convergence norms from the f64 gradient when the configuration
        # paid for one (mixed + refinement): the f32 gradient's ~1e-7
        # relative noise would defeat tight gradient_tolerance settings
        g_norms = grad64 if grad64 is not None else grad
        out = {
            "cost": cost,
            "gradient_max_norm": jnp.max(jnp.abs(g_norms)).astype(dtype),
            "gradient_norm": jnp.linalg.norm(g_norms).astype(dtype),
            "delta": delta,
            "model_cost_change": mcc.astype(dtype),
            "step_norm": jnp.linalg.norm(delta),
            "lin_iters": lin_iters,
        }
        if program.has_bounds:
            out["gradient_full"] = grad.astype(dtype)
        return out

    def _subspace_solve(jac_s, g, gn, radius, dtype):
        """SUBSPACE_DOGLEG (dogleg_strategy.cc ComputeSubspaceModel +
        FindMinimumOnTrustRegionBoundary): minimize the quadratic model on
        the 2-D span{gradient, Gauss-Newton} intersected with the ball.
        The reference finds the boundary minimum by quartic root-finding
        (polynomial.cc); here the 2x2 eigen-decomposition reduces it to the
        secular equation phi(lam) = sum g_i^2/(d_i+lam)^2 = r^2, solved by a
        fixed-count bisection (traceable, branch-free)."""
        # Orthonormal basis of span{g, gn} (Gram-Schmidt).
        b1 = g / jnp.maximum(jnp.linalg.norm(g), 1e-300)
        v = gn - jnp.vdot(b1, gn) * b1
        v_norm = jnp.linalg.norm(v)
        degenerate = v_norm < 1e-12
        b2 = jnp.where(degenerate, b1, v / jnp.where(v_norm == 0, 1.0,
                                                     v_norm))
        # 2x2 model: B = basis^T J^T J basis, gr = basis^T g.
        Jb1 = jac_s.matvec(b1)
        Jb2 = jac_s.matvec(b2)
        B00 = Jb1.squared_norm()
        B11 = Jb2.squared_norm()
        B01 = Jb1.dot(Jb2)
        gr = jnp.stack([jnp.vdot(b1, g), jnp.vdot(b2, g)])
        B = jnp.asarray([[B00, B01], [B01, B11]], dtype=dtype)
        # Unconstrained minimum of the subspace model.
        y_unc = -jnp.linalg.solve(B + 1e-30 * jnp.eye(2, dtype=dtype), gr)
        inside = jnp.linalg.norm(y_unc) <= radius

        # Boundary: eigendecompose B, solve the secular equation.
        d, Q = jnp.linalg.eigh(B)
        gh = Q.T @ gr
        lam_lo = jnp.maximum(0.0, -d[0]) + 1e-12
        # upper bound: |gh|/radius - d_min covers phi(lam_hi) <= r^2
        lam_hi = lam_lo + jnp.linalg.norm(gh) / jnp.maximum(radius, 1e-300) \
            + jnp.abs(d).max() + 1.0

        def phi(lam):
            y = gh / (d + lam)
            return jnp.vdot(y, y)

        def bisect(_, lohi):
            lo, hi = lohi
            mid = 0.5 * (lo + hi)
            too_big = phi(mid) > radius * radius
            # phi decreasing in lam: too big -> need larger lam
            return (jnp.where(too_big, mid, lo), jnp.where(too_big, hi, mid))

        lo, hi = jax.lax.fori_loop(0, 64, bisect, (lam_lo, lam_hi))
        lam = 0.5 * (lo + hi)
        y_bnd = Q @ (-gh / (d + lam))
        y = jnp.where(inside, y_unc, y_bnd)
        d_sub = y[0] * b1 + y[1] * b2
        # Degenerate subspace (g parallel to gn): fall back to the dogleg
        # segment handled by the caller via NaN-free select.
        return d_sub, degenerate

    def dogleg_step(x, radius, scale):
        """TRADITIONAL_DOGLEG + SUBSPACE_DOGLEG
        (dogleg_strategy.cc:130-265), in the Jacobi-scaled space like the
        reference (fixed iteration-0 scaling passed in by the minimizer)."""
        if mixed:
            cost, grad, jac, res = program.linearize_fn_mixed(x)
            scale = scale.astype(jnp.float32)
        else:
            cost, grad, jac, res = program.linearize_fn(x)
        jac_s = jac.scale_columns(scale)
        g = grad * scale
        # Cauchy point: alpha = |g|^2 / |J g|^2.
        Jg = jac_s.matvec(g)
        g_sq = jnp.vdot(g, g)
        alpha = g_sq / jnp.maximum(Jg.squared_norm(), 1e-300)
        # Gauss-Newton point with ADAPTIVE regularization (the reference
        # escalates mu_ on linear-solver failure, dogleg_strategy.cc
        # ComputeGaussNewtonStep mu_ *= 10 loop): start at a tiny damping
        # and escalate x100 while the solve is numerically invalid —
        # non-finite, or a non-positive model decrease at the GN point,
        # which a correct damped solve guarantees. Gauge-deficient
        # problems (BA) make the undamped normal matrix singular; a fixed
        # tiny mu factors it into garbage.
        # Validity is tolerance-RELATIVE: near convergence (g ~ 0, tiny
        # steps) the two terms of mcc_gn cancel to rounding noise and a
        # strict mcc_gn > 0 test spuriously fails, escalating through the
        # whole damping ladder (~8 extra linear solves per LM step).
        eps_v = jnp.asarray(1e-6 if g.dtype == jnp.float32 else 1e-12,
                            g.dtype)

        def _gn_valid(gn_try):
            finite = jnp.all(jnp.isfinite(gn_try))
            Jgn = jac_s.matvec(gn_try)
            mcc_gn = -(jnp.vdot(gn_try, g) + 0.5 * Jgn.squared_norm())
            ok_decrease = mcc_gn > -eps_v * jnp.maximum(cost, 1.0)
            tiny_step = (jnp.linalg.norm(gn_try)
                         <= eps_v * (1.0 + jnp.linalg.norm(g)))
            return jnp.logical_and(
                finite, jnp.logical_or(ok_decrease, tiny_step))

        def _gn_solve(dval):
            return linear_solve(jac_s, res, jnp.full_like(g, dval))

        d0 = jnp.asarray(1e-12, dtype=g.dtype)
        gn, lin_iters = _gn_solve(d0)

        def gn_cond(state):
            dval, gn_try, _ = state
            return jnp.logical_and(dval < 1e2, ~_gn_valid(gn_try))

        def gn_body(state):
            dval, _, it0 = state
            dval = dval * 1e2
            gn_try, it = _gn_solve(dval)
            return (dval, gn_try, it0 + it)

        _, gn, lin_iters = jax.lax.while_loop(
            gn_cond, gn_body, (d0, gn, lin_iters))
        cauchy = -alpha * g
        cauchy_norm = jnp.linalg.norm(cauchy)
        # Final invalidity (the whole ladder failed): fall back to the
        # Cauchy point rather than propagating a non-finite GN step.
        gn = jnp.where(jnp.all(jnp.isfinite(gn)), gn, cauchy)
        gn_norm = jnp.linalg.norm(gn)

        # Case 1: GN inside the region.
        # Case 2: Cauchy point outside -> truncated gradient step.
        # Case 3: dogleg segment intersection with the boundary.
        diff = gn - cauchy
        a2 = jnp.vdot(diff, diff)
        b2 = 2.0 * jnp.vdot(cauchy, diff)
        c2 = jnp.vdot(cauchy, cauchy) - radius * radius
        disc = jnp.sqrt(jnp.maximum(b2 * b2 - 4.0 * a2 * c2, 0.0))
        beta = jnp.where(a2 > 0, (-b2 + disc) / (2.0 * jnp.where(a2 == 0, 1.0, a2)),
                         0.0)
        seg = cauchy + beta * diff

        d = jnp.where(gn_norm <= radius, gn,
                      jnp.where(cauchy_norm >= radius,
                                -(radius / jnp.sqrt(jnp.maximum(g_sq, 1e-300)))
                                * g,
                                seg))
        if options.dogleg_type == DoglegType.SUBSPACE_DOGLEG:
            d_sub, degenerate = _subspace_solve(jac_s, g, gn, radius,
                                                dtype)
            # GN inside the region dominates; otherwise subspace minimum
            # (falls back to the segment when the subspace degenerates).
            d = jnp.where(gn_norm <= radius, gn,
                          jnp.where(degenerate, d, d_sub))
        Jd = jac_s.matvec(d)
        mcc = -(jnp.vdot(d, g) + 0.5 * Jd.squared_norm())
        delta = (scale * d).astype(dtype)
        out = {
            "cost": cost,
            "gradient_max_norm": jnp.max(jnp.abs(grad)).astype(dtype),
            "gradient_norm": jnp.linalg.norm(grad).astype(dtype),
            "delta": delta,
            "model_cost_change": mcc.astype(dtype),
            "step_norm": jnp.linalg.norm(delta),
            "lin_iters": lin_iters,
        }
        if program.has_bounds:
            out["gradient_full"] = grad.astype(dtype)
        return out

    return (lm_step
            if strategy == TrustRegionStrategyType.LEVENBERG_MARQUARDT
            else dogleg_step)


def solve(options: SolverOptions, problem,
          summary: Optional[SolverSummary] = None) -> SolverSummary:
    """ceres::Solve equivalent (solver.cc:710-830). Returns the summary;
    solved values are written back into the user's numpy parameter arrays."""
    if summary is None:
        summary = SolverSummary()
    t_start = time.time()

    err = options.validate()
    if err is not None:
        summary.termination_type = TerminationType.FAILURE
        summary.message = f"Invalid options: {err}"
        return summary

    # Problem::Options::evaluation_callback (problem.h:179, Ceres 2.2
    # attaches the callback to the Problem): merge into the solver options
    # unless the user already set one there.
    prob_cb = getattr(getattr(problem, "options", None),
                      "evaluation_callback", None)
    if prob_cb is not None and options.evaluation_callback is None:
        import dataclasses
        options = dataclasses.replace(options, evaluation_callback=prob_cb)

    # ---- preprocess ----
    t0 = time.time()
    program = CompiledProgram.get_cached(problem, options)
    summary.fixed_cost = program.fixed_cost
    summary.num_parameter_blocks = program.num_parameter_blocks
    summary.num_parameters = program.num_parameters
    summary.num_effective_parameters = program.num_effective_parameters
    summary.num_residual_blocks = program.num_residual_blocks
    summary.num_residuals = program.num_residuals_total
    summary.num_parameter_blocks_reduced = (
        program.num_parameter_blocks_reduced)
    summary.num_parameters_reduced = program.num_parameters_reduced
    summary.num_effective_parameters_reduced = (
        program.num_effective_parameters_reduced)
    summary.num_residual_blocks_reduced = program.num_residual_blocks_reduced
    summary.num_residuals_reduced = program.num_residuals_reduced
    summary.minimizer_type = options.minimizer_type
    summary.trust_region_strategy_type = options.trust_region_strategy_type
    summary.linear_solver_type_given = options.linear_solver_type
    summary.preconditioner_type_given = options.preconditioner_type
    summary.line_search_direction_type = options.line_search_direction_type
    summary.is_constrained = program.has_bounds
    summary.num_threads_given = options.num_threads
    summary.num_threads_used = 1   # XLA owns on-device parallelism
    summary.mixed_precision_solves_used = bool(
        options.use_mixed_precision_solves)
    summary.inner_iterations_given = bool(options.use_inner_iterations)
    summary.inner_iterations_used = bool(options.use_inner_iterations)
    if (options.use_inner_iterations
            and options.inner_iteration_ordering is not None):
        from .minimizers.coordinate_descent import is_ordering_valid
        if not is_ordering_valid(program, options.inner_iteration_ordering):
            # solver.cc rejects a non-independent inner ordering up front
            # (coordinate_descent_minimizer.h:76 IsOrderingValid)
            summary.termination_type = TerminationType.FAILURE
            summary.message = (
                "Invalid inner_iteration_ordering: each group must be an "
                "independent set (no two blocks of a group may share a "
                "residual block).")
            return summary
    summary.dense_linear_algebra_library_type = (
        options.dense_linear_algebra_library_type)
    summary.sparse_linear_algebra_library_type = (
        options.sparse_linear_algebra_library_type)

    if program.num_effective == 0:
        # Nothing to optimize (all blocks constant / no residuals):
        # the reference reports the fixed cost and terminates.
        summary.initial_cost = program.fixed_cost
        summary.final_cost = program.fixed_cost
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = ("The problem has no variable parameter blocks; "
                           "nothing to optimize.")
        return summary

    # Gradient-checking mode (solver.h check_gradients; reference wraps
    # every cost function, gradient_checking_cost_function.cc).
    if options.check_gradients:
        from .gradient_checker import check_problem_gradients
        err = check_problem_gradients(
            problem, options.gradient_check_relative_precision)
        if err is not None:
            summary.termination_type = TerminationType.FAILURE
            summary.message = err
            return summary

    # Linear-solver downgrades (trust_region_preprocessor.cc:75-107).
    options = _maybe_downgrade_options(options, program, summary)
    summary.linear_solver_type_used = options.linear_solver_type
    summary.preconditioner_type_used = options.preconditioner_type
    summary.preprocessor_time_in_seconds = time.time() - t0

    # ---- minimize ----
    if options.minimizer_type == MinimizerType.TRUST_REGION:
        # Configurations that REQUIRE the host loop: callbacks,
        # nonmonotonic steps, per-iteration logging, inner iterations,
        # problem dumping, and bounds (projected gradient convergence
        # test + projected line search,
        # trust_region_minimizer.cc:101,:288). Neither the single-device
        # fused while-loop nor the sharded device loop can provide them.
        device_loop_ok = (not options.callbacks
                          and not options.use_nonmonotonic_steps
                          and not options.minimizer_progress_to_stdout
                          and not options.use_inner_iterations
                          and not options.trust_region_problem_dump_directory
                          and options.trust_region_problem_dump_format_type
                          != DumpFormatType.CONSOLE
                          and options.evaluation_callback is None
                          and not options.update_state_every_iteration
                          # a finite wall-clock budget needs the host
                          # clock between iterations
                          and options.max_solver_time_in_seconds >= 1e9
                          # dynamic re-analysis mutates host factor state
                          # per iteration; keep it on the host loop
                          and not options.dynamic_sparsity
                          and not program.has_bounds)
        use_fused = options.fused_iterations and device_loop_ok
        if options.mesh is not None and device_loop_ok:
            # Multi-chip solve over options.mesh (SURVEY.md section 5.8):
            # rows shard by e-block, the whole LM loop runs inside one
            # shard_map'd program (parallel/sharded_fused.py). Falls back
            # to the single-device path when the problem has no usable
            # Schur structure for the sharded eliminator; host-loop-only
            # configurations (bounds, callbacks, ...) fall through to the
            # single-device host-loop minimizer rather than silently
            # losing their semantics inside the device loop.
            from .parallel.solve_sharded import try_solve_sharded
            x = try_solve_sharded(program, options, summary)
            if x is not None:
                t0 = time.time()
                if summary.is_solution_usable():
                    if options.defer_parameter_writeback:
                        summary._pending_writeback = (program, x)
                    else:
                        program.write_back(x)
                summary.postprocessor_time_in_seconds = time.time() - t0
                summary.total_time_in_seconds = time.time() - t_start
                return summary
        if use_fused:
            from .minimizers.fused import run_fused
            x = run_fused(program, options, summary)
        else:
            step_fn = make_step_fn(program, options)
            x = minimize_trust_region(program, options, step_fn, summary)
    else:
        from .minimizers.line_search import minimize_line_search
        x = minimize_line_search(program, options, summary)

    # ---- postprocess ----
    t0 = time.time()
    if summary.is_solution_usable():
        if options.defer_parameter_writeback:
            summary._pending_writeback = (program, x)
        else:
            program.write_back(x)
    summary.postprocessor_time_in_seconds = time.time() - t0
    summary.total_time_in_seconds = time.time() - t_start
    return summary


def _sparse_schur_ok(structure, options):
    from .solvers.schur_sparse import sparse_schur_supported
    return sparse_schur_supported(structure)


def _maybe_downgrade_options(options, program, summary):
    """Option-interaction rewriting (trust_region_preprocessor.cc:75-107):
    Schur-type solvers downgrade when no elimination structure exists."""
    import dataclasses
    t = options.linear_solver_type
    if t in (LinearSolverType.DENSE_SCHUR, LinearSolverType.SPARSE_SCHUR,
             LinearSolverType.ITERATIVE_SCHUR):
        from .solvers.schur import detect_schur_structure
        structure = detect_schur_structure(program, options)
        if structure is None:
            if t == LinearSolverType.DENSE_SCHUR:
                new_t = LinearSolverType.DENSE_QR
            elif t == LinearSolverType.SPARSE_SCHUR:
                new_t = LinearSolverType.SPARSE_NORMAL_CHOLESKY
            else:
                new_t = LinearSolverType.CGNR
            options = dataclasses.replace(
                options, linear_solver_type=new_t,
                preconditioner_type=PreconditionerType.JACOBI)
            summary.message = (
                f"No Schur structure detected; using {new_t}. ")
        if structure is not None:
            # Schur structure string "r,e,f" (solver.h:1024; the
            # reference's SchurStructureToString, 'd' = ragged). XLA
            # shape-specializes every structure, so used == given.
            rs = {bk.r for bk in program.buckets}
            fs = {g["t"] for g in structure.f_groups}

            def _dim(vals):
                return str(next(iter(vals))) if len(vals) == 1 else "d"

            s_str = f"{_dim(rs)},{structure.te},{_dim(fs)}"
            summary.schur_structure_given = s_str
            summary.schur_structure_used = s_str
        if structure is None:
            pass
        elif (t == LinearSolverType.SPARSE_SCHUR
              and structure.nf > 4096
              and not _sparse_schur_ok(structure, options)):
            # Dense S is the device-native reduced-system form; past a few
            # thousand cameras its O(nf^2) memory/factorization loses to
            # the block-sparse host LDL^T (schur_sparse.py — the
            # schur_complement_solver.cc:291 regime) when the structure
            # supports it, and otherwise to PCG on the implicit
            # complement: ITERATIVE_SCHUR, rewritten here.
            options = dataclasses.replace(
                options, linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
                preconditioner_type=(
                    options.preconditioner_type
                    if options.preconditioner_type
                    != PreconditionerType.IDENTITY
                    else PreconditionerType.SCHUR_JACOBI))
            summary.message = (
                f"SPARSE_SCHUR with {structure.nf} camera-space columns: "
                f"routing the reduced solve to ITERATIVE_SCHUR "
                f"(dense S uneconomical past ~4096 columns). ")
    return options


class Solver:
    """Object-style API: Solver().solve(options, problem)."""

    Options = SolverOptions
    Summary = SolverSummary

    def solve(self, options, problem, summary=None):
        return solve(options, problem, summary)
