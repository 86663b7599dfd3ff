"""Schur eliminator micro-benchmark (the reference's
internal/ceres/schur_eliminator_benchmark.cc role: time Eliminate and
BackSubstitute on BA-structured problems of varying size).

Decomposition of the same surface in the fused layout:
  eliminate      explicit S + reduced rhs from the chunk-grouped Grams
  back_substitute  d_e = (EtE+D^2)^-1 (b_e - A y)
  apply_S        one implicit Schur-complement application (the
                 ITERATIVE_SCHUR CG body)
  schur_jacobi   SCHUR_JACOBI preconditioner assembly

Timings use a data-chained fori_loop: each case reports the MARGINAL
per-application time (T_N - T_1)/(N - 1), which cancels the
per-dispatch fixed cost.

Usage: python -m benchmarks.schur_eliminator_benchmark [--cpu]
       [--cameras N --points N --observations N] [--reps N]
"""

from __future__ import annotations

import json
import sys
import time

from .common import setup_platform


def main(argv=None):
    jax = setup_platform()
    import jax.numpy as jnp
    import numpy as np
    import ceres_tpu as ct
    from ceres_tpu.io.bal import synthetic_bal_problem, \
        build_bal_ceres_problem
    from ceres_tpu.program import CompiledProgram
    from ceres_tpu.solvers.schur import SchurOps, detect_schur_structure

    args = sys.argv[1:] if argv is None else argv

    def intarg(name, default):
        return int(args[args.index(name) + 1]) if name in args else default

    ncam = intarg("--cameras", 16)
    npts = intarg("--points", 22106)
    nobs = intarg("--observations", 83718)
    reps = intarg("--reps", 32)

    bal = synthetic_bal_problem(ncam, npts, nobs, seed=7, pixel_noise=1.0)
    problem, cams, pts = build_bal_ceres_problem(bal)
    options = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI)
    prog = CompiledProgram.get_cached(problem, options)
    meta = detect_schur_structure(prog, options)
    assert meta is not None
    x0 = prog.initial_state()
    _, _, jac, _ = prog.jit_with_consts(prog.linearize_fn, (x0,))(x0)
    jax.block_until_ready(jac.buckets[0].J)
    n = prog.num_effective
    nf = meta.nf
    print(f"# BAL {ncam} cams / {npts} pts / {nobs} obs; "
          f"ne={meta.ne} te={meta.te} nf={nf}", flush=True)

    rng = np.random.default_rng(3)
    D0 = jnp.asarray(rng.uniform(0.5, 2.0, n))
    b0 = jnp.asarray(rng.standard_normal(n))

    e_cols = meta.e_cols
    f_cols = meta.f_global_cols

    def split(b):
        return b[meta.c("e_cols", e_cols)], b[meta.c("f_global", f_cols)]

    # Each case: carry -> (new carry, scalar) with a true data dependency
    # through the carry so the loop body cannot be hoisted or CSE'd.
    # (Carry-independent setup — e.g. the chunk-grouped regather of J in
    # SchurOps.__init__ — IS loop-invariant and hoists, so `eliminate`
    # times the D-dependent elimination math on the grouped tensors, the
    # same surface the reference's Eliminate(A, b, D) call times.)
    def case_eliminate(c):
        ops = SchurOps(meta, jac, D0 * (1.0 + 1e-12 * c))
        b_e, b_f = split(b0)
        S, rhs = ops.explicit_S_and_rhs(b_e, b_f)
        return jnp.mean(S) + jnp.mean(rhs)

    ops0 = SchurOps(meta, jac, D0)
    b_e0, b_f0 = split(b0)
    S0, rhs0 = ops0.explicit_S_and_rhs(b_e0, b_f0)

    def case_back_substitute(c):
        y = rhs0 * (1.0 + 1e-12 * c)
        d_e = ops0.back_substitute(b_e0 * (1.0 + 1e-12 * c), y)
        return jnp.mean(d_e)

    def case_apply_S(c):
        v = rhs0 * (1.0 + 1e-12 * c)
        w = ops0.apply_S(v)
        return jnp.mean(w)

    def case_schur_jacobi(c):
        ops = SchurOps(meta, jac, D0 * (1.0 + 1e-12 * c))
        pre = ops.make_preconditioner(ct.PreconditionerType.SCHUR_JACOBI)
        return jnp.mean(pre(b_f0))

    def marginal_ms(body):
        def chained(k):
            def run(c):
                return jax.lax.fori_loop(
                    0, k, lambda i, cc: cc + body(cc), 0.0)
            return prog.jit_with_consts(run, (0.0,))

        f1, fN = chained(1), chained(reps)
        f1(0.0).block_until_ready()       # compile
        fN(0.0).block_until_ready()
        t1s, tNs = [], []
        for _ in range(7):
            t0 = time.perf_counter()
            f1(0.0).block_until_ready()
            t1s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            fN(0.0).block_until_ready()
            tNs.append(time.perf_counter() - t0)
        t1 = sorted(t1s)[len(t1s) // 2]
        tN = sorted(tNs)[len(tNs) // 2]
        return max(tN - t1, 0.0) / (reps - 1) * 1e3

    for name, body in [("eliminate", case_eliminate),
                       ("back_substitute", case_back_substitute),
                       ("apply_S", case_apply_S),
                       ("schur_jacobi_precond", case_schur_jacobi)]:
        ms = marginal_ms(body)
        print(json.dumps({"name": name, "time_ms": round(ms, 4),
                          "cameras": ncam, "points": npts,
                          "observations": nobs}), flush=True)


if __name__ == "__main__":
    main()
