"""Benchmark: BAL-16-22106-shaped bundle adjustment, LM + Schur.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

Baseline anchor (BASELINE.md): reference CPU Ceres solves BAL
problem-16-22106 (16 cams / 22,106 pts / 83,718 observations) with
DENSE_SCHUR in 0.383710 s total over 7 LM iterations (~4.75e-2 s per
steady-state iteration, installation.rst:188-235). The BAL data file is not
distributed with the reference repo (zero-egress here), so the benchmark
uses a synthetic problem with identical structure (same camera/point/
observation counts, Snavely 9-param cameras) and a perturbation tuned to
REFERENCE-LIKE DIFFICULTY: the DENSE_SCHUR solve takes 7 LM iterations from
the perturbed start, matching the anchor run's iteration count, so
wall-to-convergence is an apples-to-apples comparison.

Reported (extras in the JSON line):
  value              median measured wall of 3 solves on the DEFAULT
                     eager-writeback path — preprocessor + minimizer +
                     postprocessor, with the final parameter vector
                     downloaded and written back to user memory, exactly
                     what the reference anchor's Solve() timing includes
                     (solver.cc:650-653 CopyParameterBlockStateToUserState
                     is part of Solve). vs_baseline is apples-to-apples.
  serving_wall_s     median measured wall of 5 solves run with
                     defer_parameter_writeback=True: the solve is complete
                     (converged; summary filled from the packed device
                     stats) with the parameter vector left device-resident
                     — the serving configuration, where the next consumer
                     of x is another device program (secondary metric;
                     vs_baseline_serving).
  per_iter_s         last solve's minimizer time / LM iterations
  lm_iterations      LM iterations of the last solve
  writeback_s        summary.write_back() wall (x download + host scatter)
  wall_writeback_s   same as value (kept for cross-round comparability)
  pcg_iters_per_s    ITERATIVE_SCHUR+SCHUR_JACOBI: CG iterations/s
                     (driver BASELINE target metric)
  iterative_wall_s   wall of the ITERATIVE_SCHUR configuration
  device_solve_s     per-solve wall with 8 full LM solves dispatched
                     back-to-back before one sync: the device's solve
                     rate with host dispatch overlapped.
  device             platform, device_kind, device count and the card's
                     name and power limit (nvidia-smi) of the run.
vs_baseline = 0.383710 / value (>1 = faster than reference CPU Ceres).

Measured: wall time of Solve() to convergence (function_tolerance 1e-6),
excluding problem build and XLA compilation (one warm-up solve first; the
reference pays no compilation, we amortize it across solves). The run
needs a GPU and fails without one.
"""

import json
import os
import sys
import time

import numpy as np

BASELINE_WALL_S = 0.383710
SHAPE = dict(num_cameras=16, num_points=22106, num_observations=83718)
# 7 LM iterations at function_tolerance 1e-6 — the reference anchor's count.
PERTURB = dict(rotation_sigma=0.1, translation_sigma=1.0, point_sigma=0.5)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_config(ct, problem, cams, pts, cam0, pt0, make_options, label):
    """Warm-up + 5 timed solves; returns (median_wall, last_summary,
    warmup_wall, writeback_s, wall_writeback). warmup_wall is dominated by
    XLA compilation on a cold compilation cache and by cache
    deserialization on a warm one.

    The timed solves run with defer_parameter_writeback=True: the solve
    is complete (converged, summary filled from the packed device stats)
    but the parameter vector stays device-resident — the production
    serving mode, where the next consumer of x is another device program.
    summary.write_back() is timed separately, and one additional timed
    solve runs the default eager-writeback path (wall_writeback)."""
    import dataclasses

    def reset():
        for c, c0 in zip(cams, cam0):
            c[:] = c0
        for p, p0 in zip(pts, pt0):
            p[:] = p0

    t0 = time.time()
    summary = ct.solve(make_options(), problem)
    warmup = time.time() - t0
    log(f"[{label}] warmup solve: {warmup:.1f}s  "
        f"{summary.brief_report()}")
    times = []
    for trial in range(5):
        reset()
        opts = dataclasses.replace(make_options(),
                                   defer_parameter_writeback=True)
        t0 = time.time()
        summary = ct.solve(opts, problem)
        wall = time.time() - t0
        measured = summary.minimizer_time_in_seconds \
            + summary.preprocessor_time_in_seconds
        times.append(measured)
        log(f"[{label}] timed solve {trial}: {wall:.4f}s "
            f"(measured {measured:.4f}), {summary.num_iterations} iters, "
            f"cost {summary.initial_cost:.6e} -> {summary.final_cost:.6e}, "
            f"{summary.termination_type}")
    t0 = time.time()
    summary.write_back()
    writeback_s = time.time() - t0
    # PRIMARY metric: timed solves on the default path (x downloaded +
    # written back inside the solve) — what the reference anchor times.
    wb_times = []
    for trial in range(5):
        reset()
        s_wb = ct.solve(make_options(), problem)
        wb_times.append(s_wb.minimizer_time_in_seconds
                        + s_wb.preprocessor_time_in_seconds
                        + s_wb.postprocessor_time_in_seconds)
        log(f"[{label}] eager-writeback solve {trial}: "
            f"{wb_times[-1]:.4f}s, {s_wb.num_iterations} iters, "
            f"{s_wb.termination_type}")
        # GPU reductions are not bit-reproducible from run to run, so two
        # solves from the same start can stop one LM iteration apart
        # (ITERATIVE_SCHUR: 7 or 8 on BAL-16); they must agree to the
        # solve's own function tolerance.
        ftol = make_options().function_tolerance
        assert abs(s_wb.final_cost - summary.final_cost) \
            <= 10 * ftol * max(1.0, abs(summary.final_cost)), \
            "deferred and eager solves disagree on final cost"
    srt = sorted(wb_times)
    wall_writeback = srt[len(srt) // 2]
    # spread diagnostics — p90/p50 > 1.5 flags the run
    p90 = srt[min(len(srt) - 1, int(0.9 * len(srt)))]
    log(f"[{label}] write_back(): {writeback_s:.4f}s; eager-writeback "
        f"median: {wall_writeback:.4f}s  p90: {p90:.4f}s"
        + ("  [OUTLIERS: p90 > 1.5x p50]"
           if p90 > 1.5 * wall_writeback else ""))
    return (sorted(times)[len(times) // 2], summary, warmup,
            writeback_s, wall_writeback, srt)


def main():
    t0 = time.time()
    import jax
    import ceres_tpu as ct
    from ceres_tpu import config
    from ceres_tpu.io.bal import synthetic_bal_problem, build_bal_ceres_problem
    from ceres_tpu.utils.device import card_name_and_power_limit, require_gpu
    device = require_gpu()
    device["card"] = card_name_and_power_limit()
    log(f"devices: {jax.devices()}  card: {device['card']}  "
        f"compilation cache: {config.enable_compilation_cache()}  "
        f"(import {time.time()-t0:.1f}s)")

    solver_name = os.environ.get("BENCH_SOLVER", "DENSE_SCHUR")
    shape = SHAPE
    if os.environ.get("BENCH_SMALL"):
        shape = dict(num_cameras=4, num_points=200, num_observations=800)

    t0 = time.time()
    bal = synthetic_bal_problem(**shape, seed=7, pixel_noise=1.0)
    bal.perturb(**PERTURB, seed=8)
    log(f"synthetic BAL built: {time.time()-t0:.1f}s")

    t0 = time.time()
    problem, cams, pts = build_bal_ceres_problem(bal)
    log(f"problem graph built: {time.time()-t0:.1f}s")

    def make_options(name=None):
        return ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType[name or solver_name],
            preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
            max_num_iterations=50,
            function_tolerance=1e-6,
            max_linear_solver_iterations=100,
            use_mixed_precision_solves=not bool(
                os.environ.get("BENCH_NO_MIXED")),
            max_num_refinement_iterations=int(
                os.environ.get("BENCH_REFINE", "0")),
            fused_iterations=not bool(os.environ.get("BENCH_HOST_LOOP")),
        )

    cam0 = [c.copy() for c in cams]
    pt0 = [p.copy() for p in pts]

    # ---- primary config (DENSE_SCHUR, the reference anchor) ----
    (wall, summary, warmup, writeback_s, wall_writeback,
     wb_sorted) = run_config(
        ct, problem, cams, pts, cam0, pt0, make_options, solver_name)
    iters = max(summary.num_iterations, 1)
    per_iter = summary.minimizer_time_in_seconds / iters
    log(f"  per-LM-iteration: {per_iter:.4f}s over {iters} iterations "
        f"(reference 4.75e-2 s)")

    extras = {
        "per_iter_s": round(per_iter, 5),
        "lm_iterations": int(summary.num_iterations),
        "final_cost": float(f"{summary.final_cost:.6e}"),
        "warmup_s": round(warmup, 2),
        "writeback_s": round(writeback_s, 4),
        "wall_writeback_s": round(wall_writeback, 4),
        "eager_p50_s": round(wb_sorted[len(wb_sorted) // 2], 4),
        "eager_p90_s": round(
            wb_sorted[min(len(wb_sorted) - 1,
                          int(0.9 * len(wb_sorted)))], 4),
        "serving_wall_s": round(wall, 4),
        "vs_baseline_serving": round(BASELINE_WALL_S / wall, 3),
    }

    # ---- pipelined device throughput (host dispatch overlapped) ----
    def device_rate(name, opts_override=None, want_lin_iters=False,
                    want_iters=False):
        """Per-solve device wall with 8 solves dispatched back-to-back
        before one sync: each dispatch re-executes the FULL fused LM
        solve."""
        import jax as _jax
        from ceres_tpu.program import CompiledProgram
        from ceres_tpu.minimizers.fused import make_fused_tr_solve
        opts = opts_override or make_options(name)
        if not opts.fused_iterations:
            return None
        program = CompiledProgram.get_cached(problem, opts)
        solve = program.cached_jit(
            ("fused", opts.cache_key()),
            lambda: program.jit_with_consts(
                make_fused_tr_solve(program, opts),
                (program.example_x(),)))
        for c, c0 in zip(cams, cam0):
            c[:] = c0
        for p, p0 in zip(pts, pt0):
            p[:] = p0
        x0 = program.initial_state()
        reps = 8
        xs = [x0] * reps
        _jax.device_get(solve(x0)[1])              # warm
        # No transfer to the host inside the timed region: stats download
        # and the trajectory check happen after the clock stops.
        t0 = time.time()
        rs = [solve(x) for x in xs]                # async dispatches
        _jax.block_until_ready([r[1] for r in rs])
        dt = (time.time() - t0) / reps
        stats = [_jax.device_get(r[1]) for r in rs]
        iters = [int(s[2]) for s in stats]
        if len(set(iters)) != 1:
            log(f"  (device-rate trajectories differ: {iters})")
        if want_lin_iters:
            return dt, float(np.median([s[7] for s in stats]))
        if want_iters:
            # the per-iteration denominator comes from THESE
            # trajectories, not from the headline solve
            return dt, float(np.median(iters))
        return dt

    try:
        dev_pair = device_rate(solver_name, want_iters=True)
        if dev_pair:
            dev, dev_iters = dev_pair
            extras["device_solve_s"] = round(dev, 4)
            extras["device_solves_per_s"] = round(1.0 / dev, 2)
            extras["device_rate_lm_iterations"] = dev_iters
            log(f"  pipelined device solve: {dev:.4f}s/solve over "
                f"{dev_iters:.0f} LM iters "
                f"({1.0/dev:.1f} full LM solves/s; reference CPU "
                f"{1.0/BASELINE_WALL_S:.1f}/s)")
    except Exception as e:
        log(f"pipelined throughput measurement failed: {e}")

    # ---- marginal per-iteration cost: two pinned iteration budgets
    # (zero tolerances, so BOTH runs take exactly max_num_iterations)
    # differenced — the per-dispatch fixed cost cancels, leaving the
    # per-LM-iteration execution time. The fixed cost itself is reported
    # as dispatch_floor_ms (a K-solve serving batch pays it once per
    # dispatch, not per iteration).
    if not os.environ.get("BENCH_SKIP_MFU"):
        try:
            import dataclasses as _dc
            pins = []
            # pins stay within the PRODUCTIVE iteration range (the
            # problem converges at 6): forcing iterations past
            # convergence yields rejected steps whose relinearize is a
            # measurement artifact, not real per-iteration work. Each
            # pin is measured twice and the MIN taken: the short span
            # makes the slope sensitive to per-dispatch floor spikes.
            for N in (2, 6):
                opts_n = _dc.replace(
                    make_options(), max_num_iterations=N,
                    function_tolerance=0.0, gradient_tolerance=0.0,
                    parameter_tolerance=0.0)
                best = None
                for _rep in range(3):
                    d_n, it_n = device_rate(solver_name,
                                            opts_override=opts_n,
                                            want_iters=True)
                    if best is None or d_n < best[0]:
                        best = (d_n, it_n)
                pins.append(best)
            (d1, i1), (d2, i2) = pins
            if i2 > i1 and d2 > d1:
                slope = (d2 - d1) / (i2 - i1)
                extras["marginal_step_ms"] = round(1e3 * slope, 3)
                extras["dispatch_floor_ms"] = round(
                    1e3 * max(d1 - slope * i1, 0.0), 2)
                log(f"  marginal LM step: {1e3*slope:.3f} ms "
                    f"(N={i1:.0f}->{i2:.0f}: {d1*1e3:.1f}->"
                    f"{d2*1e3:.1f} ms; dispatch floor "
                    f"{extras['dispatch_floor_ms']} ms/execution)")
            else:
                extras["step_slope_inconclusive"] = True
                log(f"  marginal-step A/B INCONCLUSIVE: "
                    f"{d1:.4f}@{i1:.0f} -> {d2:.4f}@{i2:.0f}")
        except Exception as e:
            log(f"marginal-step measurement failed: {e}")

    # ---- batched serving rate (ct.solve_batched, no reference analog:
    # a RANSAC / per-frame-refinement shaped batch as ONE device
    # program) ----
    if not os.environ.get("BENCH_SKIP_BATCH"):
        try:
            from ceres_tpu.io.bal import (synthetic_bal_problem as _synth,
                                          build_bal_ceres_problem as _bld)

            def batch_build(perturb_seed):
                b = _synth(num_cameras=4, num_points=500,
                           num_observations=2000, seed=11,
                           pixel_noise=0.5)
                b.perturb(rotation_sigma=0.05, translation_sigma=0.2,
                          point_sigma=0.1, seed=perturb_seed)
                return _bld(b)[0]

            K = 8
            bopts = lambda: ct.SolverOptions(  # noqa: E731
                linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
                use_mixed_precision_solves=True,
                max_num_iterations=40, function_tolerance=1e-6,
                fused_iterations=True)
            ct.solve_batched(bopts(), [batch_build(s)
                                       for s in range(K)])   # warm
            probs = [batch_build(s) for s in range(K)]
            t0 = time.time()
            bsum = ct.solve_batched(bopts(), probs)
            bwall = time.time() - t0
            extras["batch8_wall_s"] = round(bwall, 4)
            extras["batch8_solves_per_s"] = round(K / bwall, 2)
            log(f"  batched serving: {K} BA solves in {bwall:.3f}s "
                f"({K/bwall:.1f} solves/s), all "
                f"{'converged' if all(str(s.termination_type).endswith('CONVERGENCE') for s in bsum) else 'NOT CONVERGED'}")
        except Exception as e:
            log(f"batched serving measurement failed: {e}")

    # ---- ITERATIVE_SCHUR + SCHUR_JACOBI (driver BASELINE config) ----
    if not os.environ.get("BENCH_SKIP_ITERATIVE"):
        try:
            it_wall, it_summary, it_warm, _, it_wb, _ = run_config(
                ct, problem, cams, pts, cam0, pt0,
                lambda: make_options("ITERATIVE_SCHUR"), "ITERATIVE_SCHUR")
            extras["iterative_warmup_s"] = round(it_warm, 2)
            tot_cg = it_summary.num_linear_solver_iterations \
                or it_summary.num_linear_solves
            extras["iterative_wall_s"] = round(it_wall, 4)
            extras["iterative_eager_wall_s"] = round(it_wb, 4)
            extras["pcg_iters_per_s"] = round(
                float(tot_cg) / max(it_summary.minimizer_time_in_seconds,
                                    1e-9), 1)
            it_dev = device_rate("ITERATIVE_SCHUR")
            if it_dev:
                extras["iterative_device_solve_s"] = round(it_dev, 4)
                extras["pcg_iters_per_s_device"] = round(
                    float(tot_cg) / it_dev, 1)
                log(f"  ITERATIVE_SCHUR device rate: {it_dev:.4f}s/solve, "
                    f"{float(tot_cg)/it_dev:.0f} PCG iters/s")

            # ---- PCG apply time (reference methodology
            # evaluation_benchmark.cc:240-637): isolate the marginal cost
            # of one CG application by FORCING two CG depths (min=max=K)
            # and differencing the device walls — the LM-iteration fixed
            # work (linearize/eliminate/precond) cancels.
            try:
                import dataclasses as _dc
                # Pin the OUTER trajectory: zero tolerances + a fixed
                # LM-iteration count mean both runs do identical
                # linearize/eliminate/precondition work and differ ONLY
                # in total CG applications — otherwise the shallower CG
                # depth degrades the LM steps, the outer count changes,
                # and the fixed work does not cancel (this produced a
                # negative marginal in one capture).
                ks, devs, cgs = (5, 25), [], []
                for K in ks:
                    opts_k = _dc.replace(
                        make_options("ITERATIVE_SCHUR"),
                        min_linear_solver_iterations=K,
                        max_linear_solver_iterations=K,
                        max_num_iterations=8,
                        function_tolerance=0.0,
                        gradient_tolerance=0.0,
                        parameter_tolerance=0.0)
                    d_k, cg_k = device_rate("ITERATIVE_SCHUR",
                                            opts_override=opts_k,
                                            want_lin_iters=True)
                    devs.append(d_k)
                    cgs.append(cg_k)
                if cgs[1] > cgs[0] and devs[1] > devs[0]:
                    apply_s = (devs[1] - devs[0]) / (cgs[1] - cgs[0])
                    extras["pcg_apply_ms"] = round(1e3 * apply_s, 4)
                    log(f"  PCG apply: {1e3*apply_s:.4f} ms marginal "
                        f"(K={ks[0]}->{ks[1]}: {devs[0]:.4f}->"
                        f"{devs[1]:.4f} s, cg {cgs[0]:.0f}->{cgs[1]:.0f})")
                else:
                    # LOUD failure in the JSON, not silent omission
                    extras["pcg_ab_inconclusive"] = True
                    log(f"  PCG apply A/B INCONCLUSIVE — fields omitted, "
                        f"pcg_ab_inconclusive=true in the JSON: "
                        f"K={ks[0]}->{ks[1]}: {devs[0]:.4f}->{devs[1]:.4f}"
                        f" s, cg {cgs[0]:.0f}->{cgs[1]:.0f}")
            except Exception as e:
                log(f"PCG apply measurement failed: {e}")
        except Exception as e:
            log(f"ITERATIVE_SCHUR config failed: {e}")

    # PRIMARY value: the eager-writeback wall — the apples-to-apples
    # comparison against the reference anchor's Solve() timing, which
    # includes copying the final parameters to user memory
    # (solver.cc:650-653). The deferred/serving wall is the secondary
    # serving_wall_s / vs_baseline_serving pair.
    print(json.dumps({
        "metric": f"bal16_22106_{solver_name.lower()}_wall_to_convergence",
        "value": round(wall_writeback, 4),
        "unit": "s",
        "vs_baseline": round(BASELINE_WALL_S / wall_writeback, 3),
        **extras,
        "device": device,
    }))


if __name__ == "__main__":
    main()
