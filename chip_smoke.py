#!/usr/bin/env python3
"""Smoke test of the solve path on NVIDIA GPUs.

Drives the user entry points (`ct.solve`, `ct.solve_batched`) at full
problem widths and compares each configuration with a plain reference:
the f64 host-loop LM on the generic step paths, with no fused loop and no
mixed precision. One process uses the card(s) throughout.

Default phases (one GPU):
  1. device   refuse anything but a GPU; print the card, its power limit,
              JAX, x64, the compilation-cache directory, the native
              host library.
  2. dense    BAL-16-22106 (16 cameras, 22,106 points, 83,718
              observations), DENSE_SCHUR, mixed precision in the fused
              device loop vs the f64 host loop.
  3. iterative  the same problem, ITERATIVE_SCHUR + SCHUR_JACOBI.
  4. batched  ct.solve_batched of 8 small BA problems vs each problem's
              own f64 solve.
  5. sparse   an SE3 pose graph at Sphere2500's shape (2,500 poses):
              SPARSE_NORMAL_CHOLESKY (host LDL^T through pure_callback)
              vs DENSE_NORMAL_CHOLESKY at f64 on the card.
  6. gpu-tests  the GPU test tier (tests_gpu/), run in this process.

Options (each runs only its own phases):
  --large  1024 cameras / 200k points / 1M observations, implicit fused
           ITERATIVE_SCHUR, mixed vs the same solve at f64.
  --trace  one jax.profiler trace of a warm solve of phases 2 and 3 (no
           end-to-end timing); prints the device busy share and the top
           device operations by time. The trace goes to chiprun_out/trace.
  --four   BAL-16 over a 1-D mesh of 4 GPUs, DENSE_SCHUR and implicit
           ITERATIVE_SCHUR, vs the same problems on one GPU; prints where
           the residual rows live.

Usage:  python chip_smoke.py [--large | --trace | --four]

A failed check raises and the script exits non-zero. The last line of
standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

BAL16 = dict(num_cameras=16, num_points=22106, num_observations=83718)
# 7 LM iterations at function_tolerance 1e-6 for the f64 solve.
BAL16_PERTURB = dict(rotation_sigma=0.1, translation_sigma=1.0,
                     point_sigma=0.5)
# Sphere2500's shape: 2,500 poses; odometry plus one loop closure per pose
# gives 4,998 edges (Sphere2500 has 4,949).
POSE_GRAPH = dict(num_poses=2500, loop_every=1, seed=3)
LARGE = dict(num_cameras=1024, num_points=200000, num_observations=1000000)
LARGE_PERTURB = dict(rotation_sigma=0.01, translation_sigma=0.1,
                     point_sigma=0.05)
# Mixed mode factors and solves in f32: final costs agree with the f64
# reference to 1e-5 relative (tests/test_fused_schur.py uses the same).
MIXED_RTOL = 1e-5
SPARSE_RTOL = 1e-8
MESH_RTOL = 1e-6


class SmokeFailure(AssertionError):
    """A smoke check failed."""


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def lm_steps(summary):
    """LM iterations taken (accepted + rejected steps); the same count on
    the host loop and the fused loop."""
    return summary.num_successful_steps + summary.num_unsuccessful_steps


def converged(summary):
    import ceres_tpu as ct
    return summary.termination_type == ct.TerminationType.CONVERGENCE


def peak_bytes(device=None):
    import jax
    stats = (device or jax.devices()[0]).memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# ---------------------------------------------------------------- problems

class BALCase:
    """A synthetic BAL problem with its user arrays and initial values."""

    def __init__(self, shape, perturb, seed=7, perturb_seed=8):
        from ceres_tpu.io.bal import (build_bal_ceres_problem,
                                      synthetic_bal_problem)
        bal = synthetic_bal_problem(**shape, seed=seed, pixel_noise=1.0)
        bal.perturb(**perturb, seed=perturb_seed)
        self.problem, self.cams, self.pts = build_bal_ceres_problem(bal)
        self.x0 = [a.copy() for a in self.cams + self.pts]

    def reset(self):
        for a, a0 in zip(self.cams + self.pts, self.x0):
            a[:] = a0

    def user_state_cost(self, options):
        """f64 cost at the values now in the user arrays."""
        from ceres_tpu.program import CompiledProgram
        program = CompiledProgram.get_cached(self.problem, options)
        cost = program.cached_jit(
            ("smoke_cost",),
            lambda: program.jit_with_consts(program.cost_fn,
                                            (program.example_x(),)))
        return float(cost(program.initial_state()))


def bal_options(solver, mixed, **kw):
    import ceres_tpu as ct
    base = dict(
        linear_solver_type=ct.LinearSolverType[solver],
        preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
        max_num_iterations=50, function_tolerance=1e-6,
        max_linear_solver_iterations=100,
        use_mixed_precision_solves=mixed, fused_iterations=mixed)
    base.update(kw)
    return ct.SolverOptions(**base)


def precision_note(mixed):
    import jax
    mm = jax.config.jax_default_matmul_precision or "default"
    if mixed:
        return ("mixed: f32 Jacobian/elimination/solve, f64 cost; fused "
                f"Schur einsums at HIGHEST, other matmuls {mm}")
    return f"f64 throughout, matmul precision {mm}"


def solve_and_compare(phase, case, solver, timed=True, converge=True, **kw):
    """Mixed fused solve (compile + 3 warm solves) vs the f64 reference
    (the host loop, unless kw sets fused_iterations) on the same problem;
    checks convergence (or, with converge=False, a usable solution within
    the iteration budget), the cost bound and write-back."""
    import ceres_tpu as ct
    mixed_opts = bal_options(solver, True, **kw)
    ref_opts = bal_options(solver, False, **kw)
    say(phase, precision_note(True) + " | reference " +
        precision_note(False))

    case.reset()
    t0 = time.perf_counter()
    s = ct.solve(mixed_opts, case.problem)
    say(phase, f"compile + first solve {time.perf_counter() - t0:.3f} s")
    walls = []
    if timed:
        for _ in range(3):
            case.reset()
            t0 = time.perf_counter()
            s = ct.solve(mixed_opts, case.problem)   # eager write-back
            walls.append(time.perf_counter() - t0)
        say(phase, "warm solve walls "
            + ", ".join(f"{w:.4f}" for w in walls)
            + f" s; median {statistics.median(walls):.4f} s")
    ok = converged if converge else (lambda x: x.is_solution_usable())
    check(ok(s), f"{phase}: mixed solve failed: "
          f"{s.termination_type} {s.message}")
    at_user = case.user_state_cost(ref_opts)
    check(rel(at_user, s.final_cost) <= 1e-9,
          f"{phase}: user arrays do not hold the solution "
          f"(cost there {at_user:.10e}, summary {s.final_cost:.10e})")

    case.reset()
    t0 = time.perf_counter()
    r = ct.solve(ref_opts, case.problem)
    loop = "fused loop" if ref_opts.fused_iterations else "host loop"
    say(phase, f"f64 reference ({loop}, compile included) "
        f"{time.perf_counter() - t0:.3f} s")
    check(ok(r), f"{phase}: f64 reference failed: "
          f"{r.termination_type} {r.message}")
    d = rel(s.final_cost, r.final_cost)
    say(phase, f"LM iterations mixed {lm_steps(s)} / f64 {lm_steps(r)}; "
        f"linear iterations mixed {s.num_linear_solver_iterations} / "
        f"f64 {r.num_linear_solver_iterations}")
    say(phase, f"final cost mixed {s.final_cost:.10e} / f64 "
        f"{r.final_cost:.10e}; rel diff {d:.3e} (bound {MIXED_RTOL:g}); "
        f"termination {s.termination_type.name} / "
        f"{r.termination_type.name}")
    if lm_steps(s) > lm_steps(r) + 1:
        say(phase, "NOTE: mixed run took more than one LM iteration "
            "beyond the f64 reference")
    check(d <= MIXED_RTOL, f"{phase}: final costs differ by {d:.3e}")
    say(phase, f"peak_bytes_in_use {peak_bytes()}")
    return s, r


# ------------------------------------------------------------------ phases

def phase_device():
    import jax
    from ceres_tpu import config, native
    from ceres_tpu.utils.device import card_name_and_power_limit, require_gpu
    stamp = require_gpu()
    say("device", f"platform {stamp['platform']}, device_kind "
        f"{stamp['kind']!r}, count {stamp['count']}")
    say("device", f"jax {jax.__version__}, x64 "
        f"{bool(jax.config.jax_enable_x64)}, compilation cache "
        f"{config.enable_compilation_cache()}")
    print(f"card: {card_name_and_power_limit()}", flush=True)
    say("device", f"native host library loaded: {native.available()}")
    return stamp


def phase_dense(case):
    solve_and_compare("dense", case, "DENSE_SCHUR")


def phase_iterative(case):
    solve_and_compare("iterative", case, "ITERATIVE_SCHUR")


def phase_batched():
    """Shapes and seeds of bench.py's batched serving cell."""
    import ceres_tpu as ct
    from ceres_tpu.io.bal import (build_bal_ceres_problem,
                                  synthetic_bal_problem)

    def make_bal(perturb_seed):
        b = synthetic_bal_problem(num_cameras=4, num_points=500,
                                  num_observations=2000, seed=11,
                                  pixel_noise=0.5)
        b.perturb(rotation_sigma=0.05, translation_sigma=0.2,
                  point_sigma=0.1, seed=perturb_seed)
        return b

    K = 8
    mixed = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
        use_mixed_precision_solves=True, max_num_iterations=40,
        function_tolerance=1e-6, fused_iterations=True)
    say("batched", precision_note(True))
    bals = [make_bal(s) for s in range(K)]
    t0 = time.perf_counter()
    sums = ct.solve_batched(
        mixed, [build_bal_ceres_problem(b)[0] for b in bals])
    say("batched", f"compile + first batch {time.perf_counter() - t0:.3f} s")
    probs = [build_bal_ceres_problem(b)[0] for b in bals]
    t0 = time.perf_counter()
    sums = ct.solve_batched(mixed, probs)
    wall = time.perf_counter() - t0
    say("batched", f"warm batch of {K}: {wall:.4f} s "
        f"({K / wall:.2f} solves/s)")

    # f64 references: the 8 problems share one structure and observation
    # set (same synthesis seed), so one Problem is reused with each
    # element's initial values copied in — one compilation for all eight.
    ref_prob, rc, rp = build_bal_ceres_problem(bals[0])
    ref_opts = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
        max_num_iterations=40, function_tolerance=1e-6)
    worst = 0.0
    for i, (b, s) in enumerate(zip(bals, sums)):
        for a, v in zip(rc, b.cameras):
            a[:] = v
        for a, v in zip(rp, b.points):
            a[:] = v
        r = ct.solve(ref_opts, ref_prob)
        check(converged(s), f"batched: element {i} did not converge: "
              f"{s.termination_type}")
        check(converged(r), f"batched: f64 reference {i} did not converge")
        d = rel(s.final_cost, r.final_cost)
        worst = max(worst, d)
        say("batched", f"element {i}: LM iterations {lm_steps(s)} / f64 "
            f"{lm_steps(r)}; cost {s.final_cost:.10e} / "
            f"{r.final_cost:.10e}; rel diff {d:.3e}")
        check(d <= MIXED_RTOL, f"batched: element {i} differs by {d:.3e}")
    say("batched", f"worst rel diff {worst:.3e} (bound {MIXED_RTOL:g}); "
        f"peak_bytes_in_use {peak_bytes()}")


def phase_sparse():
    import ceres_tpu as ct
    from ceres_tpu.examples.slam import build_pose_graph_3d_problem
    from ceres_tpu.io.g2o import synthetic_pose_graph_3d
    poses, constraints, _ = synthetic_pose_graph_3d(**POSE_GRAPH)
    say("sparse", f"{len(poses)} poses, {len(constraints)} edges; "
        + precision_note(False))
    costs = {}
    for solver in ("SPARSE_NORMAL_CHOLESKY", "DENSE_NORMAL_CHOLESKY"):
        problem, _, _ = build_pose_graph_3d_problem(poses, constraints)
        t0 = time.perf_counter()
        s = ct.solve(ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType[solver],
            max_num_iterations=50), problem)
        say("sparse", f"{solver}: {time.perf_counter() - t0:.3f} s "
            f"(compile included), LM iterations {lm_steps(s)}, cost "
            f"{s.initial_cost:.10e} -> {s.final_cost:.10e}, "
            f"{s.termination_type}")
        check(converged(s), f"sparse: {solver} did not converge: "
              f"{s.message}")
        costs[solver] = s.final_cost
    d = rel(costs["SPARSE_NORMAL_CHOLESKY"], costs["DENSE_NORMAL_CHOLESKY"])
    say("sparse", f"rel diff {d:.3e} (bound {SPARSE_RTOL:g}); "
        f"peak_bytes_in_use {peak_bytes()}")
    check(d <= SPARSE_RTOL, f"sparse: final costs differ by {d:.3e}")


def phase_gpu_tests():
    import pytest
    rc = pytest.main(["-q", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests_gpu")])
    check(rc == 0, f"gpu-tests: pytest exit code {int(rc)}")


def phase_large():
    """The cost keeps falling by about 1e-6 relative per LM iteration for
    many iterations here, so at function_tolerance 1e-6 the mixed and f64
    solves stop several iterations apart, ~1.5e-5 from each other. They
    are compared after a 200-iteration budget instead, where both have
    gone far down that tail."""
    case = BALCase(LARGE, LARGE_PERTURB)
    say("large", f"{LARGE}; implicit fused ITERATIVE_SCHUR, "
        "200-iteration budget")
    solve_and_compare("large", case, "ITERATIVE_SCHUR", timed=False,
                      converge=False, fused_iterations=True,
                      function_tolerance=1e-9, max_num_iterations=200)


def phase_trace(case):
    """Warm both mixed solves, then trace one solve of each."""
    import jax
    import ceres_tpu as ct
    from benchmarks.trace_summary import summarize
    runs = [(case, bal_options("DENSE_SCHUR", True)),
            (case, bal_options("ITERATIVE_SCHUR", True))]
    for case, opts in runs:
        case.reset()
        ct.solve(opts, case.problem)                 # compile outside
    out = os.path.join(REPO, "chiprun_out", "trace")
    with jax.profiler.trace(out):
        for (case, opts), name in zip(runs, ("dense", "iterative")):
            case.reset()
            with jax.profiler.TraceAnnotation(f"smoke_{name}"):
                s = ct.solve(opts, case.problem)
            check(converged(s), f"trace: {name} did not converge")
    summary = summarize(out)
    for line in summary["report"]:
        say("trace", line)


def phase_four():
    """BAL-16 on a 4-GPU mesh vs one GPU, DENSE_SCHUR and implicit
    ITERATIVE_SCHUR."""
    import jax
    import ceres_tpu as ct
    from jax.sharding import Mesh
    import numpy as np
    from ceres_tpu.program import CompiledProgram
    devices = jax.devices()
    check(len(devices) == 4, f"four: {len(devices)} devices, need 4")
    mesh = Mesh(np.array(devices), axis_names=("data",))
    case = BALCase(BAL16, BAL16_PERTURB)
    for solver, implicit in (("DENSE_SCHUR", False),
                             ("ITERATIVE_SCHUR", True)):
        name = solver + (" implicit" if implicit else "")
        if implicit:
            os.environ["CERES_TPU_FORCE_IMPLICIT"] = "1"
        try:
            opts1 = bal_options(solver, False, fused_iterations=True)
            case.reset()
            t0 = time.perf_counter()
            s1 = ct.solve(opts1, case.problem)
            say("four", f"{name} one GPU: {time.perf_counter() - t0:.3f} s"
                f" (compile included), LM iterations {lm_steps(s1)}, "
                f"cost {s1.final_cost:.10e}")
            opts4 = bal_options(solver, False, fused_iterations=True,
                                mesh=mesh)
            case.reset()
            t0 = time.perf_counter()
            s4 = ct.solve(opts4, case.problem)
            say("four", f"{name} 4 GPUs: {time.perf_counter() - t0:.3f} s"
                f" (compile included), LM iterations {lm_steps(s4)}, "
                f"cost {s4.final_cost:.10e}; {s4.message}")
        finally:
            os.environ.pop("CERES_TPU_FORCE_IMPLICIT", None)
        check("sharded fused" in s4.message,
              f"four: {name} did not take the sharded path: {s4.message}")
        check(converged(s1) and converged(s4),
              f"four: {name} did not converge")
        d = rel(s4.final_cost, s1.final_cost)
        say("four", f"{name} rel diff {d:.3e} (bound {MESH_RTOL:g})")
        check(d <= MESH_RTOL, f"four: {name} costs differ by {d:.3e}")

        # where the sharded row data lives
        program = CompiledProgram.get_cached(case.problem, opts4)
        placed = [v[1] for k, v in program._jit_cache.items()
                  if k[0] == "sharded_fused" and k[1] == opts4.cache_key()]
        check(placed, f"four: no placed shards for {name}")
        per_dev = {d.id: 0 for d in devices}
        for leaf in jax.tree_util.tree_leaves(placed[0]):
            if isinstance(leaf, jax.Array) and len(leaf.sharding.device_set) > 1:
                for sh in leaf.addressable_shards:
                    per_dev[sh.device.id] += sh.data.nbytes
        say("four", f"{name} sharded row bytes per device {per_dev}")
        check(all(b > 0 for b in per_dev.values()),
              f"four: some device holds no rows: {per_dev}")
        say("four", "peak_bytes_in_use per device "
            + str({d.id: peak_bytes(d) for d in devices}))


# -------------------------------------------------------------------- main

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--large", action="store_true")
    mode.add_argument("--trace", action="store_true")
    mode.add_argument("--four", action="store_true")
    args = ap.parse_args(argv)

    from ceres_tpu.utils.device import NoGPUError
    t_start = time.perf_counter()
    try:
        stamp = phase_device()
    except NoGPUError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2

    def run(name, fn, *a):
        t0 = time.perf_counter()
        fn(*a)
        say(name, f"ok in {time.perf_counter() - t0:.1f} s")

    if args.large:
        run("large", phase_large)
    elif args.trace:
        run("trace", phase_trace, BALCase(BAL16, BAL16_PERTURB))
    elif args.four:
        run("four", phase_four)
    else:
        case = BALCase(BAL16, BAL16_PERTURB)
        run("dense", phase_dense, case)
        run("iterative", phase_iterative, case)
        run("batched", phase_batched)
        run("sparse", phase_sparse)
        run("gpu-tests", phase_gpu_tests)
    say("total", f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": stamp}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
