"""Batched-solve throughput: K structurally-identical BA problems as one
vmapped fused device program vs K sequential solves.

The serving-rate benchmark for the ct.solve_batched API (batch.py): a
RANSAC / per-frame-refinement shaped workload where the unit of work is
a batch of small solves. Sequential solves pay the per-call dispatch
cost K times and leave the chip idle between calls; the batched program
pays it once and keeps the device busy with batched contractions.

Usage: python -m benchmarks.batch_benchmark [--cpu] [--batch K]
       python -m benchmarks.batch_benchmark --sweep [--batch K]

--sweep measures BOTH execution modes (lockstep vmapped batch vs
asynchronously pipelined singles) at each problem size and prints one
JSON row per size with the faster mode — the data the
batch.py BATCH_CROSSOVER_RESIDUALS constant must be read off of
(VERDICT r4: the crossover was labeled 'measured' without a captured
sweep). Reference methodology analog: evaluation_benchmark.cc thread
sweeps."""

from __future__ import annotations

import json
import sys
import time

from .common import setup_platform


def sweep(K=8):
    """Batch-vs-pipeline wall at each size; one JSON row per size."""
    import dataclasses
    import ceres_tpu as ct
    from ceres_tpu.io.bal import (build_bal_ceres_problem,
                                  synthetic_bal_problem)

    sizes = [(4, 125, 500), (4, 500, 2000), (4, 1250, 5000),
             (8, 2500, 10000), (8, 5000, 20000), (16, 11000, 44000)]
    base = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
        use_mixed_precision_solves=True,
        max_num_iterations=40, function_tolerance=1e-6,
        fused_iterations=True)
    for (nc, npts, nobs) in sizes:
        def build(perturb_seed):
            bal = synthetic_bal_problem(num_cameras=nc, num_points=npts,
                                        num_observations=nobs, seed=11,
                                        pixel_noise=0.5)
            bal.perturb(rotation_sigma=0.05, translation_sigma=0.2,
                        point_sigma=0.1, seed=perturb_seed)
            return build_bal_ceres_problem(bal)[0]

        row = {"name": f"batch{K}_bal{nc}_{npts}_{nobs}",
               "residuals": 2 * nobs}
        for mode in ("batch", "pipeline"):
            opts = dataclasses.replace(base, batch_mode=mode)
            ct.solve_batched(opts, [build(s) for s in range(K)])  # warm
            probs = [build(s) for s in range(K)]
            t0 = time.time()
            sums = ct.solve_batched(opts, probs)
            row[f"{mode}_wall_s"] = round(time.time() - t0, 4)
            row[f"{mode}_converged"] = all(
                str(s.termination_type).endswith("CONVERGENCE")
                for s in sums)
        row["faster_mode"] = ("batch" if row["batch_wall_s"]
                              <= row["pipeline_wall_s"] else "pipeline")
        print(json.dumps(row), flush=True)
    return 0


def main(argv=None):
    jax = setup_platform()
    import numpy as np
    import ceres_tpu as ct
    from ceres_tpu.io.bal import (build_bal_ceres_problem,
                                  synthetic_bal_problem)

    K = 16
    if "--batch" in sys.argv:
        K = int(sys.argv[sys.argv.index("--batch") + 1])
    if "--sweep" in sys.argv:
        return sweep(min(K, 8))

    def build(perturb_seed):
        bal = synthetic_bal_problem(num_cameras=4, num_points=500,
                                    num_observations=2000, seed=11,
                                    pixel_noise=0.5)
        bal.perturb(rotation_sigma=0.05, translation_sigma=0.2,
                    point_sigma=0.1, seed=perturb_seed)
        return build_bal_ceres_problem(bal)

    options = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
        use_mixed_precision_solves=True,
        max_num_iterations=40, function_tolerance=1e-6,
        fused_iterations=True)

    # ---- sequential (one fused solve per problem) ----
    probs = [build(s)[0] for s in range(K)]
    t0 = time.time()
    seq = [ct.solve(options, p) for p in probs]
    seq_warm_incl = time.time() - t0          # first call pays compile
    probs = [build(s)[0] for s in range(K)]
    t0 = time.time()
    seq = [ct.solve(options, p) for p in probs]
    seq_wall = time.time() - t0
    seq_cost = sum(s.final_cost for s in seq)

    # ---- batched (one vmapped device program) ----
    probs_b = [build(s)[0] for s in range(K)]
    t0 = time.time()
    bat = ct.solve_batched(options, probs_b)
    bat_warm_incl = time.time() - t0
    probs_b = [build(s)[0] for s in range(K)]
    t0 = time.time()
    bat = ct.solve_batched(options, probs_b)
    bat_wall = time.time() - t0
    bat_cost = sum(s.final_cost for s in bat)

    rel = abs(bat_cost - seq_cost) / max(abs(seq_cost), 1e-30)
    print(json.dumps({
        "name": f"batch{K}_bal4_500_2000_dense_schur",
        "sequential_wall_s": round(seq_wall, 3),
        "batched_wall_s": round(bat_wall, 3),
        "speedup": round(seq_wall / max(bat_wall, 1e-9), 2),
        "sequential_solves_per_s": round(K / seq_wall, 2),
        "batched_solves_per_s": round(K / bat_wall, 2),
        "seq_warmup_s": round(seq_warm_incl, 2),
        "bat_warmup_s": round(bat_warm_incl, 2),
        "total_cost_rel_diff": float(f"{rel:.2e}"),
        "iterations": [s.num_iterations for s in bat],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
