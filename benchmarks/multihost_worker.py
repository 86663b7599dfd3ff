"""Multi-host solve worker: one process of an N-process sharded solve.

The BASELINE "iterations/s at N>=2 hosts" line, run as a true multi-process
JAX program: each process owns a subset of the devices, collectives cross
the process boundary (Gloo on the CPU proxy; NCCL across GPU hosts —
the same `parallel/sharded_fused.py` program either way, reference role:
SURVEY.md §5.8; the reference has no distributed analog).

Launch one process per "host":

  python -m benchmarks.multihost_worker --num-processes 2 --process-id 0 \
      --devices-per-process 4 --coordinator 127.0.0.1:19765 &
  python -m benchmarks.multihost_worker --num-processes 2 --process-id 1 \
      --devices-per-process 4 --coordinator 127.0.0.1:19765 &

On GPU hosts, drop --devices-per-process and the platform force: each
process finds its locally attached cards and jax.distributed wires the
rest. Process 0 prints one JSON line with the solve result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="127.0.0.1:19765")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--devices-per-process", type=int, default=0,
                    help="CPU proxy: virtual host devices per process "
                         "(0 = use the attached platform's devices)")
    ap.add_argument("--cameras", type=int, default=16)
    ap.add_argument("--points", type=int, default=2000)
    ap.add_argument("--observations", type=int, default=8000)
    ap.add_argument("--iterative", action="store_true",
                    help="ITERATIVE_SCHUR + SCHUR_JACOBI instead of "
                         "DENSE_SCHUR")
    ap.add_argument("--f64", action="store_true",
                    help="disable mixed precision")
    args = ap.parse_args()

    if args.devices_per_process:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count="
              f"{args.devices_per_process}")
    import jax
    if args.devices_per_process:
        jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=args.coordinator,
                               num_processes=args.num_processes,
                               process_id=args.process_id,
                               cluster_detection_method="deactivate")

    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh
    import ceres_tpu as ct
    from ceres_tpu.io.bal import (synthetic_bal_problem,
                                  build_bal_ceres_problem)

    def log(*a):
        print(f"[proc {args.process_id}]", *a, file=sys.stderr, flush=True)

    log(f"{jax.process_count()} processes, "
        f"{jax.local_device_count()} local / {jax.device_count()} global "
        f"devices")

    # Every process builds the identical problem (deterministic seeds);
    # only process-local shards of the row data are materialized on its
    # devices by the sharded placement.
    bal = synthetic_bal_problem(num_cameras=args.cameras,
                                num_points=args.points,
                                num_observations=args.observations,
                                seed=7, pixel_noise=1.0)
    bal.perturb(rotation_sigma=0.1, translation_sigma=1.0,
                point_sigma=0.5, seed=8)
    problem, cams, pts = build_bal_ceres_problem(bal)
    cam0 = [c.copy() for c in cams]
    pt0 = [p.copy() for p in pts]

    def reset():
        # solve() writes results back into the user arrays; restore the
        # perturbed start so every timed solve runs the full trajectory.
        for c, c0 in zip(cams, cam0):
            c[:] = c0
        for p, p0 in zip(pts, pt0):
            p[:] = p0

    # {host, chip} mesh: process-major device order, so the chip axis is
    # intra-process (ICI on real pods) and host crosses processes (DCN).
    devs = np.array(jax.devices()).reshape(
        jax.process_count(), jax.device_count() // jax.process_count())
    mesh = Mesh(devs, axis_names=("host", "chip"))

    options = ct.SolverOptions(
        linear_solver_type=(ct.LinearSolverType.ITERATIVE_SCHUR
                            if args.iterative
                            else ct.LinearSolverType.DENSE_SCHUR),
        preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
        use_mixed_precision_solves=not args.f64,
        max_num_iterations=50, function_tolerance=1e-9,
        mesh=mesh)

    t0 = time.time()
    summary = ct.solve(options, problem)
    warm = time.time() - t0
    log(f"warmup solve {warm:.1f}s: {summary.brief_report()}")
    assert "sharded fused" in summary.message, summary.message

    reset()
    t0 = time.time()
    summary = ct.solve(options, problem)
    wall = time.time() - t0
    log(f"timed solve {wall:.3f}s: {summary.brief_report()}")

    if args.process_id == 0:
        print(json.dumps({
            "processes": jax.process_count(),
            "global_devices": jax.device_count(),
            "wall_s": round(wall, 4),
            "lm_iterations": int(summary.num_iterations),
            "iters_per_s": round(summary.num_iterations / wall, 3),
            "initial_cost": float(f"{summary.initial_cost:.8e}"),
            "final_cost": float(f"{summary.final_cost:.8e}"),
            "termination": str(summary.termination_type),
        }), flush=True)
    # Let every process drain before teardown (avoids Gloo teardown races
    # while peers still hold open collectives).
    multihost_utils.sync_global_devices("done")


if __name__ == "__main__":
    main()
