"""Bundle-adjustment scaling benchmark: LM wall time vs problem size
across solver configurations (the reference's evaluation_benchmark.cc role
at the whole-solve level).

Usage: python -m benchmarks.ba_scaling_benchmark [--cpu] [--quick]
       [--large]
"""

from __future__ import annotations

import json
import sys
import time

from .common import setup_platform


def main(argv=None):
    jax = setup_platform()
    import ceres_tpu as ct
    from ceres_tpu.io.bal import (build_bal_ceres_problem,
                                  synthetic_bal_problem)

    quick = "--quick" in sys.argv
    cases = [
        (4, 2000, 8000, "DENSE_SCHUR"),
        (16, 22106, 83718, "DENSE_SCHUR"),
    ]
    if not quick:
        cases += [
            (64, 30000, 150000, "ITERATIVE_SCHUR"),
            (256, 50000, 300000, "ITERATIVE_SCHUR"),
        ]
    if "--large" in sys.argv:
        # nf = 9216 > the explicit-S cap: exercises the matrix-free
        # implicit fused ITERATIVE_SCHUR at production scale (1M
        # observations; J alone is ~100 MB f32, A/S would be ~2.2 GB).
        cases = [(1024, 200000, 1000000, "ITERATIVE_SCHUR")]

    for (ncam, npts, nobs, solver) in cases:
        bal = synthetic_bal_problem(ncam, npts, nobs, seed=7,
                                    pixel_noise=1.0)
        bal.perturb(rotation_sigma=0.01, translation_sigma=0.1,
                    point_sigma=0.05, seed=8)
        problem, cams, pts = build_bal_ceres_problem(bal)
        options = ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType[solver],
            preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
            use_mixed_precision_solves=True,
            max_num_iterations=50,
            function_tolerance=1e-6,
            max_linear_solver_iterations=100,
            fused_iterations=True)
        cam0 = [c.copy() for c in cams]
        pt0 = [pp.copy() for pp in pts]
        s = ct.solve(options, problem)          # warmup (compile)
        for c, c0 in zip(cams, cam0):
            c[:] = c0
        for pp, p0 in zip(pts, pt0):
            pp[:] = p0
        t0 = time.time()
        s = ct.solve(options, problem)          # timed full solve, warm
        wall = time.time() - t0
        print(json.dumps({
            "name": f"ba_{ncam}x{npts}x{nobs}_{solver.lower()}",
            "wall_to_convergence_s": round(wall, 3),
            "iterations": s.num_iterations,
            "s_per_lm_iteration": round(wall / max(s.num_iterations, 1), 4),
            "pcg_iterations": int(s.num_linear_solver_iterations or 0),
            "final_cost": s.final_cost,
            "termination": str(s.termination_type),
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
