"""Mixed-precision iteration-gap experiment.

Question: when the mixed (f32) solve takes more LM iterations than f64,
is the cause (a) f32 ARITHMETIC in the Gram/solve pipeline (fixable with
compensated/f64 accumulation) or (b) the f32 JACOBIAN ENTRIES themselves
(jacfwd runs natively in f32; only an f64 jacfwd would fix it)?

Runs the bench problem three ways:
  f64        : full f64 (reference trajectory)
  mixed      : f32 jacfwd + f32 arithmetic (production mixed mode)
  mixed+f64acc: f32 jacfwd, f64 everything downstream
                (CERES_TPU_EXP_F64ACC=1)

If mixed+f64acc matches f64's iteration count, compensated-f32 sums are
worth building; if it matches mixed, the gap is J-entry rounding and no
summation trick helps.

Usage: python scripts/exp_precision.py [--cpu] [all|f64|mixed|f64acc]
Runs on the attached accelerator; --cpu forces the host backend.
"""
import os
import sys

import jax

if "--cpu" in sys.argv[1:]:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import ceres_tpu as ct  # noqa: E402
from ceres_tpu.io.bal import (synthetic_bal_problem,  # noqa: E402
                              build_bal_ceres_problem)

SHAPE = dict(num_cameras=16, num_points=22106, num_observations=83718)
PERTURB = dict(rotation_sigma=0.1, translation_sigma=1.0,
               point_sigma=0.5)


def run(label, mixed):
    bal = synthetic_bal_problem(**SHAPE, seed=7, pixel_noise=1.0)
    bal.perturb(**PERTURB, seed=8)
    problem, cams, pts = build_bal_ceres_problem(bal)
    opts = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
        preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
        max_num_iterations=50,
        function_tolerance=1e-6,
        max_linear_solver_iterations=100,
        use_mixed_precision_solves=mixed,
        fused_iterations=True,
    )
    summary = ct.solve(opts, problem)
    print(f"{label:>14}: {summary.num_iterations} LM iterations, "
          f"final cost {summary.final_cost:.12e}", flush=True)
    return summary


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    which = args[0] if args else "all"
    if which in ("all", "f64"):
        run("f64", mixed=False)
    if which in ("all", "mixed"):
        os.environ.pop("CERES_TPU_EXP_F64ACC", None)
        run("mixed", mixed=True)
    if which in ("all", "f64acc"):
        os.environ["CERES_TPU_EXP_F64ACC"] = "1"
        run("mixed+f64acc", mixed=True)
