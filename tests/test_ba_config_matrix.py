"""Combinatorial end-to-end BA config matrix (the reference's generated
bundle-adjustment test tier: generate_bundle_adjustment_tests.py:44,
bundle_adjustment_test_util.h:61-246).

One 16-camera synthetic BAL problem; every config in the product
{linear solver x preconditioner x ordering x mesh x precision x strategy}
solves it and the FINAL RESIDUAL VECTOR is compared against the trusted
reference configuration's (DENSE_SCHUR f64 auto-ordering) to 1e-4 —
residuals, not parameters, since parameter space is gauge-ambiguous
(test_util.h:102-113 methodology). Runtime is budgeted by a downscaled
point count (compile cost dominates, numeric cost is negligible) and by
the shared per-structure program cache.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.io.bal import synthetic_bal_problem, build_bal_ceres_problem

NCAM, NPTS, NOBS = 16, 600, 2400
FTOL = 1e-9
RES_TOL = 1e-4           # reference tolerance (bundle_adjustment_test_util.h:245)
RES_TOL_MIXED = 5e-3     # f32-Jacobian configs round the trajectory

L = ct.LinearSolverType
P = ct.PreconditionerType


def _bal():
    bal = synthetic_bal_problem(NCAM, NPTS, NOBS, seed=11, pixel_noise=1.0)
    bal.perturb(rotation_sigma=0.05, translation_sigma=0.5,
                point_sigma=0.25, seed=12)
    return bal


_BAL = _bal()


def _solve(mesh=None, ordering="auto", **kw):
    problem, cams, pts = build_bal_ceres_problem(_BAL)
    if ordering == "user":
        ob = ct.ParameterBlockOrdering()
        for p in pts:
            ob.add_element_to_group(p, 0)
        for c in cams:
            ob.add_element_to_group(c, 1)
        kw["linear_solver_ordering"] = ob
    if kw.pop("subset_rbs", False):
        # SUBSET preconditioner (subset_preconditioner.h:70 role): a
        # half-problem row subset whose Gram covers every column
        rbs = problem.residual_blocks()[:NOBS // 2]
        kw["residual_blocks_for_subset_preconditioner"] = rbs
    if mesh == "mesh8":
        import jax
        from jax.sharding import Mesh
        devs = np.asarray(jax.devices()[:8])
        kw["mesh"] = Mesh(devs, axis_names=("data",))
    opts = ct.SolverOptions(max_num_iterations=40,
                            function_tolerance=FTOL, **kw)
    summary = ct.solve(opts, problem)
    assert summary.is_solution_usable(), summary.message
    _, residuals, _, _ = problem.evaluate(apply_loss_function=False)
    return summary, np.asarray(residuals)


@pytest.fixture(scope="module")
def reference_solution():
    summary, residuals = _solve(linear_solver_type=L.DENSE_SCHUR)
    assert summary.termination_type == ct.TerminationType.CONVERGENCE
    return summary, residuals


def _check(cfg, reference_solution, tol=RES_TOL):
    ref_summary, r_ref = reference_solution
    summary, r = _solve(**cfg)
    scale = 1.0 + float(np.max(np.abs(r_ref)))
    err = float(np.max(np.abs(r - r_ref)))
    assert err < tol * scale, (
        f"residual mismatch {err:.3e} (tol {tol * scale:.3e}); "
        f"cost {summary.final_cost:.6e} vs ref {ref_summary.final_cost:.6e}")


# ---------------------------------------------------------------------
# single-device f64 matrix

_SINGLE = []
for solver in (L.DENSE_SCHUR, L.SPARSE_SCHUR):
    for ordering in ("auto", "user"):
        _SINGLE.append(dict(linear_solver_type=solver, ordering=ordering))
for pre in (P.JACOBI, P.SCHUR_JACOBI, P.SCHUR_POWER_SERIES_EXPANSION,
            P.CLUSTER_JACOBI, P.CLUSTER_TRIDIAGONAL):
    for ordering in ("auto", "user"):
        _SINGLE.append(dict(linear_solver_type=L.ITERATIVE_SCHUR,
                            preconditioner_type=pre, ordering=ordering))
for pre in (P.CLUSTER_JACOBI, P.CLUSTER_TRIDIAGONAL):
    _SINGLE.append(dict(linear_solver_type=L.ITERATIVE_SCHUR,
                        preconditioner_type=pre,
                        visibility_clustering_type=ct
                        .VisibilityClusteringType.SINGLE_LINKAGE))
_SINGLE.append(dict(linear_solver_type=L.ITERATIVE_SCHUR,
                    preconditioner_type=P.SCHUR_JACOBI,
                    use_explicit_schur_complement=True))
_SINGLE.append(dict(linear_solver_type=L.ITERATIVE_SCHUR,
                    preconditioner_type=P.SCHUR_JACOBI,
                    use_spse_initialization=True))
for pre in (P.IDENTITY, P.JACOBI):
    _SINGLE.append(dict(linear_solver_type=L.CGNR,
                        preconditioner_type=pre))
_SINGLE.append(dict(linear_solver_type=L.CGNR, preconditioner_type=P.JACOBI,
                    ordering="user"))
# SUBSET is a weaker preconditioner on this problem: untruncated CG
# (tight eta) so the LM trajectory matches the exact-solver reference
_SINGLE.append(dict(linear_solver_type=L.CGNR, preconditioner_type=P.SUBSET,
                    subset_rbs=True, eta=1e-6,
                    max_linear_solver_iterations=800))
for otype in (ct.OrderingType.AMD, ct.OrderingType.NATURAL):
    _SINGLE.append(dict(linear_solver_type=L.SPARSE_NORMAL_CHOLESKY,
                        linear_solver_ordering_type=otype))
_SINGLE.append(dict(linear_solver_type=L.DENSE_QR))
_SINGLE.append(dict(linear_solver_type=L.DENSE_NORMAL_CHOLESKY))
for dog in (ct.DoglegType.TRADITIONAL_DOGLEG, ct.DoglegType.SUBSPACE_DOGLEG):
    _SINGLE.append(dict(
        linear_solver_type=L.DENSE_SCHUR,
        trust_region_strategy_type=ct.TrustRegionStrategyType.DOGLEG,
        dogleg_type=dog))


def _cfg_id(cfg):
    bits = [str(cfg.get("linear_solver_type", "?"))]
    for k, v in cfg.items():
        if k in ("linear_solver_type",):
            continue
        bits.append(f"{k}={v}" if not isinstance(v, bool) or v else "")
    return "-".join(b for b in bits if b)


@pytest.mark.parametrize("cfg", _SINGLE, ids=_cfg_id)
def test_single_device_config(cfg, reference_solution):
    _check(cfg, reference_solution)


# ---------------------------------------------------------------------
# mixed-precision matrix (f32 Jacobian pipeline; reference role
# solver.h:572-589 mixed_precision_solves)

_MIXED = [
    dict(linear_solver_type=L.DENSE_SCHUR,
         use_mixed_precision_solves=True),
    dict(linear_solver_type=L.SPARSE_SCHUR,
         use_mixed_precision_solves=True),
    dict(linear_solver_type=L.ITERATIVE_SCHUR,
         preconditioner_type=P.SCHUR_JACOBI,
         use_mixed_precision_solves=True),
    dict(linear_solver_type=L.CGNR, preconditioner_type=P.JACOBI,
         use_mixed_precision_solves=True),
    dict(linear_solver_type=L.SPARSE_NORMAL_CHOLESKY,
         use_mixed_precision_solves=True),
    dict(linear_solver_type=L.DENSE_NORMAL_CHOLESKY,
         use_mixed_precision_solves=True),
]


@pytest.mark.parametrize("cfg", _MIXED, ids=_cfg_id)
def test_mixed_precision_config(cfg, reference_solution):
    _check(cfg, reference_solution, tol=RES_TOL_MIXED)


# ---------------------------------------------------------------------
# 8-device mesh matrix (the thread-count axis translated to mesh width;
# SURVEY.md section 4 test-strategy translation)

_MESH = [
    dict(linear_solver_type=L.DENSE_SCHUR, mesh="mesh8"),
    dict(linear_solver_type=L.DENSE_SCHUR, mesh="mesh8", ordering="user"),
    dict(linear_solver_type=L.SPARSE_SCHUR, mesh="mesh8"),
    dict(linear_solver_type=L.ITERATIVE_SCHUR,
         preconditioner_type=P.SCHUR_JACOBI, mesh="mesh8"),
    dict(linear_solver_type=L.ITERATIVE_SCHUR,
         preconditioner_type=P.JACOBI, mesh="mesh8"),
    dict(linear_solver_type=L.CGNR, preconditioner_type=P.JACOBI,
         mesh="mesh8"),
    dict(linear_solver_type=L.DENSE_SCHUR, mesh="mesh8",
         use_mixed_precision_solves=True),
]


@pytest.mark.parametrize("cfg", _MESH, ids=_cfg_id)
def test_mesh_config(cfg, reference_solution):
    tol = (RES_TOL_MIXED if cfg.get("use_mixed_precision_solves")
           else RES_TOL)
    _check(cfg, reference_solution, tol=tol)


def test_matrix_size():
    """The tier covers >= 40 configurations (VERDICT r3 item 8; the
    reference ships 73 generated files over a wider backend axis that
    has no analog here)."""
    assert len(_SINGLE) + len(_MIXED) + len(_MESH) >= 40, (
        len(_SINGLE), len(_MIXED), len(_MESH))
