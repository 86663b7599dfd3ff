"""Fused Schur elimination LM step: one pass over the Jacobian.

The generic step path (solver.py make_step_impl + solvers/schur.py SchurOps)
is assembled from reusable pieces, each of which re-reads the bucket
Jacobian from device memory and re-scatters into global vectors: cast,
gradient (J^T r), squared column norms, scale_columns (a full J rebuild),
column norms again, the chunk-layout gather, E^T E, the explicit-S
products, and back-substitution. At BAL scale that pipeline is bound not
by FLOPs (~1 GFLOP per iteration at BAL-16-22106) but by redundant passes
over J and [n, 3]-indexed scatters.

This module replaces the WHOLE LM step for Schur-structured problems with
a single fused pipeline (the reference's SchurEliminator role,
internal/ceres/schur_eliminator_impl.h, re-architected rather than
translated):

  1. linearize each bucket (vmapped jacfwd), corrector applied;
  2. gather rows into the chunk layout ONCE ([ne, k, r, t] per e-block);
  3. compute all Gram/cross/gradient reductions as dense einsums + one-hot
     matmuls over the chunk tensors: EtE [ne,te,te], cross A [ne,te,nf],
     block-diagonal FtF [kf,t,t], gradient e/f parts, column norms (which
     are just the Gram diagonals — no extra pass);
  4. apply Jacobi scaling and LM damping analytically to the SMALL tensors
     (scale is a rank-1 congruence: no scale_columns pass over J);
  5. eliminate: S = blockdiag(FtF) - A^T (EtE)^-1 A with a closed-form
     batched SPD inverse for te <= 3; solve the [nf, nf] reduced system
     with a dense Cholesky factorization (or CG for ITERATIVE_SCHUR);
  6. back-substitute and assemble the step, model cost change, step/grad
     norms from the e/f parts.

The big tensors are touched exactly twice (linearize write + chunk-gather
read); everything downstream lives in [ne, te, *] / [kf, t, t] tensors.

Supported when: single f size-group, every e-bucket chunk-grouped with one
f slot, one-hots available (same condition as SchurOps' grouped explicit-S
path). The generic path remains for everything else.
"""

from __future__ import annotations

import os
from typing import Optional

import functools

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np

# f32 matmuls at default precision may run in reduced precision (TF32 on
# the GPU's tensor cores, ~1e-3 relative error) — enough to push the
# damped Schur complement indefinite at typical LM damping levels. Large
# contractions (one-hot reductions, the S correction) therefore run at
# HIGHEST (true f32). The per-row outer products contract over r=2/k<=16,
# shapes no matrix unit helps with; those run as broadcast multiply-reduce
# (exact f32).
_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def _outer_rt(Ja, Jb):
    """sum_r Ja[..., r, :] (x) Jb[..., r, :] -> [..., ta, tb]."""
    return jnp.sum(Ja[..., :, :, None] * Jb[..., :, None, :], axis=-3)


def _chunk_gather(T, rows, mask):
    """T [n, ...] -> T[rows] * mask, rows [ne, k].

    Gathers FLAT rows (trailing dims collapsed) then reshapes, so each
    index moves one contiguous r*t row instead of r*t scalars."""
    trail = T.shape[1:]
    flat = jnp.take(T.reshape(T.shape[0], -1), rows.reshape(-1), axis=0)
    out = flat.reshape(rows.shape + trail)
    return out * mask.reshape(mask.shape + (1,) * len(trail))


def _rvec_rt(Ja, rg):
    """sum_r Ja[..., r, :] * rg[..., r] -> [..., ta]."""
    return jnp.sum(Ja * rg[..., None], axis=-2)

from ..types import LinearSolverType, PreconditionerType

__all__ = ["fused_schur_supported", "make_fused_schur_lm_step"]


def _slab_of(cols: np.ndarray) -> Optional[int]:
    """If cols.reshape(-1) == arange(s, s + size), return s (slab start)."""
    flat = cols.reshape(-1)
    if flat.size == 0:
        return None
    s = int(flat[0])
    if np.array_equal(flat, np.arange(s, s + flat.size, dtype=flat.dtype)):
        return s
    return None


def fused_structure_ok(meta, require_onehots: bool) -> bool:
    """Structural conditions shared by the single-device and sharded
    fused eliminators: one f group, chunk layout on every e-bucket, one f
    slot per bucket. require_onehots additionally demands materializable
    [n, kf] one-hots (needed only by the single-device EXPLICIT mode; the
    implicit mode runs camera-chunk gather+sum reductions and the sharded
    runtime builds its one-hots on the fly)."""
    if meta is None or len(meta.f_groups) != 1:
        return False
    grp = meta.f_groups[0]
    for bi, bs in enumerate(meta.buckets):
        if bs.e_slot is not None:
            if bs.chunk_rows is None:
                return False
            if bs.f_cols is None:
                continue          # e-only bucket (e.g. constant-camera
                                  # observations): EtE/g_e contributions
            slots_here = [s for s in grp["slots"] if s[0] == bi]
            if len(slots_here) != 1:
                return False
            if require_onehots and meta._build_onehot(
                    0, bi, slots_here[0][1], slots_here[0][2],
                    grp["kf"]) is None:
                return False
        elif bs.f_cols is not None:
            slots_here = [s for s in grp["slots"] if s[0] == bi]
            if len(slots_here) != 1:
                return False
            if require_onehots and meta._build_onehot(
                    0, bi, slots_here[0][1], slots_here[0][2],
                    grp["kf"]) is None:
                return False
    return True


def iterative_options_ok(options) -> bool:
    """ITERATIVE_SCHUR configurations the fused paths can serve: a
    preconditioner assembled exactly from the chunk tensors, no SPSE
    warm start (host-loop feature)."""
    if options.preconditioner_type not in (
            PreconditionerType.IDENTITY, PreconditionerType.JACOBI,
            PreconditionerType.SCHUR_JACOBI):
        return False
    return not options.use_spse_initialization


def fused_schur_supported(program, options, meta) -> bool:
    """Structural conditions for the single-device fused eliminator."""
    t = options.linear_solver_type
    if t in (LinearSolverType.DENSE_SCHUR, LinearSolverType.SPARSE_SCHUR):
        # direct reduced solve: dense S + the cross tensor A must fit
        return (fused_structure_ok(meta, require_onehots=True)
                and _explicit_viable(meta))
    if t == LinearSolverType.ITERATIVE_SCHUR:
        if not iterative_options_ok(options):
            return False
        # The one-hot viability cap only gates the explicit mode; the
        # implicit mode is one-hot-free, which is what lets the fused
        # path cover the production large-camera regime (1024 cams x 1M
        # observations has n*kf ~ 1e9, far past any materialization cap).
        will_be_explicit = (
            _explicit_viable(meta)
            and not os.environ.get("CERES_TPU_FORCE_IMPLICIT"))
        return fused_structure_ok(meta, require_onehots=will_be_explicit)
    return False


def _explicit_viable(meta) -> bool:
    """Dense S + materialized A = E^T F affordable? The caps keep peak
    device memory for A + inv(EtE)A + S around ~4 GB; past them the
    matrix-free implicit apply takes over. Explicit wins whenever it fits:
    the CG operator becomes one [nf, nf] matvec (~us) instead of a walk
    over the chunk tensors (~ms)."""
    return meta.nf <= 4096 and meta.ne * meta.te * meta.nf <= 4.2e8


# ----------------------------------------------------------------------
# small SPD inverses (closed form, batched) — replaces batched Cholesky +
# two triangular solves for the (E^T E + D^2) blocks.

def _spd_inv_small(M):
    """[k, t, t] SPD -> inverse, closed form for t in {1, 2, 3}; Cholesky
    fallback otherwise. Damped BA e-blocks are well-conditioned at f32."""
    t = M.shape[-1]
    if t == 1:
        return 1.0 / M
    if t == 2:
        a = M[..., 0, 0]
        b = M[..., 0, 1]
        d = M[..., 1, 1]
        det = a * d - b * b
        inv_det = 1.0 / det
        row0 = jnp.stack([d, -b], axis=-1)
        row1 = jnp.stack([-b, a], axis=-1)
        return jnp.stack([row0, row1], axis=-2) * inv_det[..., None, None]
    if t == 3:
        a = M[..., 0, 0]
        b = M[..., 0, 1]
        c = M[..., 0, 2]
        d = M[..., 1, 1]
        e = M[..., 1, 2]
        f = M[..., 2, 2]
        co00 = d * f - e * e
        co01 = c * e - b * f
        co02 = b * e - c * d
        co11 = a * f - c * c
        co12 = b * c - a * e
        co22 = a * d - b * b
        det = a * co00 + b * co01 + c * co02
        inv_det = 1.0 / det
        row0 = jnp.stack([co00, co01, co02], axis=-1)
        row1 = jnp.stack([co01, co11, co12], axis=-1)
        row2 = jnp.stack([co02, co12, co22], axis=-1)
        return jnp.stack([row0, row1, row2],
                         axis=-2) * inv_det[..., None, None]
    chol = jnp.linalg.cholesky(M)
    eye = jnp.broadcast_to(jnp.eye(t, dtype=M.dtype), M.shape)
    y = jsl.solve_triangular(chol, eye, lower=True)
    return jsl.solve_triangular(jnp.swapaxes(chol, -1, -2), y, lower=False)


def _spd_solve_dense(S, rhs):
    """Solve S y = rhs for one dense SPD [m, m] system by Cholesky
    (cuSOLVER on the GPU, LAPACK on the CPU). NaN on indefinite S, as the
    caller's invalid-step retry expects."""
    c, lower = jsl.cho_factor(S)
    return jsl.cho_solve((c, lower), rhs)


def make_fused_schur_lm_step(program, options, meta):
    """Returns lm_step(x, radius) -> out dict (same contract as
    solver.make_step_impl's lm_step)."""
    from ..loss import correct_residuals_and_jacobian
    from .schur import bk_slot_keys

    dtype = program.dtype
    mixed = options.use_mixed_precision_solves
    work_dtype = jnp.float32 if mixed else dtype
    if mixed and os.environ.get("CERES_TPU_EXP_F64ACC"):
        # Experiment knob: f32 jacfwd, but all Gram/solve arithmetic in
        # f64 — isolates accumulation error from J-entry rounding.
        work_dtype = dtype
    use_jacobi_scaling = options.jacobi_scaling
    min_diag = options.min_lm_diagonal
    max_diag = options.max_lm_diagonal
    ne, te, nf = meta.ne, meta.te, meta.nf
    grp = meta.f_groups[0]
    kf, tf = grp["kf"], grp["t"]
    iterative = (options.linear_solver_type
                 == LinearSolverType.ITERATIVE_SCHUR)
    # explicit: materialize A [ne, te, nf] + dense S (direct solve or
    # CG-on-explicit-S); implicit: matrix-free CG over the chunk tensors
    # (the large-camera-count regime). CERES_TPU_FORCE_IMPLICIT exercises
    # the implicit path at small sizes (tests).
    explicit = (not iterative) or (
        _explicit_viable(meta)
        and not os.environ.get("CERES_TPU_FORCE_IMPLICIT"))


    # ---- static structure (host, once) ----
    e_slab = _slab_of(meta.e_cols)                  # e cols contiguous?
    # global tangent columns of the f blocks, in block-layout order
    fpos_np = meta.f_global_cols[grp["cols"]].reshape(-1)    # [kf*tf]
    f_slab = _slab_of(fpos_np.reshape(kf, tf))
    program.register_const("schur.fused.fpos", fpos_np.astype(np.int32))

    bucket_plan = []
    for bi, (bk, bs) in enumerate(zip(program.buckets, meta.buckets)):
        slots_here = [s for s in grp["slots"] if s[0] == bi]
        (_, f_si, local) = slots_here[0] if slots_here else (None, None,
                                                            None)
        vslots = [i for i, sl in enumerate(bk.slots) if sl.variable]
        # offsets of each variable slot inside the bucket J tensor
        offs, off = [], 0
        for i, sl in enumerate(bk.slots):
            if sl.variable:
                offs.append((i, off, sl.tangent_size))
                off += sl.tangent_size
        slot_off = {vsi: (o, t) for vsi, (i, o, t) in
                    zip(range(len(offs)), offs)}
        bucket_plan.append(dict(bk=bk, bs=bs, bi=bi, f_si=f_si,
                                local=local, slot_off=slot_off))

    # Mixed mode rhs accuracy: f32 J·r products carry the f32 input
    # rounding, which costs ~1-2 extra LM iterations at BAL scale vs f64.
    # CERES_TPU_F64_RHS=1 computes the e/f gradients from the f64 Jacobian
    # before the cast, at the price of an f64 chunk gather and f64
    # reductions every iteration; OFF by default, for problems where
    # trajectory fidelity matters more than wall time.
    f64_rhs = mixed and bool(os.environ.get("CERES_TPU_F64_RHS"))

    cross_pairs = []
    if not explicit:
        # camera-chunk layouts for the matrix-free apply (host, once)
        for plan in bucket_plan:
            bs2 = plan["bs"]
            if bs2.f_cols is None:
                continue
            if bs2.e_slot is not None:
                _build_cam_chunks(program, plan["local"], bs2.chunk_rows,
                                  bs2.chunk_mask,
                                  f"schur.fused.cam{plan['bi']}", kf)
                # does any camera observe the same point through several
                # rows? (the SCHUR_JACOBI assembly then needs the
                # within-chunk cross terms to stay exact)
                plan["dup_cams"] = chunk_has_dup_cams(
                    plan["local"][bs2.chunk_rows], bs2.chunk_mask)
            else:
                _build_cam_chunks(program, plan["local"], None, None,
                                  f"schur.fused.cam{plan['bi']}", kf)
                program.register_const(
                    f"schur.fused.fids{plan['bi']}",
                    plan["local"].astype(np.int32))
        # Cross-BUCKET duplicate (camera, point) pairs (host, once):
        # ordered by the sstore e-entry order the solve phase iterates.
        cross_pairs = detect_cross_bucket_dups(
            [(plan["local"][plan["bs"].chunk_rows],
              plan["bs"].chunk_mask > 0)
             for plan in bucket_plan
             if plan["bs"].f_cols is not None
             and plan["bs"].e_slot is not None])

    # Split-phase structure: _lin_phase is radius-INdependent
    # (linearize + eliminate-ready scaled Grams); _solve_phase applies the
    # LM damping for a given radius and solves. The fused while-loop skips
    # _lin_phase on rejected steps (the reference reuses the Jacobian and
    # diagonal across rejections, levenberg_marquardt_strategy.cc
    # reuse_diagonal_), re-running only the damped solve.
    keep_chunks = not (explicit and mixed and not iterative)

    def _split_scale(scale):
        """Full tangent scale vector -> (s_e [ne, te], s_f [kf, tf])."""
        scale_w = scale.astype(work_dtype)
        if e_slab is not None:
            s_e = jax.lax.dynamic_slice(scale_w, (e_slab,),
                                        (ne * te,)).reshape(ne, te)
        else:
            s_e = scale_w[meta.c("e_cols", meta.e_cols)]
        if f_slab is not None:
            s_f = jax.lax.dynamic_slice(scale_w, (f_slab,),
                                        (kf * tf,)).reshape(kf, tf)
        else:
            s_f = scale_w[program.const("schur.fused.fpos")].reshape(kf, tf)
        return s_e, s_f

    def _resolve_scale(cn_e, cn_f, s_e_in, s_f_in, first):
        """Iteration-0 Jacobi scaling from THIS linearization's Gram
        diagonals (the column norms), carried thereafter — deriving it
        here keeps the fused program at ONE copy of the linearize graph
        (a separate scale pass cannot be CSE'd into the while_loop).
        first=None means 'use the given scale' (host-loop contract,
        where the minimizer computed the scale at x0 itself)."""
        if first is None:
            return s_e_in, s_f_in
        if not use_jacobi_scaling:
            return jnp.ones_like(cn_e), jnp.ones_like(cn_f)
        s_e = jnp.where(first, 1.0 / (1.0 + jnp.sqrt(cn_e)), s_e_in)
        s_f = jnp.where(first, 1.0 / (1.0 + jnp.sqrt(cn_f)), s_f_in)
        return s_e, s_f

    def _lin_phase(x, scale):
        s_e, s_f = _split_scale(scale)
        return _lin_phase_generic(x, s_e, s_f, None)

    def _lin_phase_carry(x, s_e, s_f, first, known_cost=None):
        # known_cost: f64 total cost at x, already evaluated by the
        # minimizer (the accepted candidate's cost from the previous
        # iteration) — skips the linearize phase's own f64 residual pass,
        # which is one full f64 residual evaluation per iteration.
        return _lin_phase_generic(x, s_e, s_f, first, known_cost)

    def _lin_phase_generic(x, s_e_in, s_f_in, first, known_cost=None):
        total_cost = jnp.asarray(program.fixed_cost, dtype=dtype)

        EtE = jnp.zeros((ne, te, te), dtype=work_dtype)
        g_e = jnp.zeros((ne, te), dtype=dtype if f64_rhs else work_dtype)
        FtF = jnp.zeros((kf, tf, tf), dtype=work_dtype)
        g_f = jnp.zeros((kf, tf), dtype=dtype if f64_rhs else work_dtype)
        A = (jnp.zeros((ne, te, kf * tf), dtype=work_dtype) if explicit
             else None)
        chunk_store = []                 # per e-bucket tensors for back-sub

        for plan in bucket_plan:
            bk, bs, bi = plan["bk"], plan["bs"], plan["bi"]
            loss = program._bucket_loss(bk)
            if mixed and not f64_rhs:
                # Mixed precision: the jacfwd tangent chains run in f32;
                # cost comes from a cheap f64 residual-only pass so
                # trust-region tolerances keep their f64 meaning. (The
                # f64 residuals also feed the corrected rc below, so the
                # pass stays even when the minimizer carries the cost.)
                r64 = program._bucket_residuals(bk, x)
                if known_cost is None:
                    cost, _, _ = correct_residuals_and_jacobian(
                        loss, r64, None)
                    total_cost = total_cost + jnp.sum(cost)
                _, J32 = program._bucket_linearize(
                    bk, x, cast_dtype=jnp.float32)
                _, rc, Jc = correct_residuals_and_jacobian(
                    loss, r64.astype(work_dtype), J32)
                rc = rc.astype(work_dtype)
                Jc = Jc.astype(work_dtype)
                rc64, Jc64 = rc, Jc    # f64_rhs is off on this path
            else:
                r, J = program._bucket_linearize(bk, x)
                cost, rc64, Jc64 = correct_residuals_and_jacobian(
                    loss, r, J)
                total_cost = total_cost + jnp.sum(cost)
                rc = rc64.astype(work_dtype)
                Jc = Jc64.astype(work_dtype)

            if bs.e_slot is not None and bs.f_cols is None:
                # ---- e-only bucket (constant f-side parameters) ----
                rows = meta.c(f"b{bi}.chunk_rows", bs.chunk_rows)
                mask = meta.c(f"b{bi}.chunk_mask",
                              bs.chunk_mask).astype(work_dtype)
                Jg = _chunk_gather(Jc, rows, mask)
                rg = _chunk_gather(rc, rows, mask)
                eo, _ = plan["slot_off"][bs.e_slot]
                Je = Jg[..., eo:eo + te]
                EtE = EtE + jnp.sum(_outer_rt(Je, Je), axis=1)
                if f64_rhs:
                    mask64 = mask.astype(dtype)
                    Jg64 = _chunk_gather(Jc64, rows, mask64)
                    rg64 = _chunk_gather(rc64, rows, mask64)
                    g_e = g_e + jnp.sum(
                        _rvec_rt(Jg64[..., eo:eo + te], rg64), axis=1)
                else:
                    g_e = g_e + jnp.sum(_rvec_rt(Je, rg), axis=1)
                chunk_store.append(("e0", Je, None, None, plan))
            elif bs.e_slot is not None:
                # ---- chunk-grouped e-bucket ----
                rows = meta.c(f"b{bi}.chunk_rows", bs.chunk_rows)
                mask = meta.c(f"b{bi}.chunk_mask",
                              bs.chunk_mask).astype(work_dtype)
                Jg = _chunk_gather(Jc, rows, mask)       # [ne, k, rr, tt]
                rg = _chunk_gather(rc, rows, mask)       # [ne, k, rr]
                eo, _ = plan["slot_off"][bs.e_slot]
                fo, ftw = plan["slot_off"][plan["f_si"]]
                Je = Jg[..., eo:eo + te]                 # [ne,k,rr,te]
                Jf = Jg[..., fo:fo + ftw]                # [ne,k,rr,tf]

                EtE = EtE + jnp.sum(_outer_rt(Je, Je), axis=1)
                Gf = _outer_rt(Jf, Jf)                   # [ne,k,tf,tf]
                if explicit and kf == 1:
                    # One-f-block specialization (the reference's
                    # SchurEliminatorForOneFBlock role,
                    # schur_eliminator.h:365, re-architected): every
                    # one-hot is identically 1, so the selector matmuls
                    # collapse to plain sums and no [n, kf] one-hot is
                    # built or read. Pad lanes contribute zero (Jg/rg are
                    # already chunk-masked). Two-view BA / single-camera
                    # refinement land here.
                    oh = None
                    FtF = FtF + jnp.sum(Gf, axis=(0, 1))[None]
                    Ge = _outer_rt(Je, Jf)               # [ne,k,te,tf]
                    A = A + jnp.sum(Ge, axis=1).reshape(ne, te, kf * tf)
                elif explicit:
                    _, oh = meta.grouped_fslot(0, bi, plan["f_si"],
                                               plan["local"])
                    oh = oh.astype(work_dtype)           # [ne,k,kf]
                    FtF = FtF + _einsum("nkc,nktu->ctu", oh, Gf)
                    Ge = _outer_rt(Je, Jf)               # [ne,k,te,tf]
                    # A: contraction over k (chunk width) — broadcast sum
                    # to [ne, te, kf, tf] then flatten block-major.
                    A = A + jnp.sum(oh[:, :, None, :, None]
                                    * Ge[:, :, :, None, :],
                                    axis=1).reshape(ne, te, kf * tf)
                else:
                    # Implicit mode: one-hot-free camera-chunk reduction
                    # (the [ne*k, kf] one-hot is unaffordable in the
                    # large-camera regime this mode exists for). Trailing
                    # dims are flattened before the gather (see
                    # _chunk_gather).
                    oh = None
                    camr = program.const(f"schur.fused.cam{bi}.rows")
                    camm = program.const(f"schur.fused.cam{bi}.mask"
                                         ).astype(work_dtype)
                    FtF = FtF + jnp.sum(
                        Gf.reshape(-1, ftw * ftw)[camr]
                        * camm[..., None], axis=1).reshape(kf, ftw, ftw)
                if f64_rhs:
                    mask64 = mask.astype(dtype)
                    Jg64 = _chunk_gather(Jc64, rows, mask64)
                    rg64 = _chunk_gather(rc64, rows, mask64)
                    g_e = g_e + jnp.sum(
                        _rvec_rt(Jg64[..., eo:eo + te], rg64), axis=1)
                    gf64 = _rvec_rt(Jg64[..., fo:fo + ftw], rg64)
                    if explicit and kf == 1:
                        g_f = g_f + jnp.sum(gf64, axis=(0, 1))[None]
                    elif explicit:
                        g_f = g_f + _einsum("nkc,nkt->ct",
                                            oh.astype(dtype), gf64)
                    else:
                        g_f = g_f + jnp.sum(
                            gf64.reshape(-1, ftw)[camr]
                            * camm.astype(dtype)[..., None], axis=1)
                else:
                    g_e = g_e + jnp.sum(_rvec_rt(Je, rg), axis=1)
                    gfc = _rvec_rt(Jf, rg)
                    if explicit and kf == 1:
                        g_f = g_f + jnp.sum(gfc, axis=(0, 1))[None]
                    elif explicit:
                        g_f = g_f + _einsum("nkc,nkt->ct", oh, gfc)
                    else:
                        g_f = g_f + jnp.sum(
                            gfc.reshape(-1, ftw)[camr]
                            * camm[..., None], axis=1)
                chunk_store.append(("e", Je, Jf, oh, plan))
            elif bs.f_cols is not None:
                # ---- f-only bucket: block-diagonal + gradient ----
                fo, ftw = plan["slot_off"][plan["f_si"]]
                Jf = Jc[..., fo:fo + ftw]                # [n, rr, tf]
                G = _outer_rt(Jf, Jf)                    # [n,tf,tf]
                if explicit and kf == 1:
                    oh = None           # one-f-block: selector is all-ones
                    FtF = FtF + jnp.sum(G, axis=0)[None]
                elif explicit:
                    oh = meta.onehot(0, bi, plan["f_si"], plan["local"],
                                     kf).astype(work_dtype)
                    FtF = FtF + _einsum("nc,ntu->ctu", oh, G)
                else:
                    oh = None
                    camr = program.const(f"schur.fused.cam{bi}.rows")
                    camm = program.const(f"schur.fused.cam{bi}.mask"
                                         ).astype(work_dtype)
                    FtF = FtF + jnp.sum(
                        G.reshape(-1, ftw * ftw)[camr]
                        * camm[..., None], axis=1).reshape(kf, ftw, ftw)
                if f64_rhs:
                    gf64 = _rvec_rt(Jc64[..., fo:fo + ftw], rc64)
                    if explicit and kf == 1:
                        g_f = g_f + jnp.sum(gf64, axis=0)[None]
                    elif explicit:
                        g_f = g_f + _einsum("nc,nt->ct",
                                            oh.astype(dtype), gf64)
                    else:
                        g_f = g_f + jnp.sum(
                            gf64[camr] * camm.astype(dtype)[..., None],
                            axis=1)
                else:
                    gfc = _rvec_rt(Jf, rc)
                    if explicit and kf == 1:
                        g_f = g_f + jnp.sum(gfc, axis=0)[None]
                    elif explicit:
                        g_f = g_f + _einsum("nc,nt->ct", oh, gfc)
                    else:
                        g_f = g_f + jnp.sum(gfc[camr] * camm[..., None],
                                            axis=1)
                chunk_store.append(("f", Jf, None, oh, plan))

        if known_cost is not None:
            total_cost = known_cost.astype(dtype)

        # ---- column norms ARE the Gram diagonals ----
        # Fixed iteration-0 Jacobi scaling
        # (trust_region_minimizer.cc:261-277), given by the host-loop
        # minimizer (first=None) or derived here on the fused loop's
        # first iteration.
        cn_e = jnp.diagonal(EtE, axis1=-2, axis2=-1)     # [ne, te]
        cn_f = jnp.diagonal(FtF, axis1=-2, axis2=-1)     # [kf, tf]
        s_e, s_f = _resolve_scale(cn_e, cn_f, s_e_in, s_f_in, first)

        # ---- scale the small tensors (radius-independent) ----
        # scaled Gram = diag(s) G diag(s); scaled col norm = s^2 cn.
        diag_e = jnp.clip(s_e * s_e * cn_e, min_diag, max_diag)
        diag_f = jnp.clip(s_f * s_f * cn_f, min_diag, max_diag)
        EtE_s = EtE * (s_e[:, :, None] * s_e[:, None, :])
        FtF_s = FtF * (s_f[:, :, None] * s_f[:, None, :])
        sA = s_f.reshape(kf * tf)
        A_s = (A * s_e[:, :, None] * sA[None, None, :]) if explicit \
            else None
        # scale in the gradient's (possibly f64) dtype, then cast the rhs
        # to the working precision — the ACCUMULATION accuracy is what
        # matters, not the storage of the final vector.
        g_se = (g_e * s_e.astype(g_e.dtype)).astype(work_dtype)
        g_sf = (g_f * s_f.astype(g_f.dtype)
                ).reshape(kf * tf).astype(work_dtype)

        g_f_flat = g_f.reshape(kf * tf)
        grad_max = jnp.maximum(jnp.max(jnp.abs(g_e)),
                               jnp.max(jnp.abs(g_f_flat))).astype(dtype)
        grad_norm = jnp.sqrt(jnp.vdot(g_e, g_e)
                             + jnp.vdot(g_f_flat, g_f_flat)).astype(dtype)

        art = dict(cost=total_cost, EtE_s=EtE_s, FtF_s=FtF_s, A_s=A_s,
                   g_se=g_se, g_sf=g_sf, s_e=s_e, s_f=s_f, sA=sA,
                   diag_e=diag_e, diag_f=diag_f,
                   grad_max=grad_max, grad_norm=grad_norm)
        if keep_chunks:
            art["chunks"] = chunk_store
        if program.has_bounds:
            grad = jnp.zeros((program.num_effective,), dtype=g_e.dtype)
            if e_slab is not None:
                grad = jax.lax.dynamic_update_slice(
                    grad, g_e.reshape(-1), (e_slab,))
            else:
                grad = grad.at[meta.c("e_cols", meta.e_cols)].set(g_e)
            if f_slab is not None:
                grad = jax.lax.dynamic_update_slice(grad, g_f_flat,
                                                    (f_slab,))
            else:
                grad = grad.at[program.const("schur.fused.fpos")
                               ].set(g_f_flat)
            art["grad_full"] = grad.astype(dtype)
        return art

    def _solve_phase(art, radius):
        total_cost = art["cost"]
        EtE_s, FtF_s = art["EtE_s"], art["FtF_s"]
        A_s = art.get("A_s")
        g_se, g_sf = art["g_se"], art["g_sf"]
        s_e, s_f, sA = art["s_e"], art["s_f"], art["sA"]
        chunk_store = art.get("chunks", [])

        rad = radius.astype(work_dtype)
        D2_e = art["diag_e"] / rad                       # D^2, [ne, te]
        D2_f = art["diag_f"] / rad                       # [kf, tf]
        EtE_d = EtE_s + D2_e[..., None] * jnp.eye(te, dtype=work_dtype)
        inv_ete = _spd_inv_small(EtE_d)                  # [ne, te, te]

        # ---- eliminate + reduced solve (block layout) ----
        b_e = -g_se                                      # [ne, te]
        b_f = -g_sf                                      # [kf*tf]
        z = _einsum("nij,nj->ni", inv_ete, b_e)          # (EtE)^-1 b_e

        if explicit:
            rhs = b_f - _einsum("nuf,nu->f", A_s, z)
            Y = _einsum("nuv,nvf->nuf", inv_ete, A_s)
            S_corr = _einsum("nuf,nug->fg", A_s, Y)
            ii = jnp.arange(kf)
            S = (-S_corr).reshape(kf, tf, kf, tf).at[ii, :, ii, :].add(
                FtF_s + D2_f[..., None] * jnp.eye(tf, dtype=work_dtype)
            ).reshape(kf * tf, kf * tf)

            if not iterative:
                y = _spd_solve_dense(S, rhs)
                lin_iters = jnp.asarray(1, dtype=jnp.int32)
            else:
                from .cg import conjugate_gradients
                precond = _block_precond(
                    FtF_s + D2_f[..., None] * jnp.eye(tf,
                                                      dtype=work_dtype),
                    S, kf, tf, options.preconditioner_type, S_corr)
                result = conjugate_gradients(
                    lambda v: _einsum("fg,g->f", S, v), rhs,
                    jnp.zeros_like(rhs),
                    apply_preconditioner=precond,
                    max_iterations=options.max_linear_solver_iterations,
                    q_tolerance=options.eta,
                    min_iterations=options.min_linear_solver_iterations)
                y = result.x
                lin_iters = result.num_iterations

            # back-substitute: d_e = (EtE)^-1 (b_e - A y)
            d_e = _einsum("nij,nj->ni", inv_ete,
                          b_e - _einsum("nuf,f->nu", A_s, y))
        else:
            # ---- implicit (matrix-free) ITERATIVE_SCHUR over the chunk
            # tensors — the large-camera-count regime where A [ne,te,nf]
            # and dense S are unaffordable (implicit_schur_complement.h
            # role in the fused layout). Scaled chunk tensors are built
            # once; each CG application is a handful of broadcast
            # products + two camera-chunk reductions.
            # gather/camera-chunk forms: the one-hot [rows, kf] matrix
            # is ~0.4 GB at 256 cameras and would be re-read every CG
            # application; instead f values are row-taken by camera id
            # and F^T reductions run as camera-chunk gather + dense sum.
            sstore = []
            for kind, Je, Jf, oh, plan in chunk_store:
                if kind == "e0":
                    continue      # no F part: enters only through EtE
                bi2 = plan["bi"]
                camr = program.const(f"schur.fused.cam{bi2}.rows")
                camm = program.const(f"schur.fused.cam{bi2}.mask"
                                     ).astype(work_dtype)
                if kind == "e":
                    Je_s = Je * s_e[:, None, None, :]
                    fids = meta.grouped_loc(0, bi2, plan["f_si"],
                                            plan["local"])
                    sfrow = s_f[fids]                    # [ne,k,tf]
                    Jf_s = Jf * sfrow[:, :, None, :]
                else:
                    Je_s = None
                    fids = program.const(f"schur.fused.fids{bi2}")
                    sfrow = s_f[fids]                    # [n,tf]
                    Jf_s = Jf * sfrow[:, None, :]
                sstore.append((kind, Je_s, Jf_s, fids, camr, camm,
                               plan.get("dup_cams", False)))

            def mv(J, v):      # [..., r, t] x [..., t] -> [..., r]
                return jnp.sum(J * v[..., None, :], axis=-1)

            def cam_reduce(contrib, camr, camm):
                """[rows..., tf] -> [kf, tf] by camera-chunk gather+sum."""
                flat = contrib.reshape((-1,) + contrib.shape[-1:])
                return jnp.sum(flat[camr] * camm[..., None], axis=1)

            def apply_S(v):
                vb = v.reshape(kf, tf)
                out = jnp.zeros((kf, tf), dtype=work_dtype)
                u = jnp.zeros((ne, te), dtype=work_dtype)
                ws = []
                for kind, Je_s, Jf_s, fids, camr, camm, _dup in sstore:
                    vrow = vb[fids]
                    w = mv(Jf_s, vrow)
                    if kind == "e":
                        u = u + jnp.sum(_rvec_rt(Je_s, w), axis=1)
                    ws.append(w)
                zz = jnp.sum(inv_ete * u[:, None, :], axis=-1)
                for (kind, Je_s, Jf_s, fids, camr, camm, _dup), w in zip(
                        sstore, ws):
                    if kind == "e":
                        w2 = w - mv(Je_s, zz[:, None, :])
                    else:
                        w2 = w
                    out = out + cam_reduce(_rvec_rt(Jf_s, w2), camr, camm)
                return (out + D2_f * vb).reshape(kf * tf)

            # reduced rhs: b_f - F_s^T E_s z
            acc = jnp.zeros((kf, tf), dtype=work_dtype)
            for kind, Je_s, Jf_s, fids, camr, camm, _dup in sstore:
                if kind != "e":
                    continue
                w = mv(Je_s, z[:, None, :])
                acc = acc + cam_reduce(_rvec_rt(Jf_s, w), camr, camm)
            rhs = b_f - acc.reshape(kf * tf)

            # preconditioner blocks: exact block diagonal of S for
            # SCHUR_JACOBI — incl. within-chunk cross terms when a camera
            # observes a point through several rows, and cross-BUCKET
            # terms when the same (cam, point) pair has rows in two
            # buckets; of F_s^T F_s for JACOBI
            pk = options.preconditioner_type
            precond = None
            if pk != PreconditionerType.IDENTITY:
                blocks = FtF_s + D2_f[..., None] * jnp.eye(
                    tf, dtype=work_dtype)
                if pk == PreconditionerType.SCHUR_JACOBI:
                    for kind, Je_s, Jf_s, fids, camr, camm, dup in sstore:
                        if kind != "e":
                            continue
                        Ge_s = _outer_rt(Je_s, Jf_s)     # [ne,k,te,tf]
                        M = _einsum("nij,nkjt->nkit", inv_ete, Ge_s)
                        contribT = _sj_chunk_blocks(Ge_s, M, fids, dup)
                        blocks = blocks - _sj_reduce_to_blocks(
                            contribT, camr, camm,
                            Ge_s.shape[1], Ge_s.shape[0], tf)
                    # cross-BUCKET duplicate (cam, point) pairs: the S
                    # diagonal couples the buckets' Ge contributions
                    es = [t for t in sstore if t[0] == "e"]
                    for i1, i2 in cross_pairs:
                        _, Je1, Jf1, fid1, camr1, camm1, _ = es[i1]
                        _, Je2, Jf2, fid2, _, _, _ = es[i2]
                        Ge1 = _outer_rt(Je1, Jf1)
                        crossT = _sj_cross_pair_blocks(
                            Ge1, _outer_rt(Je2, Jf2),
                            inv_ete, fid1, fid2)
                        blocks = blocks - _sj_reduce_to_blocks(
                            crossT, camr1, camm1,
                            Ge1.shape[1], Ge1.shape[0], tf)
                precond = _precond_from_blocks(blocks, kf, tf)

            from .cg import conjugate_gradients
            result = conjugate_gradients(
                apply_S, rhs, jnp.zeros_like(rhs),
                apply_preconditioner=precond,
                max_iterations=options.max_linear_solver_iterations,
                q_tolerance=options.eta,
                min_iterations=options.min_linear_solver_iterations)
            y = result.x
            lin_iters = result.num_iterations

            # back-substitute: d_e = (EtE)^-1 (b_e - E_s^T F_s y)
            yb = y.reshape(kf, tf)
            u2 = jnp.zeros((ne, te), dtype=work_dtype)
            for kind, Je_s, Jf_s, fids, camr, camm, _dup in sstore:
                if kind != "e":
                    continue
                yrow = yb[fids]
                u2 = u2 + jnp.sum(_rvec_rt(Je_s, mv(Jf_s, yrow)), axis=1)
            d_e = jnp.sum(inv_ete * (b_e - u2)[:, None, :], axis=-1)

        # ---- step, norms, model cost change (all from parts) ----
        d_dot_g = jnp.vdot(d_e, g_se) + jnp.vdot(y, g_sf)
        if mixed and not iterative:
            # Exact direct solve: ||J_s d||^2 = d.b - ||D d||^2; the f32
            # step already bounds tail accuracy, the saved matvec is
            # material (solver.py's exact_solver rationale).
            Dd_sq = jnp.sum(D2_e * d_e * d_e) + jnp.sum(
                D2_f.reshape(kf * tf) * y * y)
            Jd_sq = -d_dot_g - Dd_sq
        else:
            # Exact ||J_s d||^2 via the stored chunk tensors: required for
            # f64 tail digits (the identity cancels catastrophically near
            # convergence) and for inexact CG solves (identity invalid).
            dw_e = s_e * d_e                          # [ne, te] work dtype
            dw_fb = (sA * y).reshape(kf, tf)          # [kf, tf]
            Jd_sq = jnp.asarray(0.0, dtype=work_dtype)
            for kind, Ja, Jb, oh, _plan in chunk_store:
                if kind == "e":
                    if oh is None:      # implicit mode: row-take by f id
                        fids = meta.grouped_loc(0, _plan["bi"],
                                                _plan["f_si"],
                                                _plan["local"])
                        dfb = dw_fb[fids]                # [ne,k,tf]
                    else:
                        dfb = _einsum("nkc,ct->nkt", oh, dw_fb)
                    Jd = _einsum("nkrt,nt->nkr", Ja, dw_e) \
                        + _einsum("nkrt,nkt->nkr", Jb, dfb)
                elif kind == "e0":
                    Jd = _einsum("nkrt,nt->nkr", Ja, dw_e)
                else:
                    if oh is None and kf == 1:
                        # one-f-block specialization: every row maps to
                        # block 0
                        dfb = jnp.broadcast_to(
                            dw_fb[0], Ja.shape[:1] + (tf,))
                    elif oh is None:
                        fids = program.const(
                            f"schur.fused.fids{_plan['bi']}")
                        dfb = dw_fb[fids]                # [n,tf]
                    else:
                        dfb = _einsum("nc,ct->nt", oh, dw_fb)
                    Jd = _einsum("nrt,nt->nr", Ja, dfb)
                Jd_sq = Jd_sq + jnp.vdot(Jd, Jd)
        mcc = -(d_dot_g + 0.5 * Jd_sq)

        delta_e = (s_e * d_e).astype(dtype)              # [ne, te]
        delta_f = (sA * y).astype(dtype)                 # [kf*tf] block order
        delta = jnp.zeros((program.num_effective,), dtype=dtype)
        if e_slab is not None:
            delta = jax.lax.dynamic_update_slice(
                delta, delta_e.reshape(-1), (e_slab,))
        else:
            delta = delta.at[meta.c("e_cols", meta.e_cols)].set(delta_e)
        if f_slab is not None:
            delta = jax.lax.dynamic_update_slice(delta, delta_f, (f_slab,))
        else:
            delta = delta.at[program.const("schur.fused.fpos")].set(delta_f)

        out = {
            "cost": total_cost,
            "gradient_max_norm": art["grad_max"],
            "gradient_norm": art["grad_norm"],
            "delta": delta,
            "model_cost_change": mcc.astype(dtype),
            "step_norm": jnp.linalg.norm(delta),
            "lin_iters": lin_iters,
        }
        if program.has_bounds:
            out["gradient_full"] = art["grad_full"]
        return out

    def lm_step(x, radius, scale):
        return _solve_phase(_lin_phase(x, scale), radius)

    # Rejected-step fast path (see minimizers/fused.py): valid when the
    # solve phase needs nothing beyond the art pytree (identity-mcc
    # explicit mixed mode — otherwise the chunk tensors would live in the
    # while-loop carry).
    lm_step.split_ok = not keep_chunks
    lm_step.linearize = _lin_phase
    lm_step.linearize_carry = _lin_phase_carry
    lm_step.scale_carry_example = (
        jax.ShapeDtypeStruct((ne, te), work_dtype),
        jax.ShapeDtypeStruct((kf, tf), work_dtype))
    lm_step.solve_from = _solve_phase

    return lm_step


def cam_chunk_layout(cams, positions, kf: int, kc: int = None):
    """Group `positions` (row ids) by f-block id `cams` into a dense
    [kf, kc] index layout with a validity mask — the camera-chunk form
    the implicit reductions gather over. Shared by the single-device
    (_build_cam_chunks) and sharded (_cam_chunks_per_shard) builders."""
    cams = np.asarray(cams, dtype=np.int64)
    positions = np.asarray(positions)
    counts = np.bincount(cams, minlength=kf)
    if kc is None:
        kc = max(1, int(counts.max()) if counts.size else 1)
    order = np.argsort(cams, kind="stable")
    starts = np.zeros(kf, dtype=np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    rank = np.arange(len(cams), dtype=np.int64) - starts[cams[order]]
    rows = np.zeros((kf, kc), dtype=np.int32)
    mask = np.zeros((kf, kc), dtype=np.float32)
    rows[cams[order], rank] = positions[order].astype(np.int32)
    mask[cams[order], rank] = 1.0
    return rows, mask


def chunk_has_dup_cams(fids, mask) -> bool:
    """Does any chunk row observe the same f block through more than one
    valid lane? Decides whether the implicit SCHUR_JACOBI assembly needs
    the within-chunk cross terms (host-side, once per program)."""
    fs = np.sort(np.where(np.asarray(mask) > 0, np.asarray(fids), -1),
                 axis=1)
    return bool(np.any((fs[:, 1:] == fs[:, :-1]) & (fs[:, 1:] >= 0)))


def _build_cam_chunks(program, local, chunk_rows, chunk_mask, name, kf):
    """Camera-chunk layout for the implicit apply: rows regrouped BY
    F-BLOCK so the F^T reductions become gather + dense sum instead of a
    one-hot matmul (the [n, kf] one-hot is ~0.4 GB at 256 cameras and is
    read twice per CG application). Returns (rows [kf, kc], mask) program
    consts: flat positions into the POINT-chunk layout (or observation
    order when chunk_rows is None); padded lanes are masked AND point at
    position 0 (whose contribution is zeroed by the chunk mask anyway)."""
    n = local.shape[0]
    if chunk_rows is not None:
        # position of each original row inside the flattened point-chunk
        # layout (pad lanes carry row id 0 but mask 0 — exclude via mask)
        flat_rows = chunk_rows.reshape(-1)
        flat_valid = chunk_mask.reshape(-1) > 0
        pos_of_row = np.zeros(n, dtype=np.int64)
        pos_of_row[flat_rows[flat_valid]] = np.nonzero(flat_valid)[0]
    else:
        pos_of_row = np.arange(n, dtype=np.int64)
    rows, mask = cam_chunk_layout(local, pos_of_row, kf)
    program.register_const(f"{name}.rows", rows)
    program.register_const(f"{name}.mask", mask)
    return name


def _sj_chunk_blocks(Ge_s, M, fids, dup: bool):
    """Per-lane contributions to the S block diagonal, TRANSPOSED:
    returns [tf*tf, k, ne] (row t*tf+v) with the long row axis TRAILING
    (tiny trailing dims would pad badly in a [n, k, tf, tf] layout).
    Math: Ge^T inv(EtE) Ge per lane; with dup=True (some camera observes
    the same point through more than one row) the within-chunk cross
    terms between same-camera lanes are included via a k^2 pass, keeping
    the SCHUR_JACOBI blocks the exact diagonal of S.
    Shared by the single-device and sharded implicit assemblies."""
    ne, k, u, tf = Ge_s.shape
    Ge_t = Ge_s.transpose(2, 3, 1, 0)                    # [u, t, k, ne]
    if not dup:
        M_t = M.transpose(2, 3, 1, 0)                    # [u, v, k, ne]
        C = _einsum("utkn,uvkn->tvkn", Ge_t, M_t)
        return C.reshape(tf * tf, k, ne)
    out = None
    for k2 in range(k):
        eq = (fids == fids[:, k2:k2 + 1]).astype(Ge_s.dtype)   # [ne, k]
        M2_t = M[:, k2].transpose(1, 2, 0)               # [u, v, ne]
        C = _einsum("utkn,uvn->tvkn", Ge_t, M2_t)
        C = C * eq.T[None, None]
        out = C if out is None else out + C
    return out.reshape(tf * tf, k, ne)


def _sj_reduce_to_blocks(contribT, camr, camm, k, ne, tf):
    """Camera-chunk reduction of transposed lane contributions:
    [tf*tf, k, ne] -> [kf, tf, tf]. camr holds row indices in the
    original n-major lane order (n*k + lane), remapped here to the
    transposed lane-major order (lane*ne + n)."""
    camr2 = (camr % k) * ne + camr // k
    flat = contribT.reshape(tf * tf, k * ne)
    taken = jnp.take(flat, camr2.reshape(-1), axis=1).reshape(
        (tf * tf,) + camr.shape)
    return jnp.sum(taken * camm[None], axis=2).T.reshape(-1, tf, tf)


def _sj_cross_pair_blocks(Ge1_s, Ge2_s, inv_ete, fids1, fids2):
    """Cross-BUCKET correction to the implicit SCHUR_JACOBI blocks: when
    the same (camera, point) pair carries residual rows in two different
    buckets (e.g. two loss functions on one observation), the S diagonal
    block has cross terms between the buckets' Ge contributions —
    A_c = sum_rows Ge_row sums ACROSS buckets before the congruence.
    Returns the TRANSPOSED [tf*tf, k1, ne] contribution C + C^T with
    C[n, k1] = sum_{k2 : fids2[n,k2] == fids1[n,k1]}
               Ge1[n,k1]^T inv_ete[n] Ge2[n,k2]
    to be camera-chunk-reduced with BUCKET 1's layout (each unordered
    cross pair is counted exactly once there; use _sj_reduce_to_blocks).
    Pad lanes contribute zero (Ge tensors are chunk-masked)."""
    ne, k1, u, tf = Ge1_s.shape
    Ge1_t = Ge1_s.transpose(2, 3, 1, 0)                  # [u, t, k1, ne]
    Ge2_t = Ge2_s.transpose(2, 3, 1, 0)                  # [v?, t, k2, ne]
    inv_t = inv_ete.transpose(1, 2, 0)                   # [u, v, ne]
    MG2_t = _einsum("uvn,vtln->utln", inv_t, Ge2_t)      # [u, t, k2, ne]
    eq = (fids1[:, :, None] == fids2[:, None, :]).astype(Ge1_s.dtype)
    eq_t = eq.transpose(1, 2, 0)                         # [k1, k2, ne]
    C = _einsum("utkn,umln,kln->tmkn", Ge1_t, MG2_t, eq_t)
    C = C + C.transpose(1, 0, 2, 3)
    return C.reshape(tf * tf, k1, ne)


def detect_cross_bucket_dups(e_entries):
    """Host-side, once per program: which ORDERED pairs of e-buckets
    share a (point, camera) observation? e_entries: list of
    (fids [ne, k] np, valid [ne, k] bool np). Returns [(i, j), ...]
    index pairs (i < j) into that list."""
    stride = 1 + max((int(np.asarray(f).max(initial=0))
                      for f, _ in e_entries), default=0)
    keys = []
    for fids, valid in e_entries:
        fids = np.asarray(fids, dtype=np.int64)
        valid = np.asarray(valid, dtype=bool)
        n_idx = np.broadcast_to(
            np.arange(fids.shape[0], dtype=np.int64)[:, None], fids.shape)
        keys.append(np.unique(n_idx[valid] * stride + fids[valid]))
    return [(i, j)
            for i in range(len(keys)) for j in range(i + 1, len(keys))
            if np.intersect1d(keys[i], keys[j], assume_unique=True).size]


def _precond_from_blocks(blocks, kf, tf):
    """Block-diagonal preconditioner apply from [kf, tf, tf] SPD blocks.

    The inverse is materialized ONCE (closed form for tf <= 3, Cholesky
    against the identity otherwise) so every CG application is a single
    broadcast multiply-reduce instead of batched tiny triangular solves
    inside the CG body."""
    inv = _spd_inv_small(blocks)

    def apply(v):
        return jnp.sum(inv * v.reshape(kf, 1, tf),
                       axis=-1).reshape(kf * tf)

    return apply


def _block_precond(P_blocks, S, kf, tf, kind, S_corr):
    """Preconditioner apply for the fused ITERATIVE_SCHUR CG over an
    explicit S, or None for IDENTITY. JACOBI: block diagonal of F^T F
    (+damping); SCHUR_JACOBI: block diagonal of S itself (exact, since
    S is materialized here)."""
    if kind == PreconditionerType.IDENTITY:
        return None
    if kind == PreconditionerType.SCHUR_JACOBI:
        P_blocks = S.reshape(kf, tf, kf, tf)[jnp.arange(kf), :,
                                             jnp.arange(kf), :]
    return _precond_from_blocks(P_blocks, kf, tf)
