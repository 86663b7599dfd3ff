"""Multi-chip fused Schur LM solve: the whole trust-region loop inside one
shard_map-ed, jitted device program.

This is the scale-out form of solvers/schur_fused.py (the single-chip fused
eliminator) and the production consumer of SolverOptions.mesh: residual
rows are sharded BY E-BLOCK over the mesh's data axis, so every tensor
indexed by e-blocks — the chunk-layout Jacobians, E^T E, its inverse, the
cross tensor A = E^T F, the e-side gradient and back-substitution — is
shard-local, with NO replication (the round-1 sharded path replicated the
dense A [ne, te, nf] per device; here A lives sharded, per-chip memory is
O(ne/P * te * nf)).

Per LM iteration the devices exchange exactly:
  psum #1: cost + unscaled F^T F block-diagonal + f gradient (≈ kf·t² + kf·t
           floats) + e-side max-abs gradient (pmax via psum of partials);
  psum #2: the S correction A_s^T (EtE)^-1 A_s and reduced-rhs correction
           (≈ nf² + nf floats);
  all_gather: the e-part of the step ([ne, te] → the full tangent delta);
  psum #3: the candidate cost (1 float).
All other traffic is zero; the reduced [nf, nf] camera solve runs
replicated (identical on every chip, so the LM control flow stays in
lockstep without communication).

Reference roles replaced: schur_eliminator_impl.h's per-thread chunk
buffers + mutex reduction -> per-chip partial Grams + psum over ICI
(SURVEY.md §5.7-5.8); trust_region_minimizer.cc's outer loop ->
lax.while_loop running identically on all chips.
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..loss import correct_residuals_and_jacobian
from ..types import LinearSolverType, PreconditionerType

_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def sharded_fused_supported(program, options, meta,
                            num_shards: int = None) -> bool:
    """The sharded runtime never needs the host [n, kf] one-hots — its
    explicit mode builds shard-local one-hots on the fly and its implicit
    mode uses camera-chunk reductions — so the structural check runs with
    require_onehots=False (the single-device predicate would spuriously
    reject mid-size mesh problems whose n*kf exceeds the host cap)."""
    from ..solvers.schur_fused import (fused_structure_ok,
                                      iterative_options_ok)
    if not fused_structure_ok(meta, require_onehots=False):
        return False
    if num_shards is None:
        num_shards = len(jax.devices())
    if options.linear_solver_type == LinearSolverType.ITERATIVE_SCHUR:
        # always coverable: shard-local explicit A when it fits, the
        # matrix-free implicit apply (one psum per CG iteration) beyond
        return iterative_options_ok(options)
    if options.linear_solver_type in (LinearSolverType.DENSE_SCHUR,
                                      LinearSolverType.SPARSE_SCHUR):
        # direct reduced solve: replicated dense S + shard-local A
        return _sharded_explicit_viable(meta, num_shards)
    return False


def _sharded_explicit_viable(meta, num_shards: int) -> bool:
    """Shard-local A [ne/P, te, nf] + replicated dense S affordable?"""
    return (meta.nf <= 4096
            and meta.ne * meta.te * meta.nf <= 1.5e8 * max(num_shards, 1))


def collective_footprint(meta, options, n_devices: int,
                         cg_iterations: int = 0,
                         dtype_bytes: int = 4) -> dict:
    """EXACT per-LM-iteration collective volume of the sharded fused
    solve, analytically from the problem structure (the CPU-mesh proxy
    cannot measure hardware scaling, so the claim "the communication
    pattern adds no superlinear cost" gets this number instead).

    Counts follow the module docstring's exchange list:
      explicit mode — psum #1 (cost + F^T F blockdiag + g_f + ge stats),
      psum #2 (S correction (kf·tf)^2 + rhs kf·tf), norm psum (3),
      all_gather of the e-part of the step [ne, te], candidate-cost
      psum (1);
      implicit mode — one [kf, tf] psum per CG application plus the
      reduced-rhs psum, instead of psum #2.
    Bytes are the logical payload per device per collective (ring
    all-reduce moves ~2x(P-1)/P of this over the wire; the factor is
    topology-dependent and excluded).

    Single-f-group only, matching the sharded fused path itself
    (fused_structure_ok requires len(f_groups) == 1) — asserted so the
    'exact' claim can never silently under-count a multi-group problem.
    """
    assert len(meta.f_groups) == 1, (
        "collective_footprint is exact only for the single-f-group "
        "structure the sharded fused path supports")
    grp = meta.f_groups[0]
    kf, tf, ne, te = grp["kf"], grp["t"], meta.ne, meta.te
    nf = kf * tf
    iterative = (options is not None and options.linear_solver_type
                 == LinearSolverType.ITERATIVE_SCHUR)
    psum1 = (1 + kf * tf * tf + kf * tf + 2) * dtype_bytes
    norms = 3 * dtype_bytes
    cand = 1 * dtype_bytes
    gather = ne * te * dtype_bytes
    out = {"n_devices": int(n_devices), "ne": ne, "nf": nf}
    if iterative and cg_iterations:
        per_cg = kf * tf * dtype_bytes
        out.update(psum_count=3 + 1 + cg_iterations,
                   psum_bytes=psum1 + norms + cand
                   + (1 + cg_iterations) * per_cg,
                   allgather_count=1, allgather_bytes=gather)
    else:
        psum2 = (nf * nf + nf) * dtype_bytes
        out.update(psum_count=4, psum_bytes=psum1 + psum2 + norms + cand,
                   allgather_count=1, allgather_bytes=gather)
    out["total_bytes"] = out["psum_bytes"] + out["allgather_bytes"]
    return out


def _cam_chunks_per_shard(fids, mask, kf: int, num_shards: int):
    """Per-shard camera-chunk index layout for the implicit reductions.

    fids/mask: [N, ...] padded so num_shards divides N (e-buckets
    [ne_pad, k], f-only buckets [n_pad]). Returns (rows, cmask) of shape
    [num_shards * kf, kc]: under a P(axis) in_spec each device sees its
    own [kf, kc] block of flat positions into ITS shard-local row space
    (size (N/num_shards) * k). Padded lanes point at position 0 with
    mask 0 (their contribution is zeroed by the row mask anyway)."""
    from ..solvers.schur_fused import cam_chunk_layout
    fids = np.asarray(fids)
    mask = np.asarray(mask)
    N = fids.shape[0]
    nloc = N // num_shards
    per = []
    kc = 1
    for s in range(num_shards):
        f = fids[s * nloc:(s + 1) * nloc].reshape(-1)
        m = mask[s * nloc:(s + 1) * nloc].reshape(-1) > 0
        idx = np.nonzero(m)[0]
        cams = f[idx].astype(np.int64)
        if cams.size:
            kc = max(kc, int(np.bincount(cams, minlength=kf).max()))
        per.append((idx, cams))
    rows = np.zeros((num_shards, kf, kc), np.int32)
    cmask = np.zeros((num_shards, kf, kc), np.float32)
    for s, (idx, cams) in enumerate(per):
        rows[s], cmask[s] = cam_chunk_layout(cams, idx, kf, kc)
    return (rows.reshape(num_shards * kf, kc),
            cmask.reshape(num_shards * kf, kc))


def build_chunk_shards(program, meta, num_shards: int,
                       cam_chunks: bool = False):
    """Host-side: per-bucket row data re-laid in chunk order and padded so
    the e-block axis divides the shard count.

    Returns (shards, ne_pad): `shards` is a list (one entry per bucket) of
    dicts of numpy arrays whose LEADING axis is the shardable one —
    [ne_pad, k, ...] for e-buckets, [n_pad, ...] for f-only buckets.
    cam_chunks=True (implicit mode) adds per-shard camera-chunk index
    layouts ("cam_rows"/"cam_mask", [num_shards*kf, kc]) for the
    matrix-free F^T reductions.
    """
    ne = meta.ne
    ne_pad = int(math.ceil(max(ne, 1) / num_shards) * num_shards)
    shards = []
    for bi, (bk, bs) in enumerate(zip(program.buckets, meta.buckets)):
        if bs.e_slot is not None:
            entry = {"kind": "e" if bs.f_cols is not None else "e0"}
        else:
            entry = {"kind": "f"}
        if bs.e_slot is not None:
            rows = bs.chunk_rows                       # [ne, k]
            k = rows.shape[1]

            def chunked(a):
                a = np.asarray(a)
                out = a[rows.reshape(-1)].reshape((ne, k) + a.shape[1:])
                if ne_pad != ne:
                    pad = np.repeat(out[:1], ne_pad - ne, axis=0)
                    out = np.concatenate([out, pad], axis=0)
                return out

            if bk.data == () or bk.data == {}:
                entry["data"] = ()
            else:
                entry["data"] = jax.tree_util.tree_map(chunked, bk.data)
            entry["amb"] = tuple(chunked(sl.amb_idx) for sl in bk.slots)
            mask = bs.chunk_mask                        # [ne, k]
            if ne_pad != ne:
                mask = np.concatenate(
                    [mask, np.zeros((ne_pad - ne, k), mask.dtype)], axis=0)
            entry["mask"] = mask
            # local f-block id per lane (for the on-the-fly one-hot);
            # e-only buckets (constant f side) have no f slot and enter
            # only through EtE / g_e / cost.
            if entry["kind"] == "e":
                grp = meta.f_groups[0]
                slots_here = [s for s in grp["slots"] if s[0] == bi]
                if len(slots_here) != 1:
                    raise ValueError(
                        f"sharded fused path: bucket {bi} must have "
                        f"exactly one f slot (got {len(slots_here)})")
                _, f_si, local = slots_here[0]
                entry["f_ids"] = chunked(local).astype(np.int32)  # [ne_pad,k]
            if getattr(bk, "loss_attrs", None):
                entry["loss_attrs"] = {kk: chunked(v)
                                       for kk, v in bk.loss_attrs.items()}
        else:
            n = np.asarray(bk.slots[0].amb_idx).shape[0] if bk.slots else 0
            n_pad = int(math.ceil(max(n, 1) / num_shards) * num_shards)

            def padded(a):
                a = np.asarray(a)
                if a.shape[0] == n_pad:
                    return a
                pad = np.repeat(a[:1], n_pad - a.shape[0], axis=0)
                return np.concatenate([a, pad], axis=0)

            if bk.data == () or bk.data == {}:
                entry["data"] = ()
            else:
                entry["data"] = jax.tree_util.tree_map(padded, bk.data)
            entry["amb"] = tuple(padded(sl.amb_idx) for sl in bk.slots)
            mask = np.zeros(n_pad)
            mask[:n] = 1.0
            entry["mask"] = mask
            grp = meta.f_groups[0]
            slots_here = [s for s in grp["slots"] if s[0] == bi]
            if len(slots_here) != 1:
                raise ValueError(
                    f"sharded fused path: f-only bucket {bi} must have "
                    f"exactly one f slot (got {len(slots_here)})")
            _, _, local = slots_here[0]
            entry["f_ids"] = padded(local).astype(np.int32)    # [n_pad]
            if getattr(bk, "loss_attrs", None):
                entry["loss_attrs"] = {kk: padded(v)
                                       for kk, v in bk.loss_attrs.items()}
        if cam_chunks and "f_ids" in entry:
            kf = meta.f_groups[0]["kf"]
            entry["cam_rows"], entry["cam_mask"] = _cam_chunks_per_shard(
                entry["f_ids"], entry["mask"], kf, num_shards)
        shards.append(entry)
    return shards, ne_pad


class ShardedFusedResult(NamedTuple):
    x: jnp.ndarray
    cost: jnp.ndarray
    initial_cost: jnp.ndarray
    iterations: jnp.ndarray
    successful_steps: jnp.ndarray
    unsuccessful_steps: jnp.ndarray
    termination_code: jnp.ndarray
    gradient_max_norm: jnp.ndarray
    total_linear_iterations: jnp.ndarray


def make_sharded_fused_solve(program, options, meta, mesh: Mesh,
                             axis=None):
    """Returns (solve, place): solve(x0, shards) -> ShardedFusedResult runs
    the entire LM loop sharded; place(shards_np) device_puts the row data
    with the right shardings. shards_np from build_chunk_shards.

    axis: mesh axis name (or tuple of names) to shard rows over. Default:
    ALL mesh axes — a multi-host {host, chip} mesh flattens into one
    e-block data axis, collectives reducing over both (ICI within a host,
    DCN across; XLA picks the hierarchical reduction)."""
    from ..solvers.schur_fused import (_spd_inv_small, _spd_solve_dense,
                                       _slab_of, _block_precond,
                                       _precond_from_blocks,
                                       _sj_chunk_blocks,
                                       _sj_cross_pair_blocks,
                                       _sj_reduce_to_blocks,
                                       detect_cross_bucket_dups,
                                       chunk_has_dup_cams,
                                       _outer_rt, _rvec_rt)

    if axis is None:
        axis = tuple(mesh.axis_names)
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    axis = axes if len(axes) > 1 else axes[0]
    num_shards = int(np.prod([mesh.shape[a] for a in axes]))
    # explicit: shard-local A [ne/P, te, nf] + replicated dense S;
    # implicit (the large-camera regime): matrix-free CG over the
    # shard-local chunk tensors, one psum per CG application.
    iterative = (options.linear_solver_type
                 == LinearSolverType.ITERATIVE_SCHUR)
    explicit = (not iterative) or (
        _sharded_explicit_viable(meta, num_shards)
        and not os.environ.get("CERES_TPU_FORCE_IMPLICIT"))
    shards_np, ne_pad = build_chunk_shards(program, meta, num_shards,
                                           cam_chunks=not explicit)
    # implicit SCHUR_JACOBI exactness: does any camera observe the same
    # point through several rows of a bucket? (host, once)
    dup_cams = {}
    cross_pairs = []
    if not explicit:
        for bi2, entry in enumerate(shards_np):
            if entry["kind"] == "e":
                dup_cams[bi2] = chunk_has_dup_cams(entry["f_ids"],
                                                   entry["mask"])
        # cross-BUCKET duplicate (cam, point) pairs: all e-buckets share
        # the same point-chunk layout, so the host-side detection (and
        # the per-shard correction) aligns on the chunk row index
        cross_pairs = detect_cross_bucket_dups(
            [(entry["f_ids"], np.asarray(entry["mask"]) > 0)
             for entry in shards_np if entry["kind"] == "e"])

    dtype = program.dtype
    mixed = options.use_mixed_precision_solves
    work_dtype = jnp.float32 if mixed else dtype
    use_jacobi_scaling = options.jacobi_scaling
    min_diag = options.min_lm_diagonal
    max_diag = options.max_lm_diagonal
    ne, te, nf = meta.ne, meta.te, meta.nf
    grp = meta.f_groups[0]
    kf, tf = grp["kf"], grp["t"]
    gtol = options.gradient_tolerance
    ftol = options.function_tolerance
    ptol = options.parameter_tolerance
    min_rel_decrease = options.min_relative_decrease
    max_iters = options.max_num_iterations
    min_radius = options.min_trust_region_radius
    max_radius = options.max_trust_region_radius
    max_invalid = options.max_num_consecutive_invalid_steps

    e_slab = _slab_of(meta.e_cols)
    fpos_np = meta.f_global_cols[grp["cols"]].reshape(-1)
    f_slab = _slab_of(fpos_np.reshape(kf, tf))
    fpos = jnp.asarray(fpos_np.astype(np.int32))
    # padded e-cols for the sharded scatter of delta_e (pad rows write into
    # a sacrificial extra slot)
    if e_slab is None:
        ecols_pad = np.concatenate(
            [meta.e_cols,
             np.full((ne_pad - ne, te), program.num_effective,
                     dtype=np.int32)], axis=0)
        ecols_pad = jnp.asarray(ecols_pad)

    # per-bucket slot offsets within the J tensor
    plans = []
    for bi, (bk, bs) in enumerate(zip(program.buckets, meta.buckets)):
        offs, off = [], 0
        for sl in bk.slots:
            if sl.variable:
                offs.append(off)
                off += sl.tangent_size
        f_si = None
        for s in grp["slots"]:
            if s[0] == bi:
                f_si = s[1]
        plans.append(dict(bk=bk, bs=bs, bi=bi, offs=offs, f_si=f_si))

    def bucket_loss(bk, sh):
        loss = bk.loss
        if "loss_attrs" in sh:
            attrs = sh["loss_attrs"]
            if sh["kind"] in ("e", "e0"):
                # e-bucket rows are evaluated flattened to [nloc*k]; the
                # chunk-layout [nloc, k, ...] attr planes must match that
                # row layout (pad lanes are masked out downstream).
                attrs = {k2: v.reshape((-1,) + v.shape[2:])
                         for k2, v in attrs.items()}
            loss = object.__new__(type(bk.loss))
            object.__setattr__(loss, "__dict__", dict(attrs))
        return loss

    def local_cost(x, shards):
        """Shard-local cost sum (pre-psum)."""
        total = jnp.asarray(0.0, dtype=dtype)
        for plan, sh in zip(plans, shards):
            bk = plan["bk"]
            if sh["kind"] in ("e", "e0"):
                nloc, k = sh["mask"].shape
                data = jax.tree_util.tree_map(
                    lambda a: a.reshape((nloc * k,) + a.shape[2:]),
                    sh["data"])
                amb = tuple(a.reshape((nloc * k,) + a.shape[2:])
                            for a in sh["amb"])
                r = program._bucket_residuals(bk, x, row_arrays=(data, amb))
                r = r * sh["mask"].reshape(-1)[:, None]
            else:
                r = program._bucket_residuals(
                    bk, x, row_arrays=(sh["data"], sh["amb"]))
                r = r * sh["mask"][:, None]
            c, _, _ = correct_residuals_and_jacobian(bucket_loss(bk, sh),
                                                     r, None)
            total = total + jnp.sum(c)
        return total

    def lm_pieces(x, shards):
        """Linearize + eliminate; returns everything the outer loop needs.
        Mirrors solvers/schur_fused.py with shard-local e tensors."""
        cost_loc = jnp.asarray(0.0, dtype=dtype)
        nloc_e = ne_pad // num_shards
        EtE = jnp.zeros((nloc_e, te, te), dtype=work_dtype)
        g_e = jnp.zeros((nloc_e, te), dtype=work_dtype)
        FtF = jnp.zeros((kf, tf, tf), dtype=work_dtype)
        g_f = jnp.zeros((kf, tf), dtype=work_dtype)
        A = (jnp.zeros((nloc_e, te, kf * tf), dtype=work_dtype)
             if explicit else None)
        store = []
        for plan, sh in zip(plans, shards):
            bk, bs = plan["bk"], plan["bs"]
            if sh["kind"] in ("e", "e0"):
                nloc, k = sh["mask"].shape
                data = jax.tree_util.tree_map(
                    lambda a: a.reshape((nloc * k,) + a.shape[2:]),
                    sh["data"])
                amb = tuple(a.reshape((nloc * k,) + a.shape[2:])
                            for a in sh["amb"])
                loss = bucket_loss(bk, sh)
                rmask = sh["mask"].reshape(-1)
                if mixed:
                    # f32-native jacfwd; f64 residual-only pass for cost
                    # (see solvers/schur_fused.py).
                    r64 = program._bucket_residuals(
                        bk, x, row_arrays=(data, amb)) * rmask[:, None]
                    cost, _, _ = correct_residuals_and_jacobian(
                        loss, r64, None)
                    _, J32 = program._bucket_linearize(
                        bk, x, row_arrays=(data, amb),
                        cast_dtype=jnp.float32)
                    _, rc, Jc = correct_residuals_and_jacobian(
                        loss, r64.astype(work_dtype),
                        J32 * rmask.astype(jnp.float32)[:, None, None])
                else:
                    r, J = program._bucket_linearize(
                        bk, x, row_arrays=(data, amb))
                    cost, rc, Jc = correct_residuals_and_jacobian(
                        loss, r * rmask[:, None],
                        J * rmask[:, None, None])
                cost_loc = cost_loc + jnp.sum(cost)
                rr = Jc.shape[1]
                Jg = Jc.reshape(nloc, k, rr, -1).astype(work_dtype)
                rg = rc.reshape(nloc, k, rr).astype(work_dtype)
                eo = plan["offs"][bs.e_slot]
                Je = Jg[..., eo:eo + te]
                EtE = EtE + jnp.sum(_outer_rt(Je, Je), axis=1)
                g_e = g_e + jnp.sum(_rvec_rt(Je, rg), axis=1)
                if sh["kind"] == "e0":
                    # constant f side: EtE / g_e / cost only
                    store.append(("e0", Je, None, None))
                    continue
                fo = plan["offs"][plan["f_si"]]
                Jf = Jg[..., fo:fo + tf]
                Gf = _outer_rt(Jf, Jf)
                if explicit:
                    oh = jax.nn.one_hot(sh["f_ids"], kf, dtype=work_dtype)
                    oh = oh * sh["mask"][..., None].astype(work_dtype)
                    FtF = FtF + _einsum("nkc,nktu->ctu", oh, Gf)
                    g_f = g_f + _einsum("nkc,nkt->ct", oh,
                                        _rvec_rt(Jf, rg))
                    Ge = _outer_rt(Je, Jf)
                    A = A + jnp.sum(oh[:, :, None, :, None]
                                    * Ge[:, :, :, None, :],
                                    axis=1).reshape(nloc, te, kf * tf)
                    store.append(("e", Je, Jf, oh))
                else:
                    # one-hot-free: shard-local camera-chunk gather+sum
                    # (rows pre-masked; pad cam lanes masked in cam_mask)
                    camr, camm = sh["cam_rows"], sh["cam_mask"]
                    FtF = FtF + jnp.sum(
                        Gf.reshape(-1, tf * tf)[camr]
                        * camm[..., None], axis=1).reshape(kf, tf, tf)
                    g_f = g_f + jnp.sum(
                        _rvec_rt(Jf, rg).reshape(-1, tf)[camr]
                        * camm[..., None], axis=1)
                    store.append(("e", Je, Jf,
                                  (sh["f_ids"], camr, camm,
                                   dup_cams.get(plan["bi"], False))))
            else:
                r, J = program._bucket_linearize(
                    bk, x, row_arrays=(sh["data"], sh["amb"]))
                cost, rc, Jc = correct_residuals_and_jacobian(
                    bucket_loss(bk, sh), r * sh["mask"][:, None],
                    J * sh["mask"][:, None, None])
                cost_loc = cost_loc + jnp.sum(cost)
                rc = rc.astype(work_dtype)
                Jc = Jc.astype(work_dtype)
                fo = plan["offs"][plan["f_si"]]
                Jf = Jc[..., fo:fo + tf]
                G = _outer_rt(Jf, Jf)
                if explicit:
                    oh = jax.nn.one_hot(sh["f_ids"], kf, dtype=work_dtype)
                    oh = oh * sh["mask"][:, None].astype(work_dtype)
                    FtF = FtF + _einsum("nc,ntu->ctu", oh, G)
                    g_f = g_f + _einsum("nc,nt->ct", oh, _rvec_rt(Jf, rc))
                    store.append(("f", Jf, None, oh))
                else:
                    camr, camm = sh["cam_rows"], sh["cam_mask"]
                    FtF = FtF + jnp.sum(
                        G.reshape(-1, tf * tf)[camr]
                        * camm[..., None], axis=1).reshape(kf, tf, tf)
                    g_f = g_f + jnp.sum(
                        _rvec_rt(Jf, rc)[camr] * camm[..., None], axis=1)
                    store.append(("f", Jf, None,
                                  (sh["f_ids"], camr, camm, False)))
        return cost_loc, EtE, g_e, FtF, g_f, A, store

    def solve_body(x, radius, shards, s_e, s_f, first):
        """One LM linearize+step; all-replicated outputs except delta_e.

        The fixed iteration-0 Jacobi scaling
        (trust_region_minimizer.cc:261-277) is derived INSIDE the first
        body iteration from its own Gram diagonals (`first`) and carried
        thereafter — a separate scale pass at x0 would trace a second
        copy of the linearize graph outside the while_loop, which XLA
        cannot CSE across the loop boundary."""
        (cost_loc, EtE, g_e, FtF_loc, g_f_loc, A, store) = lm_pieces(
            x, shards)
        ge_max_loc = jnp.max(jnp.abs(g_e)) if g_e.size else \
            jnp.asarray(0.0, work_dtype)
        ge_sq_loc = jnp.vdot(g_e, g_e)
        # ---- psum #1: cost, f Grams/gradient, e gradient norm ----
        cost, FtF, g_f, ge_sq = jax.lax.psum(
            (cost_loc, FtF_loc, g_f_loc, ge_sq_loc), axis)
        ge_max = jax.lax.pmax(ge_max_loc, axis)
        cost = cost + program.fixed_cost

        cn_e = jnp.diagonal(EtE, axis1=-2, axis2=-1)
        cn_f = jnp.diagonal(FtF, axis1=-2, axis2=-1)
        if use_jacobi_scaling:
            s_e = jnp.where(first, 1.0 / (1.0 + jnp.sqrt(cn_e)), s_e)
            s_f = jnp.where(first, 1.0 / (1.0 + jnp.sqrt(cn_f)), s_f)
        diag_e = jnp.clip(s_e * s_e * cn_e, min_diag, max_diag)
        diag_f = jnp.clip(s_f * s_f * cn_f, min_diag, max_diag)
        rad = radius.astype(work_dtype)
        D2_e = diag_e / rad
        D2_f = diag_f / rad

        EtE_d = EtE * (s_e[:, :, None] * s_e[:, None, :]) \
            + D2_e[..., None] * jnp.eye(te, dtype=work_dtype)
        FtF_s = FtF * (s_f[:, :, None] * s_f[:, None, :])
        sA = s_f.reshape(kf * tf)
        g_se = g_e * s_e
        g_sf = (g_f * s_f).reshape(kf * tf)
        inv_ete = _spd_inv_small(EtE_d)

        b_e = -g_se
        b_f = -g_sf
        z = _einsum("nij,nj->ni", inv_ete, b_e)
        from ..solvers.cg import conjugate_gradients
        if explicit:
            A_s = A * s_e[:, :, None] * sA[None, None, :]
            rhs_corr_loc = _einsum("nuf,nu->f", A_s, z)
            Y = _einsum("nuv,nvf->nuf", inv_ete, A_s)
            S_corr_loc = _einsum("nuf,nug->fg", A_s, Y)
            # ---- psum #2: S and rhs corrections ----
            S_corr, rhs_corr = jax.lax.psum((S_corr_loc, rhs_corr_loc),
                                            axis)
            rhs = b_f - rhs_corr
            ii = jnp.arange(kf)
            S = (-S_corr).reshape(kf, tf, kf, tf).at[ii, :, ii, :].add(
                FtF_s + D2_f[..., None] * jnp.eye(tf, dtype=work_dtype)
            ).reshape(kf * tf, kf * tf)

            if not iterative:
                y = _spd_solve_dense(S, rhs)
                lin_iters = jnp.asarray(1, dtype=jnp.int32)
            else:
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

            d_e = _einsum("nij,nj->ni", inv_ete,
                          b_e - _einsum("nuf,f->nu", A_s, y))
        else:
            # ---- implicit (matrix-free) sharded ITERATIVE_SCHUR ----
            # The shard-local chunk tensors ARE the operator; each CG
            # application costs a handful of broadcast products, one
            # camera-chunk gather+sum, and exactly one psum of [kf, tf]
            # (the reduced-space residual). A is never materialized.
            sstore = []
            for kind, Je0, Jf0, aux in store:
                if kind == "e0":
                    continue
                fids, camr, camm, dup = aux
                if kind == "e":
                    Je_s = Je0 * s_e[:, None, None, :]
                    Jf_s = Jf0 * s_f[fids][:, :, None, :]
                else:
                    Je_s = None
                    Jf_s = Jf0 * s_f[fids][:, None, :]
                sstore.append((kind, Je_s, Jf_s, fids, camr, camm, dup))

            def mv(J, v):      # [..., r, t] x [..., t] -> [..., r]
                return jnp.sum(J * v[..., None, :], axis=-1)

            def cam_reduce(contrib, camr, camm):
                """[rows..., d] -> [kf, d] shard-local gather+sum."""
                flat = contrib.reshape((-1,) + contrib.shape[-1:])
                return jnp.sum(flat[camr] * camm[..., None], axis=1)

            nloc_e = s_e.shape[0]

            def apply_S(v):
                vb = v.reshape(kf, tf)
                out = jnp.zeros((kf, tf), dtype=work_dtype)
                u = jnp.zeros((nloc_e, te), dtype=work_dtype)
                ws = []
                for kind, Je_s, Jf_s, fids, camr, camm, _dup in sstore:
                    w = mv(Jf_s, vb[fids])
                    if kind == "e":
                        u = u + jnp.sum(_rvec_rt(Je_s, w), axis=1)
                    ws.append(w)
                zz = jnp.sum(inv_ete * u[:, None, :], axis=-1)
                for (kind, Je_s, Jf_s, fids, camr, camm,
                     _dup), w in zip(sstore, ws):
                    w2 = w - mv(Je_s, zz[:, None, :]) if kind == "e" \
                        else w
                    out = out + cam_reduce(_rvec_rt(Jf_s, w2), camr,
                                           camm)
                out = jax.lax.psum(out, axis)   # one psum per CG apply
                return (out + D2_f * vb).reshape(kf * tf)

            # reduced rhs: b_f - F_s^T E_s z (one psum)
            acc = jnp.zeros((kf, tf), dtype=work_dtype)
            for kind, Je_s, Jf_s, fids, camr, camm, _dup in sstore:
                if kind != "e":
                    continue
                w = mv(Je_s, z[:, None, :])
                acc = acc + cam_reduce(_rvec_rt(Jf_s, w), camr, camm)
            rhs = b_f - jax.lax.psum(acc, axis).reshape(kf * tf)

            pk = options.preconditioner_type
            precond = None
            if pk != PreconditionerType.IDENTITY:
                blocks = FtF_s + D2_f[..., None] * jnp.eye(
                    tf, dtype=work_dtype)
                if pk == PreconditionerType.SCHUR_JACOBI:
                    corr = jnp.zeros((kf, tf, tf), dtype=work_dtype)
                    for kind, Je_s, Jf_s, fids, camr, camm, dup \
                            in sstore:
                        if kind != "e":
                            continue
                        Ge_s = _outer_rt(Je_s, Jf_s)     # [n,k,te,tf]
                        M = _einsum("nij,nkjt->nkit", inv_ete, Ge_s)
                        contribT = _sj_chunk_blocks(Ge_s, M, fids, dup)
                        corr = corr + _sj_reduce_to_blocks(
                            contribT, camr, camm,
                            Ge_s.shape[1], Ge_s.shape[0], tf)
                    # cross-BUCKET duplicate (cam, point) pairs: the S
                    # diagonal couples the buckets' Ge contributions
                    # (shard-local — a point lives on exactly one shard)
                    es = [t for t in sstore if t[0] == "e"]
                    for i1, i2 in cross_pairs:
                        _, Je1, Jf1, fid1, camr1, camm1, _ = es[i1]
                        _, Je2, Jf2, fid2, _, _, _ = es[i2]
                        Ge1 = _outer_rt(Je1, Jf1)
                        crossT = _sj_cross_pair_blocks(
                            Ge1, _outer_rt(Je2, Jf2),
                            inv_ete, fid1, fid2)
                        corr = corr + _sj_reduce_to_blocks(
                            crossT, camr1, camm1,
                            Ge1.shape[1], Ge1.shape[0], tf)
                    blocks = blocks - jax.lax.psum(corr, axis)
                precond = _precond_from_blocks(blocks, kf, tf)

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
            u2 = jnp.zeros((nloc_e, te), dtype=work_dtype)
            for kind, Je_s, Jf_s, fids, camr, camm, _dup in sstore:
                if kind != "e":
                    continue
                u2 = u2 + jnp.sum(_rvec_rt(Je_s, mv(Jf_s, yb[fids])),
                                  axis=1)
            d_e = jnp.sum(inv_ete * (b_e - u2)[:, None, :], axis=-1)

        # norms / model cost change (communicated pieces via psum)
        d_dot_g_loc = jnp.vdot(d_e, g_se)
        de_sq_loc = jnp.vdot(s_e * d_e, s_e * d_e)
        if mixed and not iterative:
            # Exact direct solve: ||J_s d||^2 = d.b - ||D d||^2 (the f32
            # step already bounds tail accuracy; solvers/schur_fused.py
            # restricts the identity the same way).
            Dd_sq_loc = jnp.sum(D2_e * d_e * d_e)
            d_dot_g_e, Dd_sq_e, de_sq = jax.lax.psum(
                (d_dot_g_loc, Dd_sq_loc, de_sq_loc), axis)
            d_dot_g = d_dot_g_e + jnp.vdot(y, g_sf)
            Dd_sq = Dd_sq_e + jnp.sum(D2_f.reshape(kf * tf) * y * y)
            Jd_sq = -d_dot_g - Dd_sq
        else:
            # Exact ||J_s d||^2 from the shard-local chunk tensors:
            # the identity is invalid for inexact CG solves and cancels
            # catastrophically in f64 tails (schur_fused.py rationale).
            dw_e = s_e * d_e                      # [nloc_e, te]
            dw_fb = (sA * y).reshape(kf, tf)      # replicated
            Jd_sq_loc = jnp.asarray(0.0, dtype=work_dtype)
            for kind, Ja, Jb, oh_s in store:
                # implicit mode stores (f_ids, cam_rows, cam_mask): take
                # the f step rows by camera id (Ja/Jb are pre-masked, so
                # pad lanes contribute zero either way)
                if kind == "e":
                    if isinstance(oh_s, tuple):
                        dfb = dw_fb[oh_s[0]]             # [n,k,tf]
                    else:
                        dfb = _einsum("nkc,ct->nkt", oh_s, dw_fb)
                    Jd = _einsum("nkrt,nt->nkr", Ja, dw_e) \
                        + _einsum("nkrt,nkt->nkr", Jb, dfb)
                elif kind == "e0":
                    Jd = _einsum("nkrt,nt->nkr", Ja, dw_e)
                else:
                    if isinstance(oh_s, tuple):
                        dfb = dw_fb[oh_s[0]]             # [n,tf]
                    else:
                        dfb = _einsum("nc,ct->nt", oh_s, dw_fb)
                    Jd = _einsum("nrt,nt->nr", Ja, dfb)
                Jd_sq_loc = Jd_sq_loc + jnp.vdot(Jd, Jd)
            d_dot_g_e, Jd_sq, de_sq = jax.lax.psum(
                (d_dot_g_loc, Jd_sq_loc, de_sq_loc), axis)
            d_dot_g = d_dot_g_e + jnp.vdot(y, g_sf)
        mcc = -(d_dot_g + 0.5 * Jd_sq)

        # ---- assemble the global delta (all_gather of the e part) ----
        delta_e = (s_e * d_e).astype(dtype)                # [nloc_e, te]
        delta_f = (sA * y).astype(dtype)
        delta_e_full = jax.lax.all_gather(delta_e, axis,
                                          tiled=True)      # [ne_pad, te]
        delta = jnp.zeros((program.num_effective + (0 if e_slab is not None
                                                    else 1),), dtype=dtype)
        if e_slab is not None:
            delta = jax.lax.dynamic_update_slice(
                delta, delta_e_full[:ne].reshape(-1), (e_slab,))
        else:
            delta = delta.at[ecols_pad].set(delta_e_full)
        if f_slab is not None:
            delta = jax.lax.dynamic_update_slice(delta, delta_f, (f_slab,))
        else:
            delta = delta.at[fpos].set(delta_f)
        delta = delta[:program.num_effective]

        gf_flat = g_f.reshape(kf * tf)
        grad_max = jnp.maximum(ge_max,
                               jnp.max(jnp.abs(gf_flat))).astype(dtype)
        grad_norm = jnp.sqrt(ge_sq + jnp.vdot(gf_flat, gf_flat)
                             ).astype(dtype)
        step_norm = jnp.sqrt(de_sq + jnp.vdot(delta_f, delta_f)
                             ).astype(dtype)
        return dict(cost=cost, delta=delta, mcc=mcc.astype(dtype),
                    grad_max=grad_max, grad_norm=grad_norm,
                    step_norm=step_norm, lin_iters=lin_iters,
                    s_e=s_e, s_f=s_f)

    lm_strategy = True  # sharded fused path is LM-only

    def solve(x0, shards):
        cost0 = jax.lax.psum(local_cost(x0, shards), axis) \
            + program.fixed_cost

        def cond(s):
            return s["code"] == 0

        def body(s):
            out = solve_body(s["x"], s["radius"], shards, s["s_e"],
                             s["s_f"], s["iter"] == 0)
            cost = out["cost"]
            mcc = out["mcc"]
            step_norm = out["step_norm"]
            grad_max = out["grad_max"]
            step_valid = (jnp.isfinite(mcc) & (mcc > 0.0)
                          & jnp.isfinite(step_norm))
            x_new = program.plus(s["x"], out["delta"])
            new_cost = jax.lax.psum(local_cost(x_new, shards), axis) \
                + program.fixed_cost
            rel_dec = (cost - new_cost) / jnp.where(mcc == 0, 1.0, mcc)
            accept = (step_valid & jnp.isfinite(new_cost)
                      & (rel_dec > min_rel_decrease))

            grow = s["radius"] / jnp.maximum(
                1.0 / 3.0, 1.0 - (2.0 * rel_dec - 1.0) ** 3)
            radius_acc = jnp.minimum(grow, max_radius)
            radius_rej = s["radius"] / s["decrease_factor"]
            radius = jnp.where(accept, radius_acc, radius_rej)
            decrease_factor = jnp.where(accept, 2.0,
                                        2.0 * s["decrease_factor"])

            invalid = jnp.where(step_valid, 0, s["invalid"] + 1)
            it = s["iter"] + 1
            candidate_ok = step_valid & jnp.isfinite(new_cost)
            had_success = (s["ok_steps"] > 0) | accept

            code = jnp.asarray(0, jnp.int32)
            code = jnp.where((code == 0) & (grad_max <= gtol), 1, code)
            code = jnp.where(
                (code == 0) & candidate_ok
                & (jnp.abs(cost - new_cost) <= ftol * cost)
                & (accept | (jnp.abs(mcc) <= ftol * cost)), 2, code)
            code = jnp.where(
                (code == 0) & ~step_valid & jnp.isfinite(mcc)
                & (jnp.abs(mcc) <= ftol * cost), 2, code)
            code = jnp.where(
                (code == 0) & candidate_ok & had_success
                & (step_norm <= ptol * (program.state_norm(s["x"])
                                        + ptol)),
                3, code)
            code = jnp.where((code == 0) & (radius < min_radius), 4, code)
            code = jnp.where((code == 0) & (it >= max_iters), 5, code)
            code = jnp.where((code == 0) & (invalid >= max_invalid), 6,
                             code)

            take = accept | ((code == 2) & candidate_ok
                             & (new_cost < cost))
            x_out = jnp.where(take, x_new, s["x"])
            cost_out = jnp.where(take, new_cost, cost)
            return {
                "x": x_out, "cost": cost_out, "radius": radius,
                "decrease_factor": decrease_factor, "iter": it,
                "invalid": invalid, "code": code,
                "ok_steps": s["ok_steps"] + jnp.where(accept, 1, 0),
                "bad_steps": s["bad_steps"] + jnp.where(accept, 0, 1),
                "grad_max": grad_max,
                "lin_iters": s["lin_iters"]
                + out["lin_iters"].astype(jnp.int32),
                "s_e": out["s_e"], "s_f": out["s_f"],
            }

        init = {
            "x": x0,
            "cost": cost0,
            "radius": jnp.asarray(options.initial_trust_region_radius,
                                  dtype=dtype),
            "decrease_factor": jnp.asarray(2.0, dtype=dtype),
            "iter": jnp.asarray(0, jnp.int32),
            "invalid": jnp.asarray(0, jnp.int32),
            "code": jnp.asarray(
                0 if options.max_num_iterations > 0 else 5, jnp.int32),
            "ok_steps": jnp.asarray(0, jnp.int32),
            "bad_steps": jnp.asarray(0, jnp.int32),
            "grad_max": jnp.asarray(jnp.inf, dtype=dtype),
            "lin_iters": jnp.asarray(0, jnp.int32),
            # placeholder; iteration 0 derives the real scale (see
            # solve_body) — ones are also the final value when Jacobi
            # scaling is disabled.
            "s_e": jnp.ones((ne_pad // num_shards, te), work_dtype),
            "s_f": jnp.ones((kf, tf), work_dtype),
        }
        s = jax.lax.while_loop(cond, body, init)
        return ShardedFusedResult(
            x=s["x"], cost=s["cost"], initial_cost=cost0,
            iterations=s["iter"], successful_steps=s["ok_steps"],
            unsuccessful_steps=s["bad_steps"], termination_code=s["code"],
            gradient_max_norm=s["grad_max"],
            total_linear_iterations=s["lin_iters"])

    from jax import shard_map

    shard_spec = []
    for entry in shards_np:
        spec = {}
        for k, v in entry.items():
            if k == "kind":
                continue
            spec[k] = jax.tree_util.tree_map(lambda _: P(axis), v)
        shard_spec.append(spec)

    def strip_kinds(shards):
        return [{k: v for k, v in e.items() if k != "kind"}
                for e in shards]

    kinds = [e["kind"] for e in shards_np]

    def rebind(shards_nokind):
        return [dict(kind=k, **e) for k, e in zip(kinds, shards_nokind)]

    def wrapped(x0, shards_nokind):
        return solve(x0, rebind(shards_nokind))

    solve_sharded = shard_map(
        wrapped, mesh=mesh,
        in_specs=(P(), shard_spec),
        out_specs=P(),
        check_vma=False)
    solve_jit = jax.jit(solve_sharded)

    def place(shards=None):
        data = strip_kinds(shards_np if shards is None else shards)
        return jax.tree_util.tree_map(
            lambda a, sp: jax.device_put(jnp.asarray(a),
                                         NamedSharding(mesh, sp)),
            data, shard_spec)

    def run(x0, placed_shards):
        return solve_jit(x0, placed_shards)

    return run, place
