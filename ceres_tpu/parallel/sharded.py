"""Multi-chip execution: residual-block data parallelism over a device mesh.

This is the replacement for the reference's execution substrate (L0:
ThreadPool/ParallelFor, internal/ceres/parallel_for.h) and its absent
distributed backend (SURVEY.md section 5.8): residual blocks shard across
mesh devices along a 'data' axis; the parameter/tangent state replicates;
gradient, J^T J diagonals, preconditioner blocks, Schur contributions, and
CG inner products reduce with jax.lax.psum over the device interconnect.

Mechanics: each bucket's per-row arrays (stacked functor data, ambient
gather indices, tangent column maps, Jacobi-group local ids) are padded to a
multiple of the shard count (pad rows replicate row 0 and carry mask = 0;
residuals/Jacobians are masked post-evaluation so every downstream reduction
is exact). The whole LM step — linearize, Jacobi scale, damping, CGNR with
block-Jacobi preconditioner — runs inside one shard_map-ed jitted call; one
psum per reduction, no host traffic.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..loss import correct_residuals_and_jacobian


def _pad_rows(a: np.ndarray, n_pad: int):
    n = a.shape[0]
    if n == n_pad:
        return a
    reps = np.repeat(a[:1], n_pad - n, axis=0)
    return np.concatenate([a, reps], axis=0)


def build_row_shards(program, num_shards: int):
    """Per-bucket padded row arrays as one pytree (leading axis shardable)."""
    shards = []
    for bk in program.buckets:
        n_pad = int(math.ceil(bk.n / num_shards) * num_shards)
        entry = {}
        if bk.data == () or bk.data == {}:
            entry["data"] = ()
        else:
            entry["data"] = jax.tree_util.tree_map(
                lambda a: _pad_rows(np.asarray(a), n_pad), bk.data)
        entry["amb"] = tuple(_pad_rows(sl.amb_idx, n_pad)
                             for sl in bk.slots)
        var_slots = [sl for sl in bk.slots if sl.variable]
        entry["cols"] = _pad_rows(
            np.concatenate([sl.cols for sl in var_slots], axis=1), n_pad)
        entry["slot_cols"] = tuple(_pad_rows(sl.cols, n_pad)
                                   for sl in var_slots)
        entry["local_ids"] = tuple(_pad_rows(sl.local_ids, n_pad)
                                   for sl in var_slots)
        mask = np.zeros(n_pad)
        mask[:bk.n] = 1.0
        entry["mask"] = mask
        if getattr(bk, "loss_attrs", None):
            entry["loss_attrs"] = {k: _pad_rows(np.asarray(v), n_pad)
                                   for k, v in bk.loss_attrs.items()}
        shards.append(entry)
    return shards


def _local_linearize(program, x, shards, dtype):
    """Masked local (cost_sum, [rc, Jc] per bucket)."""
    cost_local = jnp.asarray(0.0, dtype=dtype)
    outs = []
    for bk, sh in zip(program.buckets, shards):
        r, J = program._bucket_linearize(bk, x, row_arrays=(sh["data"],
                                                            sh["amb"]))
        m = sh["mask"]
        r = r * m[:, None]
        J = J * m[:, None, None]
        loss = bk.loss
        if "loss_attrs" in sh:
            loss = object.__new__(type(bk.loss))
            object.__setattr__(loss, "__dict__", dict(sh["loss_attrs"]))
        cost, rc, Jc = correct_residuals_and_jacobian(loss, r, J)
        cost_local = cost_local + jnp.sum(cost)
        outs.append((rc, Jc))
    return cost_local, outs


def make_sharded_lm_step(program, options, mesh: Mesh, axis: str = "data"):
    """Returns (step_fn, shards_pytree). step_fn(x, radius, shards) runs one
    LM linearize+solve (CGNR + block-Jacobi) fully sharded; call it under
    jit with shards placed via shard specs from `input_shardings`."""
    num_shards = int(np.prod([mesh.shape[a] for a in mesh.axis_names
                              if a == axis]))
    shards_np = build_row_shards(program, num_shards)
    dtype = program.dtype
    n_eff = program.num_effective
    groups = program.groups
    use_jacobi_scaling = options.jacobi_scaling
    min_diag, max_diag = options.min_lm_diagonal, options.max_lm_diagonal
    max_cg = options.max_linear_solver_iterations
    eta = options.eta

    def local_matvec(outs, shards, v):
        """(J^T J + D^2) v with one psum; D folded in by caller closure."""
        acc = jnp.zeros((n_eff,), dtype=dtype)
        for (rc, Jc), sh in zip(outs, shards):
            vb = v[sh["cols"]]
            Jv = jnp.einsum("nrt,nt->nr", Jc, vb)
            JtJv = jnp.einsum("nrt,nr->nt", Jc, Jv)
            acc = acc.at[sh["cols"]].add(JtJv)
        return jax.lax.psum(acc, axis)

    def step(x, radius, shards):
        cost_local, outs = _local_linearize(program, x, shards, dtype)
        cost = jax.lax.psum(cost_local, axis) + program.fixed_cost

        # gradient and column norms (one psum each)
        g_loc = jnp.zeros((n_eff,), dtype=dtype)
        cn_loc = jnp.zeros((n_eff,), dtype=dtype)
        for (rc, Jc), sh in zip(outs, shards):
            g_loc = g_loc.at[sh["cols"]].add(
                jnp.einsum("nrt,nr->nt", Jc, rc))
            cn_loc = cn_loc.at[sh["cols"]].add(jnp.sum(Jc * Jc, axis=1))
        grad = jax.lax.psum(g_loc, axis)
        col_norms = jax.lax.psum(cn_loc, axis)

        scale = (1.0 / (1.0 + jnp.sqrt(col_norms))
                 if use_jacobi_scaling else jnp.ones_like(grad))
        # scaled quantities: J_s = J diag(scale)
        diag = jnp.clip(col_norms * scale * scale, min_diag, max_diag)
        D2 = diag / radius
        b = -(grad * scale)

        # block-Jacobi preconditioner of (J_s^T J_s + D^2): psum the
        # per-parameter-block Gram blocks, factorize replicated.
        factors = []
        # per-bucket column offsets of each variable slot inside J's t_total
        slot_offsets = []
        for bk in program.buckets:
            offs, off = [], 0
            for sl in bk.slots:
                if sl.variable:
                    offs.append(off)
                    off += sl.tangent_size
            slot_offsets.append(offs)
        for g in groups:
            t = g.tangent_size
            acc = jnp.zeros((g.num_blocks, t, t), dtype=dtype)
            for (bi, var_si, _) in g.bucket_slots:
                rc, Jc = outs[bi]
                sh = shards[bi]
                off = slot_offsets[bi][var_si]
                Js = Jc[:, :, off:off + t] \
                    * scale[sh["slot_cols"][var_si]][:, None, :]
                G = jnp.einsum("nrt,nru->ntu", Js, Js)
                acc = acc.at[sh["local_ids"][var_si]].add(G)
            acc = jax.lax.psum(acc, axis)
            cols = jnp.asarray(g.tan_cols)
            d2 = D2[cols]
            acc = acc + d2[..., :, None] * jnp.eye(t, dtype=dtype)[None]
            factors.append((cols, jnp.linalg.cholesky(acc)))

        def precond(v):
            out = jnp.zeros_like(v)
            for cols, chol in factors:
                vb = v[cols][..., None]
                y = jax.scipy.linalg.solve_triangular(chol, vb, lower=True)
                z = jax.scipy.linalg.solve_triangular(
                    jnp.swapaxes(chol, -1, -2), y, lower=False)
                out = out.at[cols].set(z[..., 0])
            return out

        def apply_A(v):
            return local_matvec(outs, shards, scale * v) * scale + D2 * v

        # PCG: the shared implementation (solvers/cg.py) — all-device-
        # synchronous since the operator psums and the dots run on
        # replicated vectors. Reuse brings the reference termination
        # rules (eta/Q-tolerance, r-tolerance, indefiniteness guard) the
        # old inline copy dropped — without eta every LM step burned the
        # full max_linear_solver_iterations.
        from ..solvers.cg import conjugate_gradients
        result = conjugate_gradients(
            apply_A, b, jnp.zeros_like(b), apply_preconditioner=precond,
            max_iterations=max_cg, q_tolerance=eta,
            min_iterations=options.min_linear_solver_iterations)
        d = result.x
        iters = result.num_iterations

        Jd_sq = jnp.vdot(d, local_matvec(outs, shards, scale * d) * scale)
        mcc = -(jnp.vdot(d, -b) + 0.5 * Jd_sq)
        delta = scale * d
        return {
            "cost": cost,
            "gradient_max_norm": jnp.max(jnp.abs(grad)),
            "gradient_norm": jnp.linalg.norm(grad),
            "delta": delta,
            "model_cost_change": mcc,
            "step_norm": jnp.linalg.norm(delta),
            "lin_iters": iters,
        }

    from jax import shard_map

    shard_spec = jax.tree_util.tree_map(lambda _: P(axis), shards_np)
    step_sharded = shard_map(
        step, mesh=mesh,
        in_specs=(P(), P(), shard_spec),
        out_specs=P(),
        check_vma=False)

    def place(shards):
        return jax.tree_util.tree_map(
            lambda a, s: jax.device_put(jnp.asarray(a),
                                        NamedSharding(mesh, s)),
            shards, shard_spec)

    return jax.jit(step_sharded), shards_np, place


def make_sharded_cost_fn(program, mesh: Mesh, shards_np, axis: str = "data"):
    """Sharded total-cost evaluation (for the accept/reject test)."""
    dtype = program.dtype

    def cost(x, shards):
        total = jnp.asarray(0.0, dtype=dtype)
        for bk, sh in zip(program.buckets, shards):
            r = program._bucket_residuals(bk, x, row_arrays=(sh["data"],
                                                             sh["amb"]))
            r = r * sh["mask"][:, None]
            loss = bk.loss
            if "loss_attrs" in sh:
                loss = object.__new__(type(bk.loss))
                object.__setattr__(loss, "__dict__", dict(sh["loss_attrs"]))
            c, _, _ = correct_residuals_and_jacobian(loss, r, None)
            total = total + jnp.sum(c)
        return jax.lax.psum(total, axis) + program.fixed_cost

    from jax import shard_map
    shard_spec = jax.tree_util.tree_map(lambda _: P(axis), shards_np)
    return jax.jit(shard_map(cost, mesh=mesh, in_specs=(P(), shard_spec),
                             out_specs=P(), check_vma=False))


def make_sharded_schur_step(program, options, mesh: Mesh,
                            axis: str = "data"):
    """Sharded DENSE_SCHUR LM step: each shard eliminates its rows into
    partial Gram tensors (E^T E blocks, F^T F, the cross tensor A = E^T F,
    gradient), ONE psum per tensor over ICI, then the reduced camera system
    solves replicated — the multi-chip form of the reference's chunked
    SchurEliminator (schur_eliminator_impl.h:228: per-thread buffers +
    reduction; here per-chip partials + psum, SURVEY.md section 5.7).

    NOTE: this is the step-level reference implementation (simple layout,
    replicated A) kept for the driver dry run and mesh tests. The
    PRODUCTION multi-chip path is parallel/sharded_fused.py — the whole
    LM loop in one shard_map'd program, rows sharded by e-block, A
    shard-local, chunk-layout Grams — reached via ct.solve(mesh=...).

    Returns (step_fn, shards_np, place) like make_sharded_lm_step.
    """
    from ..solvers.schur import detect_schur_structure

    meta = detect_schur_structure(program, options)
    if meta is None:
        raise ValueError("no Schur structure for sharded Schur step")
    num_shards = int(np.prod([mesh.shape[a] for a in mesh.axis_names
                              if a == axis]))
    shards_np = build_row_shards(program, num_shards)
    # Augment with per-row Schur indexing.
    for bi, bs in enumerate(meta.buckets):
        n_pad = shards_np[bi]["mask"].shape[0]
        if bs.e_slot is not None:
            shards_np[bi]["e_ids"] = _pad_rows(bs.e_ids, n_pad)
        if bs.f_cols is not None:
            shards_np[bi]["f_cols"] = _pad_rows(bs.f_cols, n_pad)

    dtype = program.dtype
    n_eff = program.num_effective
    ne, te, nf = meta.ne, meta.te, meta.nf
    e_cols = meta.e_cols             # np [ne, te]
    f_global = meta.f_global_cols    # np [nf]
    use_jacobi_scaling = options.jacobi_scaling
    min_diag, max_diag = options.min_lm_diagonal, options.max_lm_diagonal

    # Per-bucket variable-slot offsets within J's t_total.
    slot_offsets = []
    for bk in program.buckets:
        offs, off = [], 0
        for sl in bk.slots:
            if sl.variable:
                offs.append(off)
                off += sl.tangent_size
        slot_offsets.append(offs)

    def step(x, radius, shards):
        cost_local, outs = _local_linearize(program, x, shards, dtype)
        cost = jax.lax.psum(cost_local, axis) + program.fixed_cost

        g_loc = jnp.zeros((n_eff,), dtype=dtype)
        cn_loc = jnp.zeros((n_eff,), dtype=dtype)
        for (rc, Jc), sh in zip(outs, shards):
            g_loc = g_loc.at[sh["cols"]].add(
                jnp.einsum("nrt,nr->nt", Jc, rc))
            cn_loc = cn_loc.at[sh["cols"]].add(jnp.sum(Jc * Jc, axis=1))
        grad = jax.lax.psum(g_loc, axis)
        col_norms = jax.lax.psum(cn_loc, axis)

        scale = (1.0 / (1.0 + jnp.sqrt(col_norms))
                 if use_jacobi_scaling else jnp.ones_like(grad))
        diag = jnp.clip(col_norms * scale * scale, min_diag, max_diag)
        D2 = diag / radius
        b = -(grad * scale)
        b_e = b[jnp.asarray(e_cols)]                      # [ne, te]
        b_f = b[jnp.asarray(f_global)]                    # [nf]

        # Shard-local partial elimination tensors.
        ete_loc = jnp.zeros((ne, te, te), dtype=dtype)
        FtF_loc = jnp.zeros((nf, nf), dtype=dtype)
        A_loc = jnp.zeros((ne, te, nf), dtype=dtype)
        for bi, ((rc, Jc), sh, bs) in enumerate(zip(outs, shards,
                                                    meta.buckets)):
            Js = Jc * scale[sh["cols"]][:, None, :]
            if bs.e_slot is not None:
                off = slot_offsets[bi][bs.e_slot]
                Je = Js[:, :, off:off + te]
                G = jnp.einsum("nrt,nru->ntu", Je, Je)
                ete_loc = ete_loc.at[sh["e_ids"]].add(G)
            if bs.f_cols is not None:
                Jf_parts = []
                for vs in bs.f_slots:
                    offv = slot_offsets[bi][vs]
                    tv = program.buckets[bi].slots[
                        _abs_slot_of(program.buckets[bi], vs)].tangent_size
                    Jf_parts.append(Js[:, :, offv:offv + tv])
                Jf = (jnp.concatenate(Jf_parts, axis=2)
                      if len(Jf_parts) > 1 else Jf_parts[0])
                Gf = jnp.einsum("nrt,nru->ntu", Jf, Jf)
                c = sh["f_cols"]
                n, t = c.shape
                rows = jnp.broadcast_to(c[:, :, None], (n, t, t))
                colsb = jnp.broadcast_to(c[:, None, :], (n, t, t))
                FtF_loc = FtF_loc.at[rows, colsb].add(Gf)
                if bs.e_slot is not None:
                    off = slot_offsets[bi][bs.e_slot]
                    Je = Js[:, :, off:off + te]
                    Gc = jnp.einsum("nrt,nru->ntu", Je, Jf)  # [n, te, tf]
                    erows = jnp.broadcast_to(sh["e_ids"][:, None, None],
                                             (n, te, t))
                    mids = jnp.broadcast_to(
                        jnp.arange(te)[None, :, None], (n, te, t))
                    fcols = jnp.broadcast_to(c[:, None, :], (n, te, t))
                    A_loc = A_loc.at[erows, mids, fcols].add(Gc)

        ete = jax.lax.psum(ete_loc, axis)
        FtF = jax.lax.psum(FtF_loc, axis)
        A = jax.lax.psum(A_loc, axis)

        # Replicated reduced solve.
        d2e = D2[jnp.asarray(e_cols)]
        ete = ete + d2e[..., :, None] * jnp.eye(te, dtype=dtype)[None]
        chol_e = jnp.linalg.cholesky(ete)
        eye = jnp.broadcast_to(jnp.eye(te, dtype=dtype), (ne, te, te))
        ylo = jax.scipy.linalg.solve_triangular(chol_e, eye, lower=True)
        inv_ete = jax.scipy.linalg.solve_triangular(
            jnp.swapaxes(chol_e, -1, -2), ylo, lower=False)
        B = jnp.einsum("iuv,ivg->iug", inv_ete, A)        # (EtE)^-1 A
        S = FtF + jnp.diag(D2[jnp.asarray(f_global)]) \
            - jnp.einsum("itf,itg->fg", A, B)
        rhs = b_f - jnp.einsum("itf,it->f", A,
                               jnp.einsum("iuv,iv->iu", inv_ete, b_e))
        c_, lo = jax.scipy.linalg.cho_factor(S)
        y = jax.scipy.linalg.cho_solve((c_, lo), rhs)
        d_e = jnp.einsum("iuv,iv->iu", inv_ete,
                         b_e - jnp.einsum("iuf,f->iu", A, y))
        d = jnp.zeros((n_eff,), dtype=dtype)
        d = d.at[jnp.asarray(f_global)].set(y)
        d = d.at[jnp.asarray(e_cols)].set(d_e)

        # ||J_s d||^2 for the model cost change (psum of local pieces).
        Jd_sq_loc = jnp.asarray(0.0, dtype=dtype)
        for (rc, Jc), sh in zip(outs, shards):
            Js = Jc * scale[sh["cols"]][:, None, :]
            Jv = jnp.einsum("nrt,nt->nr", Js, d[sh["cols"]])
            Jd_sq_loc = Jd_sq_loc + jnp.sum(Jv * Jv)
        Jd_sq = jax.lax.psum(Jd_sq_loc, axis)
        mcc = -(jnp.vdot(d, -b) + 0.5 * Jd_sq)
        delta = scale * d
        return {
            "cost": cost,
            "gradient_max_norm": jnp.max(jnp.abs(grad)),
            "gradient_norm": jnp.linalg.norm(grad),
            "delta": delta,
            "model_cost_change": mcc,
            "step_norm": jnp.linalg.norm(delta),
            "lin_iters": jnp.asarray(1, jnp.int32),
        }

    from jax import shard_map

    shard_spec = jax.tree_util.tree_map(lambda _: P(axis), shards_np)
    step_sharded = shard_map(
        step, mesh=mesh,
        in_specs=(P(), P(), shard_spec),
        out_specs=P(),
        check_vma=False)

    def place(shards):
        return jax.tree_util.tree_map(
            lambda a, s: jax.device_put(jnp.asarray(a),
                                        NamedSharding(mesh, s)),
            shards, shard_spec)

    return jax.jit(step_sharded), shards_np, place


def _abs_slot_of(bk, var_si):
    """Absolute slot index of the var_si-th variable slot."""
    v = -1
    for si, sl in enumerate(bk.slots):
        if sl.variable:
            v += 1
            if v == var_si:
                return si
    raise IndexError(var_si)
