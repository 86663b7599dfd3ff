"""Host-stage splitting for backends without host callbacks.

`jax.pure_callback` is the natural analog of the reference's host-side
sparse factorizations (CHOLMOD/Eigen run on the CPU while the GPU holds
the matrices — context_impl.h:56, sparse_cholesky.cc): the device
program pauses, the host factors, the program resumes. Some PJRT
backends do not implement the send/recv machinery callbacks compile to ("UNIMPLEMENTED: ... does not
support host send/recv callbacks").

This module keeps the SAME solver code working there by splitting the
traced step at its callback equations: the jaxpr is partitioned into
device segments (each compiled as its own XLA program) with the Python
callbacks executed eagerly on host between them. Semantics are
identical — the split is just the host-orchestrated spelling of the
device-paused program — at the cost of one extra dispatch per segment.

Only TOP-LEVEL callbacks are splittable; a callback inside lax control
flow (e.g. the SUBSET preconditioner's per-CG-iteration backsolve) has
no sequential spelling and still requires a callback-capable backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax._src import core as _core

__all__ = ["backend_supports_callbacks", "split_jit"]

_CALLBACK_PRIMS = ("pure_callback", "io_callback")


@functools.lru_cache(maxsize=None)
def _supports_callbacks(platform: str) -> bool:
    def probe(x):
        return jax.pure_callback(
            lambda v: v, jax.ShapeDtypeStruct((), jnp.float32), x)

    try:
        # Execute, don't just compile: some plugins accept the send/recv
        # HLO and only fail when the program runs.
        jax.jit(probe)(jnp.zeros((), jnp.float32)).block_until_ready()
        return True
    except Exception:
        return False


def backend_supports_callbacks() -> bool:
    return _supports_callbacks(jax.default_backend())


def _has_callbacks(jaxpr) -> bool:
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in _CALLBACK_PRIMS:
            return True
    return False


def _nested_callbacks(jaxpr) -> bool:
    """True if any sub-jaxpr (cond/while/scan/pjit...) contains a
    callback — those cannot be split at the top level."""
    for eqn in jaxpr.eqns:
        for sub in _core.jaxprs_in_params(eqn.params):
            if _has_callbacks(sub) or _nested_callbacks(sub):
                return True
    return False


def _make_segment_fn(eqns, invars, outvars):
    """Compile one callback-free run of equations as its own program."""

    def seg(*vals):
        env = dict(zip(invars, vals))

        def read(v):
            return v.val if isinstance(v, _core.Literal) else env[v]

        for eqn in eqns:
            outs = eqn.primitive.bind(*[read(v) for v in eqn.invars],
                                      **eqn.params)
            if not eqn.primitive.multiple_results:
                outs = [outs]
            for ov, o in zip(eqn.outvars, outs):
                env[ov] = o
        return tuple(env[v] for v in outvars)

    return jax.jit(seg)


def split_jit(fn, example_args):
    """jit(fn), except top-level pure_callback equations run eagerly on
    host between separately compiled device segments.

    Returns None when fn has no top-level callbacks (caller should use a
    plain jit) or when its callbacks are nested inside control flow
    (unsplittable — the plain jit will surface the backend error).
    example_args: avals/arrays matching fn's positional signature.
    """
    closed, out_shape = jax.make_jaxpr(fn, return_shape=True)(*example_args)
    jaxpr = closed.jaxpr
    if not _has_callbacks(jaxpr) or _nested_callbacks(jaxpr):
        return None
    out_tree = jax.tree_util.tree_structure(out_shape)

    # Partition: [segment][callback][segment][callback]...[segment]
    stages = []          # ("seg", eqns) | ("cb", eqn)
    cur = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in _CALLBACK_PRIMS:
            if cur:
                stages.append(("seg", cur))
                cur = []
            stages.append(("cb", eqn))
        else:
            cur.append(eqn)
    if cur:
        stages.append(("seg", cur))

    # Live-variable analysis per segment: a segment's outputs are the
    # vars it defines that any LATER stage (or the jaxpr result) reads.
    def reads_of(stage):
        kind, payload = stage
        eqns = payload if kind == "seg" else [payload]
        r = set()
        for eqn in eqns:
            for v in eqn.invars:
                if not isinstance(v, _core.Literal):
                    r.add(v)
        return r

    later_reads = [set() for _ in stages]
    acc = {v for v in jaxpr.outvars if not isinstance(v, _core.Literal)}
    for i in range(len(stages) - 1, -1, -1):
        later_reads[i] = set(acc)
        acc |= reads_of(stages[i])

    compiled = []
    for i, (kind, payload) in enumerate(stages):
        if kind == "cb":
            compiled.append((kind, payload))
            continue
        defined = set()
        for eqn in payload:
            defined.update(ov for ov in eqn.outvars
                           if not isinstance(ov, _core.DropVar))
        invars = sorted(reads_of(("seg", payload)) - defined,
                        key=lambda v: v.count)
        # later_reads[i] = final outvars + reads of every stage AFTER i
        # (the backward sweep snapshots acc before folding stage i in) —
        # exactly what this segment must emit.
        outvars = sorted(defined & later_reads[i], key=lambda v: v.count)
        compiled.append((kind, (_make_segment_fn(payload, invars, outvars),
                                invars, outvars)))

    constvars, const_vals = jaxpr.constvars, closed.consts

    def run(*args):
        flat_args = jax.tree_util.tree_leaves(args)
        env = dict(zip(jaxpr.invars, flat_args))
        env.update(zip(constvars, const_vals))

        def read(v):
            return v.val if isinstance(v, _core.Literal) else env[v]

        for kind, payload in compiled:
            if kind == "seg":
                seg_fn, invars, outvars = payload
                outs = seg_fn(*[read(v) for v in invars])
                env.update(zip(outvars, outs))
            else:
                eqn = payload
                cb = eqn.params["callback"]
                ins = [np.asarray(read(v)) for v in eqn.invars]
                outs = cb(*ins)
                if not isinstance(outs, (list, tuple)):
                    outs = [outs]
                for ov, o, aval in zip(eqn.outvars, outs,
                                       eqn.params["result_avals"]):
                    if not isinstance(ov, _core.DropVar):
                        env[ov] = jnp.asarray(o, dtype=aval.dtype)
        flat_out = [read(v) for v in jaxpr.outvars]
        return jax.tree_util.tree_unflatten(out_tree, flat_out)

    run._split_stages = len(stages)
    return run
