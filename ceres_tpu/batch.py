"""Batched solves: N structurally-identical problems in ONE device program.

No reference analog — this is an accelerator-native capability. Ceres
solves one
problem per Solve() call; on accelerator hardware the natural unit is a
BATCH of small/medium solves (RANSAC hypotheses, per-frame pose
refinement, multi-start global optimization, sensor-array calibration)
executed as a single jitted program: the fused trust-region while-loop
(minimizers/fused.py) is vmapped over the problem axis, so every LM
iteration runs the whole batch's linearize/eliminate/solve as batched
device ops, and the loop runs until every element terminates (finished
elements are frozen by the fused loop's freeze_done guard).

Contract: all problems must share the SAME structure — identical block
sizes, residual counts, cost classes, loss classes, and sparsity (the
same construction code with different numeric data). Structure is
verified cheaply: the per-problem constant sets must agree in name,
shape, and dtype, and every integer (index/structural) constant must be
bitwise equal; float data constants (measurements, loss scales,
interpolation grids) may differ per problem. Problems whose
configuration cannot run the fused loop (bounds, callbacks, inner
iterations, ...) fall back to sequential ct.solve().

Usage:
    summaries = ct.solve_batched(options, [p1, p2, ...])
Results are written back into each problem's parameter arrays, exactly
like ct.solve().
"""

from __future__ import annotations

import time
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import program as program_mod
from .program import CompiledProgram
from .types import SolverSummary
from .types import DumpFormatType, MinimizerType, TerminationType

# Problem size (total residuals per element) above which "auto" switches
# from one vmapped batch program to pipelined single solves. The value is
# carried over from an earlier accelerator and has NOT been measured on
# the GPU (`benchmarks/batch_benchmark.py --sweep` measures it); override
# with SolverOptions.batch_mode for workloads beyond it.
BATCH_CROSSOVER_RESIDUALS = 200000

# Structural template registry: the jitted batch/pipeline solve depends
# only on the problems' STRUCTURE (block layout, const shapes, the
# shared/var const split), not on their numeric data — in serving, every
# request builds FRESH Problem objects, and without this the per-call
# retrace + compile-cache lookup dwarfs the device solve. Entries hold the template program (alive, its
# baked values are never read — every recorded const is bound as an
# argument) plus the jitted executable; bounded LRU.
_TEMPLATE_REGISTRY: "list[dict]" = []
_TEMPLATE_REGISTRY_CAP = 8


def _registry_lookup(key, template, names, shared_names, var_names):
    for entry in _TEMPLATE_REGISTRY:
        if entry["key"] != key:
            continue
        if (entry["names"] != names or entry["shared"] != shared_names
                or entry["var"] != var_names):
            continue
        if _validate_same_structure([entry["template"], template]) is not None:
            continue
        # Shape/dtype equality is NOT enough for reuse: host-side build
        # decisions inside make_fused_tr_solve are taken from the
        # template's constant VALUES at trace time (e.g. the cross-bucket
        # duplicate pair list in solvers/schur_fused.py is derived from
        # the observation wiring; chunk groupings from counts.max()), so
        # an executable is specialized to the old graph even though every
        # recorded const is bound as an argument. Require bitwise
        # equality of every integer-dtype (structural) constant before
        # reusing; numeric float data may differ freely.
        if not _same_structural_consts(entry["template"], template, names):
            continue
        _TEMPLATE_REGISTRY.remove(entry)
        _TEMPLATE_REGISTRY.append(entry)       # LRU bump
        return entry
    return None


def _same_structural_consts(a, b, names) -> bool:
    for nm in names:
        va, vb = a.consts_np[nm], b.consts_np[nm]
        la = jax.tree_util.tree_leaves(va)
        if any(np.issubdtype(np.asarray(x).dtype, np.integer) for x in la):
            if not _tree_equal(va, vb):
                return False
    return True


def _registry_store(key, template, names, shared_names, var_names,
                    solve_jit):
    _TEMPLATE_REGISTRY.append(dict(
        key=key, template=template, names=names, shared=shared_names,
        var=var_names, solve_jit=solve_jit))
    while len(_TEMPLATE_REGISTRY) > _TEMPLATE_REGISTRY_CAP:
        _TEMPLATE_REGISTRY.pop(0)


def _fused_capable(program, options) -> bool:
    # options.fused_iterations is deliberately ignored: the batched
    # implementation IS the fused loop (a host loop per element would
    # defeat the point); the flag only selects the single-solve path.
    return (options.minimizer_type == MinimizerType.TRUST_REGION
            and not options.callbacks
            and not options.use_nonmonotonic_steps
            and not options.minimizer_progress_to_stdout
            and not options.use_inner_iterations
            and not options.trust_region_problem_dump_directory
            and options.trust_region_problem_dump_format_type
            != DumpFormatType.CONSOLE
            and options.evaluation_callback is None
            and not options.update_state_every_iteration
            and options.max_solver_time_in_seconds >= 1e9
            and not options.dynamic_sparsity
            and not program.has_bounds
            and options.mesh is None)


def _record_const_names(fn, example_args):
    used = set()
    tok = program_mod._CONST_CTX.set(("record", used))
    try:
        jax.eval_shape(fn, *example_args)
    finally:
        program_mod._CONST_CTX.reset(tok)
    return sorted(used)


def solve_batched(options, problems: Sequence) -> List[SolverSummary]:
    """Solve N structurally-identical problems in one vmapped device
    program. Returns one SolverSummary per problem; parameters are
    written back into each problem's arrays."""
    from .solver import solve as solve_single
    from .minimizers.fused import (make_fused_tr_solve, FusedResult,
                                   TERMINATION_BY_CODE)

    problems = list(problems)
    if not problems:
        return []
    if len(problems) == 1:
        return [solve_single(options, problems[0])]

    t_start = time.time()
    programs = [CompiledProgram.get_cached(p, options) for p in problems]
    template = programs[0]

    if not _fused_capable(template, options):
        return [solve_single(options, p) for p in problems]

    # Execution mode: the vmapped batch program runs every element in
    # LOCKSTEP until the slowest terminates; asynchronously pipelined
    # single solves (one shared compiled program, per-element constant
    # arguments) do not, and the device runs them back-to-back. Batching
    # wins while one element leaves the device mostly idle — small
    # problems (BATCH_CROSSOVER_RESIDUALS).
    mode = options.batch_mode
    if mode == "auto":
        mode = ("batch" if template.num_residuals_total
                <= BATCH_CROSSOVER_RESIDUALS else "pipeline")
    batched_flag = mode == "batch"

    # Build the solve from the template; building the step structure for
    # the OTHER programs as well makes their lazily-registered constants
    # (Schur meta, camera chunks, ...) available for stacking.
    fn = make_fused_tr_solve(template, options, freeze_done=batched_flag)
    other_fns = [make_fused_tr_solve(pr, options, freeze_done=batched_flag)
                 for pr in programs[1:]]

    # ---- structural validation ----
    err = _validate_same_structure(programs)
    if err is not None:
        raise ValueError(f"solve_batched: problems differ in structure "
                         f"({err}); batched solving requires identical "
                         f"graphs (same construction code, different "
                         f"numeric data)")

    names = _record_const_names(fn, (template.example_x(),))

    # Constants registered at TRACE time exist only on programs whose
    # solve has been traced; the template's recording above covered it —
    # trace any other program still missing a recorded name so its
    # per-problem value can be stacked.
    for pr, fn_pr in zip(programs[1:], other_fns):
        if any(nm not in pr.consts_np for nm in names):
            _record_const_names(fn_pr, (pr.example_x(),))
    missing = [(i + 1, nm) for i, pr in enumerate(programs[1:])
               for nm in names if nm not in pr.consts_np]
    if missing:
        raise ValueError(f"solve_batched: constants missing on non-"
                         f"template programs after tracing: {missing}")

    # shared (bitwise-equal across problems) vs per-problem constants
    shared_names, var_names = [], []
    for nm in names:
        v0 = template.consts_np[nm]
        same = all(_tree_equal(v0, pr.consts_np[nm]) for pr in programs[1:])
        (shared_names if same else var_names).append(nm)
    # integer structural constants must not vary (index layouts are baked
    # into host-side decisions like slab offsets)
    for nm in var_names:
        leaves = jax.tree_util.tree_leaves(template.consts_np[nm])
        if any(np.issubdtype(np.asarray(a).dtype, np.integer)
               for a in leaves):
            raise ValueError(
                f"solve_batched: structural (integer) constant {nm!r} "
                f"differs across problems — the sparsity/ordering must "
                f"be identical for a batched solve")

    def one(shared_tuple, var_tuple, x0):
        mapping = dict(zip(shared_names, shared_tuple))
        mapping.update(dict(zip(var_names, var_tuple)))
        tok = program_mod._CONST_CTX.set(("bind", mapping))
        try:
            return fn(x0)
        finally:
            program_mod._CONST_CTX.reset(tok)

    shared_tuple = tuple(template._device_const(nm)
                         for nm in shared_names)
    reg_key = (options.cache_key(), mode,
               len(problems) if mode == "batch" else None)
    entry = _registry_lookup(reg_key, template, names, shared_names,
                             var_names)
    if mode == "batch":
        if entry is not None:
            solve_jit = entry["solve_jit"]
        else:
            def bound(shared_tuple, var_stacked, x0_stacked):
                return jax.vmap(lambda v, x: one(shared_tuple, v, x))(
                    var_stacked, x0_stacked)

            solve_jit = jax.jit(bound)
            _registry_store(reg_key, template, names, shared_names,
                            var_names, solve_jit)

        t0 = time.time()
        var_stacked = tuple(
            jax.tree_util.tree_map(
                lambda *a: jnp.stack([jnp.asarray(x) for x in a]),
                *[pr.consts_np[nm] for pr in programs])
            for nm in var_names)
        x0_stacked = jnp.stack([pr.initial_state() for pr in programs])
        x_dev, stats_dev = solve_jit(shared_tuple, var_stacked,
                                     x0_stacked)
        x_host, stats = jax.device_get((x_dev, stats_dev))
        minimizer_time = time.time() - t0
    else:
        # pipeline: ONE compiled single-solve, K asynchronous dispatches
        # with per-element constants — the chip runs them back-to-back
        # with no lockstep waste and the full single-problem kernel
        # specializations active.
        if entry is not None:
            one_jit = entry["solve_jit"]
        else:
            one_jit = jax.jit(one)
            _registry_store(reg_key, template, names, shared_names,
                            var_names, one_jit)
        vars_per = [
            tuple(jax.tree_util.tree_map(jnp.asarray, pr.consts_np[nm])
                  for nm in var_names)
            for pr in programs]
        xs0 = [pr.initial_state() for pr in programs]
        t0 = time.time()
        rs = [one_jit(shared_tuple, v, x0)
              for v, x0 in zip(vars_per, xs0)]
        jax.block_until_ready([r[1] for r in rs])
        pulled = jax.device_get(rs)
        x_host = [p[0] for p in pulled]
        stats = [p[1] for p in pulled]
        minimizer_time = time.time() - t0

    summaries = []
    for i, pr in enumerate(programs):
        result = FusedResult.unpack(x_host[i], stats[i])
        s = SolverSummary()
        s.minimizer_type = options.minimizer_type
        s.trust_region_strategy_type = options.trust_region_strategy_type
        s.linear_solver_type_given = options.linear_solver_type
        s.linear_solver_type_used = options.linear_solver_type
        s.num_parameter_blocks = pr.num_parameter_blocks
        s.num_parameters = pr.num_parameters
        s.num_residual_blocks = pr.num_residual_blocks
        s.num_residuals = pr.num_residuals_total
        s.fixed_cost = pr.fixed_cost
        s.initial_cost = float(result.initial_cost)
        s.final_cost = float(result.cost)
        s.num_successful_steps = int(result.successful_steps)
        s.num_unsuccessful_steps = int(result.unsuccessful_steps)
        s.num_linear_solves = int(result.iterations)
        s.num_linear_solver_iterations = int(
            result.total_linear_iterations)
        s.num_iterations_fused = int(result.iterations)
        code = int(result.termination_code)
        term, msg = TERMINATION_BY_CODE.get(
            code, (TerminationType.FAILURE, f"unknown code {code}"))
        s.termination_type = term
        s.message = msg + f" (batched fused mode [{mode}], element {i})"
        s.minimizer_time_in_seconds = minimizer_time
        s.total_time_in_seconds = time.time() - t_start
        if s.is_solution_usable():
            pr.write_back(result.x)
        summaries.append(s)
    return summaries


def _tree_equal(a, b) -> bool:
    la = jax.tree_util.tree_leaves(a)
    lb = jax.tree_util.tree_leaves(b)
    if len(la) != len(lb):
        return False
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(la, lb))


def _validate_same_structure(programs) -> str:
    """None when all programs share the template's structure, else a
    human-readable difference."""
    t = programs[0]
    for i, pr in enumerate(programs[1:], start=1):
        if pr.num_ambient != t.num_ambient:
            return f"problem {i}: {pr.num_ambient} ambient parameters " \
                   f"vs {t.num_ambient}"
        if pr.num_effective != t.num_effective:
            return f"problem {i}: {pr.num_effective} effective " \
                   f"parameters vs {t.num_effective}"
        if len(pr.buckets) != len(t.buckets):
            return f"problem {i}: {len(pr.buckets)} cost buckets vs " \
                   f"{len(t.buckets)}"
        if pr.fixed_cost != t.fixed_cost:
            return f"problem {i}: fixed cost {pr.fixed_cost} vs " \
                   f"{t.fixed_cost} (constant-block residuals are " \
                   f"folded host-side and must agree)"
        if set(pr.consts_np) != set(t.consts_np):
            extra = set(pr.consts_np) ^ set(t.consts_np)
            return f"problem {i}: constant set differs ({sorted(extra)[:4]})"
        for nm, v in t.consts_np.items():
            sa = [(np.asarray(x).shape, np.asarray(x).dtype)
                  for x in jax.tree_util.tree_leaves(v)]
            sb = [(np.asarray(x).shape, np.asarray(x).dtype)
                  for x in jax.tree_util.tree_leaves(pr.consts_np[nm])]
            if sa != sb:
                return (f"problem {i}: constant {nm!r} "
                        f"shape/dtype {sb} vs {sa}")
    return None
