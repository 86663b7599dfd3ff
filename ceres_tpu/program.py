"""CompiledProgram: Problem graph -> pure jittable evaluation functions.

Replaces the reference's evaluation layer (L3): Program / ParameterBlock /
ResidualBlock (internal/ceres/program.cc, parameter_block.h,
residual_block.cc), ProgramEvaluator (program_evaluator.h:115) and the
Jacobian writers (block_jacobian_writer.cc etc.).

Design (SURVEY.md section 7): residual blocks are grouped into
shape-uniform buckets by (cost-function code, loss, per-slot manifold +
constancy). Each bucket evaluates as ONE vmapped call; Jacobians come from
jax.jacfwd of residual o manifold.plus at delta = 0, giving tangent-space
block Jacobians directly (this fuses the reference's Jet autodiff
(autodiff.h:307), the PlusJacobian chain rule (residual_block.cc:134-157),
and the robust-loss Corrector (corrector.cc) into one XLA program). The
reference's ParallelFor-over-residual-blocks (program_evaluator.h:186)
becomes XLA batching; per-thread gradient scratch + reduction
(program_evaluator.h:239-281) becomes einsum + scatter-add.
"""

from __future__ import annotations

import contextvars
import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

# Constant-indirection context: when set, program.const(name) yields the
# traced argument instead of embedding the numpy array as an HLO literal.
# Mode "record" collects which names a function uses; mode "bind" substitutes
# traced values. Large problems embed tens of MB of index maps otherwise,
# which bloats HLO and forces recompiles per problem.
_CONST_CTX = contextvars.ContextVar("ceres_tpu_consts", default=None)

from . import config
from .cost import NumericDiffCostFunction, SizedCostFunction
from .loss import correct_residuals_and_jacobian
from .manifolds import EuclideanManifold
from .ops.bsr import BlockJacobian, BucketJacobian, RVec


def _abs_slot(bucket, var_si):
    """Absolute slot index of the var_si-th variable slot."""
    k = -1
    for j, sl in enumerate(bucket.slots):
        if sl.variable:
            k += 1
            if k == var_si:
                return j
    raise IndexError(var_si)


def _loss_vectorizable(loss):
    """A loss whose attributes are all plain numbers can be batched across
    a bucket with per-row stacked attributes (they broadcast elementwise
    against the [n] squared-norm vector in evaluate())."""
    try:
        return all(isinstance(v, (int, float))
                   for v in vars(loss).values())
    except Exception:
        return False


def _loss_key(loss):
    if loss is None:
        return None
    try:
        if _loss_vectorizable(loss):
            # Same-class losses batch into ONE bucket; differing scalar
            # parameters ride as stacked per-row data (e.g. the 24
            # per-filter alphas of Fields-of-Experts collapse 24 buckets
            # into one, shrinking compile 24x).
            return (type(loss).__name__, "vectorized")
        items = tuple(sorted(
            (k, v) for k, v in vars(loss).items()
            if isinstance(v, (int, float, bool, str))))
        return (type(loss).__name__, items)
    except Exception:
        return ("loss-id", id(loss))


class _Slot:
    __slots__ = ("variable", "amb_size", "tangent_size", "manifold",
                 "amb_idx", "cols", "local_ids", "group_id",
                 "amb_name", "cols_name", "local_name", "oh_name",
                 "amb_gid", "amb_local", "alocal_name")

    def __init__(self):
        self.variable = False
        self.manifold = None
        self.amb_idx = None
        self.cols = None
        self.local_ids = None
        self.group_id = -1
        self.amb_name = None
        self.cols_name = None
        self.local_name = None
        self.oh_name = None
        self.amb_gid = -1
        self.amb_local = None
        self.alocal_name = None


class _Bucket:
    __slots__ = ("cost", "loss", "residual_fn", "jac_mode", "data", "slots",
                 "n", "r", "row_offset", "orig_indices", "key", "_slot_keys",
                 "data_name", "sorted_abs_slot", "loss_attrs",
                 "loss_attr_consts")


class GroupMeta:
    """Variable parameter blocks grouped by tangent size, for batched
    block-diagonal ops (Jacobi preconditioner, Schur (E^T E)^-1)."""
    __slots__ = ("tangent_size", "num_blocks", "tan_cols", "bucket_slots")

    def __init__(self, tangent_size, num_blocks, tan_cols, bucket_slots):
        self.tangent_size = tangent_size
        self.num_blocks = num_blocks
        self.tan_cols = tan_cols          # np [k, t] int32 tangent columns
        self.bucket_slots = bucket_slots  # [(bucket_idx, slot_idx, local_ids)]


class CompiledProgram:
    """Static compilation of a Problem at a given structure revision."""

    @classmethod
    def get_cached(cls, problem, options=None, apply_loss: bool = True,
                   include_fixed_blocks: bool = False):
        """Reuse the program (and its jitted executables) across solves as
        long as the problem structure hasn't changed — the reference's
        Preprocessor is re-run per Solve, but XLA executables are the
        expensive artifact here and must persist (context_impl.h's role:
        ContextImpl owns reusable handles; here the program owns them).
        Keyed per configuration so alternating solve / Problem.Evaluate
        (different include_fixed_blocks) does not thrash; stale-revision
        entries are dropped when the problem mutates."""
        dtype = (getattr(options, "dtype", None) or config.default_dtype())
        from .solvers.schur import _ordering_cache_key
        key = (problem._revision, str(dtype), apply_loss,
               include_fixed_blocks, _ordering_cache_key(options))
        cache = getattr(problem, "_compiled_cache", None)
        if cache is None or not isinstance(cache, dict):
            cache = {}
            problem._compiled_cache = cache
        for k in [k for k in cache if k[0] != problem._revision]:
            del cache[k]
        if key in cache:
            return cache[key]
        prog = cls(problem, options=options, apply_loss=apply_loss,
                   include_fixed_blocks=include_fixed_blocks)
        cache[key] = prog
        return prog

    def cached_jit(self, key, builder):
        """Build-once jitted executables keyed by an options signature."""
        cache = self._jit_cache
        if key not in cache:
            cache[key] = builder()
        return cache[key]

    # ---------- constant indirection ----------

    def register_const(self, name: str, value):
        """Register a structural constant (numpy array or pytree of arrays).
        Must happen before the first trace of any function that uses it."""
        self.consts_np[name] = value

    def const(self, name: str):
        """Inside traced code: the constant as a traced argument (when bound
        via jit_with_consts) or as an embedded literal (fallback)."""
        ctx = _CONST_CTX.get()
        if ctx is not None:
            mode, store = ctx
            if mode == "record":
                store.add(name)
            elif name in store:
                return store[name]
        v = self.consts_np[name]
        return jax.tree_util.tree_map(jnp.asarray, v)

    def _device_const(self, name: str):
        if name not in self._device_consts:
            self._device_consts[name] = jax.tree_util.tree_map(
                jnp.asarray, self.consts_np[name])
        return self._device_consts[name]

    def jit_with_consts(self, fn, example_args, static_argnums=()):
        """jax.jit(fn) with every program constant the function touches
        passed as a device-resident argument instead of an HLO literal.
        example_args: ShapeDtypeStructs (or arrays) for fn's arguments,
        used for a cheap recording trace."""
        used = set()
        tok = _CONST_CTX.set(("record", used))
        try:
            jax.eval_shape(fn, *example_args)
        finally:
            _CONST_CTX.reset(tok)
        names = sorted(used)

        def bound(consts_tuple, *args):
            tok = _CONST_CTX.set(("bind", dict(zip(names, consts_tuple))))
            try:
                return fn(*args)
            finally:
                _CONST_CTX.reset(tok)

        jitted = jax.jit(bound)

        from .utils.hostsplit import backend_supports_callbacks, split_jit
        if not backend_supports_callbacks():
            # Backends without host send/recv cannot compile
            # jax.pure_callback. The sparse
            # direct solvers and the C-API cost shim are host stages by
            # design (the reference factors on CPU too); split the traced
            # program at its top-level callbacks into device segments
            # with the host work run eagerly between them — identical
            # semantics, one extra dispatch per segment.
            def _ex(v):
                return jax.tree_util.tree_map(
                    lambda a: jax.ShapeDtypeStruct(np.shape(a),
                                                   np.asarray(a).dtype),
                    v)
            example_consts = tuple(_ex(self.consts_np[n]) for n in names)
            try:
                split = split_jit(bound, (example_consts, *example_args))
            except Exception:
                split = None
            if split is not None:
                jitted = split

        def call(*args):
            consts = tuple(self._device_const(n) for n in names)
            return jitted(consts, *args)

        call.__wrapped__ = fn
        call._const_names = names
        return call

    def example_x(self):
        return jax.ShapeDtypeStruct((self.num_ambient,), self.dtype)

    def example_delta(self):
        return jax.ShapeDtypeStruct((self.num_effective,), self.dtype)

    def example_scalar(self):
        return jax.ShapeDtypeStruct((), self.dtype)

    def traced_groups(self):
        """GroupMeta views whose arrays resolve through const() — call
        INSIDE traced code (block-Jacobi preconditioner, inner iterations)."""
        out = []
        for gi, g in enumerate(self.groups):
            slots = [(bi, vsi,
                      self.const(self.buckets[bi].slots[_abs_slot(
                          self.buckets[bi], vsi)].local_name))
                     for (bi, vsi, _) in g.bucket_slots]
            out.append(GroupMeta(g.tangent_size, g.num_blocks,
                                 self.const(f"grp{gi}.tan_cols"), slots))
        return out

    def __init__(self, problem, options=None, apply_loss: bool = True,
                 include_fixed_blocks: bool = False):
        self._jit_cache = {}
        self.consts_np = {}
        self._device_consts = {}
        self.problem = problem
        self.revision = problem._revision
        self.dtype = (getattr(options, "dtype", None)
                      or config.default_dtype())
        self.apply_loss = apply_loss

        records = problem._param_records()
        residuals = problem._residual_records()

        # --- classify residual blocks ---
        def is_fixed(rb):
            return all(problem._blocks[k].constant for k in rb.param_keys)

        if include_fixed_blocks:
            active_res = residuals
            fixed_res = []
        else:
            active_res = [rb for rb in residuals if not is_fixed(rb)]
            fixed_res = [rb for rb in residuals if is_fixed(rb)]

        used_keys = set()
        for rb in active_res + fixed_res:
            used_keys.update(rb.param_keys)

        # --- parameter layout ---
        # Ambient x contains every used block (constants included, so buckets
        # gather all parameters from one vector). Tangent space covers only
        # variable used blocks (the reference's "reduced program",
        # program.cc:287).
        self.used_blocks = [b for b in records if id(b.array) in used_keys]
        self.unused_blocks = [b for b in records
                              if id(b.array) not in used_keys]
        # Layout blocks grouped by size (stable within a size): every
        # same-size group occupies ONE contiguous slab of x, so per-slot
        # parameter gathers become slice+reshape+row-take — taking rows of
        # a [k, size] matrix moves contiguous rows where the equivalent
        # flat gather x[idx[n, size]] moves scalars. Public
        # gradient/jacobian views are permuted back to insertion order in
        # public_evaluate.
        self.used_blocks.sort(key=lambda b: b.size)
        self.amb_offset = {}
        off = 0
        for b in self.used_blocks:
            self.amb_offset[id(b.array)] = off
            off += b.size
        self.num_ambient = off

        self.variable_blocks = [b for b in self.used_blocks
                                if not b.constant and b.tangent_size > 0]
        self.variable_blocks.sort(key=lambda b: b.tangent_size)
        self.tan_offset = {}
        toff = 0
        for b in self.variable_blocks:
            self.tan_offset[id(b.array)] = toff
            toff += b.tangent_size
        self.num_effective = toff

        # Ambient slabs: blocks grouped by ambient size, each contiguous.
        # _amb_group_of_block: id -> (group_index, local_row).
        self._amb_group_of_block = {}
        self.amb_slabs = []   # [(start_offset, k, size)]
        _ag = {}
        for b in self.used_blocks:
            _ag.setdefault(b.size, []).append(b)
        for gi, (size, blks) in enumerate(sorted(_ag.items())):
            start = self.amb_offset[id(blks[0].array)]
            for li, b in enumerate(blks):
                self._amb_group_of_block[id(b.array)] = (gi, li)
            self.amb_slabs.append((start, len(blks), size))

        # --- summary counts ---
        self.num_parameter_blocks = len(records)
        self.num_parameters = sum(b.size for b in records)
        self.num_effective_parameters = sum(
            (b.manifold.tangent_size if b.manifold else b.size)
            for b in records)
        self.num_residual_blocks = len(residuals)
        self.num_residuals_total = sum(rb.cost.num_residuals
                                       for rb in residuals)
        self.num_parameter_blocks_reduced = len(self.variable_blocks)
        self.num_parameters_reduced = sum(b.size
                                          for b in self.variable_blocks)
        self.num_effective_parameters_reduced = self.num_effective
        self.num_residual_blocks_reduced = len(active_res)
        self.num_residuals_reduced = sum(rb.cost.num_residuals
                                         for rb in active_res)

        # (initial ambient state is rebuilt per solve from the live user
        # arrays — the program caches structure, not values)

        # --- bounds (projection in plus, parameter_block.h Plus) ---
        self.has_bounds = any(b.has_bounds for b in self.variable_blocks)
        if self.has_bounds:
            lo = np.full(self.num_ambient, -np.inf)
            hi = np.full(self.num_ambient, np.inf)
            for b in self.variable_blocks:
                if b.has_bounds:
                    o = self.amb_offset[id(b.array)]
                    lo[o:o + b.size] = b.lower
                    hi[o:o + b.size] = b.upper
            self._lo, self._hi = lo, hi

        # --- buckets ---
        self.buckets: List[_Bucket] = []
        groups_map = {}  # key -> list per residual block index
        for rb in active_res:
            slot_sig = []
            for k in rb.param_keys:
                blk = problem._blocks[k]
                var = (not blk.constant) and blk.tangent_size > 0
                man_key = (blk.manifold.bucket_key() if blk.manifold
                           else ("euclid", blk.size))
                slot_sig.append((var, blk.size, man_key))
            key = (rb.cost.bucket_key(), _loss_key(rb.loss), tuple(slot_sig))
            groups_map.setdefault(key, []).append(rb)

        # Jacobi groups: variable blocks by tangent size.
        size_groups = {}
        for b in self.variable_blocks:
            size_groups.setdefault(b.tangent_size, []).append(b)
        self.groups: List[GroupMeta] = []
        self._group_of_block = {}   # id(array) -> (group_id, local_id)
        for gi, (t, blks) in enumerate(sorted(size_groups.items())):
            offs = np.fromiter((self.tan_offset[id(b.array)] for b in blks),
                               dtype=np.int32, count=len(blks))
            tan_cols = offs[:, None] + np.arange(t, dtype=np.int32)[None, :]
            for li, b in enumerate(blks):
                self._group_of_block[id(b.array)] = (gi, li)
            self.groups.append(GroupMeta(t, len(blks), tan_cols, []))

        row = 0
        for bi, (key, rbs) in enumerate(groups_map.items()):
            # Order the bucket's rows by the block index of the slot with
            # the most parameter blocks (BA: the point slot). Transpose-
            # side scatter-adds then see sorted indices (a segmented
            # reduction instead of random updates), and
            # the Schur chunk gathers become near-contiguous.
            if len(rbs) > 1:
                sort_si, sort_kg = None, 1
                for si, k in enumerate(rbs[0].param_keys):
                    blk = problem._blocks[k]
                    if blk.constant or blk.tangent_size <= 0:
                        continue
                    gi_, _ = self._group_of_block[k]
                    kg = self.groups[gi_].num_blocks
                    if kg > sort_kg:
                        sort_kg, sort_si = kg, si
                if sort_si is not None:
                    rbs = sorted(
                        rbs, key=lambda rb: self._group_of_block[
                            rb.param_keys[sort_si]][1])
            else:
                sort_si = None
            bk = _Bucket()
            bk.sorted_abs_slot = sort_si
            bk.key = key
            bk.cost = rbs[0].cost
            bk.loss = rbs[0].loss if apply_loss else None
            # Vectorized per-row loss parameters (see _loss_key): stack the
            # scalar attributes when they differ across the bucket.
            bk.loss_attrs = None
            bk.loss_attr_consts = None
            if (apply_loss and bk.loss is not None
                    and _loss_vectorizable(bk.loss)):
                attr_sets = [vars(rb.loss) for rb in rbs]
                names = sorted(attr_sets[0])
                if any(attr_sets[i][k] != attr_sets[0][k]
                       for i in range(len(rbs)) for k in names):
                    bk.loss_attrs = {
                        k: np.asarray([a[k] for a in attr_sets])
                        for k in names}
            bk.n = len(rbs)
            bk.r = bk.cost.num_residuals
            bk.row_offset = row
            row += bk.n * bk.r
            bk.orig_indices = np.asarray([rb.index for rb in rbs],
                                         dtype=np.int64)
            bk.residual_fn = bk.cost.make_residual_fn()

            # Jacobian mode
            if isinstance(bk.cost, NumericDiffCostFunction):
                bk.jac_mode = "numdiff"
            elif (isinstance(bk.cost, SizedCostFunction)
                  and type(bk.cost).jacobians
                  is not SizedCostFunction.jacobians):
                bk.jac_mode = "analytic"
            else:
                bk.jac_mode = "ad"

            # Stacked per-block data
            datas = [rb.cost.block_data() for rb in rbs]
            if datas[0] == () or datas[0] == {}:
                bk.data = datas[0]
            else:
                def stack(*leaves):
                    a = np.stack([np.asarray(x) for x in leaves])
                    if np.issubdtype(a.dtype, np.floating):
                        a = a.astype(self.dtype)
                    return a
                bk.data = jax.tree_util.tree_map(stack, *datas)

            # Slots
            bk.slots = []
            var_si = 0  # index among variable slots (BucketJacobian order)
            sizes = bk.cost.parameter_block_sizes
            for si in range(len(sizes)):
                sl = _Slot()
                blk0 = problem._blocks[rbs[0].param_keys[si]]
                sl.amb_size = blk0.size
                sl.variable = (not blk0.constant) and blk0.tangent_size > 0
                sl.manifold = blk0.manifold
                sl.tangent_size = blk0.tangent_size if sl.variable else 0
                amb_off = np.fromiter(
                    (self.amb_offset[rb.param_keys[si]] for rb in rbs),
                    dtype=np.int32, count=bk.n)
                sl.amb_idx = amb_off[:, None] + np.arange(
                    sl.amb_size, dtype=np.int32)[None, :]
                sl.amb_gid = self._amb_group_of_block[
                    rbs[0].param_keys[si]][0]
                sl.amb_local = np.fromiter(
                    (self._amb_group_of_block[rb.param_keys[si]][1]
                     for rb in rbs), dtype=np.int32, count=bk.n)
                if sl.variable:
                    t = sl.tangent_size
                    tan_off = np.fromiter(
                        (self.tan_offset[rb.param_keys[si]] for rb in rbs),
                        dtype=np.int32, count=bk.n)
                    sl.cols = tan_off[:, None] + np.arange(
                        t, dtype=np.int32)[None, :]
                    gid = self._group_of_block[rbs[0].param_keys[si]][0]
                    sl.local_ids = np.fromiter(
                        (self._group_of_block[rb.param_keys[si]][1]
                         for rb in rbs), dtype=np.int32, count=bk.n)
                    sl.group_id = gid
                    # bucket_slots indexes VARIABLE slots (slot_J order)
                    self.groups[gid].bucket_slots.append(
                        (bi, var_si, sl.local_ids))
                    var_si += 1
                bk.slots.append(sl)
            self.buckets.append(bk)

        self.num_rows = row

        # --- fixed cost (blocks whose parameters are all constant;
        #     reference program.cc:287 fixed_cost) ---
        self.fixed_cost = 0.0
        if fixed_res:
            self.fixed_cost = float(self._eval_fixed(fixed_res))

        # ---- constant registry: every structural array becomes a named
        # constant passed to jitted functions as a device argument ----
        for bi, bk in enumerate(self.buckets):
            bk.data_name = f"b{bi}.data"
            self.register_const(bk.data_name, bk.data)
            if bk.loss_attrs is not None:
                bk.loss_attr_consts = {}
                for k, v in bk.loss_attrs.items():
                    name = f"b{bi}.lossattr.{k}"
                    self.register_const(name, v)
                    bk.loss_attr_consts[k] = name
            var_si = 0
            for si, sl in enumerate(bk.slots):
                sl.amb_name = f"b{bi}.amb{si}"
                sl.alocal_name = f"b{bi}.alocal{si}"
                self.register_const(sl.amb_name, sl.amb_idx)
                self.register_const(sl.alocal_name, sl.amb_local)
                if sl.variable:
                    sl.cols_name = f"b{bi}.cols{var_si}"
                    sl.local_name = f"b{bi}.local{var_si}"
                    self.register_const(sl.cols_name, sl.cols)
                    self.register_const(sl.local_name, sl.local_ids)
                    # One-hot of the slot's block index: scatter-adds with
                    # massive index duplication (few blocks shared by many
                    # residual rows — e.g. 16 cameras x 83k observations)
                    # serialize on colliding updates; a one-hot matmul
                    # makes the duplicate reduction a dense contraction.
                    kg = self.groups[sl.group_id].num_blocks
                    if kg <= 1024 and bk.n * kg <= 3e8 \
                            and bk.n // max(kg, 1) >= 16:
                        oh = np.zeros((bk.n, kg), dtype=np.float32)
                        oh[np.arange(bk.n), sl.local_ids] = 1.0
                        sl.oh_name = f"b{bi}.oh{var_si}"
                        self.register_const(sl.oh_name, oh)
                    var_si += 1
        for gi, g in enumerate(self.groups):
            self.register_const(f"grp{gi}.tan_cols", g.tan_cols)

        # Plus groups: variable blocks by manifold key for batched plus.
        plus_map = {}
        for b in self.variable_blocks:
            mk = (b.manifold.bucket_key() if b.manifold
                  else ("euclid", b.size))
            plus_map.setdefault(mk, []).append(b)
        self.plus_groups = []
        for mk, blks in plus_map.items():
            ao = np.fromiter((self.amb_offset[id(b.array)] for b in blks),
                             dtype=np.int32, count=len(blks))
            to = np.fromiter((self.tan_offset[id(b.array)] for b in blks),
                             dtype=np.int32, count=len(blks))
            amb = ao[:, None] + np.arange(blks[0].size,
                                          dtype=np.int32)[None, :]
            tan = to[:, None] + np.arange(blks[0].tangent_size,
                                          dtype=np.int32)[None, :]
            pi = len(self.plus_groups)
            self.register_const(f"plus{pi}.amb", amb)
            self.register_const(f"plus{pi}.tan", tan)
            # Slab fast path: when the group's ambient/tangent indices are
            # one contiguous run, plus() uses slice+reshape instead of a
            # flat gather/scatter x[idx[k, s]].
            def _slab(ix):
                flat = ix.reshape(-1)
                s = int(flat[0]) if flat.size else 0
                if np.array_equal(flat,
                                  np.arange(s, s + flat.size,
                                            dtype=flat.dtype)):
                    return (s, ix.shape[0], ix.shape[1])
                return None
            self.plus_groups.append((blks[0].manifold, amb, tan,
                                     _slab(amb), _slab(tan)))
        if self.has_bounds:
            self.register_const("bounds.lo", self._lo)
            self.register_const("bounds.hi", self._hi)

    # ------------------------------------------------------------------
    # state handling

    def initial_state(self):
        # used_blocks are amb_offset-ordered (offsets assigned sequentially
        # over the sorted list), so the state gather is one C-level
        # concatenate instead of a 22k-block Python slice loop (~25 ms at
        # BAL-16 scale). Falls back to the loop if the layout ever gains
        # holes.
        parts = getattr(self, "_init_parts", None)
        if parts is None:
            # the part list is stable (user arrays are fixed objects,
            # mutated in place); building it once keeps the per-solve cost
            # at one C-level concatenate (~1 ms at 22k blocks vs ~20 ms
            # for a Python-level gather loop). axis=None flattens each
            # block at call time, so current contents are always read.
            # The fast path REQUIRES used_blocks iteration order to equal
            # amb_offset order with no holes — verified here once (not
            # just by total size) so any future reorder falls back to the
            # explicit-offset loop instead of silently permuting x0.
            off = 0
            contiguous = True
            for b in self.used_blocks:
                if self.amb_offset[id(b.array)] != off:
                    contiguous = False
                    break
                off += b.size
            parts = [b.array for b in self.used_blocks] \
                if contiguous and off == self.num_ambient else []
            self._init_parts = parts
        if parts:
            x0 = np.concatenate(parts, axis=None)
            if x0.dtype != np.float64:
                x0 = x0.astype(np.float64)
        else:
            x0 = np.zeros(0, dtype=np.float64)
        if x0.size != self.num_ambient:
            x0 = np.zeros(self.num_ambient, dtype=np.float64)
            for b in self.used_blocks:
                o = self.amb_offset[id(b.array)]
                x0[o:o + b.size] = b.array
        # Device-resident cache keyed by content hash: repeated solves from
        # the same parameter state (serving, benchmarking, retry loops)
        # skip the host-to-device transfer.
        import hashlib
        h = hashlib.blake2b(x0.tobytes(), digest_size=16).digest()
        cached = getattr(self, "_x0_dev_cache", None)
        if cached is not None and cached[0] == h:
            return cached[1]
        xd = jnp.asarray(x0, dtype=self.dtype)
        self._x0_dev_cache = (h, xd)
        return xd

    def write_back(self, x):
        """Copy the solved ambient state into the user's numpy arrays
        (reference Program::StateVectorToParameterBlocks +
        CopyParameterBlockStateToUserState). A device-resident x is pulled
        in one transfer."""
        xh = np.asarray(x)
        for b in self.used_blocks:
            if not b.constant:
                o = self.amb_offset[id(b.array)]
                b.array[:] = xh[o:o + b.size]

    def state_norm(self, x):
        """Norm of the VARIABLE part of the ambient state — the
        reference's x_norm_ is the REDUCED program's parameter vector
        norm (constant blocks removed, trust_region_preprocessor.cc), so
        constant blocks must not inflate the parameter-tolerance
        threshold. All-variable programs (the common case) keep the
        plain norm — no graph change, compiled-program caches stay
        valid."""
        if len(self.variable_blocks) == len(self.used_blocks):
            return jnp.linalg.norm(x)
        if "var_amb_mask" not in self.consts_np:
            mask = np.zeros(self.num_ambient, dtype=np.float64)
            for b in self.variable_blocks:
                o = self.amb_offset[id(b.array)]
                mask[o:o + b.size] = 1.0
            self.register_const("var_amb_mask", mask)
        return jnp.linalg.norm(x * self.const("var_amb_mask").astype(x.dtype))

    # ------------------------------------------------------------------
    # plus

    def plus(self, x, delta):
        """x' = Plus(x, delta), batched per manifold group, then projected
        onto the bound box (parameter_block.h Plus semantics)."""
        out = x
        for pi, (manifold, _, _, amb_slab, tan_slab) in enumerate(
                self.plus_groups):
            if amb_slab is not None:
                s, k, a = amb_slab
                xs = jax.lax.dynamic_slice(x, (s,), (k * a,)).reshape(k, a)
            else:
                xs = x[self.const(f"plus{pi}.amb")]       # [k, amb]
            if tan_slab is not None:
                s2, k2, t2 = tan_slab
                ds = jax.lax.dynamic_slice(delta, (s2,),
                                           (k2 * t2,)).reshape(k2, t2)
            else:
                ds = delta[self.const(f"plus{pi}.tan")]   # [k, t]
            if manifold is None:
                new = xs + ds
            else:
                new = jax.vmap(manifold.plus)(xs, ds)
            if amb_slab is not None:
                out = jax.lax.dynamic_update_slice(out, new.reshape(-1),
                                                   (amb_slab[0],))
            else:
                out = out.at[self.const(f"plus{pi}.amb")].set(new)
        if self.has_bounds:
            out = jnp.clip(out,
                           self.const("bounds.lo").astype(self.dtype),
                           self.const("bounds.hi").astype(self.dtype))
        return out

    # ------------------------------------------------------------------
    # evaluation

    def _bucket_loss(self, bk):
        """The bucket's loss, with per-row stacked parameters when the
        bucket batches same-class losses with differing scalars."""
        if not getattr(bk, "loss_attr_consts", None):
            return bk.loss
        cls = type(bk.loss)
        obj = object.__new__(cls)
        object.__setattr__(obj, "__dict__",
                           {k: self.const(nm).astype(self.dtype)
                            for k, nm in bk.loss_attr_consts.items()})
        return obj

    def _bucket_params(self, bk, x):
        """Per-slot parameters [n, amb]: slab slice + row-take (blocks of a
        size group are contiguous in x, so this avoids the flat gather
        x[idx[n, size]])."""
        out = []
        for sl in bk.slots:
            start, k, size = self.amb_slabs[sl.amb_gid]
            Xg = x[start:start + k * size].reshape(k, size)
            out.append(Xg[self.const(sl.alocal_name)])
        return out

    def _eval_fixed(self, fixed_res):
        total = 0.0
        x = self.initial_state()
        for rb in fixed_res:
            fn = rb.cost.make_residual_fn()
            params = [x[self.amb_offset[k]:self.amb_offset[k]
                        + self.problem._blocks[k].size]
                      for k in rb.param_keys]
            r = fn(jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, dtype=self.dtype)
                if isinstance(a, (np.ndarray, float, int)) else a,
                rb.cost.block_data()), *params)
            s = jnp.sum(r * r)
            if rb.loss is not None and self.apply_loss:
                rho0, _, _ = rb.loss.evaluate(s)
                total += 0.5 * float(rho0)
            else:
                total += 0.5 * float(s)
        return total

    def _bucket_residuals(self, bk, x, row_arrays=None):
        """Uncorrected residuals [n, r] for one bucket."""
        if row_arrays is not None:
            data, amb_idxs = row_arrays
            params = [x[ai] for ai in amb_idxs]
        else:
            data = self.const(bk.data_name)
            params = self._bucket_params(bk, x)
        fn = bk.residual_fn

        def per_block(data, *ps):
            return fn(data, *ps)

        return jax.vmap(per_block)(data, *params)

    def _bucket_linearize(self, bk, x, row_arrays=None, cast_dtype=None):
        """(residuals [n,r], J [n,r,t_total]) tangent-space, uncorrected.

        row_arrays: optional (data, [amb_idx per slot]) override — used by
        the sharded path (parallel/sharded.py) to evaluate a row shard.
        cast_dtype: evaluate the functor (and its jacfwd tangents) in this
        dtype — mixed precision runs the Jacobian pass in f32; the caller
        keeps cost/residuals from a separate f64 residual-only pass."""
        if row_arrays is not None:
            data, amb_idxs = row_arrays
            params = [x[ai] for ai in amb_idxs]
        else:
            data = self.const(bk.data_name)
            params = self._bucket_params(bk, x)
        if cast_dtype is not None:
            data = jax.tree_util.tree_map(
                lambda a: a.astype(cast_dtype)
                if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
                else a, data)
            params = [p.astype(cast_dtype) for p in params]
            x = x.astype(cast_dtype)
        fn = bk.residual_fn
        var_slots = [(i, sl) for i, sl in enumerate(bk.slots) if sl.variable]

        if not var_slots:
            # All-constant bucket (possible under include_fixed_blocks,
            # e.g. Problem::Evaluate with a parameter_blocks subset):
            # residuals only, zero tangent columns.
            r = jax.vmap(lambda data, *ps: fn(data, *ps))(data, *params)
            return r, jnp.zeros(r.shape + (0,), dtype=r.dtype)

        if bk.jac_mode == "ad":
            def per_block(data, *ps):
                def g(deltas):
                    plussed = list(ps)
                    for k, (i, sl) in enumerate(var_slots):
                        if sl.manifold is None:
                            plussed[i] = ps[i] + deltas[k]
                        else:
                            plussed[i] = sl.manifold.plus(ps[i], deltas[k])
                    r = fn(data, *plussed)
                    return r, r

                zeros = tuple(
                    jnp.zeros((sl.tangent_size,), dtype=x.dtype)
                    for _, sl in var_slots)
                Js, r = jax.jacfwd(g, has_aux=True)(zeros)
                return r, jnp.concatenate(Js, axis=-1)

            return jax.vmap(per_block)(data, *params)

        # analytic / numeric: ambient Jacobian then PlusJacobian chain rule
        # (residual_block.cc:134-157).
        if bk.jac_mode == "analytic":
            cls = type(bk.cost)

            def jac_fn(data, ps):
                obj = object.__new__(cls)
                object.__setattr__(obj, "__dict__",
                                   dict(data) if isinstance(data, dict)
                                   else {})
                return obj.jacobians(*ps)
        else:  # numdiff
            slot_jfns = {i: bk.cost.jacobian_of(fn, i) for i, _ in var_slots}

            def jac_fn(data, ps):
                return [slot_jfns[i](data, ps) if i in slot_jfns else None
                        for i in range(len(ps))]

        def per_block(data, *ps):
            r = fn(data, *ps)
            Jambs = jac_fn(data, list(ps))
            Jts = []
            for i, sl in var_slots:
                Jamb = jnp.asarray(Jambs[i]).reshape(bk.r, sl.amb_size)
                if sl.manifold is None or isinstance(sl.manifold,
                                                     EuclideanManifold):
                    Jts.append(Jamb)
                else:
                    Jts.append(Jamb @ sl.manifold.plus_jacobian(ps[i]))
            return r, jnp.concatenate(Jts, axis=-1)

        return jax.vmap(per_block)(data, *params)

    # --- public pure functions (jit these) ---

    def cost_fn(self, x):
        """Total cost 0.5 sum_i rho_i(||r_i||^2) + fixed_cost."""
        total = jnp.asarray(self.fixed_cost, dtype=x.dtype)
        for bk in self.buckets:
            r = self._bucket_residuals(bk, x)
            cost, _, _ = correct_residuals_and_jacobian(self._bucket_loss(bk), r, None)
            total = total + jnp.sum(cost)
        return total

    def residuals_fn(self, x, corrected: bool = False) -> RVec:
        parts = []
        for bk in self.buckets:
            r = self._bucket_residuals(bk, x)
            if corrected:
                _, r, _ = correct_residuals_and_jacobian(self._bucket_loss(bk), r, None)
            parts.append(r)
        return RVec(parts)

    def linearize_fn(self, x):
        """(cost, gradient [num_effective], jac BlockJacobian, res RVec).

        res and jac are loss-corrected; gradient = J^T r. One fused XLA
        program per bucket (the reference's EvaluateGradientAndJacobian hot
        path, trust_region_minimizer.cc:244)."""
        total = jnp.asarray(self.fixed_cost, dtype=x.dtype)
        jac_buckets = []
        res_parts = []
        for bk in self.buckets:
            r, J = self._bucket_linearize(bk, x)
            cost, rc, Jc = correct_residuals_and_jacobian(self._bucket_loss(bk), r, J)
            total = total + jnp.sum(cost)
            jac_buckets.append(self._make_bucket_jacobian(bk, Jc))
            res_parts.append(rc)
        jac = BlockJacobian(jac_buckets, self.num_rows, self.num_effective)
        res = RVec(res_parts)
        grad = jac.rmatvec(res)
        return total, grad, jac, res

    def linearize_fn_mixed(self, x):
        """Mixed-precision linearize: (cost f64, gradient f32, jac f32,
        res f32). The Jacobian pass (jacfwd tangent chains) runs in f32;
        cost keeps f64 meaning via a tangent-free f64 residual pass. Same
        contract as linearize_fn otherwise."""
        total = jnp.asarray(self.fixed_cost, dtype=self.dtype)
        jac_buckets = []
        res_parts = []
        for bk in self.buckets:
            loss = self._bucket_loss(bk)
            r64 = self._bucket_residuals(bk, x)
            cost, _, _ = correct_residuals_and_jacobian(loss, r64, None)
            total = total + jnp.sum(cost)
            _, J32 = self._bucket_linearize(bk, x,
                                            cast_dtype=jnp.float32)
            _, rc, Jc = correct_residuals_and_jacobian(
                loss, r64.astype(jnp.float32), J32)
            rc = rc.astype(jnp.float32)
            Jc = Jc.astype(jnp.float32)
            jac_buckets.append(self._make_bucket_jacobian(bk, Jc))
            res_parts.append(rc)
        jac = BlockJacobian(jac_buckets, self.num_rows, self.num_effective)
        res = RVec(res_parts)
        grad = jac.rmatvec(res)
        return total, grad, jac, res

    def _make_bucket_jacobian(self, bk, Jc):
        """BucketJacobian wrapper for a corrected per-bucket J tensor
        (shared by linearize_fn / linearize_fn_mixed)."""
        vslots = [sl for sl in bk.slots if sl.variable]
        cols = tuple(self.const(sl.cols_name) for sl in vslots)
        onehots = tuple(self.const(sl.oh_name)
                        if sl.oh_name is not None else None
                        for sl in vslots)
        gcols = tuple(self.const(f"grp{sl.group_id}.tan_cols")
                      if sl.oh_name is not None else None
                      for sl in vslots)
        sorted_vslot = -1
        if getattr(bk, "sorted_abs_slot", None) is not None:
            vcount = -1
            for si, sl in enumerate(bk.slots):
                if sl.variable:
                    vcount += 1
                if si == bk.sorted_abs_slot:
                    sorted_vslot = vcount if sl.variable else -1
                    break
        tlocals = tuple(self.const(sl.local_name) for sl in vslots)
        tslabs = tuple(
            (int(self.groups[sl.group_id].tan_cols[0, 0]),
             self.groups[sl.group_id].num_blocks,
             self.groups[sl.group_id].tangent_size)
            for sl in vslots)
        return BucketJacobian(Jc, cols, bk.row_offset, onehots, gcols,
                              sorted_slot=sorted_vslot, tlocals=tlocals,
                              tslabs=tslabs)

    # ------------------------------------------------------------------

    def public_evaluate(self, want_residuals, want_gradient, want_jacobian,
                        jacobian_format: str = "dense"):
        """Problem::Evaluate (problem_impl.cc:585). Residuals in insertion
        order; gradient/jacobian in tangent space ordered by parameter-block
        insertion order.

        jacobian_format: "dense" (numpy [rows, cols]) or "csr"
        (scipy.sparse.csr_matrix — the reference returns a CRSMatrix;
        assembled from the block structure without densifying, usable at
        BA scale)."""
        x = self.initial_state()
        if want_gradient or want_jacobian:
            lin = self.cached_jit(
                "public_evaluate.lin",
                lambda: self.jit_with_consts(self.linearize_fn, (x,)))
            cost, grad, jac, res = lin(x)
        else:
            cost_j = self.cached_jit(
                "public_evaluate.cost",
                lambda: self.jit_with_consts(self.cost_fn, (x,)))
            cost = cost_j(x)
            grad, jac = None, None
            # corrected=True: Problem::Evaluate returns loss-corrected
            # ("robustified") residuals, matching ResidualBlock::Evaluate
            # (residual_block.cc applies the Corrector to residuals). When
            # apply_loss=False the program carries no losses and correction
            # is the identity.
            if want_residuals:
                res_j = self.cached_jit(
                    "public_evaluate.res",
                    lambda: self.jit_with_consts(
                        lambda xx: self.residuals_fn(xx, corrected=True),
                        (x,)))
                res = res_j(x)
            else:
                res = None

        residuals_out = None
        if want_residuals:
            # reorder rows back to insertion order
            out = np.zeros(self.num_rows)
            # per-original-block row offsets
            sizes = {}
            for rb in self.problem._residual_records():
                sizes[rb.index] = rb.cost.num_residuals
            order = sorted(sizes)
            offs, o = {}, 0
            for idx in order:
                offs[idx] = o
                o += sizes[idx]
            for bk, part in zip(self.buckets, res.parts):
                ph = np.asarray(part)
                for i, orig in enumerate(bk.orig_indices):
                    out[offs[orig]:offs[orig] + bk.r] = ph[i]
            residuals_out = out

        # Permute tangent-space outputs from the internal grouped-by-size
        # layout back to parameter-block insertion order (the reference's
        # Problem::Evaluate contract, problem_impl.cc:585).
        perm = None
        if want_gradient or want_jacobian:
            order = [b for b in self.problem._param_records()
                     if id(b.array) in self.tan_offset]
            perm = np.concatenate([
                np.arange(self.tan_offset[id(b.array)],
                          self.tan_offset[id(b.array)] + b.tangent_size)
                for b in order]) if order else np.zeros(0, np.int64)

        grad_out = None
        if want_gradient:
            grad_out = np.asarray(grad)[perm]
        jac_out = None
        if want_jacobian:
            # rows to residual-block insertion order (as residuals above)
            sizes = {rb.index: rb.cost.num_residuals
                     for rb in self.problem._residual_records()}
            offs, o = {}, 0
            for idx in sorted(sizes):
                offs[idx] = o
                o += sizes[idx]
            if jacobian_format == "csr":
                import scipy.sparse as sp
                ncols = perm.size
                inv = np.empty(ncols, dtype=np.int64)
                inv[perm] = np.arange(ncols)
                rows_l, cols_l, data_l = [], [], []
                for bk, b in zip(self.buckets, jac.buckets):
                    t = b.J.shape[2]
                    if t == 0:
                        continue
                    Jb = np.asarray(b.J)               # [n, r, t]
                    cpub = inv[np.asarray(b.all_cols)]  # [n, t]
                    starts = np.asarray(
                        [offs[orig] for orig in bk.orig_indices])
                    r = bk.r
                    rows = (starts[:, None, None]
                            + np.arange(r)[None, :, None])
                    rows_l.append(np.broadcast_to(
                        rows, Jb.shape).ravel())
                    cols_l.append(np.broadcast_to(
                        cpub[:, None, :], Jb.shape).ravel())
                    data_l.append(Jb.ravel())
                if rows_l:
                    jac_out = sp.coo_matrix(
                        (np.concatenate(data_l),
                         (np.concatenate(rows_l), np.concatenate(cols_l))),
                        shape=(self.num_rows, ncols)).tocsr()
                else:
                    jac_out = sp.csr_matrix((self.num_rows, ncols))
            else:
                jd = np.asarray(jac.to_dense())[:, perm]
                jac_out = np.zeros_like(jd)
                row = 0
                for bk in self.buckets:
                    for i, orig in enumerate(bk.orig_indices):
                        jac_out[offs[orig]:offs[orig] + bk.r] = \
                            jd[row:row + bk.r]
                        row += bk.r
        return (float(cost),
                residuals_out,
                grad_out,
                jac_out)
