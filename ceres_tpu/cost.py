"""Cost functions: the user-facing residual definitions.

Capability parity with the reference's cost-function surface:
CostFunction base (include/ceres/cost_function.h:64), SizedCostFunction
(sized_cost_function.h:50), AutoDiffCostFunction
(autodiff_cost_function.h:156 + internal/autodiff.h:307 Jet machinery),
NumericDiffCostFunction (numeric_diff_cost_function.h:181,
internal/numeric_diff.h:61, FORWARD/CENTRAL/RIDDERS types.h:446-457),
DynamicAutoDiffCostFunction / DynamicNumericDiffCostFunction
(dynamic_*_cost_function.h), CostFunctionToFunctor
(cost_function_to_functor.h:104), ConditionedCostFunction
(conditioned_cost_function.h:74), NormalPrior (normal_prior.h:60).

Design: there is no Jet type — `jax.jacfwd` over the traced functor
*is* forward-mode dual-number AD, batched with vmap over all residual blocks
sharing a functor. A functor is either
  * a plain function `f(*param_arrays) -> residual_array`, or
  * an instance of a class whose `__call__(self, *param_arrays)` is
    jnp-traceable; instance attributes (observations etc.) are treated as
    per-residual-block data, stacked across the bucket and vmapped over.
All functors must be pure and traceable (no Python branches on array values).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .types import NumericDiffMethodType


class NumericDiffOptions:
    """Reference numeric_diff_options.h."""

    def __init__(self,
                 relative_step_size: float = 1e-6,
                 ridders_relative_initial_step_size: float = 1e-2,
                 max_num_ridders_extrapolations: int = 10,
                 ridders_epsilon: float = 1e-12,
                 ridders_step_shrink_factor: float = 2.0):
        self.relative_step_size = relative_step_size
        self.ridders_relative_initial_step_size = (
            ridders_relative_initial_step_size)
        self.max_num_ridders_extrapolations = max_num_ridders_extrapolations
        self.ridders_epsilon = ridders_epsilon
        self.ridders_step_shrink_factor = ridders_step_shrink_factor


def _functor_parts(functor):
    """Split a functor into (static code key, callable-from-data, data pytree).

    For a plain function: data is an empty tuple. For a class instance: data
    is the instance `__dict__` (stacked across the bucket by the evaluator),
    and the call rebuilds a lightweight instance per vmap lane.
    """
    import types as _types

    if isinstance(functor, type):
        raise TypeError("pass an instance or function, not a class")
    if isinstance(functor, (_types.FunctionType, _types.BuiltinFunctionType,
                            _types.MethodType, _types.LambdaType)):
        return functor, (lambda data, *params: functor(*params)), ()
    if callable(functor):
        cls = type(functor)
        data = dict(vars(functor)) if hasattr(functor, "__dict__") else {}

        def call(data_dict, *params):
            obj = object.__new__(cls)
            object.__setattr__(obj, "__dict__", dict(data_dict))
            return obj(*params)

        return cls, call, data
    raise TypeError(f"functor {functor!r} is not callable")


class CostFunction:
    """Base cost function (reference cost_function.h:64).

    Subclasses define `parameter_block_sizes`, `num_residuals`, and a
    traceable `residuals(*params)`; the solver differentiates with jacfwd.
    Override `residuals_and_jacobians` to supply analytic Jacobians
    (the SizedCostFunction + user-Evaluate path of the reference).
    """

    def __init__(self, num_residuals: int,
                 parameter_block_sizes: Sequence[int]):
        self._num_residuals = int(num_residuals)
        self._parameter_block_sizes = [int(s) for s in parameter_block_sizes]

    @property
    def num_residuals(self) -> int:
        return self._num_residuals

    @property
    def parameter_block_sizes(self) -> Sequence[int]:
        return list(self._parameter_block_sizes)

    # --- bucketing interface used by the evaluator ---
    def bucket_key(self):
        """Residual blocks with equal keys are evaluated in one vmap batch."""
        return (type(self), self._num_residuals,
                tuple(self._parameter_block_sizes))

    def block_data(self):
        """Per-residual-block data pytree, stacked across the bucket."""
        return ()

    def make_residual_fn(self) -> Callable:
        """Returns f(data, *params) -> residuals, traceable, unbatched."""
        raise NotImplementedError

    def make_residual_and_jacobian_fn(self) -> Optional[Callable]:
        """If not None: f(data, params_tuple, plus_fns) handled by evaluator.
        None means the evaluator differentiates make_residual_fn."""
        return None

    # --- convenience single-block evaluation (Problem::Evaluate path) ---
    def evaluate(self, params):
        fn = self.make_residual_fn()
        return fn(self.block_data(), *[jnp.asarray(p) for p in params])


class AutoDiffCostFunction(CostFunction):
    """Forward-mode AD cost (reference autodiff_cost_function.h:156).

    ceres:  AutoDiffCostFunction<Functor, kNumResiduals, N0, N1...>
    here:   AutoDiffCostFunction(functor, num_residuals, [n0, n1, ...])
    """

    def __init__(self, functor, num_residuals: int,
                 parameter_block_sizes: Sequence[int]):
        super().__init__(num_residuals, parameter_block_sizes)
        self._functor = functor
        self._code_key, self._call, self._data = _functor_parts(functor)

    @property
    def functor(self):
        return self._functor

    def bucket_key(self):
        return ("autodiff", self._code_key, self._num_residuals,
                tuple(self._parameter_block_sizes))

    def block_data(self):
        return self._data

    def make_residual_fn(self):
        call = self._call
        nr = self._num_residuals

        def fn(data, *params):
            r = jnp.asarray(call(data, *params))
            return r.reshape((nr,))

        return fn


class SizedCostFunction(CostFunction):
    """Analytic-derivative base (reference sized_cost_function.h:50).

    Users subclass and implement `residuals(*params)` (traceable; jacfwd used)
    or both `residuals` and `jacobians(*params) -> [J_0, ...]` for fully
    analytic evaluation.
    """

    def bucket_key(self):
        return ("sized", type(self), self._num_residuals,
                tuple(self._parameter_block_sizes))

    def residuals(self, *params):
        raise NotImplementedError

    def jacobians(self, *params):
        return None

    def block_data(self):
        return dict(vars(self))

    def make_residual_fn(self):
        cls = type(self)
        nr = self._num_residuals

        def fn(data, *params):
            obj = object.__new__(cls)
            object.__setattr__(obj, "__dict__", dict(data))
            return jnp.asarray(obj.residuals(*params)).reshape((nr,))

        return fn


class NumericDiffCostFunction(CostFunction):
    """Finite-difference cost (reference numeric_diff_cost_function.h:181).

    method: FORWARD | CENTRAL | RIDDERS (types.h:446-457). The derivative
    engine (internal/numeric_diff.h:61) is re-expressed as batched, vmapped
    perturbation stencils — all probe evaluations for one parameter block run
    as a single batched call on the device.
    """

    def __init__(self, functor, method=NumericDiffMethodType.CENTRAL,
                 num_residuals: int = 1,
                 parameter_block_sizes: Sequence[int] = (),
                 options: Optional[NumericDiffOptions] = None):
        super().__init__(num_residuals, parameter_block_sizes)
        self._functor = functor
        self._method = method
        self._options = options or NumericDiffOptions()
        self._code_key, self._call, self._data = _functor_parts(functor)

    def bucket_key(self):
        return ("numdiff", self._code_key, self._method, self._num_residuals,
                tuple(self._parameter_block_sizes))

    def block_data(self):
        return self._data

    def make_residual_fn(self):
        call = self._call
        nr = self._num_residuals

        def fn(data, *params):
            return jnp.asarray(call(data, *params)).reshape((nr,))

        return fn

    def jacobian_of(self, residual_fn, slot: int):
        """Finite-difference Jacobian wrt parameter slot `slot`:
        returns jfn(data, params) -> [num_residuals, size_slot]."""
        opts = self._options
        method = self._method

        def jfn(data, params):
            x = params[slot]
            size = x.shape[0]
            # Per-coordinate step (numeric_diff.h: relative step, min-clamped)
            step = opts.relative_step_size * jnp.maximum(jnp.abs(x), 1.0) \
                if method != NumericDiffMethodType.RIDDERS else \
                opts.ridders_relative_initial_step_size * jnp.maximum(
                    jnp.abs(x), 1.0)

            def eval_at(xs):
                ps = list(params)
                ps[slot] = xs
                return residual_fn(data, *ps)

            eye = jnp.eye(size, dtype=x.dtype)

            if method == NumericDiffMethodType.FORWARD:
                f0 = eval_at(x)
                probes = jax.vmap(lambda e, h: eval_at(x + h * e))(eye, step)
                return ((probes - f0[None, :]) / step[:, None]).T
            if method == NumericDiffMethodType.CENTRAL:
                fp = jax.vmap(lambda e, h: eval_at(x + h * e))(eye, step)
                fm = jax.vmap(lambda e, h: eval_at(x - h * e))(eye, step)
                return ((fp - fm) / (2.0 * step[:, None])).T
            # RIDDERS: Richardson extrapolation of central differences over a
            # geometrically shrinking step (numeric_diff.h:EvaluateRiddersJacobianColumn),
            # vectorized: fixed max table depth, best-error entry selected per
            # output element (no data-dependent early exit under jit).
            T = opts.max_num_ridders_extrapolations
            shrink = opts.ridders_step_shrink_factor

            def central(h):
                fp = jax.vmap(lambda e, hh: eval_at(x + hh * e))(eye, h)
                fm = jax.vmap(lambda e, hh: eval_at(x - hh * e))(eye, h)
                return (fp - fm) / (2.0 * h[:, None])  # [size, nr]

            # Build Neville tableau.
            steps = [step / (shrink ** t) for t in range(T)]
            col = [central(h) for h in steps]  # A[t][0]
            best = col[0]
            best_err = jnp.full_like(best, jnp.inf)
            prev_row = [col[0]]
            for t in range(1, T):
                row = [col[t]]
                fac = shrink ** 2
                for m in range(1, t + 1):
                    new = (row[m - 1] * fac - prev_row[m - 1]) / (fac - 1.0)
                    fac *= shrink ** 2
                    err = jnp.maximum(jnp.abs(new - row[m - 1]),
                                      jnp.abs(new - prev_row[m - 1]))
                    better = err < best_err
                    best = jnp.where(better, new, best)
                    best_err = jnp.where(better, err, best_err)
                    row.append(new)
                prev_row = row
            return best.T  # [nr, size]

        return jfn


class DynamicAutoDiffCostFunction(AutoDiffCostFunction):
    """Runtime-sized AD cost (reference dynamic_autodiff_cost_function.h:80).

    The functor receives a list of parameter arrays. Sizes are fixed when
    blocks are added (XLA static shapes), so this is API-level parity: sizes
    chosen at runtime, not compile time.
    """

    def __init__(self, functor):
        self._functor = functor
        self._code_key, self._call, self._data = _functor_parts(functor)
        self._num_residuals = -1
        self._parameter_block_sizes = []

    def add_parameter_block(self, size: int):
        self._parameter_block_sizes.append(int(size))

    def set_num_residuals(self, n: int):
        self._num_residuals = int(n)

    def bucket_key(self):
        return ("dyn_autodiff", self._code_key, self._num_residuals,
                tuple(self._parameter_block_sizes))

    def make_residual_fn(self):
        call = self._call
        nr = self._num_residuals

        def fn(data, *params):
            return jnp.asarray(call(data, list(params))).reshape((nr,))

        return fn


class DynamicNumericDiffCostFunction(NumericDiffCostFunction):
    """Reference dynamic_numeric_diff_cost_function.h."""

    def __init__(self, functor, method=NumericDiffMethodType.CENTRAL,
                 options: Optional[NumericDiffOptions] = None):
        self._functor = functor
        self._method = method
        self._options = options or NumericDiffOptions()
        self._code_key, self._call, self._data = _functor_parts(functor)
        self._num_residuals = -1
        self._parameter_block_sizes = []

    def add_parameter_block(self, size: int):
        self._parameter_block_sizes.append(int(size))

    def set_num_residuals(self, n: int):
        self._num_residuals = int(n)

    def bucket_key(self):
        return ("dyn_numdiff", self._code_key, self._method,
                self._num_residuals, tuple(self._parameter_block_sizes))

    def make_residual_fn(self):
        call = self._call
        nr = self._num_residuals

        def fn(data, *params):
            return jnp.asarray(call(data, list(params))).reshape((nr,))

        return fn


class CostFunctionToFunctor:
    """Wrap a CostFunction back into a functor so analytic and AD costs mix
    (reference cost_function_to_functor.h:104). In JAX everything is already
    a traceable function, so this simply calls through."""

    def __init__(self, cost_function: CostFunction):
        self._cost = cost_function
        self._fn = cost_function.make_residual_fn()
        self._data = cost_function.block_data()

    def __call__(self, *params):
        return self._fn(self._data, *params)


class DynamicCostFunctionToFunctor(CostFunctionToFunctor):
    """Wrap a dynamically-sized CostFunction into a functor (reference
    dynamic_cost_function_to_functor.h:46). Called with a list/tuple of
    parameter arrays, mirroring the dynamic functor convention
    (T const* const* parameters)."""

    def __call__(self, params):
        return self._fn(self._data, *params)


class ConditionedCostFunction(CostFunction):
    """Apply per-residual conditioner cost functions
    (reference conditioned_cost_function.h:74): out_i = c_i(r_i)."""

    def __init__(self, wrapped: CostFunction, conditioners):
        super().__init__(wrapped.num_residuals,
                         wrapped.parameter_block_sizes)
        if len(conditioners) != wrapped.num_residuals:
            raise ValueError("need one conditioner per residual")
        self._wrapped = wrapped
        self._conditioners = list(conditioners)

    def bucket_key(self):
        return ("conditioned", self._wrapped.bucket_key(),
                tuple(id(c) for c in self._conditioners))

    def block_data(self):
        return self._wrapped.block_data()

    def make_residual_fn(self):
        inner = self._wrapped.make_residual_fn()
        conds = self._conditioners

        def fn(data, *params):
            r = inner(data, *params)
            outs = []
            for i, c in enumerate(conds):
                if c is None:
                    outs.append(r[i])
                else:
                    ci = c.make_residual_fn() if isinstance(c, CostFunction) \
                        else (lambda d, v, _c=c: _c(v))
                    val = ci(c.block_data() if isinstance(c, CostFunction)
                             else (), r[i:i + 1])
                    outs.append(jnp.reshape(val, ()))
            return jnp.stack(outs)

        return fn


class NormalPrior(CostFunction):
    """r = A (x - b), Gaussian prior (reference normal_prior.h:60)."""

    def __init__(self, A, b):
        A = np.asarray(A, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        if A.ndim != 2 or b.ndim != 1 or A.shape[1] != b.shape[0]:
            raise ValueError("A must be [r, n], b must be [n]")
        super().__init__(A.shape[0], [b.shape[0]])
        self.A = A
        self.b = b

    def bucket_key(self):
        return ("normal_prior", self.A.shape)

    def block_data(self):
        return {"A": self.A, "b": self.b}

    def make_residual_fn(self):
        def fn(data, x):
            return data["A"] @ (x - data["b"])

        return fn
