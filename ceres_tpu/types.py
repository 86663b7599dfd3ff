"""Enums and option structs for the solver.

Capability parity with the reference's types.h:51-468 and solver.h:61-815
(Solver::Options ~70 knobs with validation at solver.cc:690). Options are
plain dataclasses validated by `validate()`; every enum has to/from-string
helpers used by the example CLIs (reference types.cc).
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence


class _StrEnum(enum.Enum):
    def __str__(self) -> str:
        return self.name

    @classmethod
    def from_string(cls, s: str):
        try:
            return cls[s.upper()]
        except KeyError:
            raise ValueError(f"Unknown {cls.__name__}: {s!r}. "
                             f"Valid: {[e.name for e in cls]}")


class MinimizerType(_StrEnum):
    TRUST_REGION = enum.auto()
    LINE_SEARCH = enum.auto()


class TrustRegionStrategyType(_StrEnum):
    LEVENBERG_MARQUARDT = enum.auto()
    DOGLEG = enum.auto()


class DoglegType(_StrEnum):
    TRADITIONAL_DOGLEG = enum.auto()
    SUBSPACE_DOGLEG = enum.auto()


class LinearSolverType(_StrEnum):
    """Reference types.h:57-91 (8 types)."""
    DENSE_NORMAL_CHOLESKY = enum.auto()
    DENSE_QR = enum.auto()
    SPARSE_NORMAL_CHOLESKY = enum.auto()
    DENSE_SCHUR = enum.auto()
    SPARSE_SCHUR = enum.auto()
    ITERATIVE_SCHUR = enum.auto()
    CGNR = enum.auto()


class PreconditionerType(_StrEnum):
    IDENTITY = enum.auto()
    JACOBI = enum.auto()
    SCHUR_JACOBI = enum.auto()
    SCHUR_POWER_SERIES_EXPANSION = enum.auto()
    CLUSTER_JACOBI = enum.auto()
    CLUSTER_TRIDIAGONAL = enum.auto()
    SUBSET = enum.auto()


class VisibilityClusteringType(_StrEnum):
    CANONICAL_VIEWS = enum.auto()
    SINGLE_LINKAGE = enum.auto()


class OrderingType(_StrEnum):
    """Reference types.h (linear_solver_ordering_type): fill-reducing
    ordering for the sparse direct factorization. NATURAL = no
    reordering. AMD routes to the native ORDER_AUTO, which runs the
    from-scratch RCM and quotient-graph minimum-degree (the AMD role)
    symbolically and keeps whichever fills less — never worse than plain
    AMD. NESDIS (METIS nested dissection) has no third-party backend
    here and maps to the same AUTO selection."""
    NATURAL = enum.auto()
    AMD = enum.auto()
    NESDIS = enum.auto()


class DumpFormatType(_StrEnum):
    """Reference types.h (trust_region_problem_dump_format_type).
    CONSOLE logs the inner problem; TEXTFILE writes per-iteration files
    (here: one .npz with J, residuals, gradient, x, delta, radius)."""
    CONSOLE = enum.auto()
    TEXTFILE = enum.auto()


class DenseLinearAlgebraLibraryType(_StrEnum):
    """Reference types.h:121-125. Accepted for API parity; every dense
    factorization here runs through XLA on the device (the CUDA role).
    The value is echoed into the summary, nothing else."""
    EIGEN = enum.auto()
    LAPACK = enum.auto()
    CUDA = enum.auto()


class SparseLinearAlgebraLibraryType(_StrEnum):
    """Reference types.h:127-144. Accepted for API parity; the sparse
    direct backend here is the from-scratch native LDL^T
    (native/ceres_native.cpp) with a scipy fallback, regardless of the
    requested library."""
    SUITE_SPARSE = enum.auto()
    EIGEN_SPARSE = enum.auto()
    ACCELERATE_SPARSE = enum.auto()
    CUDA_SPARSE = enum.auto()
    NO_SPARSE = enum.auto()


class LineSearchDirectionType(_StrEnum):
    """Reference types.h:229-307."""
    STEEPEST_DESCENT = enum.auto()
    NONLINEAR_CONJUGATE_GRADIENT = enum.auto()
    LBFGS = enum.auto()
    BFGS = enum.auto()


class NonlinearConjugateGradientType(_StrEnum):
    FLETCHER_REEVES = enum.auto()
    POLAK_RIBIERE = enum.auto()
    HESTENES_STIEFEL = enum.auto()


class LineSearchType(_StrEnum):
    ARMIJO = enum.auto()
    WOLFE = enum.auto()


class LineSearchInterpolationType(_StrEnum):
    BISECTION = enum.auto()
    QUADRATIC = enum.auto()
    CUBIC = enum.auto()


class NumericDiffMethodType(_StrEnum):
    """Reference types.h:446-457."""
    FORWARD = enum.auto()
    CENTRAL = enum.auto()
    RIDDERS = enum.auto()


class CovarianceAlgorithmType(_StrEnum):
    """Reference types.h:465-468."""
    DENSE_SVD = enum.auto()
    SPARSE_QR = enum.auto()


class TerminationType(_StrEnum):
    """Reference types.h:375-430."""
    CONVERGENCE = enum.auto()
    NO_CONVERGENCE = enum.auto()
    FAILURE = enum.auto()
    USER_SUCCESS = enum.auto()
    USER_FAILURE = enum.auto()


class EvaluationCallback:
    """Reference EvaluationCallback (evaluation_callback.h:63): notified
    before each residual/jacobian evaluation so user code can update
    shared state. Attach via Problem::Options.evaluation_callback or
    SolverOptions.evaluation_callback. Duck typing is accepted everywhere;
    this base exists for API parity and documentation."""

    def prepare_for_evaluation(self, evaluate_jacobians: bool,
                               new_evaluation_point: bool):
        raise NotImplementedError


class CallbackReturnType(_StrEnum):
    """Reference types.h:401-415."""
    SOLVER_CONTINUE = enum.auto()
    SOLVER_ABORT = enum.auto()
    SOLVER_TERMINATE_SUCCESSFULLY = enum.auto()


class LinearSolverTerminationType(_StrEnum):
    """Reference linear_solver.h:57."""
    LINEAR_SOLVER_SUCCESS = enum.auto()
    LINEAR_SOLVER_NO_CONVERGENCE = enum.auto()
    LINEAR_SOLVER_FAILURE = enum.auto()
    LINEAR_SOLVER_FATAL_ERROR = enum.auto()


class LoggingType(_StrEnum):
    SILENT = enum.auto()
    PER_MINIMIZER_ITERATION = enum.auto()


class OwnershipType(_StrEnum):
    # Ownership is a no-op in Python (GC), kept for API parity.
    DO_NOT_TAKE_OWNERSHIP = enum.auto()
    TAKE_OWNERSHIP = enum.auto()


@dataclass
class TrustRegionOptions:
    """Subset of Solver::Options consumed by the trust-region minimizer."""
    initial_trust_region_radius: float = 1e4
    max_trust_region_radius: float = 1e16
    min_trust_region_radius: float = 1e-32
    min_relative_decrease: float = 1e-3
    min_lm_diagonal: float = 1e-6
    max_lm_diagonal: float = 1e32
    max_num_consecutive_invalid_steps: int = 5
    use_nonmonotonic_steps: bool = False
    max_consecutive_nonmonotonic_steps: int = 5


@dataclass
class SolverOptions:
    """Mirror of Solver::Options (reference solver.h:61-815).

    Only knobs whose reference behavior exists are listed; validation mirrors
    Solver::Options::IsValid (solver.cc:690).
    """
    # Minimizer choice
    minimizer_type: MinimizerType = MinimizerType.TRUST_REGION
    trust_region_strategy_type: TrustRegionStrategyType = (
        TrustRegionStrategyType.LEVENBERG_MARQUARDT)
    dogleg_type: DoglegType = DoglegType.TRADITIONAL_DOGLEG

    # Line search
    line_search_direction_type: LineSearchDirectionType = (
        LineSearchDirectionType.LBFGS)
    line_search_type: LineSearchType = LineSearchType.WOLFE
    nonlinear_conjugate_gradient_type: NonlinearConjugateGradientType = (
        NonlinearConjugateGradientType.FLETCHER_REEVES)
    max_lbfgs_rank: int = 20
    use_approximate_eigenvalue_bfgs_scaling: bool = False
    line_search_interpolation_type: LineSearchInterpolationType = (
        LineSearchInterpolationType.CUBIC)
    min_line_search_step_size: float = 1e-9
    line_search_sufficient_function_decrease: float = 1e-4
    max_line_search_step_contraction: float = 1e-3
    min_line_search_step_contraction: float = 0.6
    max_num_line_search_step_size_iterations: int = 20
    max_num_line_search_direction_restarts: int = 5
    line_search_sufficient_curvature_decrease: float = 0.9
    max_line_search_step_expansion: float = 10.0

    # Trust region
    initial_trust_region_radius: float = 1e4
    max_trust_region_radius: float = 1e16
    min_trust_region_radius: float = 1e-32
    min_relative_decrease: float = 1e-3
    min_lm_diagonal: float = 1e-6
    max_lm_diagonal: float = 1e32
    max_num_consecutive_invalid_steps: int = 5
    use_nonmonotonic_steps: bool = False
    max_consecutive_nonmonotonic_steps: int = 5
    jacobi_scaling: bool = True

    # Termination
    max_num_iterations: int = 50
    max_solver_time_in_seconds: float = 1e9
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8

    # Linear solver
    linear_solver_type: LinearSolverType = LinearSolverType.DENSE_QR
    preconditioner_type: PreconditionerType = PreconditionerType.JACOBI
    visibility_clustering_type: VisibilityClusteringType = (
        VisibilityClusteringType.CANONICAL_VIEWS)
    use_explicit_schur_complement: bool = False
    use_mixed_precision_solves: bool = False
    max_num_refinement_iterations: int = 0
    min_linear_solver_iterations: int = 0
    max_linear_solver_iterations: int = 500
    use_spse_initialization: bool = False
    max_num_spse_iterations: int = 5
    spse_tolerance: float = 0.1
    eta: float = 1e-1  # forcing-sequence start (linear_solver.h q/eta)
    dynamic_sparsity: bool = False
    # Library selectors (solver.h): accepted for parity, echoed into the
    # summary; dense factorizations run on-device via XLA, the sparse
    # direct backend is the native LDL^T.
    # Fill-reducing ordering for the sparse direct path (reorder_program.cc
    # role; see OrderingType docstring for the native mapping).
    linear_solver_ordering_type: OrderingType = OrderingType.AMD
    dense_linear_algebra_library_type: DenseLinearAlgebraLibraryType = (
        DenseLinearAlgebraLibraryType.EIGEN)
    sparse_linear_algebra_library_type: SparseLinearAlgebraLibraryType = (
        SparseLinearAlgebraLibraryType.SUITE_SPARSE)

    # Ordering (None = automatic; a list of sets = user elimination groups,
    # reference ordered_groups.h)
    linear_solver_ordering: Optional["ParameterBlockOrdering"] = None

    # SUBSET preconditioner rows (reference solver.h
    # residual_blocks_for_subset_preconditioner): collection of
    # ResidualBlockIds whose rows form the preconditioning matrix Q.
    residual_blocks_for_subset_preconditioner: Optional[Any] = None

    # Inner iterations (reference coordinate_descent_minimizer)
    use_inner_iterations: bool = False
    inner_iteration_tolerance: float = 1e-3
    inner_iteration_ordering: Optional["ParameterBlockOrdering"] = None

    # Numeric / evaluation
    num_threads: int = 1              # no-op (XLA threads); API parity
    check_gradients: bool = False
    gradient_check_relative_precision: float = 1e-8
    gradient_check_numeric_derivative_relative_step_size: float = 1e-6
    update_state_every_iteration: bool = False

    # Logging / callbacks
    logging_type: LoggingType = LoggingType.PER_MINIMIZER_ITERATION
    minimizer_progress_to_stdout: bool = False
    callbacks: Sequence[Callable] = field(default_factory=list)
    # EvaluationCallback (evaluation_callback.h:63):
    # prepare_for_evaluation(evaluate_jacobians, new_evaluation_point) is
    # invoked before each device evaluation in the host-loop minimizer.
    evaluation_callback: Optional[Any] = None
    # Trust-region problem dumping (solver.h:724-734): directory to write
    # per-iteration (J, D, rhs, x) npz files, or None.
    trust_region_problem_dump_directory: Optional[str] = None
    # Which iterations to dump (empty = every iteration once a dump
    # directory is set) and in which format (solver.h:706-734).
    trust_region_minimizer_iterations_to_dump: Sequence[int] = field(
        default_factory=tuple)
    trust_region_problem_dump_format_type: DumpFormatType = (
        DumpFormatType.TEXTFILE)

    # Accelerator-specific extensions (no reference analog)
    dtype: Any = None                 # None -> config.default_dtype()
    mesh: Any = None                  # jax.sharding.Mesh for multi-chip solve
    fused_iterations: bool = False    # run whole TR loop in one lax.while_loop
    # Leave the solved state device-resident: Solve() fills the summary
    # from the packed device stats but does NOT download the parameter
    # vector or touch the user's numpy arrays; call
    # summary.write_back() to materialize them. For serving/retry loops
    # the parameter download is pure waste when the next consumer is
    # another device program.
    defer_parameter_writeback: bool = False
    # solve_batched execution mode: "batch" = one vmapped device program
    # (every LM iteration runs the whole batch's linearize/solve as
    # batched contractions, lockstep until the SLOWEST element
    # terminates), "pipeline" = one shared compiled single-solve
    # dispatched asynchronously per element (no lockstep waste; the
    # chip pipelines the K programs back-to-back), "auto" = pick by
    # measured crossover (benchmarks/batch_benchmark.py): batching wins
    # only when a single element leaves the chip mostly idle.
    batch_mode: str = "auto"

    def cache_key(self):
        """Hashable signature of every option that affects compiled
        executables (excludes callbacks/mesh/host-side-only knobs)."""
        parts = []
        for f in dataclasses.fields(self):
            if f.name == "defer_parameter_writeback":
                continue   # host-side result handling; same executable
            v = getattr(self, f.name)
            if f.name == "residual_blocks_for_subset_preconditioner":
                v = (tuple(sorted(rb.index for rb in v))
                     if v is not None else None)
            if isinstance(v, (int, float, bool, str, enum.Enum,
                              tuple)) or v is None:
                parts.append((f.name, v))
        return tuple(parts)

    def validate(self) -> Optional[str]:
        """Returns an error string, or None if valid (solver.cc:690)."""
        positive = [
            "initial_trust_region_radius", "max_trust_region_radius",
            "min_trust_region_radius", "min_relative_decrease",
            "min_lm_diagonal", "max_lm_diagonal",
            "function_tolerance", "gradient_tolerance", "parameter_tolerance",
            "eta", "min_line_search_step_size",
            "line_search_sufficient_function_decrease",
        ]
        for name in positive:
            if getattr(self, name) <= 0:
                return f"{name} must be > 0"
        if self.max_num_iterations < 0:
            return "max_num_iterations must be >= 0"
        if self.batch_mode not in ("auto", "batch", "pipeline"):
            return "batch_mode must be 'auto', 'batch' or 'pipeline'"
        if self.min_trust_region_radius > self.max_trust_region_radius:
            return "min_trust_region_radius > max_trust_region_radius"
        if not (0 < self.max_line_search_step_contraction
                < self.min_line_search_step_contraction < 1):
            return ("need 0 < max_line_search_step_contraction < "
                    "min_line_search_step_contraction < 1")
        if self.minimizer_type == MinimizerType.LINE_SEARCH:
            if not (self.line_search_sufficient_function_decrease
                    < self.line_search_sufficient_curvature_decrease < 1):
                return ("need sufficient_function_decrease < "
                        "sufficient_curvature_decrease < 1")
        if self.max_lbfgs_rank <= 0:
            return "max_lbfgs_rank must be > 0"
        return None


@dataclass
class IterationSummary:
    """Per-iteration trace (reference iteration_callback.h:46)."""
    iteration: int = 0
    step_is_valid: bool = False
    step_is_nonmonotonic: bool = False
    step_is_successful: bool = False
    cost: float = 0.0
    cost_change: float = 0.0
    gradient_max_norm: float = 0.0
    gradient_norm: float = 0.0
    step_norm: float = 0.0
    relative_decrease: float = 0.0
    trust_region_radius: float = 0.0
    eta: float = 0.0
    step_size: float = 0.0
    line_search_function_evaluations: int = 0
    line_search_gradient_evaluations: int = 0
    line_search_iterations: int = 0
    linear_solver_iterations: int = 0
    iteration_time_in_seconds: float = 0.0
    step_solver_time_in_seconds: float = 0.0
    cumulative_time_in_seconds: float = 0.0


@dataclass
class SolverSummary:
    """Mirror of Solver::Summary (reference solver.h:817-…)."""
    termination_type: TerminationType = TerminationType.FAILURE
    message: str = ""
    initial_cost: float = 0.0
    final_cost: float = 0.0
    fixed_cost: float = 0.0
    num_successful_steps: int = 0
    num_unsuccessful_steps: int = 0
    num_inner_iteration_steps: int = 0
    num_line_search_steps: int = 0
    iterations: list = field(default_factory=list)

    num_parameter_blocks: int = 0
    num_parameters: int = 0
    num_effective_parameters: int = 0
    num_residual_blocks: int = 0
    num_residuals: int = 0
    num_parameter_blocks_reduced: int = 0
    num_parameters_reduced: int = 0
    num_effective_parameters_reduced: int = 0
    num_residual_blocks_reduced: int = 0
    num_residuals_reduced: int = 0

    # Is the reduced problem bounds constrained (solver.h:975).
    is_constrained: bool = False
    # Threads are an XLA concern; echoed for parity (solver.h:979).
    num_threads_given: int = 1
    num_threads_used: int = 1
    # Evaluator call counts (solver.h num_residual/jacobian_evaluations).
    # In fused mode these are derived from the device-loop statistics
    # (one jacobian per accepted step + 1, one residual per iteration + 1).
    num_residual_evaluations: int = 0
    num_jacobian_evaluations: int = 0
    # Inner iterations (solver.h inner_iterations_given/used).
    inner_iterations_given: bool = False
    inner_iterations_used: bool = False
    inner_iteration_time_in_seconds: float = 0.0
    # Mixed precision (solver.h:1005).
    mixed_precision_solves_used: bool = False
    # Schur elimination structure "r,e,f" ('d' = ragged/dynamic); XLA
    # shape-specializes every structure, so given == used
    # (solver.h:1024,:1033 — the reference may fall back to <d,d,d>).
    schur_structure_given: str = ""
    schur_structure_used: str = ""
    # Library selectors echoed from the options (solver.h).
    dense_linear_algebra_library_type: DenseLinearAlgebraLibraryType = (
        DenseLinearAlgebraLibraryType.EIGEN)
    sparse_linear_algebra_library_type: SparseLinearAlgebraLibraryType = (
        SparseLinearAlgebraLibraryType.SUITE_SPARSE)
    # Line-search phase times (solver.h). Evaluations here are fused
    # value_and_grad calls: the cost/gradient split is not separable, so
    # the evaluation time is reported under cost_evaluation and the
    # gradient entry stays 0 (documented deviation).
    line_search_cost_evaluation_time_in_seconds: float = 0.0
    line_search_gradient_evaluation_time_in_seconds: float = 0.0
    line_search_polynomial_minimization_time_in_seconds: float = 0.0
    line_search_total_time_in_seconds: float = 0.0

    minimizer_type: MinimizerType = MinimizerType.TRUST_REGION
    trust_region_strategy_type: TrustRegionStrategyType = (
        TrustRegionStrategyType.LEVENBERG_MARQUARDT)
    linear_solver_type_given: LinearSolverType = LinearSolverType.DENSE_QR
    linear_solver_type_used: LinearSolverType = LinearSolverType.DENSE_QR
    preconditioner_type_given: PreconditionerType = PreconditionerType.JACOBI
    preconditioner_type_used: PreconditionerType = PreconditionerType.JACOBI
    line_search_direction_type: LineSearchDirectionType = (
        LineSearchDirectionType.LBFGS)

    preprocessor_time_in_seconds: float = 0.0
    minimizer_time_in_seconds: float = 0.0
    postprocessor_time_in_seconds: float = 0.0
    total_time_in_seconds: float = 0.0
    linear_solver_time_in_seconds: float = 0.0
    residual_evaluation_time_in_seconds: float = 0.0
    jacobian_evaluation_time_in_seconds: float = 0.0
    num_linear_solves: int = 0
    # total inner (CG/PCG) iterations across the solve — the reference's
    # Summary::linear_solver iteration counts rolled up
    num_linear_solver_iterations: int = 0

    # set by the fused minimizer, which has no per-iteration records
    num_iterations_fused: int = 0

    @property
    def num_iterations(self) -> int:
        return len(self.iterations) or self.num_iterations_fused

    def write_back(self):
        """Materialize a deferred solution: download the device-resident
        parameter vector and copy it into the user's numpy arrays. No-op
        when the solve already wrote back (the default) or produced no
        usable solution. Returns self."""
        pending = getattr(self, "_pending_writeback", None)
        if pending is not None:
            program, x = pending
            self._pending_writeback = None
            program.write_back(x)
        return self

    def is_solution_usable(self) -> bool:
        return self.termination_type in (TerminationType.CONVERGENCE,
                                         TerminationType.NO_CONVERGENCE,
                                         TerminationType.USER_SUCCESS)

    def brief_report(self) -> str:
        """Reference solver.cc:839-852."""
        return (f"Ceres-TPU Solver Report: Iterations: {self.num_iterations}, "
                f"Initial cost: {self.initial_cost:e}, "
                f"Final cost: {self.final_cost:e}, "
                f"Termination: {self.termination_type}")

    def full_report(self) -> str:
        lines = ["", "Solver Summary (ceres_tpu)", ""]
        lines.append(f"{'':34}{'Original':>12}{'Reduced':>12}")
        lines.append(f"{'Parameter blocks':<34}{self.num_parameter_blocks:>12}"
                     f"{self.num_parameter_blocks_reduced:>12}")
        lines.append(f"{'Parameters':<34}{self.num_parameters:>12}"
                     f"{self.num_parameters_reduced:>12}")
        lines.append(f"{'Effective parameters':<34}"
                     f"{self.num_effective_parameters:>12}"
                     f"{self.num_effective_parameters_reduced:>12}")
        lines.append(f"{'Residual blocks':<34}{self.num_residual_blocks:>12}"
                     f"{self.num_residual_blocks_reduced:>12}")
        lines.append(f"{'Residuals':<34}{self.num_residuals:>12}"
                     f"{self.num_residuals_reduced:>12}")
        lines.append("")
        lines.append(f"Minimizer                 {self.minimizer_type}")
        if self.minimizer_type == MinimizerType.TRUST_REGION:
            lines.append(f"Trust region strategy     "
                         f"{self.trust_region_strategy_type}")
            lines.append(f"Linear solver             "
                         f"given: {self.linear_solver_type_given}, "
                         f"used: {self.linear_solver_type_used}")
            lines.append(f"Preconditioner            "
                         f"given: {self.preconditioner_type_given}, "
                         f"used: {self.preconditioner_type_used}")
        else:
            lines.append(f"Line search direction     "
                         f"{self.line_search_direction_type}")
        lines.append("")
        lines.append(f"Initial cost              {self.initial_cost:e}")
        lines.append(f"Final cost                {self.final_cost:e}")
        lines.append(f"Termination               {self.termination_type} "
                     f"({self.message})")
        lines.append("")
        lines.append(f"Successful steps          {self.num_successful_steps}")
        lines.append(f"Unsuccessful steps        {self.num_unsuccessful_steps}")
        lines.append("")
        lines.append(f"Time (in seconds):")
        lines.append(f"  Preprocessor            "
                     f"{self.preprocessor_time_in_seconds:.6f}")
        lines.append(f"  Minimizer               "
                     f"{self.minimizer_time_in_seconds:.6f}")
        lines.append(f"    Residual evaluation   "
                     f"{self.residual_evaluation_time_in_seconds:.6f}")
        lines.append(f"    Jacobian evaluation   "
                     f"{self.jacobian_evaluation_time_in_seconds:.6f}")
        lines.append(f"    Linear solver         "
                     f"{self.linear_solver_time_in_seconds:.6f}")
        lines.append(f"  Total                   "
                     f"{self.total_time_in_seconds:.6f}")
        return "\n".join(lines)


class ParameterBlockOrdering:
    """Ordered partition of parameter blocks into elimination groups
    (reference ordered_groups.h:55). Elements are the numpy parameter-block
    arrays (keyed by identity, as the reference keys on double*)."""

    @staticmethod
    def _key(element):
        # numpy arrays are unhashable; identity is the block's key.
        return id(element) if hasattr(element, "__array__") else element

    def __init__(self):
        self._group_of = {}     # key -> group id
        self._groups = {}       # group id -> dict key -> element

    def add_element_to_group(self, element, group: int):
        k = self._key(element)
        old = self._group_of.get(k)
        if old is not None:
            self._groups[old].pop(k, None)
            if not self._groups[old]:
                del self._groups[old]
        self._group_of[k] = group
        self._groups.setdefault(group, {})[k] = element

    def remove(self, element) -> bool:
        k = self._key(element)
        g = self._group_of.pop(k, None)
        if g is None:
            return False
        self._groups[g].pop(k, None)
        if not self._groups[g]:
            del self._groups[g]
        return True

    def group_id(self, element) -> int:
        k = self._key(element)
        if k not in self._group_of:
            raise KeyError(element)
        return self._group_of[k]

    def is_member(self, element) -> bool:
        return self._key(element) in self._group_of

    def group_elements(self, group: int):
        return list(self._groups.get(group, {}).values())

    def group_element_keys(self, group: int):
        return set(self._groups.get(group, {}).keys())

    @property
    def num_elements(self) -> int:
        return len(self._group_of)

    def group_id_of_key(self, key):
        return self._group_of.get(key)

    @property
    def num_groups(self) -> int:
        return len(self._groups)

    def min_non_zero_group(self) -> int:
        if not self._groups:
            raise ValueError("empty ordering")
        return min(self._groups)

    def group_sizes(self):
        return {g: len(s) for g, s in self._groups.items()}

    def groups_sorted(self):
        return sorted(self._groups)
