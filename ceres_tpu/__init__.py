"""ceres_tpu: an accelerator-native nonlinear least-squares and general
minimization framework (JAX/XLA), with the capabilities of Ceres Solver
2.2.0.

Built from scratch for the accelerator: residual blocks evaluate as vmapped XLA
batches, Jacobians via jax.jacfwd composed with manifold retractions,
trust-region / line-search outer loops drive jitted linearize+solve steps,
and bundle-adjustment Schur elimination runs as batched segmented
reductions. See SURVEY.md at the repo root for the reference layer map.
"""

from . import config  # noqa: F401  (enables x64 on import)

from .types import (  # noqa: F401
    CallbackReturnType, CovarianceAlgorithmType,
    DenseLinearAlgebraLibraryType, DoglegType, DumpFormatType,
    EvaluationCallback,
    IterationSummary, LineSearchDirectionType, LineSearchInterpolationType,
    LineSearchType, LinearSolverType, LoggingType, MinimizerType,
    NonlinearConjugateGradientType, NumericDiffMethodType, OrderingType,
    ParameterBlockOrdering, PreconditionerType, SolverOptions, SolverSummary,
    SparseLinearAlgebraLibraryType,
    TerminationType, TrustRegionStrategyType, VisibilityClusteringType,
)
from .loss import (  # noqa: F401
    ArctanLoss, CauchyLoss, ComposedLoss, HuberLoss, LossFunction,
    LossFunctionWrapper, ScaledLoss, SoftLOneLoss, TolerantLoss, TrivialLoss,
    TukeyLoss,
)
from .manifolds import (  # noqa: F401
    AutoDiffManifold, EigenQuaternionManifold, EuclideanManifold,
    LineManifold, Manifold, ProductManifold, QuaternionManifold,
    SphereManifold, SubsetManifold,
)
from .cost import (  # noqa: F401
    AutoDiffCostFunction, ConditionedCostFunction, CostFunction,
    CostFunctionToFunctor, DynamicAutoDiffCostFunction,
    DynamicCostFunctionToFunctor,
    DynamicNumericDiffCostFunction, NormalPrior, NumericDiffCostFunction,
    NumericDiffOptions, SizedCostFunction,
)
from .problem import Problem, ProblemOptions, ResidualBlockId  # noqa: F401
from .solver import Solver, solve  # noqa: F401
from .batch import solve_batched  # noqa: F401
from .covariance import Covariance, CovarianceOptions  # noqa: F401
from .gradient_checker import GradientChecker  # noqa: F401
from .gradient_problem import (  # noqa: F401
    AutoDiffFirstOrderFunction, FirstOrderFunction, GradientProblem,
    GradientProblemSolver, NumericDiffFirstOrderFunction,
    solve_gradient_problem,
)
from .interpolation import (  # noqa: F401
    BiCubicInterpolator, CubicInterpolator, Grid1D, Grid2D,
)
from .tiny_solver import (  # noqa: F401
    TinySolver, TinySolverOptions, TinySolverResult, tiny_solve,
)
from . import rotation  # noqa: F401

__version__ = "0.1.0"
