"""Ellipse approximation by a piecewise-linear closed contour
(reference examples/ellipse_approximation.cc — the dynamic_sparsity demo).

Each data point y_i gets a preimage parameter t_i on the contour; the
residual y_i - ((1-u) X[i0] + u X[i1]) structurally touches the whole
contour X but dynamically only two control points. The reference handles
this with dynamic_sparsity=true re-analysis of the Jacobian each iteration
(PointToLineSegmentContourCostFunction, ellipse_approximation.cc). This
design instead keeps X as ONE parameter block and gathers the
two active control points with traced indices inside the cost — runtime
sparsity without any host-side sparsity re-analysis, solved matrix-free
(CGNR) or densely. `dynamic_sparsity=True` is accepted for API parity.

Data: noisy samples of an ellipse (the reference embeds a 212-point cloud
of the same shape).

CLI: python -m ceres_tpu.examples.ellipse_approximation [--num_segments N]
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


class PointToContourCost:
    """residuals (2,): data point minus its linear interpolation on the
    closed contour; params: t (1,), contour X flattened (num_segments*2,).
    The segment count is derived from the block shape (static under jit);
    the active segment indices are traced gathers."""

    def __init__(self, y0: float, y1: float):
        self.y0 = y0
        self.y1 = y1

    def __call__(self, t, X):
        X2 = X.reshape((-1, 2))
        n = X2.shape[0]
        tm = t[0] - n * jnp.floor(t[0] / n)  # modulo n, stays in [0, n)
        i0 = jnp.floor(tm).astype(jnp.int32)
        i1 = jnp.mod(i0 + 1, n)
        u = tm - i0
        p = (1.0 - u) * X2[i0] + u * X2[i1]
        return jnp.stack([self.y0, self.y1]) - p


class EuclideanDistanceCost:
    """sqrt_weight * (X[i] - X[j]): contour smoothness regularizer
    (ellipse_approximation.cc EuclideanDistanceFunctor), over the single
    contour block; i, j ride the bucket as per-lane data (traced gathers)."""

    def __init__(self, i: int, j: int, sqrt_weight: float):
        self.i = i
        self.j = j
        self.sqrt_weight = sqrt_weight

    def __call__(self, X):
        X2 = X.reshape((-1, 2))
        return self.sqrt_weight * (X2[self.i] - X2[self.j])


def synthesize_ellipse_points(n=212, a=4.0, b=1.4, noise=0.02, seed=3):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.0, 2.0 * np.pi, size=n)
    pts = np.stack([a * np.cos(theta), b * np.sin(theta)], axis=1)
    return pts + rng.normal(0.0, noise, size=pts.shape)


def solve_ellipse(points: np.ndarray, num_segments: int = 151,
                  regularization_weight: float = 1e-2,
                  dynamic_sparsity: bool = True, max_iterations: int = 100):
    import ceres_tpu as ct
    from ceres_tpu.cost import AutoDiffCostFunction

    # Initialize the contour on the unit circle (reference main()).
    w = np.linspace(0.0, 2.0 * np.pi, num_segments + 1)[:-1]
    X = np.stack([np.cos(w), np.sin(w)], axis=1).reshape(-1)

    # Initialize each point's preimage to the nearest contour vertex.
    X2 = X.reshape(num_segments, 2)
    d = ((points[:, None, :] - X2[None, :, :]) ** 2).sum(-1)
    t_init = np.argmin(d, axis=1).astype(np.float64)

    problem = ct.Problem()
    t_blocks = [np.array([ti]) for ti in t_init]
    for i, (y0, y1) in enumerate(points):
        cost = AutoDiffCostFunction(
            PointToContourCost(float(y0), float(y1)),
            2, [1, num_segments * 2])
        problem.add_residual_block(cost, None, t_blocks[i], X)
    sw = np.sqrt(regularization_weight)
    for i in range(num_segments):
        cost = AutoDiffCostFunction(
            EuclideanDistanceCost(i, (i + 1) % num_segments, float(sw)),
            2, [num_segments * 2])
        problem.add_residual_block(cost, None, X)

    options = ct.SolverOptions(
        max_num_iterations=max_iterations,
        linear_solver_type=ct.LinearSolverType.CGNR,
        dynamic_sparsity=dynamic_sparsity,
        function_tolerance=1e-10)
    summary = ct.solve(options, problem)
    return X.reshape(num_segments, 2), t_blocks, summary


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--num_segments", type=int, default=151)
    ap.add_argument("--num_points", type=int, default=212)
    args = ap.parse_args(argv)

    points = synthesize_ellipse_points(args.num_points)
    X, t, summary = solve_ellipse(points, args.num_segments)
    print(summary.brief_report())
    # Report mean distance of data points to the fitted contour vertices.
    d = np.sqrt(((points[:, None, :] - X[None, :, :]) ** 2).sum(-1)
                ).min(axis=1)
    print(f"mean point-to-contour-vertex distance: {d.mean():.4f}")


if __name__ == "__main__":
    main()
