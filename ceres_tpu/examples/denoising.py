"""Fields-of-Experts image denoising (reference examples/denoising.cc +
fields_of_experts.{h,cc}).

Model: minimize sum_p ((x_p - n_p)/sigma)^2-style data terms plus, for every
filter i and every patch position, a linear filter response F_i . X under
the FieldsOfExpertsLoss rho(s) = alpha_i log(1 + s/2) — a large sparse grid
problem, the reference's CGNR workload (BASELINE config 4).

Deviation from the reference's build: the reference adds one
1-pixel parameter block per pixel and d*d-block residuals; here the patch
pixels are still separate 1-d parameter blocks (identical solver structure/
sparsity), and all patch positions for one filter form a single vmapped
bucket.
"""

from __future__ import annotations

import numpy as np

import ceres_tpu as ct


class FieldsOfExperts:
    """Loader for the .foe filter files (fields_of_experts.cc LoadFromFile).
    Format: 'size num_filters', x-coords, y-coords, alphas, then one row of
    size*size coefficients per filter."""

    def __init__(self, path: str):
        with open(path) as f:
            vals = f.read().split()
        it = iter(vals)
        self.size = int(next(it))
        self.num_filters = int(next(it))
        n = self.size * self.size
        self.x = [int(float(next(it))) for _ in range(n)]
        self.y = [int(float(next(it))) for _ in range(n)]
        self.alpha = [float(next(it)) for _ in range(self.num_filters)]
        self.filters = [
            np.asarray([float(next(it)) for _ in range(n)])
            for _ in range(self.num_filters)]

    @property
    def num_variables(self):
        return self.size * self.size


class FoECost(ct.SizedCostFunction):
    """Linear filter response over a patch of 1-pixel parameter blocks
    (fields_of_experts.h:60 FieldsOfExpertsCost). The residual is LINEAR
    in the pixels, so analytic Jacobians (= the filter coefficients) avoid
    the 25-tangent jacfwd entirely — at full-image scale the AD
    intermediates alone are ~4 GB."""

    def __init__(self, coefficients):
        coefficients = np.asarray(coefficients)
        super().__init__(1, [1] * coefficients.size)
        self.coefficients = coefficients

    def residuals(self, *pixels):
        import jax.numpy as jnp
        patch = jnp.stack([p[0] for p in pixels])
        return jnp.dot(self.coefficients, patch)[None]

    def jacobians(self, *pixels):
        import jax.numpy as jnp
        return [jnp.reshape(self.coefficients[k], (1, 1))
                for k in range(len(pixels))]


class FieldsOfExpertsLoss(ct.LossFunction):
    """rho(s) = alpha log(1 + s/2) (fields_of_experts.h:75)."""

    def __init__(self, alpha: float):
        self.alpha = float(alpha)

    def evaluate(self, s):
        import jax.numpy as jnp
        half = 0.5 * s
        return (self.alpha * jnp.log1p(half),
                self.alpha * 0.5 / (1.0 + half),
                self.alpha * (-0.25) / (1.0 + half) ** 2)


class QuadraticCostFunction:
    """a * (x - b) data term (denoising.cc QuadraticCostFunction)."""

    def __init__(self, a: float, b: float):
        self.a = a
        self.b = b

    def __call__(self, x):
        return self.a * (x - self.b)


def build_denoising_problem(noisy_image: np.ndarray, foe: FieldsOfExperts,
                            sigma: float = 20.0):
    """denoising.cc CreateProblem. Returns (problem, pixels [h,w] list of
    1-element arrays)."""
    h, w = noisy_image.shape
    pixels = [[np.asarray([noisy_image[r, c]]) for c in range(w)]
              for r in range(h)]
    problem = ct.Problem()

    # data terms: (x - n)/sigma with the reference's scaling
    a = 1.0 / sigma
    for r in range(h):
        for c in range(w):
            problem.add_residual_block(
                ct.AutoDiffCostFunction(
                    QuadraticCostFunction(a, noisy_image[r, c]), 1, [1]),
                None, pixels[r][c])

    # FoE terms: one per (filter, patch position)
    size = foe.size
    for i in range(foe.num_filters):
        cost_coeffs = foe.filters[i]
        loss = FieldsOfExpertsLoss(foe.alpha[i])
        for r in range(h - size + 1):
            for c in range(w - size + 1):
                blocks = [pixels[r + foe.y[k]][c + foe.x[k]]
                          for k in range(foe.num_variables)]
                problem.add_residual_block(FoECost(cost_coeffs), loss,
                                           *blocks)
    return problem, pixels


def pixels_to_image(pixels):
    return np.asarray([[p[0] for p in row] for row in pixels])
