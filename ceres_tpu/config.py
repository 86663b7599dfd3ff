"""Global numeric configuration for ceres_tpu.

Ceres semantics are float64 (the reference is Eigen/double throughout).
The performance-critical paths (batched Jacobian products, Schur
elimination, CG iterations) optionally run in f32 with f64 cost evaluation
(mixed precision, see solver options `use_mixed_precision_solves`,
reference solver.h:572-589).

x64 is enabled at import unless CERES_TPU_NO_X64 is set.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

if not os.environ.get("CERES_TPU_NO_X64"):
    jax.config.update("jax_enable_x64", True)

# Escape hatch for embedded/subprocess use (the C API shim, CI without an
# accelerator): force the host CPU backend before any computation runs.
if os.environ.get("CERES_TPU_FORCE_CPU"):
    jax.config.update("jax_platforms", "cpu")


# Fixed location of the persistent XLA compilation cache when
# JAX_COMPILATION_CACHE_DIR is not set: the cache key includes the path, so
# a directory that moves never hits. Listed in .gitignore.
DEFAULT_COMPILATION_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache for a driver script.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
    is set here. Otherwise the cache goes to DEFAULT_COMPILATION_CACHE_DIR
    (<repo>/.jax_cache). Returns the directory in use."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir",
                      DEFAULT_COMPILATION_CACHE_DIR)
    return DEFAULT_COMPILATION_CACHE_DIR


def default_dtype():
    """Solver state dtype: f64 when x64 is enabled, else f32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def machine_epsilon(dtype=None):
    return float(jnp.finfo(dtype or default_dtype()).eps)
