"""Shared micro-benchmark harness (the role of google/benchmark in the
reference's internal/ceres/*_benchmark.cc suites). Each benchmark prints
one JSON line per case: {"name": ..., "time_ms": ..., "platform": ...,
"device_kind": ..., extras...}."""

from __future__ import annotations

import json
import os
import sys
import time


def setup_platform():
    """--cpu flag or CERES_TPU_FORCE_CPU force the host backend; every row
    names the device it ran on. Turns on the persistent compilation
    cache."""
    import jax
    if "--cpu" in sys.argv or os.environ.get("CERES_TPU_FORCE_CPU"):
        jax.config.update("jax_platforms", "cpu")
    from ceres_tpu.config import enable_compilation_cache
    enable_compilation_cache()
    return jax


def bench(name: str, fn, *, warmup: int = 2, iters: int = 10, **extras):
    """Time fn() (expected to block until device completion)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = (time.perf_counter() - t0) / iters
    import jax
    d = jax.devices()[0]
    row = {"name": name, "time_ms": round(dt * 1e3, 4),
           "platform": d.platform, "device_kind": d.device_kind, **extras}
    print(json.dumps(row), flush=True)
    return dt


def block(x):
    """Block on a pytree of device arrays."""
    import jax
    jax.block_until_ready(x)
    return x
