"""Driver-script plumbing that runs on the CPU: chip_smoke.py refusing a
machine without a GPU, the compilation-cache helper, and the trace
reduction's interval arithmetic."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_require_gpu_refuses_cpu():
    from ceres_tpu.utils.device import NoGPUError, require_gpu
    with pytest.raises(NoGPUError):
        require_gpu()


def test_chip_smoke_device_phase_refuses_cpu(capsys):
    sys.path.insert(0, REPO)
    import chip_smoke
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_script_fails_without_gpu(tmp_path, where):
    """Run as the driver runs it: from the repo root, and from a directory
    that holds chip_smoke.py and nothing else of the repo."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_compilation_cache_uses_env_dir(monkeypatch, tmp_path):
    from ceres_tpu import config
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compilation_cache_defaults_to_repo_dir(monkeypatch):
    from ceres_tpu import config
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        d = config.enable_compilation_cache()
        assert d == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == d
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("intervals,expect", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (5, 15)], 15),          # overlap
    ([(20, 30), (0, 10)], 20),         # unsorted, disjoint
    ([(0, 10), (2, 3), (10, 12)], 12),  # nested and touching
])
def test_trace_union_length(intervals, expect):
    sys.path.insert(0, REPO)
    from benchmarks.trace_summary import union_length
    assert union_length(intervals) == expect
