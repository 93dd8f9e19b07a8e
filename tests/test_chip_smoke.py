"""chip_smoke.py's phases at small sizes on the CPU.

The full-size runs need a GPU (``python chip_smoke.py``; tests/test_gpu.py);
here each phase function runs at 32 cells per axis so the 3D product path
and the sharded comparison stay covered by the fast tier.
"""

import os
import subprocess
import sys

import jax
import pytest

import chip_smoke
from fluidsim_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_refuses_cpu_backend():
    """No GPU: non-zero exit and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


@pytest.mark.parametrize("name", chip_smoke.PRESETS)
def test_main_path_at_32(name):
    chip_smoke.check_preset(name, size=32, min_seconds=0.0)


def test_cli_phase_at_32():
    chip_smoke.cli_phase(size=32)


def test_oracle_phase_at_32():
    chip_smoke.compare_oracle_3d(32)


@pytest.mark.parametrize("halo", ["auto", "explicit"])
def test_multi_phase_on_four_cpu_devices(halo):
    chip_smoke.multi_phase(jax.devices()[:4], size=32, halos=(halo,))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_from_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets no other directory.
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
