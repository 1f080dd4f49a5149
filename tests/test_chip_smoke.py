"""chip_smoke.py's refusal to run off a GPU, the compile-cache rule, and the
smoke's on-card comparisons as tests marked ``gpu`` (they skip without a
card; README, "Tests", names the command that runs them on one)."""

import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_cpu(tmp_path, where):
    """No GPU, or no package beside the script: non-zero exit, no result."""
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=cwd,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    if where == "checkout":
        assert "no GPU found" in out.stderr


def test_require_gpu_refuses_cpu():
    from sarlacc_tpu.utils.device import require_gpu

    with pytest.raises(RuntimeError, match="no GPU found"):
        require_gpu()


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_dir_rule(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and is left to JAX; otherwise the
    cache sits at one fixed, ignored path inside the checkout."""
    from sarlacc_tpu.utils import cache

    if env_set:
        want = str(tmp_path / "jc")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
        before = jax.config.jax_compilation_cache_dir
        assert cache.enable_persistent_cache() == want
        assert jax.config.jax_compilation_cache_dir == before
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cache.cache_dir() == cache.DEFAULT_DIR == str(ROOT / ".jax_cache")
        assert cache.cache_dir() == cache.cache_dir()
        assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
@pytest.mark.parametrize(
    "check", ["dp_align", "barcodes", "banded_pairs", "golden_pipeline"]
)
def test_on_card_matches_reference(gpu_device, check):
    """chip_smoke's phase-3 comparisons, run on the card."""
    getattr(_smoke(), f"check_{check}")()
