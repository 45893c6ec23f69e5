"""Platform -> implementation table, compile cache location, and the
GPU smoke script's refusal to run anywhere else."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from circuits_tpu.utils import backend, compile_opts

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("platform", ["cpu", "gpu", "rocm"])
def test_for_platform(platform):
    if platform == "rocm":
        with pytest.raises(ValueError, match="no backend"):
            backend.for_platform(platform)
        return
    # each platform runs its own native custom-call library
    assert backend.for_platform(platform) == {"cpu": "cpu",
                                              "gpu": "cuda"}[platform]


def test_xla_reference_turns_native_off_and_back():
    from circuits_tpu.field import fr_ffi

    assert backend.native() == "cpu" and fr_ffi.enabled()
    with backend.xla_reference():
        assert backend.native() is None and not fr_ffi.enabled()
        with backend.xla_reference():
            assert backend.native() is None
        assert backend.native() is None
    assert backend.native() == "cpu" and fr_ffi.enabled()


class _Config:
    def __init__(self):
        self.values = {}

    def update(self, key, value):
        self.values[key] = value


class _Jax:
    def __init__(self):
        self.config = _Config()


@pytest.mark.parametrize("env_dir", [None, "/somewhere/else"])
def test_compile_cache_dir(monkeypatch, env_dir):
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    fake = _Jax()
    got = compile_opts.enable_persistent_cache(fake)
    if env_dir is None:
        assert got == str(ROOT / ".jax_cache")
        assert fake.config.values["jax_compilation_cache_dir"] == got
    else:
        # JAX reads the variable itself; no other directory is set
        assert got == env_dir
        assert "jax_compilation_cache_dir" not in fake.config.values


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = ROOT
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
