"""Where the renderer runs: the backend and kernel-route decision, the
compile-cache directory rule, and the GPU-only measurement entry points
(bench.py, chip_smoke.py) refusing to measure anything else."""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

import vktf.config as config_mod
from vktf.config import RenderConfig

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def platform(monkeypatch):
    """Pretend the default JAX device is on the given platform."""
    def set_platform(name):
        monkeypatch.setattr(config_mod, "device_platform", lambda: name)
    return set_platform


@pytest.mark.parametrize("name, backend, interpret", [
    ("gpu", "pallas", False),
    ("cpu", "tiled", True),
])
def test_route_by_platform(platform, name, backend, interpret):
    """auto resolves to the production path on a GPU and to the XLA tiled
    backend on the CPU; Pallas kernels compile on a GPU and are interpreted
    only on the CPU."""
    platform(name)
    config = RenderConfig()
    assert config.resolved_backend() == backend
    assert config.kernel_interpret() is interpret
    if backend == "pallas":
        from vktf.ops.raster_pallas import TILE_SHAPE

        assert config.tile_shape == TILE_SHAPE
    else:
        assert config.tile_shape == (32, 128)


@pytest.mark.parametrize("name", ["rocm", "metal", "neuron"])
def test_other_platforms_are_refused(platform, name):
    platform(name)
    config = RenderConfig(backend="tiled", tile_shape=(32, 128))
    with pytest.raises(ValueError, match=name):
        config.replace(backend="auto").resolved_backend()
    with pytest.raises(ValueError, match=name):
        config.kernel_interpret()


def test_no_interpret_on_gpu(platform):
    """pallas_interpret=True is the CPU test switch: on a GPU it is refused
    instead of silently interpreting a kernel."""
    platform("gpu")
    config = RenderConfig(backend="pallas", pallas_interpret=True,
                          tile_shape=(16, 32))
    with pytest.raises(ValueError, match="GPU"):
        config.kernel_interpret()
    # the production frame program asks the same question
    from vktf.ops.pipeline import PallasFrameProgram

    meta = SimpleNamespace(peel_layers=1, mixed_samplers=False)
    with pytest.raises(ValueError, match="GPU"):
        PallasFrameProgram(meta, config)


def test_compiled_kernels_need_a_gpu(platform):
    platform("cpu")
    config = RenderConfig(backend="pallas", pallas_interpret=False,
                          tile_shape=(16, 32))
    with pytest.raises(ValueError, match="GPU"):
        config.kernel_interpret()


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir_rule(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set (and is left to JAX);
    otherwise the cache sits at a fixed path inside the checkout."""
    from vktf.runtime import cache

    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cache.cache_dir_setting() == str(REPO / ".jax_cache")
        assert cache.CHECKOUT_CACHE_DIR == str(REPO / ".jax_cache")
    else:
        target = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
        assert cache.cache_dir_setting() == target


def test_checkout_cache_is_gitignored():
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def _run(args, env_extra, timeout=240):
    env = dict(os.environ)
    env.pop("VKTF_FORCE_CPU", None)
    env.update(env_extra)
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_bench_refuses_cpu_without_rehearsal_flag():
    proc = _run(["bench.py", "--preset", "box", "--width", "64", "--height",
                 "32", "--msaa", "1", "--frames", "2"], {})
    assert proc.returncode != 0
    assert "VKTF_FORCE_CPU" in proc.stderr
    assert not [l for l in proc.stdout.splitlines() if l.startswith("{")]


def test_bench_mesh_needs_enough_devices():
    """--mesh with more devices than the platform has fails (no silent
    fallback to a virtual mesh)."""
    proc = _run(["bench.py", "--preset", "box", "--width", "64", "--height",
                 "32", "--msaa", "1", "--frames", "2", "--mesh", "4,4"],
                {"VKTF_FORCE_CPU": "1"})
    assert proc.returncode != 0
    assert "needs 16 devices" in proc.stderr


def test_chip_smoke_refuses_without_gpu():
    proc = _run(["chip_smoke.py"], {"JAX_PLATFORMS": "cpu"})
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr + proc.stdout
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied away from the repository, the script cannot import the
    renderer and fails without printing a result."""
    import shutil

    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_result_line():
    import chip_smoke

    devices = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")]
    line = json.loads(chip_smoke.result_line(devices))
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100", "count": 1}}


def test_chip_smoke_failed_phase_exits_nonzero(monkeypatch, capsys):
    """A failing phase propagates (nothing catches it), so no result line
    is printed and the process exits non-zero."""
    import chip_smoke

    devices = [SimpleNamespace(platform="gpu", device_kind="k")]
    monkeypatch.setattr(chip_smoke, "phase_device", lambda n: devices)

    def broken():
        raise AssertionError("raster parity failed")

    monkeypatch.setattr(chip_smoke, "phase_raster", broken)
    with pytest.raises(AssertionError, match="parity"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out
