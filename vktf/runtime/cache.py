"""Compiled-program registry and persistent XLA compile cache.

The reference compiles GLSL to SPIR-V offline and reloads the `.spv` at
startup, falling back to runtime glslang compilation
(cmake/compile_shader.cmake, shader_module.cppm:139-152,
glslang_compiler.cppm:227-232). Here there are two layers:

  * an in-process program registry: the jitted frame function for a given
    (scene shape, render config) is built once and shared across Scene
    instances — the ShaderModule/pipeline-cache role;
  * JAX's persistent compilation cache on disk: compiled executables
    survive process restarts — the offline `.spv` role.

The cache lives where JAX_COMPILATION_CACHE_DIR says when it is set (JAX
reads the variable itself, and nothing here overrides it); otherwise at a
fixed directory inside the checkout, ``<repo>/.jax_cache`` (a fixed path,
because the path is part of the cache key).

`warmup()` is the AOT path: compile a frame program ahead of the render loop
(the analogue of CMake's offline shader compile step).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Tuple

import jax

CHECKOUT_CACHE_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")
_cache_enabled = False


def cache_dir_setting() -> str:
    """The compile-cache directory this process uses (see module doc)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_persistent_cache() -> str:
    """Enable JAX's on-disk compilation cache (idempotent); returns the dir."""
    global _cache_enabled
    cache_dir = cache_dir_setting()
    if not _cache_enabled:
        Path(cache_dir).mkdir(parents=True, exist_ok=True)
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        _cache_enabled = True
    return cache_dir


_programs: Dict[Tuple, object] = {}


def frame_program(meta, config):
    """The jitted frame function for (scene shape, config), built once.

    SceneMeta and RenderConfig are frozen/hashable, so they key the registry
    directly — the analogue of the per-scene GraphicsPipeline keyed by its
    specialization constants (scene.cppm:269-277).
    """
    from vktf.ops.pipeline import make_frame_fn

    key = ("frame", meta, config, config.resolved_backend())
    fn = _programs.get(key)
    if fn is None:
        fn = make_frame_fn(meta, config)
        _programs[key] = fn
    return fn


def warmup(scene, meta, config, view_projection, camera_position):
    """AOT-compile the frame program for the given inputs; returns compile
    seconds (0.0-ish on a persistent-cache hit)."""
    import time

    fn = frame_program(meta, config)
    t0 = time.time()
    if hasattr(fn, "warmup"):  # split-stage program: run + block once
        fn.warmup(scene, view_projection, camera_position)
    else:
        fn.lower(scene, view_projection, camera_position).compile()
    return time.time() - t0


def program_cache_info() -> dict:
    return {
        "programs": len(_programs),
        "persistent_cache": cache_dir_setting() if _cache_enabled else None,
    }
