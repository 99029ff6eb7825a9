#!/usr/bin/env python
"""Benchmark harness: steady-state render FPS on the BASELINE configs.

Prints ONE JSON line (per requested config):
    {"metric": ..., "value": N, "unit": "fps", "vs_baseline": N}

The headline metric matches BASELINE.json's north star: FPS at 1080p on a
Sponza-scale scene with full PBR + 4x MSAA (the reference publishes no
numbers of its own, so vs_baseline is measured against the 60-FPS target).

Every line names the device it ran on (platform, device_kind, device
count) and the card's power limit. The bench measures a GPU: on any other
platform it exits non-zero, unless VKTF_FORCE_CPU=1 asks for an explicit
CPU rehearsal (whose numbers are no device metric).

A JSON line lands NO MATTER WHAT:

  * timestamped progress markers go to stderr at every phase, so a killed
    run's tail shows where the time went;
  * a watchdog THREAD (immune to a blocked main thread) enforces an
    internal wall-clock budget (env BENCH_BUDGET_S, default 480 s) and
    flushes the best-so-far JSON before exiting;
  * SIGTERM/SIGINT handlers flush the same partial JSON when an external
    timeout fires first;
  * the measurement ladder is adaptive: a short device loop produces a
    valid headline measurement as early as possible, and best-of-3 /
    present / interactive refinements run only while budget remains.

The reference bar is "the app always starts" (engine.cppm:501-563); ours is
"the bench always reports".

Usage:
    python bench.py                    # headline: sponza @1080p, 4x MSAA
    python bench.py --preset helmet --width 1280 --height 720 --msaa 1
    python bench.py --all              # print one line per BASELINE config
    python bench.py --mesh 2,2         # sharded frame path on a (gp, sp) mesh
    VKTF_FORCE_CPU=1 python bench.py --preset box --width 192 --height 96
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

import numpy as np


BASELINE_TARGET_FPS = 60.0  # BASELINE.json north_star
_T0 = time.time()
_BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "480"))
_DEADLINE = _T0 + _BUDGET_S

# (preset, width, height, msaa) per BASELINE.json configs
CONFIGS = {
    "box": ("box", 1920, 1080, 1),
    "duck": ("duck", 1920, 1080, 1),
    "helmet": ("helmet", 1920, 1080, 4),
    "sponza": ("sponza", 1920, 1080, 4),
    "flythrough": ("flythrough", 3840, 2160, 4),
}

# camera placements per preset: (position, direction)
CAMERAS = {
    "box": ((0.0, 0.8, 2.4), (0.0, -0.25, -1.0)),
    "duck": ((0.0, 0.5, 2.0), (0.0, -0.2, -1.0)),
    "helmet": ((0.0, 0.4, 2.4), (0.0, -0.1, -1.0)),
    "sponza": ((-9.0, 1.7, 0.0), (1.0, 0.05, 0.0)),
    "flythrough": ((-9.0, 1.7, 0.0), (1.0, 0.05, 0.0)),
}

# ---------------------------------------------------------------------------
# always-report machinery
# ---------------------------------------------------------------------------

_emit_lock = threading.Lock()
_state = {
    "phase": "startup",          # most recent phase marker
    "partial": None,             # best-so-far headline dict (not yet printed)
    "printed": 0,                # completed JSON lines already on stdout
    "done": False,               # normal completion reached
    "device": {},                # device_kind / power_limit once known
}


def _mark(phase: str, **kv) -> None:
    """Timestamped progress marker on stderr (the killed-run breadcrumb)."""
    _state["phase"] = phase
    extra = "".join(f" {k}={v}" for k, v in kv.items())
    sys.stderr.write(f"[bench +{time.time() - _T0:6.1f}s] {phase}{extra}\n")
    sys.stderr.flush()


def _remaining() -> float:
    return _DEADLINE - time.time()


def _set_partial(line: dict) -> None:
    """Record the best-so-far headline; flushed by watchdog/signal if the
    run never reaches its normal print."""
    _state["partial"] = dict(line)


def _print_line(line: dict) -> None:
    with _emit_lock:
        print(json.dumps(line), flush=True)
        _state["printed"] += 1
        _state["partial"] = None


def _flush_partial(reason: str) -> None:
    """Emergency emission: print the best-so-far (or a zero line) exactly
    once, annotated with where the run died. Safe from any thread."""
    with _emit_lock:
        if _state["done"]:
            return
        line = _state["partial"]
        if line is None and _state["printed"] == 0:
            line = {
                "metric": "sponza @1920x1080 4xMSAA render FPS",
                "value": 0.0,
                "unit": "fps",
                "vs_baseline": 0.0,
            }
        if line is not None:
            line = {**_state["device"], **line}
            line["partial"] = reason
            line["phase"] = _state["phase"]
            line["elapsed_s"] = round(time.time() - _T0, 1)
            print(json.dumps(line), flush=True)
            _state["printed"] += 1
            _state["partial"] = None
        _state["done"] = True


def _watchdog() -> None:
    while True:
        left = _DEADLINE - time.time()
        if _state["done"]:
            return
        if left <= 0:
            stuck_in = _state["phase"]
            sys.stderr.write(
                f"[bench +{time.time() - _T0:6.1f}s] watchdog fired "
                f"(budget_s={_BUDGET_S}, stuck in: {stuck_in})\n"
            )
            sys.stderr.flush()
            _flush_partial("budget")
            os._exit(0)
        time.sleep(min(left, 2.0))


def _on_signal(signum, frame) -> None:  # pragma: no cover - signal path
    sys.stderr.write(
        f"[bench +{time.time() - _T0:6.1f}s] signal {signum} "
        f"(in phase: {_state['phase']})\n"
    )
    sys.stderr.flush()
    _flush_partial(f"signal{signum}")
    os._exit(0)


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------


def run_bench(preset: str, width: int, height: int, msaa: int,
              frames: int, animate: bool = True,
              backend: str | None = None, depth: int = 4,
              anisotropy: float = 16.0, aniso_taps: int = 1,
              present_format: str = "rgb",
              mesh_shape: tuple[int, int] | None = None,
              emit=None):
    """Measure one config. Calls ``emit(stats_dict)`` after every refinement
    so the watchdog always has the latest valid number to flush."""
    emit = emit or (lambda stats: None)
    _mark(f"{preset}: import jax")
    import jax
    import jax.numpy as jnp

    from vktf.config import RenderConfig
    from vktf.mathx import Camera, ViewFrustumParams
    from vktf.models.scenes import build_preset
    from vktf.runtime import enable_persistent_cache
    from vktf.scene.scene import Scene

    # the offline-shader-cache analogue (cmake/compile_shader.cmake): repeat
    # bench runs load the compiled frame program instead of recompiling
    cache_dir = enable_persistent_cache()
    from vktf.utils.device_info import device_summary

    device = device_summary()
    _state["device"] = {"device_kind": device["device_kind"],
                        "power_limit": device["power_limit"]}
    try:
        cache_files = len(os.listdir(cache_dir))
    except OSError:
        cache_files = 0
    _mark(f"{preset}: persistent cache ready", dir=cache_dir,
          entries=cache_files)

    config = RenderConfig(width=width, height=height, msaa_samples=msaa,
                          backend=backend or "auto",
                          max_anisotropy=anisotropy, aniso_taps=aniso_taps,
                          present_format=present_format)
    position, direction = CAMERAS[preset]
    camera = Camera(
        position,
        direction,
        ViewFrustumParams(np.radians(45.0), width / height, 0.1, 1.0e6),
    )
    # backend init BEFORE anything is timed, so it is not misattributed to
    # scene build or compile
    t0 = time.time()
    np.asarray(jnp.zeros((8,), jnp.float32) + 1.0)
    session_init_s = time.time() - t0
    _mark(f"{preset}: backend up", secs=round(session_init_s, 1),
          platform=jax.devices()[0].platform)

    mesh = None
    if mesh_shape is not None:
        from vktf.parallel import make_render_mesh

        gp, sp = mesh_shape
        mesh = make_render_mesh(jax.devices()[: gp * sp], gp=gp, sp=sp)
        _mark(f"{preset}: render mesh", gp=gp, sp=sp,
              platform=jax.devices()[0].platform)

    t0 = time.time()
    scene = Scene(build_preset(preset), config, camera=camera, mesh=mesh)
    build_s = time.time() - t0
    _mark(f"{preset}: scene built", secs=round(build_s, 1),
          tris=scene.meta.num_triangles)

    # frames are materialized to host (np.asarray) like the engine's
    # present path
    _mark(f"{preset}: compile + first frame")
    t0 = time.time()
    out = np.asarray(scene.render_async())
    compile_s = time.time() - t0
    try:
        cache_delta = len(os.listdir(cache_dir)) - cache_files
    except OSError:
        cache_delta = 0
    _mark(f"{preset}: compiled", secs=round(compile_s, 1),
          cache="miss (wrote new entries)" if cache_delta > 0 else
                ("hit" if compile_s < 20 else "miss"),
          new_cache_entries=cache_delta)

    def loop(n: int, depth: int = depth, render=None) -> float:
        """Steady-state loop, `depth` frames in flight: dispatch frame i+k
        (with an async host copy) before materializing frame i, so transfer
        and dispatch overlap device compute. The interactive engine keeps
        the reference's 2 frames in flight for input latency
        (engine.cppm:40); the bench measures throughput like a
        mailbox-present swapchain. Reports the MEDIAN present-to-present
        interval."""
        in_flight = []
        presents = []
        for _ in range(n):
            if animate:
                # per-frame camera motion — the reference's per-frame
                # Scene::Update uniform write (scene.cppm:314-329)
                scene.camera.rotate(0.0, 0.002)
            frame = (render or scene.render_async)()
            frame.copy_to_host_async()
            in_flight.append(frame)
            if len(in_flight) >= depth:
                np.asarray(in_flight.pop(0))
                presents.append(time.time())
        for frame in in_flight:
            np.asarray(frame)
            presents.append(time.time())
        return float(np.median(np.diff(presents)))

    def device_loop(n: int) -> float:
        """DEVICE render throughput: dispatch n frames, fold a tiny
        on-device probe of each frame into one accumulator, ONE host sync
        at the end. The probe (a 128-byte reduction of the frame) depends
        on the full frame program, so every frame is fully rendered;
        present_fps records the host-materialized path separately.
        """
        acc = jnp.zeros((), jnp.int32)
        np.asarray(acc)  # sync before timing
        t0 = time.time()
        for _ in range(n):
            if animate:
                scene.camera.rotate(0.0, 0.002)
            frame = scene.render_async()
            acc = acc + jnp.sum(frame.ravel()[-128:].astype(jnp.int32))
        np.asarray(acc)
        return (time.time() - t0) / n

    tris = scene.meta.num_triangles

    def stats_from(dt, present_dt=None, dt2=None, quality="first-loop"):
        s = {
            "fps": 1.0 / dt,
            "frame_ms": dt * 1e3,
            "mtris_per_s": tris / dt / 1e6,
            "triangles": tris,
            "build_s": build_s,
            "compile_s": compile_s,
            "session_init_s": session_init_s,
            "platform": device["platform"],
            "device_kind": device["device_kind"],
            "device_count": device["count"],
            "power_limit": device["power_limit"],
            "backend": config.resolved_backend(),
            "quality": quality,
        }
        if mesh is not None:
            s["mesh"] = f"gp{mesh_shape[0]}x sp{mesh_shape[1]}"
        if present_dt is not None:
            s["present_fps"] = 1.0 / present_dt
            s["present_frame_ms"] = present_dt * 1e3
        if dt2 is not None:
            s["interactive_fps"] = 1.0 / dt2
            s["interactive_frame_ms"] = dt2 * 1e3
        return s

    # --- measurement ladder: cheapest valid number first, refine within
    # budget. Every rung re-emits so the watchdog can flush it. ---
    first_n = max(4, min(frames, 8))
    dt = device_loop(first_n)  # doubles as warmup
    emit(stats_from(dt))
    _mark(f"{preset}: first device loop", n=first_n,
          frame_ms=round(dt * 1e3, 1))

    # best-of-3: the best loop is the closest estimate of the renderer's
    # own steady state. Each loop costs ~frames x frame_ms.
    loop_cost = frames * dt + 1.0
    n_loops = 0
    while n_loops < 3 and _remaining() > loop_cost + 30.0:
        dt = min(dt, device_loop(frames))
        n_loops += 1
        emit(stats_from(dt, quality=f"best-of-{n_loops + 1}"))
    _mark(f"{preset}: device loops done", loops=n_loops + 1,
          frame_ms=round(dt * 1e3, 2), budget_left=round(_remaining()))

    present_dt = None
    dt2 = None
    # present / interactive rows are refinements: only measured while
    # budget clearly remains.
    present_cost = frames * (dt + 0.04) + 1.0
    if _remaining() > 2 * present_cost + 30.0:
        present_dt = min(loop(frames), loop(frames))
        emit(stats_from(dt, present_dt, quality=f"best-of-{n_loops + 1}"))
        _mark(f"{preset}: present loops done",
              present_ms=round(present_dt * 1e3, 1))
        # the INTERACTIVE figure: the engine's real MAX_RENDER_FRAMES=2
        # configuration (config.py) — what a viewer user sees, vs the
        # mailbox-style throughput numbers above.
        if depth == 2:
            dt2 = present_dt
        elif _remaining() > 2 * present_cost + 30.0:
            dt2 = min(loop(frames, depth=2), loop(frames, depth=2))
            _mark(f"{preset}: interactive loops done",
                  interactive_ms=round(dt2 * 1e3, 1))
    else:
        _mark(f"{preset}: skipping present/interactive rows",
              budget_left=round(_remaining()))

    # PREVIEW interactive row: the viewer's --preview stream (half-res box
    # downsample + yuv420 = 8x fewer present bytes; exact stills stay
    # available via Scene.render_still). Same depth-2 engine configuration
    # as the interactive row — the delta is purely present-encoding.
    preview_dt = None
    preview_scale = None
    if (mesh is None and dt2 is not None and config.present_scale == 1
            and config.present_format == "rgb"
            and config.width % 4 == 0 and config.height % 4 == 0
            and _remaining() > 2 * present_cost + 60.0):
        from vktf.runtime import frame_program

        # candidate preview reductions: scale 2 everywhere; at 4K also
        # scale 4 (still a 960x540-site stream). The best measured scale is
        # reported with its rate.
        scales = [2]
        if (config.width >= 3840 and config.width % 8 == 0
                and config.height % 8 == 0):
            scales.append(4)
        for scale in scales:
            preview_cfg = config.replace(present_format="yuv420",
                                         present_scale=scale)
            preview_fn = frame_program(scene.meta, preview_cfg)

            def preview_render():
                return preview_fn(scene.render_scene,
                                  scene.camera.view_projection_transform,
                                  scene.camera.position)

            t0 = time.time()
            np.asarray(preview_render())  # compile outside the timed loops
            _mark(f"{preset}: preview program ready (scale {scale})",
                  secs=round(time.time() - t0, 1))
            if _remaining() > 2 * present_cost + 30.0:
                p_dt = min(loop(frames, depth=2, render=preview_render),
                           loop(frames, depth=2, render=preview_render))
                _mark(f"{preset}: preview loops done (scale {scale})",
                      preview_ms=round(p_dt * 1e3, 1))
                if preview_dt is None or p_dt < preview_dt:
                    preview_dt, preview_scale = p_dt, scale

    stats = stats_from(dt, present_dt, dt2, quality=f"best-of-{n_loops + 1}")
    if preview_dt is not None:
        stats["preview_fps"] = 1.0 / preview_dt
        stats["preview_frame_ms"] = preview_dt * 1e3
        stats["preview_scale"] = preview_scale
    return stats


def _format_line(preset, width, height, msaa, stats, present_format,
                 mesh_shape, aniso_taps=1):
    extra = {}
    if present_format != "rgb":
        extra["present_format"] = present_format
    if aniso_taps != 1:
        extra["aniso_taps"] = aniso_taps
    if mesh_shape is not None:
        extra["mesh"] = stats.get("mesh", f"gp{mesh_shape[0]}x sp{mesh_shape[1]}")
    line = {
        "metric": f"{preset} @{width}x{height} {msaa}xMSAA render FPS"
                  f" ({stats['triangles']} tris, {stats['platform']}/{stats['backend']})",
        "value": round(stats["fps"], 2),
        "unit": "fps",
        "vs_baseline": round(stats["fps"] / BASELINE_TARGET_FPS, 3),
        "frame_ms": round(stats["frame_ms"], 2),
        "mtris_per_s": round(stats["mtris_per_s"], 1),
        "compile_s": round(stats["compile_s"], 1),
        "session_init_s": round(stats["session_init_s"], 1),
        "device_kind": stats["device_kind"],
        "device_count": stats["device_count"],
        "power_limit": stats["power_limit"],
        **extra,
    }
    if "present_fps" in stats:
        line["present_fps"] = round(stats["present_fps"], 2)
    if "interactive_fps" in stats:
        line["interactive_fps"] = round(stats["interactive_fps"], 2)
    if "preview_fps" in stats:
        line["preview_fps"] = round(stats["preview_fps"], 2)
        if stats.get("preview_scale", 2) != 2:
            line["preview_scale"] = stats["preview_scale"]
    if stats.get("quality"):
        line["loops"] = stats["quality"]
    return line


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", default="sponza", choices=sorted(CONFIGS))
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--height", type=int, default=None)
    parser.add_argument("--msaa", type=int, default=None)
    parser.add_argument("--frames", type=int, default=30)
    parser.add_argument("--depth", type=int, default=4,
                        help="frames in flight (throughput pipelining)")
    parser.add_argument("--backend", default=None,
                        choices=["pallas", "tiled", "dense"],
                        help="raster backend (default: pallas on a GPU, "
                             "tiled on the CPU)")
    parser.add_argument("--anisotropy", type=float, default=16.0,
                        help="max sampler anisotropy (1 = off)")
    parser.add_argument("--aniso-taps", type=int, default=1,
                        choices=[1, 2, 4, 8],
                        help="true multi-tap anisotropic filtering (the "
                             "fidelity ladder knob; --all adds a sponza "
                             "aniso_taps=2 row automatically)")
    parser.add_argument("--present-format", default="rgb",
                        choices=("rgb", "yuv420"),
                        help="device-side present encoding for the "
                             "present/interactive rows (yuv420 = half the "
                             "device->host bytes; render fps unaffected)")
    parser.add_argument("--mesh", default=None, metavar="GP,SP",
                        help="run the SHARDED frame path over a (gp, sp) "
                             "device mesh (vktf.parallel). Needs gp*sp "
                             "devices and fails with fewer.")
    parser.add_argument("--all", action="store_true")
    parser.add_argument("--budget", type=float, default=None,
                        help="wall-clock budget in seconds (same as env "
                             "BENCH_BUDGET_S, default 480): the watchdog "
                             "flushes the best-so-far JSON and exits when "
                             "it expires")
    parser.add_argument("--verbose", action="store_true",
                        help="print observability counters to stderr")
    args = parser.parse_args()
    if args.budget is not None:
        global _BUDGET_S, _DEADLINE
        _BUDGET_S = float(args.budget)
        _DEADLINE = _T0 + _BUDGET_S

    mesh_shape = None
    if args.mesh:
        gp, sp = (int(x) for x in args.mesh.split(","))
        mesh_shape = (gp, sp)

    # arm the watchdog + signal flush BEFORE anything heavy: `import jax`
    # below can take seconds, and a SIGTERM landing mid-import would
    # otherwise kill the process with no JSON line (the un-killability
    # promise, tests/test_bench_harness.py)
    _mark("bench start", budget_s=_BUDGET_S,
          argv=" ".join(sys.argv[1:]) or "(headline)")
    threading.Thread(target=_watchdog, daemon=True).start()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _on_signal)
        except (ValueError, OSError):  # pragma: no cover - non-main thread
            pass

    import jax

    if os.environ.get("VKTF_FORCE_CPU"):
        # explicit CPU rehearsal: select the platform before the backend
        # initializes (JAX_PLATFORMS=cpu in the environment does the same)
        jax.config.update("jax_platforms", "cpu")
    platform = jax.devices()[0].platform
    if platform != "gpu" and not os.environ.get("VKTF_FORCE_CPU"):
        _mark(f"no GPU (platform {platform}); set VKTF_FORCE_CPU=1 for a "
              "CPU rehearsal")
        _state["done"] = True
        return 2
    if mesh_shape is not None:
        n = mesh_shape[0] * mesh_shape[1]
        if len(jax.devices()) < n:
            _mark(f"--mesh {args.mesh} needs {n} devices, have "
                  f"{len(jax.devices())} ({platform}); rehearse on a virtual "
                  f"mesh with XLA_FLAGS=--xla_force_host_platform_device_"
                  f"count={n} VKTF_FORCE_CPU=1")
            _state["done"] = True
            return 2

    # jobs: (preset, aniso_taps). --all appends the sponza aniso_taps=2
    # FIDELITY row (the cost of true 2-tap anisotropy, closer to the
    # reference's sampler default); explicit --aniso-taps
    # applies to every job instead.
    if args.all:
        jobs = [(p, args.aniso_taps) for p in sorted(CONFIGS)]
        if args.aniso_taps == 1:
            jobs.append(("sponza", 2))
    else:
        jobs = [(args.preset, args.aniso_taps)]
    code = 0
    for i, (preset, aniso_taps) in enumerate(jobs):
        if i > 0 and _remaining() < 120.0:
            _mark(f"skipping {preset}: budget exhausted",
                  budget_left=round(_remaining()))
            break
        _, width, height, msaa = CONFIGS[preset]
        width = args.width or width
        height = args.height or height
        msaa = args.msaa or msaa

        def emit(stats, preset=preset, width=width, height=height, msaa=msaa,
                 aniso_taps=aniso_taps):
            _set_partial(_format_line(preset, width, height, msaa, stats,
                                      args.present_format, mesh_shape,
                                      aniso_taps))

        try:
            stats = run_bench(preset, width, height, msaa, args.frames,
                              backend=args.backend,
                              depth=args.depth,
                              anisotropy=args.anisotropy,
                              aniso_taps=aniso_taps,
                              present_format=args.present_format,
                              mesh_shape=mesh_shape,
                              emit=emit)
        except Exception as exc:  # pragma: no cover - bench robustness
            _print_line({
                "metric": f"{preset} @{width}x{height} {msaa}xMSAA render FPS",
                "value": 0.0,
                "unit": "fps",
                "vs_baseline": 0.0,
                **_state["device"],
                "error": f"{type(exc).__name__}: {exc}"[:300],
            })
            code = 1
            continue
        _print_line(_format_line(preset, width, height, msaa, stats,
                                 args.present_format, mesh_shape,
                                 aniso_taps))
    if args.verbose:
        from vktf.utils.profiling import counters

        print(f"counters: {counters.snapshot()}", file=sys.stderr)
    _mark("bench done", elapsed=round(time.time() - _T0, 1))
    _state["done"] = True
    return code


if __name__ == "__main__":
    sys.exit(main())
