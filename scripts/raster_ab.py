#!/usr/bin/env python
"""Raster kernel vs the XLA tiled rasterizer on a GPU, in one process.

    python scripts/raster_ab.py [--reps 5] [--frames 20] [--sweep]
                                [--trace DIR]

At sponza 1920x1080 4x MSAA (bench.py's camera; --preset/--size change
it), in turns (A B B A ...):
  * stage: the raster alone on one fixed setup — the Triton kernel
    (ops.raster_pallas) vs rasterize_tiled (ops.raster_tiled, bins sized
    so nothing drops), each ending in block_until_ready;
  * frame: the production split-stage frame program with its raster stage
    as shipped, and the same program with rasterize_tiled in that stage
    (its blocks re-laid out to the kernel's tile layout for the shade);
    frames dispatched back to back, one host sync at the end.
--sweep times the kernel alone over tile shapes, chunk sizes and warp
counts. --trace DIR writes a profiler trace of a few production frames and
prints the device time of each jitted stage program.
Every line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _timed(fn, reps):
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _tiled_stage(config, ph, pw, capacity, large_capacity):
    """rasterize_tiled on a packed setup, emitting the kernel's block
    layout ((num_tiles, S*th, tw), row = y*S + s)."""
    from vktf.ops.raster_tiled import rasterize_tiled, setup_from_packed

    th, tw = config.tile_shape
    S = config.msaa_samples

    tph, tpw = -(-ph // 32) * 32, -(-pw // 128) * 128

    def run(packed, _perm):
        ids, dep = rasterize_tiled(
            setup_from_packed(packed), tph, tpw, tile_shape=(32, 128),
            bin_capacity=capacity, large_capacity=large_capacity,
            msaa_samples=S)

        def blocks(x):  # (S, H, W) -> (tiles, th*S, tw), row = y*S + s
            return (x.reshape(S, ph // th, th, pw // tw, tw)
                    .transpose(1, 3, 2, 0, 4).reshape(-1, th * S, tw))

        return blocks(ids[:, :ph, :pw]), blocks(dep[:, :ph, :pw])

    return run


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--frames", type=int, default=20)
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--trace", default=None)
    parser.add_argument("--preset", default="sponza")
    parser.add_argument("--size", default="1920x1080",
                        help="WxH (small sizes rehearse the script on CPU)")
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import CAMERAS
    from vktf.config import RenderConfig
    from vktf.mathx import Camera, ViewFrustumParams
    from vktf.models.scenes import build_preset
    from vktf.ops.binning import bin_triangles
    from vktf.ops.pipeline import PallasFrameProgram
    from vktf.ops.raster_pallas import rasterize_pallas
    from vktf.runtime import enable_persistent_cache
    from vktf.scene.flatten import flatten_assets
    from vktf.utils.device_info import device_summary, nvidia_smi_name_power

    enable_persistent_cache()
    dev = device_summary()
    card = nvidia_smi_name_power() or dev["device_kind"]
    print(f"card: {card} | jax {jax.__version__} | {dev}", flush=True)

    width, height = (int(v) for v in args.size.split("x"))
    msaa = 4
    scene, meta, _aux = flatten_assets(build_preset(args.preset))
    position, direction = CAMERAS[args.preset]
    camera = Camera(position, direction, ViewFrustumParams(
        np.radians(45.0), width / height, 0.1, 1.0e6))
    vp, pos = camera.view_projection_transform, camera.position
    config = RenderConfig(width=width, height=height, msaa_samples=msaa,
                          backend="pallas")
    ph, pw = config.padded_height, config.padded_width
    tph, tpw = -(-ph // 32) * 32, -(-pw // 128) * 128

    prog_k = PallasFrameProgram(meta, config)
    packed, _lights = prog_k._prepare(scene, vp, pos)
    perm = prog_k._maybe_resort(packed, vp)

    # comparator bins: nothing may drop
    bbox = packed["bbox_rows"].T.astype(jnp.int32)
    capacity, large_capacity = 4096, 4096
    while True:
        bins = jax.jit(lambda b, v: bin_triangles(
            b, v, tile_shape=(32, 128), tiles_y=tph // 32,
            tiles_x=tpw // 128,
            capacity=capacity, large_capacity=large_capacity))(
                bbox, packed["valid"])
        worst = int(np.asarray(bins.bin_counts).max())
        large = int(np.asarray(bins.large_count))
        if worst <= capacity and large <= large_capacity:
            break
        capacity = max(capacity, 1 << int(np.ceil(np.log2(worst))))
        large_capacity = max(large_capacity,
                             1 << int(np.ceil(np.log2(max(large, 1)))))
    print(f"tiled comparator: bin_capacity={capacity} "
          f"large_capacity={large_capacity} drops=0", flush=True)

    tiled_fn = jax.jit(_tiled_stage(config, ph, pw, capacity, large_capacity))
    kern_fn = prog_k._raster

    def stage(fn):
        def go():
            ids, dep = fn(packed, perm)
            dep.block_until_ready()
        return go

    t0 = time.time()
    stage(kern_fn)()
    print(f"compile+first kernel raster {time.time() - t0:.1f}s", flush=True)
    t0 = time.time()
    stage(tiled_fn)()
    print(f"compile+first tiled raster {time.time() - t0:.1f}s", flush=True)
    ids_k = np.asarray(kern_fn(packed, perm)[0])
    ids_t = np.asarray(tiled_fn(packed, perm)[0])
    print(f"raster blocks equal: {np.array_equal(ids_k, ids_t)} "
          f"(mismatched samples {(ids_k != ids_t).sum()} of "
          f"{(ids_t >= 0).sum()} covered)", flush=True)

    res = {"kernel": [], "tiled": []}
    for r in range(args.reps):
        order = ("kernel", "tiled") if r % 2 == 0 else ("tiled", "kernel")
        for name in order:
            fn = kern_fn if name == "kernel" else tiled_fn
            res[name] += _timed(stage(fn), 3)
    for name, ts in res.items():
        print(f"stage raster {name}: median {np.median(ts):.3f} ms "
              f"min {np.min(ts):.3f} ms over {len(ts)} | {card}", flush=True)

    prog_t = PallasFrameProgram(meta, config)
    prog_t._raster = tiled_fn

    def frames(prog, n):
        prog(scene, vp, pos).block_until_ready()
        t0 = time.perf_counter()
        acc = jnp.zeros((), jnp.int32)
        for _ in range(n):
            acc = acc + prog(scene, vp, pos)[0, 0, 0].astype(jnp.int32)
        acc.block_until_ready()
        return (time.perf_counter() - t0) * 1e3 / n

    t0 = time.time()
    a = np.asarray(prog_k(scene, vp, pos))
    b = np.asarray(prog_t(scene, vp, pos))
    print(f"frames compiled in {time.time() - t0:.1f}s; frames equal: "
          f"{np.array_equal(a, b)}", flush=True)
    fr = {"kernel": [], "tiled": []}
    for r in range(args.reps):
        order = ("kernel", "tiled") if r % 2 == 0 else ("tiled", "kernel")
        for name in order:
            fr[name].append(frames(prog_k if name == "kernel" else prog_t,
                                   args.frames))
    for name, ts in fr.items():
        print(f"frame with {name} raster: median {np.median(ts):.3f} ms/frame "
              f"(runs {[round(t, 3) for t in ts]}) | {card}", flush=True)

    if args.sweep:
        from vktf.ops.raster_pallas import stream_perm

        for chunk in (64, 128, 256):
            perm_c = jax.jit(lambda p, c=chunk: stream_perm(p, chunk=c))(
                packed)
            for tile in ((16, 32), (8, 32), (16, 64), (32, 32), (32, 64)):
                tph = -(-height // tile[0]) * tile[0]
                tpw = -(-width // tile[1]) * tile[1]
                for warps in (2, 4, 8):
                    fn = jax.jit(lambda s, p, tile=tile, chunk=chunk,
                                 warps=warps: rasterize_pallas(
                        s, tph, tpw, tile_shape=tile, msaa_samples=msaa,
                        chunk=chunk, num_warps=warps, sort="none", perm=p,
                        assemble=False))

                    def go(fn=fn):
                        fn(packed, perm_c)[1].block_until_ready()

                    try:
                        go()
                    except Exception as exc:  # report and go on
                        print(f"sweep tile={tile} chunk={chunk} "
                              f"warps={warps}: FAILED {type(exc).__name__}: "
                              f"{str(exc)[:200]}", flush=True)
                        continue
                    ts = _timed(go, 5)
                    print(f"sweep tile={tile} chunk={chunk} warps={warps}: "
                          f"median {np.median(ts):.3f} ms", flush=True)

    if args.trace:
        for _ in range(3):
            prog_k(scene, vp, pos).block_until_ready()
        jax.profiler.start_trace(args.trace)
        for _ in range(5):
            prog_k(scene, vp, pos).block_until_ready()
        jax.profiler.stop_trace()
        for line in device_time_by_program(args.trace, frames=5):
            print(f"trace {line} | {card}", flush=True)
        # the shade stage's bytes, from XLA's cost analysis of its program
        setup, lights = prog_k._prepare(scene, vp, pos)
        tri_id, depth = prog_k._raster(setup, perm)
        table = prog_k._table(setup, scene)
        cost = prog_k._shade.lower(tri_id, depth, table, scene, lights,
                                   pos).compile().cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost
        print(f"shade program cost analysis: bytes accessed "
              f"{cost.get('bytes accessed')} flops {cost.get('flops')}",
              flush=True)
    return 0


def device_time_by_program(trace_dir, frames):
    """Reduce a profiler trace to per-frame device time per jitted program
    (the "hlo_module" stat of each kernel event on a GPU plane's streams),
    the top kernels, and the device busy share of the traced window."""
    import glob

    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    out = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        modules, kernels, spans, shown = {}, {}, [], 0
        for line in plane.lines:
            for e in line.events:
                stats = {}
                try:
                    stats = {k: v for k, v in e.stats}
                except (AttributeError, TypeError, ValueError):
                    pass
                if shown < 3:
                    out.append(f"sample event {e.name!r} stats {stats}")
                    shown += 1
                mod = str(stats.get("hlo_module", "?"))
                modules[mod] = modules.get(mod, 0.0) + e.duration_ns
                kernels[e.name] = kernels.get(e.name, 0.0) + e.duration_ns
                if "Memcpy" not in line.name:
                    spans.append((e.start_ns, e.start_ns + e.duration_ns))
        out.append(f"{plane.name} lines: {[l.name for l in plane.lines]}")
        for key, ns in sorted(modules.items(), key=lambda kv: -kv[1]):
            out.append(f"module {key}: {ns / frames / 1e6:.3f} ms/frame")
        for key, ns in sorted(kernels.items(), key=lambda kv: -kv[1])[:15]:
            out.append(f"kernel {key}: {ns / frames / 1e6:.3f} ms/frame")
        if spans:
            spans.sort()
            busy, end = 0.0, spans[0][0]
            for a, b in spans:
                if b > end:
                    busy += b - max(a, end)
                    end = b
            window = spans[-1][1] - spans[0][0]
            out.append(f"busy {busy / 1e6:.3f} ms of {window / 1e6:.3f} ms "
                       f"window (idle share {1 - busy / window:.3f})")
    return out


if __name__ == "__main__":
    sys.exit(main())
