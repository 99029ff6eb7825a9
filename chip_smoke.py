#!/usr/bin/env python
"""Smoke test of the production frame path on a GPU.

    python chip_smoke.py          # one card: device, raster parity, oracle,
                                  # end to end
    python chip_smoke.py --mesh   # four cards: the sharded frame on (2,2)
                                  # and (4,1) meshes vs the single card

Runs in one process and stops at the first failed phase (the exception
propagates; the exit code is non-zero). Each phase prints what it found.
Only when every phase passed, the last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

It refuses to run without a GPU, and outside a checkout of the repository
(the renderer package must be importable).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np

# sponza at the north-star size (BASELINE.json): 1080p, 4x MSAA, full PBR
WIDTH, HEIGHT, MSAA = 1920, 1080, 4
E2E_FRAMES = 30
PRESET_FRAMES = 3
# raster parity. Triton and XLA's fusions contract the plane evaluations
# a*dx + b*dy + c into fused multiply-adds differently, so depths may
# differ in the last bits, and a sample sitting within such an ULP of an
# edge or of a depth tie can change its winning triangle. Allow at most
# this fraction of covered samples with another triangle id, and depths
# (in [0, 1]) at most DEPTH_ULP_TOL apart.
RASTER_MISMATCH_TOL = 1e-4
DEPTH_ULP_TOL = 1e-6
# the golden tolerance of tests/test_golden.py (mean |d| in u8 steps, and
# the fraction of pixels off by more than OUTLIER_STEP)
GOLDEN_MAX_MEAN, GOLDEN_MAX_OUTLIERS, OUTLIER_STEP = 2.5, 0.02, 8


def say(phase: str, **found) -> None:
    """One line of findings for a phase."""
    parts = " ".join(f"{k}={v}" for k, v in found.items())
    print(f"[{phase}] {parts}", flush=True)


def result_line(devices) -> str:
    """The JSON object printed as the last line on success."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }})


def _compile_stats(compiled) -> dict:
    mem = compiled.memory_analysis()
    if mem is None:
        return {"memory_analysis": None}
    return {k: getattr(mem, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(mem, k)}


def _sponza(width=WIDTH, height=HEIGHT):
    from bench import CAMERAS
    from vktf.mathx import Camera, ViewFrustumParams
    from vktf.models.scenes import build_preset

    position, direction = CAMERAS["sponza"]
    camera = Camera(position, direction, ViewFrustumParams(
        np.radians(45.0), width / height, 0.1, 1.0e6))
    return build_preset("sponza"), camera


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(expect_count: int) -> list:
    import jax

    from vktf import native
    from vktf.runtime import enable_persistent_cache
    from vktf.utils.device_info import nvidia_smi_name_power

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(f"[device] no GPU: JAX platform is {platform!r}")
    if len(devices) < expect_count:
        raise SystemExit(f"[device] need {expect_count} GPUs, have "
                         f"{len(devices)}")
    say("device", platform=platform, kind=repr(devices[0].device_kind),
        count=len(devices), jax=jax.__version__,
        xla_flags=repr(os.environ.get("XLA_FLAGS", "")),
        compile_cache=enable_persistent_cache(),
        native_host_library=native.available())
    smi = nvidia_smi_name_power()
    if smi is None:
        raise SystemExit("[device] nvidia-smi gave no card name/power limit")
    say("device", nvidia_smi=repr(smi))
    return devices[:expect_count]


def raster_parity(asset, camera, width, height, msaa, *, interpret=False):
    """Compile the raster kernel and compare its visibility buffer with
    rasterize_tiled on the same setup — the packed setup and stream order
    the frame program feeds the kernel. Returns the findings dict."""
    import jax

    from vktf.config import RenderConfig
    from vktf.ops.binning import bin_triangles
    from vktf.ops.pipeline import PallasFrameProgram
    from vktf.ops.raster_pallas import rasterize_pallas
    from vktf.ops.raster_tiled import rasterize_tiled, setup_from_packed
    from vktf.scene.flatten import flatten_assets

    scene, meta, _aux = flatten_assets(asset)
    config = RenderConfig(width=width, height=height, msaa_samples=msaa,
                          backend="pallas", pallas_interpret=interpret)
    vp, pos = camera.view_projection_transform, camera.position
    program = PallasFrameProgram(meta, config)
    packed, _lights = program._prepare(scene, vp, pos)
    perm = program._maybe_resort(packed, vp)
    setup = jax.jit(setup_from_packed)(packed)
    ph, pw = config.padded_height, config.padded_width
    tiled_tile = (32, 128)
    tph = -(-ph // tiled_tile[0]) * tiled_tile[0]
    tpw = -(-pw // tiled_tile[1]) * tiled_tile[1]
    ty, tx = tph // tiled_tile[0], tpw // tiled_tile[1]

    # the comparator must drop nothing: raise its bin capacities until the
    # binning reports zero overflow
    capacity, large_capacity = 4096, 4096
    while True:
        bins = jax.jit(lambda b, v: bin_triangles(
            b, v, tile_shape=tiled_tile, tiles_y=ty, tiles_x=tx,
            capacity=capacity, k_pairs=8, large_capacity=large_capacity,
        ))(setup["bbox"], setup["valid"])
        worst = int(np.asarray(bins.bin_counts).max())
        large = int(np.asarray(bins.large_count))
        if worst <= capacity and large <= large_capacity:
            break
        capacity = max(capacity, 1 << int(np.ceil(np.log2(max(worst, 1)))))
        large_capacity = max(large_capacity,
                             1 << int(np.ceil(np.log2(max(large, 1)))))
    drops = max(worst - capacity, 0) + max(large - large_capacity, 0)

    pallas_fn = jax.jit(lambda s, p: rasterize_pallas(
        s, ph, pw, tile_shape=config.tile_shape, msaa_samples=msaa,
        chunk=config.pallas_chunk, interpret=interpret, sort="none",
        perm=p))
    tiled_fn = jax.jit(lambda s, b: rasterize_tiled(
        s, tph, tpw, tile_shape=tiled_tile, bin_capacity=capacity,
        large_capacity=large_capacity, msaa_samples=msaa, bins=b))
    t0 = time.time()
    pallas_c = pallas_fn.lower(packed, perm).compile()
    compile_s = time.time() - t0
    tiled_c = tiled_fn.lower(setup, bins).compile()
    ids_p, dep_p = (np.asarray(a) for a in pallas_c(packed, perm))
    ids_t, dep_t = (np.asarray(a)[:, :ph, :pw]
                    for a in tiled_c(setup, bins))
    covered = int((ids_t >= 0).sum())
    mismatched = int((ids_p != ids_t).sum())
    same = ids_p == ids_t
    return dict(
        triangles=meta.num_triangles, samples=ids_t.size, covered=covered,
        bin_capacity=capacity, large_capacity=large_capacity,
        binning_drops=drops, mismatched=mismatched,
        mismatch_frac=mismatched / max(covered, 1),
        depth_only_differences=int((same & (dep_p != dep_t)).sum()),
        max_depth_diff=float(np.abs(dep_p - dep_t)[same].max(initial=0.0)),
        kernel_compile_s=round(compile_s, 2),
        raster_kernel_memory=_compile_stats(pallas_c),
        raster_tiled_memory=_compile_stats(tiled_c),
    )


def golden_scene():
    """The scene of tests/test_golden_production.py (textured box, shiny
    sphere, a BLEND plane for the depth peel, floor, point + directional
    light), with its checker texture carried as KTX2 instead of PNG."""
    import tempfile

    from vktf.loaders.gltf import load_gltf
    from vktf.loaders.images import generate_mips
    from vktf.loaders.ktx import SUPERCOMPRESSION_ZLIB, encode_ktx2
    from vktf.mathx import Camera, ViewFrustumParams
    from vktf.models.gltf_writer import GltfWriter
    from vktf.models.primitives import box_mesh, plane_mesh, uv_sphere_mesh

    checker = np.zeros((16, 16, 4), np.uint8)
    yy, xx = np.mgrid[0:16, 0:16]
    mask = ((xx // 4) + (yy // 4)) % 2 == 0
    checker[mask], checker[~mask] = (220, 40, 40, 255), (40, 40, 220, 255)
    w = GltfWriter()
    img = w.add_image_bytes(
        encode_ktx2(generate_mips(checker, True), True,
                    SUPERCOMPRESSION_ZLIB), "image/ktx2")
    tex = w.add_texture(img, w.add_sampler())
    textured = w.add_material(base_color_factor=(1.0, 1.0, 1.0, 1.0),
                              base_color_texture=tex, metallic_factor=0.1,
                              roughness_factor=0.6)
    shiny = w.add_material(base_color_factor=(0.2, 0.4, 0.9, 1.0),
                           metallic_factor=0.9, roughness_factor=0.25)
    blend = w.add_material(base_color_factor=(0.9, 0.3, 0.2, 0.45),
                           metallic_factor=0.0, roughness_factor=0.5,
                           alpha_mode="BLEND")
    floor = w.add_material(base_color_factor=(0.5, 0.5, 0.45, 1.0),
                           roughness_factor=0.9)
    w.add_scene([
        w.add_node(mesh=w.add_mesh(box_mesh(0.5), material=textured),
                   translation=(-0.45, 0.25, 0.0),
                   rotation=(0.0, 0.2588, 0.0, 0.9659)),
        w.add_node(mesh=w.add_mesh(uv_sphere_mesh(0.3, rings=16, sectors=32),
                                   material=shiny),
                   translation=(0.5, 0.3, 0.2)),
        w.add_node(mesh=w.add_mesh(plane_mesh(0.8), material=blend),
                   translation=(0.0, 0.4, 0.8),
                   rotation=(0.7071068, 0.0, 0.0, 0.7071068)),
        w.add_node(mesh=w.add_mesh(plane_mesh(4.0), material=floor)),
        w.add_node(light=w.add_light("point", color=(5.0, 5.0, 5.0)),
                   translation=(1.5, 2.0, 2.0)),
        w.add_node(light=w.add_light("directional", color=(0.8, 0.8, 0.7)),
                   rotation=(0.3827, 0.0, 0.0, 0.9239)),
    ])
    with tempfile.TemporaryDirectory() as td:
        asset = load_gltf(w.write(os.path.join(td, "golden.gltf")))
    camera = Camera((0.0, 0.7, 2.4), (0.0, -0.25, -1.0),
                    ViewFrustumParams(np.radians(45.0), 2.0, 0.1, 100.0))
    return asset, camera


def oracle_check(asset, camera, *, interpret=None):
    """Render the golden scene through the production frame path and the
    numpy oracle; returns the findings dict."""
    from vktf.config import RenderConfig
    from vktf.ops.pipeline import make_frame_fn
    from vktf.ops.raster_xla import SAMPLE_OFFSETS
    from vktf.ops.reference import ReferenceScene, render_reference
    from vktf.scene.flatten import flatten_assets

    scene, meta, aux = flatten_assets([asset])
    width, height = 256, 128
    config = RenderConfig(width=width, height=height, msaa_samples=4,
                          backend="pallas", pallas_interpret=interpret,
                          tile_shape=(32, 64), pallas_chunk=128)
    vp, pos = camera.view_projection_transform, camera.position
    produced = np.moveaxis(
        np.asarray(make_frame_fn(meta, config)(scene, vp, pos)), 0, -1)
    tex_meta = [dict(sampler, srgb=t.srgb)
                for t, sampler in aux["texture_entries"]]
    reference = ReferenceScene(
        scene, meta, [t.levels for t, _ in aux["texture_entries"]], tex_meta)
    expected = render_reference(reference, vp, pos, width, height,
                                SAMPLE_OFFSETS[4],
                                max_anisotropy=config.max_anisotropy)
    diff = np.abs(produced[..., :3].astype(int)
                  - expected[..., :3].astype(int))
    return dict(
        peel_layers=meta.peel_layers, mean_abs=float(diff.mean()),
        max_abs=int(diff.max()),
        outlier_frac=float((diff.max(axis=-1) > OUTLIER_STEP).mean()),
        lit=int(produced[..., :3].max()),
    )


def render_frames(scene, frames: int, depth: int = 2) -> tuple:
    """Render `frames` frames with camera motion, `depth` in flight, each
    materialized to host. Returns (median ms/frame, last frame)."""
    in_flight, presents, last = [], [], None
    for _ in range(frames):
        scene.camera.rotate(0.0, 0.002)
        frame = scene.render_async()
        frame.copy_to_host_async()
        in_flight.append(frame)
        if len(in_flight) >= depth:
            last = np.asarray(in_flight.pop(0))
            presents.append(time.perf_counter())
    for frame in in_flight:
        last = np.asarray(frame)
        presents.append(time.perf_counter())
    return float(np.median(np.diff(presents))) * 1e3, last


def end_to_end(asset, camera, config, frames: int, mesh=None) -> dict:
    """Scene -> compile (first frame) -> `frames` frames. Asserts the
    frames are not blank."""
    from vktf.scene.scene import Scene

    t0 = time.time()
    scene = Scene(asset, config, camera=camera, mesh=mesh)
    build_s = time.time() - t0
    t0 = time.time()
    first = np.asarray(scene.render_async())
    compile_s = time.time() - t0
    ms, last = render_frames(scene, frames)
    lit = float((last.max(axis=0) > 0).mean())
    assert first.shape == last.shape
    assert lit > 0.05, f"frame is blank ({lit:.3%} lit pixels)"
    return dict(triangles=scene.meta.num_triangles, build_s=round(build_s, 2),
                compile_s=round(compile_s, 2), ms_per_frame=round(ms, 3),
                lit_frac=round(lit, 4), shape=tuple(last.shape))


def _peak_bytes(device) -> int | None:
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def phase_raster():
    asset, camera = _sponza()
    found = raster_parity(asset, camera, WIDTH, HEIGHT, MSAA)
    say("raster", **found)
    assert found["binning_drops"] == 0
    assert found["covered"] > 0.5 * found["samples"], "raster covered little"
    assert found["mismatch_frac"] <= RASTER_MISMATCH_TOL, found
    assert found["max_depth_diff"] <= DEPTH_ULP_TOL, found


def phase_oracle():
    asset, camera = golden_scene()
    found = oracle_check(asset, camera)
    say("oracle", **found)
    assert found["lit"] > 40
    assert found["mean_abs"] <= GOLDEN_MAX_MEAN, found
    assert found["outlier_frac"] <= GOLDEN_MAX_OUTLIERS, found


def phase_end_to_end(device):
    from bench import CAMERAS, CONFIGS
    from vktf.config import RenderConfig
    from vktf.mathx import Camera, ViewFrustumParams
    from vktf.models.scenes import build_preset

    asset, camera = _sponza()
    config = RenderConfig(width=WIDTH, height=HEIGHT, msaa_samples=MSAA)
    found = end_to_end(asset, camera, config, E2E_FRAMES)
    say("end_to_end", preset="sponza", backend=config.resolved_backend(),
        frames=E2E_FRAMES, frames_in_flight=2, **found,
        peak_bytes_in_use=_peak_bytes(device))
    # every other bench shape must compile and render here first
    jobs = [(p, 1) for p in sorted(CONFIGS) if p != "sponza"]
    jobs.append(("sponza", 2))
    for preset, taps in jobs:
        _, width, height, msaa = CONFIGS[preset]
        position, direction = CAMERAS[preset]
        cam = Camera(position, direction, ViewFrustumParams(
            np.radians(45.0), width / height, 0.1, 1.0e6))
        cfg = RenderConfig(width=width, height=height, msaa_samples=msaa,
                           aniso_taps=taps)
        found = end_to_end(build_preset(preset), cam, cfg, PRESET_FRAMES)
        say("end_to_end", preset=preset, size=f"{width}x{height}",
            msaa=msaa, aniso_taps=taps, **found,
            peak_bytes_in_use=_peak_bytes(device))


def phase_mesh(devices, asset=None, camera=None, config=None,
               shapes=((2, 2), (4, 1))):
    """The sharded frame on (gp, sp) meshes, (2,2) and (4,1) by default,
    vs the single card (sponza at the north-star size unless a scene is
    given)."""
    from vktf.config import RenderConfig
    from vktf.parallel import make_render_mesh
    from vktf.scene.scene import Scene

    if asset is None:
        asset, camera = _sponza()
        config = RenderConfig(width=WIDTH, height=HEIGHT, msaa_samples=MSAA)
    # every Scene gets its own copy: render_frames moves the camera
    single_scene = Scene(asset, config, camera=copy.deepcopy(camera))
    single = np.asarray(single_scene.render_async())
    say("mesh", reference="single card", device=str(devices[0]),
        lit_frac=round(float((single.max(axis=0) > 0).mean()), 4))
    for gp, sp in shapes:
        mesh = make_render_mesh(devices[:gp * sp], gp=gp, sp=sp)
        t0 = time.time()
        scene = Scene(asset, config, camera=copy.deepcopy(camera), mesh=mesh)
        frame = np.asarray(scene.render_async())
        compile_s = time.time() - t0
        ms, _last = render_frames(scene, PRESET_FRAMES)
        diff = int((frame != single).sum())
        say("mesh", gp=gp, sp=sp, compile_s=round(compile_s, 2),
            ms_per_frame=round(ms, 3), differing_bytes=diff,
            bit_equal=diff == 0)
        assert diff == 0, f"mesh ({gp},{sp}) differs from the single card"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--mesh", action="store_true",
                        help="four cards: the sharded frame on (2,2) and "
                             "(4,1) meshes vs the single card, no other "
                             "phase")
    args = parser.parse_args(argv)

    import jax

    events = {"hits": 0, "misses": 0}

    def on_event(name, **_kw):
        if name == "/jax/compilation_cache/cache_hits":
            events["hits"] += 1
        elif name == "/jax/compilation_cache/cache_misses":
            events["misses"] += 1

    jax.monitoring.register_event_listener(on_event)
    t0 = time.time()
    devices = phase_device(4 if args.mesh else 1)
    if args.mesh:
        phase_mesh(devices)
    else:
        phase_raster()
        phase_oracle()
        phase_end_to_end(devices[0])
    from vktf.runtime.cache import cache_dir_setting
    from vktf.utils.device_info import nvidia_smi_name_power

    say("compile_cache", dir=cache_dir_setting(), hits=events["hits"],
        misses=events["misses"], wall_s=round(time.time() - t0, 1))
    print(nvidia_smi_name_power(), flush=True)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
