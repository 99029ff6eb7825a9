"""Material-pool HBM budget clamp (graceful degradation, not failure).

The packed pool inflates raw RGBA ~5.3x; a real Sponza-scale texture set
(dozens of 1-2K chains) could exceed device memory or the 2^24 f32-exact
row ceiling. build_material_pool must then DOWNSAMPLE the largest chains with
a logged error — the reference's device-limit-clamp ethos
(engine.cppm:157-199) — instead of raising.
"""

import io

import numpy as np

from vktf.loaders.images import TextureData, generate_mips
from vktf.log import Log
from vktf.ops.texture_pack import ROW_U32, build_material_pool


def _tex(size: int, srgb: bool = False) -> TextureData:
    rng = np.random.default_rng(size)
    base = rng.integers(0, 255, (size, size, 4), dtype=np.uint8)
    return TextureData(levels=generate_mips(base, srgb), srgb=srgb)


def test_pool_budget_clamps_largest_chains():
    out, err = io.StringIO(), io.StringIO()
    log = Log(out_stream=out, err_stream=err)
    mats = [
        {"base": _tex(64), "mr": _tex(64), "normal": _tex(64), "sampler": {}},
        {"base": _tex(8), "mr": _tex(8), "normal": _tex(8), "sampler": {}},
    ]
    # unbudgeted: 64px chain -> 32*32 + ... block rows
    full = build_material_pool(mats)
    # budget that forces the 64px chain down but leaves the 8px one alone
    budget_rows = 600
    pool = build_material_pool(mats, log, max_pool_bytes=budget_rows * 4 * ROW_U32)
    assert pool.quads.shape[0] <= budget_rows
    assert pool.quads.shape[0] < full.quads.shape[0]
    assert pool.width0[0] < 64  # the big chain shrank
    assert pool.width0[1] == 8  # the small one did not
    assert "over budget" in err.getvalue()
    # chain metadata stays self-consistent: rows monotone, widths pow2
    assert pool.base_row[1] > pool.base_row[0]
    assert (pool.width0 & (pool.width0 - 1)).max() == 0


def test_pool_unbudgeted_unchanged():
    out, err = io.StringIO(), io.StringIO()
    log = Log(out_stream=out, err_stream=err)
    mats = [{"base": _tex(32), "mr": _tex(32), "normal": _tex(32),
             "sampler": {}}]
    pool = build_material_pool(mats, log)
    assert pool.width0[0] == 32
    assert "over budget" not in err.getvalue()

def test_pool_budget_exact_fit_unchanged():
    """A budget that exactly fits the packed pool clamps nothing: pool size
    is bounded by the byte budget (device memory) and the f32-exact row
    ceiling alone."""
    out, err = io.StringIO(), io.StringIO()
    log = Log(out_stream=out, err_stream=err)
    mats = [
        {"base": _tex(64), "mr": _tex(64), "normal": _tex(64), "sampler": {}},
        {"base": _tex(8), "mr": _tex(8), "normal": _tex(8), "sampler": {}},
    ]
    full = build_material_pool(mats, log)
    rows = full.quads.shape[0]
    pool = build_material_pool(mats, log, max_pool_bytes=rows * 4 * ROW_U32)
    assert pool.quads.shape[0] == rows
    np.testing.assert_array_equal(pool.width0, full.width0)
    assert "over budget" not in err.getvalue()
