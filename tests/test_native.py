"""Native runtime library vs numpy fallbacks (skipped when not built)."""

import numpy as np
import pytest
import zlib

from vktf import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built"
)


def test_mips_match_numpy_fallback(monkeypatch):
    from vktf.loaders import images

    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (64, 48, 4), np.uint8)
    got = native.generate_mips(base, True)
    # force the numpy fallback for the comparison
    monkeypatch.setattr(native, "generate_mips", lambda *a: None)
    want = images.generate_mips(base, True)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        # pow() precision differences between fast-math C and numpy
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_mip_sizes_follow_floor_rule():
    base = np.zeros((6, 3, 4), np.uint8)
    levels = native.generate_mips(base, False)
    assert [l.shape[:2] for l in levels] == [(6, 3), (3, 1), (1, 1)]


def test_block_pack_matches_numpy():
    from vktf.ops import texture_pack as tp

    rng = np.random.default_rng(5)
    for w in (16, 2, 1):
        lvls = [rng.integers(0, 2**32, (w, w), dtype=np.uint32) for _ in range(3)]
        w1 = max(w >> 1, 1)
        nxt = [rng.integers(0, 2**32, (w1, w1), dtype=np.uint32)
               for _ in range(3)]
        for wraps in ([(0, 0)] * 3, [(1, 2), (0, 0), (2, 1)],
                      [(2, 1), (1, 0), (0, 2)]):
            # fused-mip row: slot A from lvls, slot B from the next level
            got = native.pack_blocks_level(lvls, nxt, wraps)
            want = tp._pack_blocks_level_np(lvls, w, wraps, nxt)
            np.testing.assert_array_equal(got, want)
            # last level: slot B stays zero
            got = native.pack_blocks_level(lvls, None, wraps)
            want = tp._pack_blocks_level_np(lvls, w, wraps, None)
            np.testing.assert_array_equal(got, want)
            assert (want[:, tp.SLOT_U32:tp.BLOCK_U32] == 0).all()


def test_accessor_unpack_normalized():
    rng = np.random.default_rng(7)
    arr = rng.integers(-128, 128, (100, 3)).astype(np.int8)
    out = native.unpack_accessor(arr.tobytes(), 100, 3, 5120, True, 3)
    np.testing.assert_allclose(
        out, np.maximum(arr.astype(np.float32) / 127.0, -1.0), atol=1e-6
    )
    # strided uint16, unnormalized
    data = np.zeros((10, 4), np.uint16)
    data[:, :2] = rng.integers(0, 65535, (10, 2))
    out = native.unpack_accessor(data.tobytes(), 10, 2, 5123, False, 8)
    np.testing.assert_allclose(out, data[:, :2].astype(np.float32))


def test_inflate_roundtrip():
    rng = np.random.default_rng(9)
    blob = rng.integers(0, 256, 10000, np.uint8).tobytes()
    assert native.inflate_zlib(zlib.compress(blob), len(blob)) == blob
    import zstandard

    compressed = zstandard.ZstdCompressor().compress(blob)
    assert native.decompress_zstd(compressed, len(blob)) == blob
