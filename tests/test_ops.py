"""Kernel parity: jnp implementations must be bit-exact vs the golden numpy
oracles, across all sparsity classes, interpolation modes, and edge seams."""

import numpy as np
import pytest

from h263_tpu.ops.deblock import deblock_jnp, golden_deblock
from h263_tpu.ops.idct import (
    derive_classes_jnp,
    golden_classes,
    golden_idct_block,
    golden_idct_channel,
    golden_idct_dense,
    idct_residual_dense_jnp,
    idct_residual_jnp,
)
from h263_tpu.ops.mocomp import (
    chroma_mv_jnp,
    gather_plane_jnp,
    golden_gather_plane,
)
from h263_tpu.ops.yuv import golden_yuv420_to_rgba, yuv420_to_rgba_jnp
from h263_tpu.types import (
    BLOCK_CLASS_DC,
    BLOCK_CLASS_FULL,
    BLOCK_CLASS_VERT,
    BLOCK_CLASS_ZERO,
    halfpel_average_sum_of_mvs,
)

rng = np.random.default_rng(1234)


def _random_blocks(n, block_class):
    coeffs = np.zeros((n, 8, 8), dtype=np.float32)
    if block_class == BLOCK_CLASS_DC:
        coeffs[:, 0, 0] = rng.integers(-2048, 2048, n)
    elif block_class == BLOCK_CLASS_VERT:
        coeffs[:, :, 0] = rng.integers(-2048, 2048, (n, 8))
    elif block_class == BLOCK_CLASS_FULL:
        coeffs[:] = rng.integers(-2048, 2048, (n, 8, 8))
    return coeffs


class TestIdct:
    @pytest.mark.parametrize("block_class", [
        BLOCK_CLASS_ZERO, BLOCK_CLASS_DC, BLOCK_CLASS_VERT, BLOCK_CLASS_FULL])
    def test_jnp_matches_golden(self, block_class):
        n = 32
        coeffs = _random_blocks(n, block_class)
        classes = np.full(n, block_class, dtype=np.int8)
        got = np.asarray(idct_residual_jnp(
            coeffs.reshape(1, n, 8, 8), classes.reshape(1, n)))[0]
        for i in range(n):
            want = golden_idct_block(coeffs[i], block_class)
            np.testing.assert_array_equal(got[i], want)

    def test_horiz_pattern_through_full_path(self):
        """Row-0-only blocks (the reference's Horiz class) must work via FULL."""
        n = 16
        coeffs = np.zeros((n, 8, 8), dtype=np.float32)
        coeffs[:, 0, :] = rng.integers(-2048, 2048, (n, 8))
        classes = np.full(n, BLOCK_CLASS_FULL, dtype=np.int8)
        got = np.asarray(idct_residual_jnp(
            coeffs.reshape(1, n, 8, 8), classes.reshape(1, n)))[0]
        for i in range(n):
            want = golden_idct_block(coeffs[i], BLOCK_CLASS_FULL)
            np.testing.assert_array_equal(got[i], want)
            # and every row is identical (constant down y)
            assert (want == want[0:1, :]).all()

    def test_dc_rounding_values(self):
        # dc=1024 -> trunc(128.5)=128; dc=-1024 -> -128; dc=8 -> trunc(1.5)=1
        for dc, expect in [(1024, 128), (-1024, -128), (8, 1), (-8, -1),
                           (2047, 255), (-2048, -256), (4, 1), (3, 0)]:
            c = np.zeros((8, 8), dtype=np.float32)
            c[0, 0] = dc
            out = golden_idct_block(c, BLOCK_CLASS_DC)
            assert out[0, 0] == expect, (dc, out[0, 0], expect)

    def test_channel_overhang_clipping(self):
        """Blocks overhanging the plane edge write only the in-bounds part."""
        coeffs = np.zeros((2, 2, 8, 8), dtype=np.float32)
        coeffs[:, :, 0, 0] = 1024
        classes = np.full((2, 2), BLOCK_CLASS_DC, dtype=np.int8)
        plane = np.zeros((12, 13), dtype=np.uint8)
        out = golden_idct_channel(coeffs, classes, plane)
        assert out.shape == (12, 13)
        assert (out == 128).all()


class TestGather:
    @pytest.mark.parametrize("seed", range(4))
    def test_random_mvs(self, seed):
        r = np.random.default_rng(seed)
        h, w = 32, 48
        ref = r.integers(0, 256, (h, w), dtype=np.uint8)
        nby, nbx = h // 8, w // 8
        mvs = r.integers(-32, 32, (nby, nbx, 2)).astype(np.int32)
        inter = r.random((nby, nbx)) < 0.8
        want = golden_gather_plane(ref, mvs, inter)
        got = np.asarray(gather_plane_jnp(ref, mvs, inter))
        np.testing.assert_array_equal(got, want.astype(got.dtype))

    def test_edge_clamping(self):
        """Large MVs off every edge clamp to the border pixels."""
        ref = np.arange(64, dtype=np.uint8).reshape(8, 8)
        for mv in ([-60, -60], [60, 60], [-61, 59], [63, -63]):
            mvs = np.array(mv, dtype=np.int32).reshape(1, 1, 2)
            inter = np.ones((1, 1), dtype=bool)
            want = golden_gather_plane(ref, mvs, inter)
            got = np.asarray(gather_plane_jnp(ref, mvs, inter))
            np.testing.assert_array_equal(got, want.astype(got.dtype))

    def test_halfpel_rounding(self):
        """1-D lerp rounds half UP; 2-D rounds (sum+2)>>2 once."""
        ref = np.array([[0, 1], [2, 4]], dtype=np.uint8)
        ref = np.pad(ref, ((0, 6), (0, 6)), mode="edge")
        # mv=(1,0): x interp between cols -> ceil((0+1)/2)=1 at (0,0)
        got = np.asarray(gather_plane_jnp(
            ref, np.array([[[1, 0]]], dtype=np.int32), np.ones((1, 1), bool)))
        assert got[0, 0] == 1
        # mv=(0,1): y interp -> ceil((0+2)/2)=1
        got = np.asarray(gather_plane_jnp(
            ref, np.array([[[0, 1]]], dtype=np.int32), np.ones((1, 1), bool)))
        assert got[0, 0] == 1
        # mv=(1,1): (0+1+2+4+2)//4 = 2
        got = np.asarray(gather_plane_jnp(
            ref, np.array([[[1, 1]]], dtype=np.int32), np.ones((1, 1), bool)))
        assert got[0, 0] == 2

    def test_chroma_mv_rounding(self):
        r = np.random.default_rng(7)
        mvs = r.integers(-64, 64, (5, 7, 4, 2)).astype(np.int16)
        got = np.asarray(chroma_mv_jnp(mvs))
        s = mvs.astype(np.int64).sum(axis=2)
        for i in range(5):
            for j in range(7):
                assert got[i, j, 0] == halfpel_average_sum_of_mvs(int(s[i, j, 0]))
                assert got[i, j, 1] == halfpel_average_sum_of_mvs(int(s[i, j, 1]))


class TestDeblock:
    @pytest.mark.parametrize("shape", [(16, 16), (24, 32), (17, 11),
                                       (48, 9), (8, 8), (64, 100)])
    @pytest.mark.parametrize("strength", [1, 4, 8, 12])
    def test_jnp_matches_golden(self, shape, strength):
        r = np.random.default_rng(shape[0] * 100 + strength)
        plane = r.integers(0, 256, shape, dtype=np.uint8)
        want = golden_deblock(plane, strength)
        got = np.asarray(deblock_jnp(plane, strength))
        np.testing.assert_array_equal(got, want)

    def test_constant_plane_is_noop(self):
        plane = np.full((32, 32), 77, dtype=np.uint8)
        np.testing.assert_array_equal(golden_deblock(plane, 12), plane)

    def test_narrow_plane_skips_vertical(self):
        plane = np.random.default_rng(3).integers(0, 256, (32, 9), dtype=np.uint8)
        out = golden_deblock(plane, 8)
        # width < 10: only horizontal edges filtered; columns untouched rows
        # outside edge neighborhoods stay identical
        np.testing.assert_array_equal(out[0:6], plane[0:6])


class TestYuv:
    @pytest.mark.parametrize("shape", [(16, 16), (17, 11), (2, 2), (1, 1),
                                       (9, 13), (288, 352)])
    def test_jnp_matches_golden(self, shape):
        h, w = shape
        r = np.random.default_rng(h * w)
        y = r.integers(0, 256, (h, w), dtype=np.uint8)
        cb = r.integers(0, 256, ((h + 1) // 2, (w + 1) // 2), dtype=np.uint8)
        cr = r.integers(0, 256, ((h + 1) // 2, (w + 1) // 2), dtype=np.uint8)
        want = golden_yuv420_to_rgba(y, cb, cr)
        got = np.asarray(yuv420_to_rgba_jnp(y, cb, cr))
        np.testing.assert_array_equal(got, want)

    def test_known_values(self):
        # Y=16,Cb=Cr=128 is black; Y=235 is white; alpha always 255.
        y = np.array([[16, 235]], dtype=np.uint8)
        cb = np.array([[128]], dtype=np.uint8)
        cr = np.array([[128]], dtype=np.uint8)
        out = golden_yuv420_to_rgba(y, cb, cr)
        np.testing.assert_array_equal(out[0, 0], [0, 0, 0, 255])
        np.testing.assert_array_equal(out[0, 1], [255, 255, 255, 255])
        # mid gray: Y=128 -> (128-16)*76309+32768 >> 16 = 130
        out = golden_yuv420_to_rgba(
            np.full((1, 1), 128, np.uint8), cb, cr)
        np.testing.assert_array_equal(out[0, 0], [130, 130, 130, 255])


class TestFmaContraction:
    """Regression: XLA may contract mul+add chains into FMAs (it compiles
    with allow-excess-precision), skipping the product's f32 rounding and
    flipping trunc() by one.  This block (caught by the 60-frame soak)
    yields 28 at (0,2) with reference rounding but 27 under FMA."""

    def _block(self):
        c = np.zeros((8, 8), dtype=np.int16)
        c[0, 2], c[0, 3], c[2, 2] = 735, -555, 215
        return c

    def test_golden_value(self):
        got = golden_idct_block(self._block().astype(np.float32),
                                BLOCK_CLASS_FULL)
        assert got[0, 2] == 28

    def test_jnp_vmapped_and_plain(self):
        import jax
        import jax.numpy as jnp

        c = self._block().reshape(1, 1, 8, 8)
        k = np.full((1, 1), BLOCK_CLASS_FULL, dtype=np.int8)
        plain = jax.jit(idct_residual_jnp)(c, k)
        assert np.asarray(plain)[0, 0, 0, 2] == 28
        vm = jax.jit(jax.vmap(idct_residual_jnp))(
            jnp.asarray(c)[None], jnp.asarray(k)[None])
        assert np.asarray(vm)[0, 0, 0, 0, 2] == 28

    def test_dense_path(self):
        """The dense-layout route reconstruct_from_dense and chip_smoke
        take (classes derived on device)."""
        import jax

        got = jax.jit(idct_residual_dense_jnp)(self._block().reshape(1, 64))
        assert np.asarray(got)[0].reshape(8, 8)[0, 2] == 28

    def test_golden_dense(self):
        got = golden_idct_dense(self._block().reshape(1, 64))
        assert got[0].reshape(8, 8)[0, 2] == 28


def _mixed_dense(n, seed):
    """int16 [n, 64] blocks of every class, with sparse and dense FULL."""
    r = np.random.default_rng(seed)
    d = np.zeros((n, 8, 8), dtype=np.int16)
    kind = r.integers(0, 4, n)
    for i in range(n):
        if kind[i] == BLOCK_CLASS_DC:
            d[i, 0, 0] = r.integers(-2048, 2048) or 1
        elif kind[i] == BLOCK_CLASS_VERT:
            d[i, :, 0] = r.integers(-2048, 2048, 8)
            d[i, 1, 0] = d[i, 1, 0] or 5
        elif kind[i] == BLOCK_CLASS_FULL:
            m = r.random((8, 8)) < r.random()
            m[0, 1] = True
            d[i][m] = r.integers(-2048, 2048, int(m.sum()))
            d[i, 0, 1] = d[i, 0, 1] or -7
    return d.reshape(n, 64)


class TestIdctDense:
    """The dense-layout IDCT route (int16 [..., 64] in, int16 out) and its
    vectorised numpy oracle."""

    def test_golden_dense_matches_per_block_oracle(self):
        d = _mixed_dense(200, 5)
        cls = golden_classes(d)
        want = np.stack([golden_idct_block(
            b.reshape(8, 8).astype(np.float32), int(c))
            for b, c in zip(d, cls)]).reshape(200, 64)
        np.testing.assert_array_equal(golden_idct_dense(d), want)

    def test_golden_classes_match_device_derivation(self):
        d = _mixed_dense(300, 6)
        np.testing.assert_array_equal(
            golden_classes(d), np.asarray(derive_classes_jnp(d)))

    @pytest.mark.parametrize("block_class", [
        BLOCK_CLASS_ZERO, BLOCK_CLASS_DC, BLOCK_CLASS_VERT, BLOCK_CLASS_FULL])
    def test_each_class_matches_golden(self, block_class):
        d = _mixed_dense(400, 7)
        d = d[golden_classes(d) == block_class]
        assert len(d) > 20
        got = np.asarray(idct_residual_dense_jnp(d))
        np.testing.assert_array_equal(got, golden_idct_dense(d))

    @pytest.mark.parametrize("lead", [(1,), (7,), (3, 5), (2, 1, 4)])
    def test_leading_axes(self, lead):
        n = int(np.prod(lead))
        d = _mixed_dense(n, 8 + n)
        got = np.asarray(idct_residual_dense_jnp(d.reshape(*lead, 64)))
        assert got.shape == (*lead, 64) and got.dtype == np.int16
        np.testing.assert_array_equal(got.reshape(n, 64),
                                      golden_idct_dense(d))

    def test_extremes_clip(self):
        d = np.zeros((4, 64), dtype=np.int16)
        d[0, :] = 2047
        d[1, :] = -2048
        d[2, ::9] = 2047
        d[3, 0] = -2048
        got = np.asarray(idct_residual_dense_jnp(d))
        assert got.min() >= -256 and got.max() <= 255
        np.testing.assert_array_equal(got, golden_idct_dense(d))
