"""Image-op unit tests: the ``ops`` entry points vs their pure-jnp twins
and numpy models of the reference-C semantics, at odd sizes and RGBA."""

import numpy as np
import pytest

from openmp_parallel_computing_tpu import ops
from openmp_parallel_computing_tpu.ops import xla_ref


def np_grayscale(img):
    """Numpy model of the framework's canonical fixed-point luma."""
    r, g, b = (img[i].astype(np.int64) for i in range(3))
    lum = ((19595 * r + 38470 * g + 7471 * b) >> 16).astype(np.uint8)
    out = img.copy()
    out[0] = out[1] = out[2] = lum
    return out


def np_grayscale_c(img):
    """Numpy model of the reference C kernel's f32 luma (truncating cast),
    parallel_to_grayscale.c:13 — used for the +-1 parity bound."""
    r, g, b = (img[i].astype(np.float32) for i in range(3))
    lum = (np.float32(0.299) * r + np.float32(0.587) * g
           + np.float32(0.114) * b).astype(np.uint8)
    out = img.copy()
    out[0] = out[1] = out[2] = lum
    return out


def np_sobel(gray):
    h, w = gray.shape
    out = np.zeros((h, w), np.uint8)
    g = gray.astype(np.int64)
    for y in range(1, h - 1):
        for x in range(1, w - 1):
            gx = (-g[y-1, x-1] - 2*g[y, x-1] - g[y+1, x-1]
                  + g[y-1, x+1] + 2*g[y, x+1] + g[y+1, x+1])
            gy = (g[y-1, x-1] + 2*g[y-1, x] + g[y-1, x+1]
                  - g[y+1, x-1] - 2*g[y+1, x] - g[y+1, x+1])
            mag = int(np.sqrt(np.float32(gx*gx + gy*gy)))
            out[y, x] = min(mag, 255)
    return out


class TestGrayscale:
    def test_twin_matches_numpy(self, small_rgb):
        np.testing.assert_array_equal(
            np.asarray(xla_ref.grayscale(small_rgb)), np_grayscale(small_rgb))

    def test_within_1_of_c_float_luma(self, small_rgb):
        """Canonical fixed-point luma stays within +-1 u8 of the reference
        C kernel's float computation (the agreed parity tolerance)."""
        ours = np_grayscale(small_rgb).astype(np.int32)
        cref = np_grayscale_c(small_rgb).astype(np.int32)
        assert np.abs(ours - cref).max() <= 1

    def test_gray_input_fixed_point(self):
        """r==g==b==k must map to exactly k (weights sum to 2^16)."""
        k = np.arange(256, dtype=np.uint8)
        img = np.broadcast_to(k, (3, 2, 256)).copy()
        got = np.asarray(xla_ref.grayscale(img))
        np.testing.assert_array_equal(got[0], img[0])

    def test_pallas_matches_twin(self, small_rgb):
        got = np.asarray(ops.grayscale(small_rgb))
        want = np.asarray(xla_ref.grayscale(small_rgb))
        np.testing.assert_array_equal(got, want)

    def test_alpha_preserved(self, small_rgba):
        got = np.asarray(ops.grayscale(small_rgba))
        np.testing.assert_array_equal(got[3], small_rgba[3])
        want = np.asarray(xla_ref.grayscale(small_rgba))
        np.testing.assert_array_equal(got, want)

    def test_idempotent(self, small_rgb):
        once = np.asarray(ops.grayscale(small_rgb))
        twice = np.asarray(ops.grayscale(once))
        np.testing.assert_array_equal(once, twice)

    def test_unaligned_shapes(self, rng):
        img = rng.integers(0, 256, size=(3, 37, 131), dtype=np.uint8)
        np.testing.assert_array_equal(
            np.asarray(ops.grayscale(img)), np.asarray(xla_ref.grayscale(img)))


class TestSobel:
    def test_twin_matches_numpy(self, small_gray):
        np.testing.assert_array_equal(
            np.asarray(xla_ref.sobel(small_gray)), np_sobel(small_gray))

    def test_pallas_matches_twin(self, small_gray):
        got = np.asarray(ops.sobel(small_gray))
        want = np.asarray(xla_ref.sobel(small_gray))
        np.testing.assert_array_equal(got, want)

    def test_border_zero(self, small_gray):
        got = np.asarray(ops.sobel(small_gray))
        assert got[0].max() == 0 and got[-1].max() == 0
        assert got[:, 0].max() == 0 and got[:, -1].max() == 0

    def test_multi_strip(self, rng):
        # Tall, odd-width plane against the numpy model of the C stencil.
        img = rng.integers(0, 256, size=(200, 131), dtype=np.uint8)
        got = np.asarray(ops.sobel(img))
        np.testing.assert_array_equal(got, np_sobel(img))

    def test_constant_image_no_edges(self):
        img = np.full((64, 128), 77, np.uint8)
        assert np.asarray(ops.sobel(img)).max() == 0

    def test_border_none_zero_out_of_plane(self, rng):
        """border="none" computes every row as interior with ZERO
        out-of-plane neighbors — the first/last row must not wrap the
        opposite edge row in as a neighbor."""
        img = rng.integers(1, 256, size=(96, 128), dtype=np.uint8)
        got = np.asarray(ops.sobel(img, border="none"))
        # expected: interior stencil of the zero-padded plane, all rows
        padded = np.zeros((98, 130), np.uint8)
        padded[1:-1, 1:-1] = img
        want = np.asarray(xla_ref.sobel(padded))[1:-1, 1:-1]
        np.testing.assert_array_equal(got, want)


class TestEdgePipeline:
    def test_pallas_matches_twin(self, small_rgb):
        got = np.asarray(ops.edge_pipeline(small_rgb))
        want = np.asarray(xla_ref.edge_pipeline(small_rgb))
        np.testing.assert_array_equal(got, want)

    def test_matches_staged(self, small_rgb):
        """Fused kernel == grayscale -> extract -> sobel -> broadcast."""
        staged_gray = np.asarray(ops.grayscale(small_rgb))
        staged_edge = np.asarray(ops.sobel(staged_gray[0]))
        fused = np.asarray(ops.edge_pipeline(small_rgb))
        np.testing.assert_array_equal(fused[0], staged_edge)
        np.testing.assert_array_equal(fused[1], staged_edge)
        np.testing.assert_array_equal(fused[2], staged_edge)

    def test_alpha_preserved(self, small_rgba):
        got = np.asarray(ops.edge_pipeline(small_rgba))
        np.testing.assert_array_equal(got[3], small_rgba[3])

    def test_multi_strip(self, rng):
        img = rng.integers(0, 256, size=(3, 200, 131), dtype=np.uint8)
        got = np.asarray(ops.edge_pipeline(img))
        want = np_sobel(np_grayscale(img)[0])
        for c in range(3):
            np.testing.assert_array_equal(got[c], want)


class TestEdgePyramidBase:
    """Perception -> pooled pyramid base vs the staged path."""

    @pytest.mark.parametrize("shape", [(3, 48, 160), (3, 70, 130),
                                       (3, 160, 256), (4, 33, 129)])
    def test_matches_staged_pooling(self, rng, shape):
        from openmp_parallel_computing_tpu.models.mpc import costs

        img = rng.integers(0, 256, size=shape, dtype=np.uint8)
        got = np.asarray(ops.edge_pyramid_base(img, s=16))
        edge = np.asarray(ops.edge_pipeline(img))[0].astype(np.float32)
        want = np.asarray(costs.avg_pool(edge, 16))
        # integer block sums stay exact in f32 -> bit-exact parity
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("h", [300, 320, 333])
    def test_multi_strip_layouts(self, rng, h):
        """Heights with a partial last block row (300, 333) and without
        (320), all with a partial last block column."""
        from openmp_parallel_computing_tpu.models.mpc import costs

        img = rng.integers(0, 256, size=(3, h, 140), dtype=np.uint8)
        got = np.asarray(ops.edge_pyramid_base(img, s=16))
        edge = np.asarray(ops.edge_pipeline(img))[0].astype(np.float32)
        want = np.asarray(costs.avg_pool(edge, 16))
        np.testing.assert_array_equal(got, want)

    def test_frame_pyramid_matches_staged(self, rng):
        from openmp_parallel_computing_tpu.models.mpc import costs

        img = rng.integers(0, 256, size=(3, 130, 260), dtype=np.uint8)
        fused = costs.build_cost_pyramid_from_frame(img)
        edge = np.asarray(ops.edge_pipeline(img))[0].astype(np.float32)
        staged = costs.build_cost_pyramid(edge)
        assert len(fused) == len(staged)
        for a, b in zip(fused, staged):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestConv3x3:
    def np_conv(self, img, k, norm):
        c, h, w = img.shape
        xp = np.pad(img.astype(np.int64), ((0, 0), (1, 1), (1, 1)))
        out = np.zeros((c, h, w), np.int64)
        for ky in range(3):
            for kx in range(3):
                out += xp[:, ky:ky+h, kx:kx+w] * k[ky][kx]
        # C integer division truncates toward zero.
        return (np.sign(out) * (np.abs(out) // norm)).astype(np.int32)

    def test_gblur_matches_numpy(self, small_rgb):
        want = self.np_conv(small_rgb, xla_ref.GBLUR_KERNEL, 16)
        np.testing.assert_array_equal(np.asarray(ops.conv3x3(small_rgb)), want)
        np.testing.assert_array_equal(
            np.asarray(xla_ref.conv3x3(small_rgb)), want)

    def test_multi_strip_and_edges(self, rng):
        img = rng.integers(0, 256, size=(4, 200, 131), dtype=np.uint8)
        got = np.asarray(ops.conv3x3(img))
        want = self.np_conv(img, xla_ref.GBLUR_KERNEL, 16)
        np.testing.assert_array_equal(got, want)

    def test_signed_taps(self, small_rgb):
        k = ((0, -1, 0), (-1, 5, -1), (0, -1, 0))  # sharpen
        got = np.asarray(ops.conv3x3(small_rgb, taps=k, norm=1))
        want = self.np_conv(small_rgb, k, 1)
        np.testing.assert_array_equal(got, want)

    def test_float_mode(self, small_rgb):
        got = np.asarray(ops.conv3x3(small_rgb, integer=False))
        want = np.asarray(xla_ref.conv3x3(small_rgb, integer=False))
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_blur_u8(self, small_rgb):
        got = np.asarray(ops.gaussian_blur(small_rgb))
        assert got.dtype == np.uint8
        want = self.np_conv(small_rgb, xla_ref.GBLUR_KERNEL, 16)
        np.testing.assert_array_equal(got, np.clip(want, 0, 255).astype(np.uint8))


class TestReductions:
    def test_channel_mean(self, small_rgb):
        got = np.asarray(ops.channel_mean(small_rgb))
        want = small_rgb.reshape(3, -1).mean(axis=1)
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_channel_sum_unaligned(self, rng):
        img = rng.integers(0, 256, size=(3, 37, 131), dtype=np.uint8)
        got = np.asarray(ops.channel_sum(img))
        np.testing.assert_allclose(got, img.reshape(3, -1).sum(axis=1),
                                   rtol=1e-6)

    def test_gray_minmax(self, small_rgb):
        gray, mn, mx = ops.grayscale_mean_minmax(small_rgb)
        want = small_rgb.astype(np.int64).sum(axis=0) // 3
        np.testing.assert_array_equal(np.asarray(gray[0]), want)
        assert int(mn) == want.min() and int(mx) == want.max()

    def test_gray_minmax_twin(self, small_rgb):
        gray, mn, mx = xla_ref.grayscale_mean_minmax(small_rgb)
        want = small_rgb.astype(np.int64).sum(axis=0) // 3
        np.testing.assert_array_equal(np.asarray(gray[0]), want)
        assert int(mn) == want.min() and int(mx) == want.max()
