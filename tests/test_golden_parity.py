"""Bit-tolerant parity against the reference C/OpenMP pipeline.

``tests/golden/*.png`` were produced by the reference binaries (built from
``/root/reference/monolithic`` with its own Makefile flags ``-O3 -march=native
-ffast-math``) run on ``images/test.jpg``. Tolerance policy (SURVEY.md §7):
the framework's fixed-point luma may differ from the C float luma by at most
1 u8 step; Sobel magnitudes may locally amplify that by the stencil's tap
weights, but mismatching pixels must stay rare.
"""

from pathlib import Path

import numpy as np
import pytest

from openmp_parallel_computing_tpu import imgio, ops
from openmp_parallel_computing_tpu.ops import xla_ref

GOLDEN = Path(__file__).parent / "golden"
# The parity fixtures live in-tree (goldens produced by the reference
# binaries once, committed); only tests that read the reference mount
# directly carry their own skipif.
REFERENCE_IMAGES = Path("/root/reference/images")


@pytest.fixture(scope="module")
def frame():
    # The goldens were produced from this lossless PNG (itself a libjpeg
    # decode of images/test.jpg) so that both pipelines see identical input
    # pixels — stb_image and libjpeg IDCTs differ by +-2 on JPEG decode.
    return np.transpose(imgio.load(GOLDEN / "input_1080p.png"), (2, 0, 1)).copy()


def test_grayscale_parity(frame):
    golden = np.transpose(imgio.load(GOLDEN / "gray_1080p.png"), (2, 0, 1))
    ours = np.asarray(ops.grayscale(frame))
    diff = np.abs(ours.astype(np.int32) - golden.astype(np.int32))
    assert diff.max() <= 1, f"luma parity broken: max diff {diff.max()}"
    # fixed-point vs C-float disagreement must be rare
    assert (diff > 0).mean() < 0.02


def test_sobel_pipeline_parity(frame):
    golden = np.transpose(imgio.load(GOLDEN / "edge_1080p.png"), (2, 0, 1))
    ours = np.asarray(ops.edge_pipeline(frame))
    # The reference leaves the 1-px border uninitialized (sobel.c:11-12 with
    # malloc'd dst); compare the interior only.
    g = golden[0, 1:-1, 1:-1].astype(np.int32)
    o = ours[0, 1:-1, 1:-1].astype(np.int32)
    diff = np.abs(g - o)
    # +-1 luma steps can shift a 3x3 stencil output by a few counts.
    assert diff.max() <= 16, f"edge parity broken: max diff {diff.max()}"
    assert (diff > 0).mean() < 0.05
    assert (diff > 2).mean() < 0.005


def test_twin_equals_pallas_on_real_frame(frame):
    np.testing.assert_array_equal(
        np.asarray(ops.edge_pipeline(frame)),
        np.asarray(xla_ref.edge_pipeline(frame)))


def test_imgio_roundtrip(tmp_path, frame):
    hwc = np.transpose(frame, (1, 2, 0))
    p = tmp_path / "rt.png"
    imgio.save_png(p, hwc)
    np.testing.assert_array_equal(imgio.load(p), hwc)


@pytest.mark.skipif(not REFERENCE_IMAGES.exists(),
                    reason="reference fixture images not mounted")
def test_reference_gray_png_decodes():
    """The reference's pre-converted grayscale fixture decodes cleanly
    (PNG path, non-RGB channel count handled)."""
    p = REFERENCE_IMAGES / "test_gray.png"
    img = imgio.load(p)
    assert img.shape[0] == 1080 and img.shape[1] == 1920
    assert img.shape[2] in (1, 3)
    assert img.dtype == np.uint8


def test_package_fixture_matches_golden_input(frame):
    """The in-package benchmark frame (data.frame_1080p.png) must stay
    pixel-identical to the golden-parity input, so bench numbers and parity
    checks describe the same image."""
    from openmp_parallel_computing_tpu import data

    pkg = np.transpose(data.load_frame_hwc(), (2, 0, 1))
    np.testing.assert_array_equal(pkg, frame)


def test_imgio_jpeg_encode(tmp_path, frame):
    hwc = np.transpose(frame, (1, 2, 0))
    p = tmp_path / "rt.jpg"
    imgio.save_jpeg(p, hwc, quality=95)
    back = imgio.load(p)
    assert back.shape == hwc.shape
    # lossy but close at q95
    assert np.abs(back.astype(int) - hwc.astype(int)).mean() < 3.0
    # grayscale path
    g = tmp_path / "g.jpg"
    imgio.save_jpeg(g, hwc[:, :, 0])
    assert imgio.load(g).shape == (hwc.shape[0], hwc.shape[1], 1)


class TestLegacyKernelGoldens:
    """The legacy conv/reduction kernels pinned against the COMPILED
    reference C (round 5). old/parallel_convolution.c:8-24 and
    old/parallel_to_grayscale.c:7-38 never built standalone (their
    utils.h was not committed — SURVEY C17); tests/golden/legacy supplies
    the header, compiles the UNMODIFIED reference sources once
    (generate.py), and commits the outputs. Integer semantics (truncating
    /GBLUR_NORM, (r+g+b)/3, fused min/max) must match exactly — these
    are integer kernels, so parity is bitwise, not tolerance-based."""

    @pytest.fixture(scope="class")
    def legacy(self):
        return np.load(GOLDEN / "legacy" / "legacy_golden.npz")

    @pytest.fixture(scope="class")
    def chw(self, legacy):
        return np.ascontiguousarray(
            np.transpose(legacy["input"], (2, 0, 1)))

    def test_gaussian_conv_matches_reference(self, legacy, chw):
        from openmp_parallel_computing_tpu.ops import conv3x3

        ours = np.asarray(conv3x3(chw, integer=True, clamp_u8=False))
        np.testing.assert_array_equal(
            ours, np.transpose(legacy["gblur"], (2, 0, 1)))

    def test_asymmetric_taps_pin_orientation(self, legacy, chw):
        """A symmetric Gaussian cannot distinguish correlation from
        convolution; the 1..9 kernel can. The reference computes
        CORRELATION (img[r+kr][c+kc] * k[kr][kc], no flip)."""
        from openmp_parallel_computing_tpu.ops import conv3x3

        taps = ((1, 2, 3), (4, 5, 6), (7, 8, 9))
        ours = np.asarray(conv3x3(chw, taps=taps, norm=16, integer=True,
                                  clamp_u8=False))
        np.testing.assert_array_equal(
            ours, np.transpose(legacy["asym"], (2, 0, 1)))

    def test_gray_minmax_matches_reference(self, legacy, chw):
        from openmp_parallel_computing_tpu.ops import (
            grayscale_mean_minmax)

        gray, gmin, gmax = grayscale_mean_minmax(chw)
        np.testing.assert_array_equal(
            np.asarray(gray), np.transpose(legacy["gray"], (2, 0, 1)))
        assert int(gmin) == int(legacy["minmax"][0])
        assert int(gmax) == int(legacy["minmax"][1])


class TestLargeFixtureParity:
    """Golden parity at the multi-megapixel fixtures x device counts
    (round 5 — the repo analogue of the reference's per-thread-count
    output images, SURVEY §4.4). Goldens produced by the reference
    monolithic binaries on the in-package PNG fixtures
    (tests/golden/generate_large.py); sharded runs go through the same
    spatial-sharding runner the HTTP 'threads' field drives, so
    correctness-under-parallelism is pinned against the C outputs, not
    just the single-device twin."""

    SIZES = ["half_mega", "6mp"]

    @pytest.fixture(scope="class")
    def fixtures(self):
        from openmp_parallel_computing_tpu import data

        return {
            "half_mega": np.transpose(
                imgio.load(data.half_mega_path()), (2, 0, 1)).copy(),
            "6mp": np.transpose(
                imgio.load(data.six_mp_path()), (2, 0, 1)).copy(),
        }

    def _run(self, kernel, img, devices):
        from openmp_parallel_computing_tpu.ops.runner import (
            make_runner, pad_rows)

        if devices == 1:
            run = make_runner(kernel, passes=1, devices=1)
            return np.asarray(run(img))
        padded, orig_h = pad_rows(img, devices)
        run = make_runner(kernel, passes=1, devices=devices,
                          orig_h=orig_h)
        return np.asarray(run(padded))[:, :orig_h]

    @pytest.mark.parametrize("devices", [1, 4])
    @pytest.mark.parametrize("size", SIZES)
    def test_grayscale_parity(self, fixtures, size, devices):
        golden = imgio.load(GOLDEN / f"gray_{size}.png")[:, :, 0]
        ours = self._run("grayscale", fixtures[size], devices)[0]
        diff = np.abs(ours.astype(np.int32) - golden.astype(np.int32))
        assert diff.max() <= 1, f"{size}/{devices}: max diff {diff.max()}"
        assert (diff > 0).mean() < 0.02

    @pytest.mark.parametrize("devices", [1, 4])
    @pytest.mark.parametrize("size", SIZES)
    def test_edge_pipeline_parity(self, fixtures, size, devices):
        golden = imgio.load(GOLDEN / f"edge_{size}.png")[:, :, 0]
        ours = self._run("edge", fixtures[size], devices)[0]
        # reference leaves the 1-px border uninitialized (sobel.c) —
        # interior only; same tolerance ladder as the 1080p gate.
        g = golden[1:-1, 1:-1].astype(np.int32)
        o = ours[1:-1, 1:-1].astype(np.int32)
        diff = np.abs(g - o)
        assert diff.max() <= 16, f"{size}/{devices}: max diff {diff.max()}"
        assert (diff > 0).mean() < 0.05
        assert (diff > 2).mean() < 0.005

    @pytest.mark.parametrize("devices", [4])
    def test_1080p_sharded_parity(self, frame, devices):
        """The original 1080p goldens at devices=4 completes the 3 sizes
        x {1, 4} matrix (devices=1 is the module-level test above)."""
        golden = np.transpose(
            imgio.load(GOLDEN / "gray_1080p.png"), (2, 0, 1))[0]
        ours = self._run("grayscale", frame, devices)[0]
        diff = np.abs(ours.astype(np.int32) - golden.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.02
        golden_e = np.transpose(
            imgio.load(GOLDEN / "edge_1080p.png"), (2, 0, 1))[0]
        ours_e = self._run("edge", frame, devices)[0]
        diff_e = np.abs(ours_e[1:-1, 1:-1].astype(np.int32)
                        - golden_e[1:-1, 1:-1].astype(np.int32))
        assert diff_e.max() <= 16 and (diff_e > 0).mean() < 0.05
