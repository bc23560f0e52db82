"""The standard-library PNG codec (``imgio.png``): the fallback that decodes
the shipped fixtures where the native codec cannot be built, checked
against the native codec pixel for pixel."""

from pathlib import Path

import numpy as np
import pytest

from openmp_parallel_computing_tpu import data, imgio
from openmp_parallel_computing_tpu.imgio import png

GOLDEN = Path(__file__).parent / "golden"
FIXTURES = sorted(GOLDEN.glob("*.png")) + sorted(
    Path(data.__file__).parent.glob("*.png"))


@pytest.fixture(scope="module")
def native():
    if imgio._load_lib() is None:
        pytest.skip("native codec not built")
    return imgio


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.name)
def test_decode_matches_native(native, path):
    np.testing.assert_array_equal(png.decode(path.read_bytes()),
                                  native.load(path))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_encode_roundtrip(native, tmp_path, channels):
    img = np.random.default_rng(channels).integers(
        0, 256, (29, 41, channels), dtype=np.uint8)
    p = tmp_path / "rt.png"
    p.write_bytes(png.encode(img, compression=1))
    np.testing.assert_array_equal(png.decode(p.read_bytes()), img)
    np.testing.assert_array_equal(native.load(p), img)


def test_unsupported_variant_rejected(tmp_path):
    blob = bytearray(png.encode(np.zeros((2, 2, 3), np.uint8)))
    blob[8 + 8 + 8] = 16                      # IHDR bit depth -> 16
    with pytest.raises(ValueError, match="unsupported"):
        png.decode(bytes(blob))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(b"GIF89a")


def test_load_falls_back_without_native(monkeypatch, tmp_path):
    """With the native codec unavailable, ``imgio.load``/``save_png``
    still read and write PNGs and the package frame loads."""
    monkeypatch.setattr(imgio, "_lib", False)
    frame = data.load_frame_planar()
    assert frame.shape == (3, 1080, 1920)
    img = np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3)
    p = tmp_path / "fb.png"
    imgio.save_png(p, img)
    np.testing.assert_array_equal(imgio.load(p), img)
