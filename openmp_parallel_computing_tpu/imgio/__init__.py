"""Host-side image I/O.

Capability twin of the reference's L0 layer (vendored stb_image /
stb_image_write, used as ``stbi_load`` at ``monolithic/src/main.c:21`` and
``stbi_write_png`` at ``:41``). Primary path is the framework's native C++
codec (``native/imgio/imgio.cpp``, libjpeg/libpng) bound via ctypes. Where
it cannot be built or loaded (no libpng/libjpeg on the host), PNGs go
through the standard-library codec in ``imgio.png`` and other formats
through Pillow.

API: ``load(path) -> (H, W, C) u8 ndarray``; ``save_png(path, img)``.
Planar conversion for the device layout lives in ``ops`` (hwc_to_chw).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

from openmp_parallel_computing_tpu.imgio import png

_REPO_ROOT = Path(__file__).resolve().parents[2]
_NATIVE_DIR = _REPO_ROOT / "native"
_LIB_PATH = _NATIVE_DIR / "build" / "libimgio.so"

_lib = None          # the loaded codec; False once it failed to load


def build_native(force: bool = False) -> bool:
    """Build the native codec with make. Returns True if the .so exists."""
    if _LIB_PATH.exists() and not force:
        return True
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        return False
    return _LIB_PATH.exists()


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib or None
    if not _LIB_PATH.exists() and not build_native():
        _lib = False
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:                 # built elsewhere, libpng missing here
        _lib = False
        return None
    lib.imgio_load.restype = ctypes.POINTER(ctypes.c_ubyte)
    lib.imgio_load.argtypes = [ctypes.c_char_p] + [
        ctypes.POINTER(ctypes.c_int)] * 3
    lib.imgio_save_png.restype = ctypes.c_int
    lib.imgio_save_png.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte)] + [ctypes.c_int] * 5
    lib.imgio_save_jpeg.restype = ctypes.c_int
    lib.imgio_save_jpeg.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte)] + [ctypes.c_int] * 4
    lib.imgio_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
    lib.imgio_last_error.restype = ctypes.c_char_p
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def load(path: str | os.PathLike) -> np.ndarray:
    """Decode a JPEG/PNG file to an interleaved (H, W, C) u8 array."""
    lib = _load_lib()
    if lib is None:
        with open(path, "rb") as f:
            head = f.read(len(png.SIGNATURE))
        if head == png.SIGNATURE:
            try:
                return png.decode(Path(path).read_bytes())
            except ValueError:      # palette / 16-bit / interlaced
                pass
        return _load_pil(path)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    ptr = lib.imgio_load(str(path).encode(), ctypes.byref(w), ctypes.byref(h),
                         ctypes.byref(c))
    if not ptr:
        raise IOError(
            f"imgio: {lib.imgio_last_error().decode()} ({path})")
    try:
        n = h.value * w.value * c.value
        arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    finally:
        lib.imgio_free(ptr)
    return arr.reshape(h.value, w.value, c.value)


def save_png(path: str | os.PathLike, img: np.ndarray,
             compression: int = -1) -> None:
    """Encode an interleaved (H, W, C) or (H, W) u8 array as PNG.

    ``compression``: zlib level 0-9 (-1 = library default). Low levels trade
    file size for encode speed; pixels are identical at every level.
    """
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    lib = _load_lib()
    if lib is None:
        Path(path).write_bytes(png.encode(img, compression))
        return
    ok = lib.imgio_save_png(
        str(path).encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        w, h, c, w * c, compression)
    if not ok:
        raise IOError(f"imgio: {lib.imgio_last_error().decode()} ({path})")


def save_jpeg(path: str | os.PathLike, img: np.ndarray,
              quality: int = 90) -> None:
    """Encode an interleaved (H, W, C) or (H, W) u8 array as JPEG."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    lib = _load_lib()
    if lib is None:
        from PIL import Image

        Image.fromarray(img.squeeze(-1) if c == 1 else img).save(
            path, quality=quality)
        return
    ok = lib.imgio_save_jpeg(
        str(path).encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        w, h, c, quality)
    if not ok:
        raise IOError(f"imgio: {lib.imgio_last_error().decode()} ({path})")


def _load_pil(path) -> np.ndarray:
    """Pillow fallback, normalized to the native codec's output.

    The C codec (native/imgio/imgio.cpp) expands palette PNGs to RGB(A)
    (png_set_palette_to_rgb / tRNS->alpha) and strips 16-bit channels to
    their high byte (png_set_strip_16); without matching conversions the
    fallback would return raw palette indices or values mod 256 — same
    file, different pixels depending on which install decodes it.
    """
    from PIL import Image

    img = Image.open(path)
    if img.mode == "P":
        img = img.convert("RGBA" if "transparency" in img.info else "RGB")
    elif img.mode == "CMYK":
        # CMYK/YCCK JPEGs (Pillow normalizes YCCK to CMYK on open): decode
        # to RGB like the native codec / stb_image do.
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        # 16-bit channels (PIL modes I;16 / I): high byte == strip_16.
        arr = np.clip(np.right_shift(arr.astype(np.int64), 8),
                      0, 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    return np.ascontiguousarray(arr, dtype=np.uint8)
