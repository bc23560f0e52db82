"""PNG codec on the standard library's ``zlib`` and numpy.

The fallback of ``imgio`` where the native codec cannot be built or loaded
(no libpng on the host): it reads the 8-bit, non-interlaced grayscale,
gray+alpha, RGB and RGBA PNGs the repository ships and serves, and writes
the same formats. Other variants raise ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}        # PNG colour type -> channels


def _chunks(blob: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        yield kind, blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def _unfilter(raw: np.ndarray, h: int, w: int, ch: int) -> np.ndarray:
    """Undo the per-row PNG filters of ``raw`` ((h, 1 + w*ch) bytes).

    Sub, Average and Paeth make a pixel depend on its left neighbour, so a
    row cannot be undone as one vector op; but pixel (r, x) depends only on
    (r, x-1), (r-1, x) and (r-1, x-1), so every pixel on one anti-diagonal
    r + x = d can be undone at once, in h + w - 1 vector steps.
    """
    ftype = raw[:, 0].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"png: bad filter type {ftype.max()}")
    filt = raw[:, 1:].reshape(h, w, ch).astype(np.int32)
    out = np.zeros((h + 1, w + 1, ch), np.int32)   # zero row/col = outside
    rows = np.arange(h)
    for d in range(h + w - 1):
        r = rows[max(0, d - w + 1):min(h, d + 1)]
        x = d - r
        a = out[r + 1, x]              # left
        b = out[r, x + 1]              # up
        c = out[r, x]                  # up-left
        t = ftype[r][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, x + 1] = (filt[r, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def decode(blob: bytes) -> np.ndarray:
    """PNG bytes -> interleaved (H, W, C) u8 array."""
    if not blob.startswith(SIGNATURE):
        raise ValueError("png: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(blob):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("png: missing IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"png: unsupported variant (depth={depth}, "
                         f"colour type={ctype}, interlace={interlace})")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * ch):
        raise ValueError("png: truncated image data")
    return _unfilter(raw.reshape(h, 1 + w * ch), h, w, ch)


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def encode(img: np.ndarray, compression: int = -1) -> bytes:
    """Interleaved (H, W, C) u8 array, C in 1..4 -> PNG bytes (no
    filtering; ``compression`` is the zlib level, -1 = zlib's default)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, ch = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * ch)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), compression))
            + _chunk(b"IEND", b""))
