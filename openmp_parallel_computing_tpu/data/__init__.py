"""In-package benchmark fixtures.

The reference repo ships its benchmark inputs in-tree
(``/root/reference/images/``; the canonical 1080p input is named at
``README.md:28``). This package does the same so every bench, study, and
example runs from a clean checkout — no external mount required.

All three benchmark inputs are lossless PNG re-encodes of the reference's
``images/`` set (identical pixels, codec-independent):

- ``frame_1080p.png``    — the canonical 1920x1080 photo (``test.jpg``);
  the same pixels the golden-parity fixtures in ``tests/golden/`` were
  generated from, so bench inputs and parity inputs agree byte-for-byte.
- ``photo_half_mega.png`` — 2037x1362 (``half_of_a_mega_photo.jpg``), the
  blur-benchmark input (BASELINE config 2).
- ``photo_6mp.png``       — 2000x3000 (``more_than_one_mega_photo.jpg``),
  the largest size-scaling input (BASELINE config 3).
"""

from __future__ import annotations

from pathlib import Path

_HERE = Path(__file__).resolve().parent


def frame_path() -> Path:
    """Path of the canonical 1080p benchmark frame (1920x1080 RGB PNG)."""
    return _HERE / "frame_1080p.png"


def half_mega_path() -> Path:
    """Path of the 2037x1362 blur-benchmark photo (BASELINE config 2)."""
    return _HERE / "photo_half_mega.png"


def six_mp_path() -> Path:
    """Path of the 2000x3000 size-scaling photo (BASELINE config 3)."""
    return _HERE / "photo_6mp.png"


def fixture_set() -> dict[str, Path]:
    """The full in-package benchmark image set, smallest to largest —
    the size-scaling axis of the reference's fixtures (SURVEY §5
    'long-axis scaling': 1080p -> 6 MP)."""
    return {
        "frame_1080p": frame_path(),
        "photo_half_mega": half_mega_path(),
        "photo_6mp": six_mp_path(),
    }


def load_frame_hwc():
    """Decode the canonical benchmark frame to an (H, W, C) u8 array."""
    from openmp_parallel_computing_tpu import imgio

    return imgio.load(frame_path())


def load_frame_planar():
    """Decode the canonical benchmark frame to a planar (C, H, W) u8
    jax array — the layout every kernel and the MPC front-end consume."""
    import jax.numpy as jnp
    import numpy as np

    return jnp.asarray(np.transpose(load_frame_hwc(), (2, 0, 1)))


def frame_ring(frame, n: int):
    """n distinct (C, H, W) frames from one: cyclic column shifts — a
    different image to the perception ops every step (their work is
    content-independent) while edge statistics stay production-like."""
    import jax.numpy as jnp

    shift = frame.shape[-1] // n
    return jnp.stack([jnp.roll(frame, k * shift, axis=-1)
                      for k in range(n)])
