"""Capability probe.

Twin of the reference's only compiled "test", the OpenMP support probe
(``monolithic/src/test_openmp.c:7-14`` printing the ``_OPENMP`` macro):
reports which JAX backend is attached, what the device fleet looks like,
and whether the compute path actually works (a tiny op is compiled and
executed). The command exits non-zero when no GPU is attached: it never
reports a CPU fallback as the accelerator.

    python -m openmp_parallel_computing_tpu.probe
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp


def probe() -> dict:
    devices = jax.devices()
    info: dict = {
        "backend": jax.default_backend(),
        "device_kind": devices[0].device_kind,
        "devices": [str(d) for d in devices],
        "device_count": len(devices),
        "process_count": jax.process_count(),
    }
    try:
        from openmp_parallel_computing_tpu import ops

        x = jnp.zeros((3, 8, 128), jnp.uint8)
        jax.block_until_ready(ops.grayscale(x))
        info["compute"] = "supported"
    except Exception as exc:  # pragma: no cover - environment specific
        info["compute"] = f"NOT supported: {exc!r}"
    return info


def main() -> int:
    info = probe()
    on_gpu = info["backend"] == "gpu"
    if on_gpu and info["compute"] == "supported":
        print(f"GPU compute path supported: {info['device_kind']} "
              f"devices={info['device_count']} "
              f"processes={info['process_count']}")
    elif not on_gpu:
        print(f"no GPU attached (backend={info['backend']})")
    else:
        print(f"GPU compute path NOT supported ({info['compute']}); "
              f"{info['device_kind']}")
    for d in info["devices"]:
        print(f"  {d}")
    return 0 if on_gpu and info["compute"] == "supported" else 1


if __name__ == "__main__":
    sys.exit(main())
