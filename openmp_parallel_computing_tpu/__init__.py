"""openmp_parallel_computing_tpu — a JAX parallel image-kernel + visual-servo MPC framework.

A ground-up JAX/XLA re-design of the capability set of the reference
repository ``PedemonteGiacomo/OpenMp-Parallel-Computing`` (OpenMP stencil
kernels, benchmark methodology, synchronous serving, and asynchronous
queue-decoupled batch processing), extended into a production visual-servo
MPC engine per this repo's BASELINE.json north star.

Layer map (bottom-up, mirroring SURVEY.md §7):

- ``imgio``     — host-side image decode/encode (native C++ codec + fallback).
- ``ops``       — XLA image ops (grayscale, Sobel, 3x3 conv, reductions,
                  fused pipelines) with pure-jnp twins for testing.
- ``parallel``  — device mesh topology, sharding specs, collective helpers.
- ``models``    — vision pipeline + the visual-servo MPC engine.
- ``bench``     — device-sweep benchmark harness (CSV + plots contract).
- ``serve``     — synchronous HTTP serving surface.
- ``dispatch``  — asynchronous queue + object-store batch tier.
- ``utils``     — config, timing, checkpointing.
"""

__version__ = "0.1.0"

from openmp_parallel_computing_tpu import ops  # noqa: F401
