"""XLA image ops (``ops.image``) and their plain-jnp references (``xla_ref``)."""

from openmp_parallel_computing_tpu.ops import xla_ref  # noqa: F401
from openmp_parallel_computing_tpu.ops.image import (  # noqa: F401
    channel_mean,
    channel_sum,
    conv3x3,
    edge_pipeline,
    edge_pyramid_base,
    gaussian_blur,
    grayscale,
    grayscale_mean_minmax,
    sobel,
)
from openmp_parallel_computing_tpu.ops.xla_ref import (  # noqa: F401
    chw_to_hwc,
    hwc_to_chw,
)
from openmp_parallel_computing_tpu.ops.runner import (  # noqa: F401,E402
    # imported last: runner's built-in registration needs the ops above
    KernelSpec,
    kernel_names,
    make_runner,
    register_kernel,
    unregister_kernel,
)
