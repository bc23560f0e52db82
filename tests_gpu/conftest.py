"""GPU suite: the ``smoke`` checks of the main path on the attached card.

Run it alone, in its own process (a JAX process reserves most of the
card's memory, so a second one beside it fails):

    python -m pytest tests_gpu -q

Every test carries the ``gpu`` marker (registered in pyproject.toml) and
skips, from a fixture, when JAX's default device is not a GPU.
"""

import jax
import pytest


@pytest.fixture(autouse=True)
def _require_gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (JAX default device is "
                    f"{jax.devices()[0].platform})")
