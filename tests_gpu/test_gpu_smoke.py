"""The main path on the card, through ``openmp_parallel_computing_tpu.smoke``
(the same checks ``chip_smoke.py`` runs), at reduced batch sizes where a
phase allows it."""

import jax
import pytest

from openmp_parallel_computing_tpu import smoke

pytestmark = pytest.mark.gpu


def test_perception_1080p():
    smoke.check_perception()


@pytest.mark.parametrize("scenarios,horizon", [(1024, 20), (256, 50)])
def test_mpc(scenarios, horizon):
    smoke.check_mpc(scenarios=scenarios, horizon=horizon, steps=5,
                    long_horizon=horizon)


def test_served():
    smoke.check_served()


def test_dispatch(tmp_path):
    smoke.check_dispatch(tmp_path)


def test_distributed_four_cards():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 GPUs")
    smoke.check_distributed(scenarios=1024)
