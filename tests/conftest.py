# NOTE: no XLA_FLAGS here on purpose — unit/smoke tests must see the single
# real CPU device. Distributed behaviour is tested via subprocesses that set
# --xla_force_host_platform_device_count themselves (test_distributed.py).
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


@pytest.fixture(scope="session")
def moe_cfg():
    from repro.configs import get_config
    return get_config("olmoe-lite")


@pytest.fixture(scope="session")
def moe_params(rng, moe_cfg):
    from repro.core import moe
    from repro.models.layers import split_params
    params, _ = split_params(moe.make_moe_params(rng, moe_cfg))
    return params


@pytest.fixture(scope="session")
def calib_x(rng, moe_cfg):
    from repro.data.pipeline import calibration_activations
    return calibration_activations(jax.random.fold_in(rng, 1), 96,
                                   moe_cfg.d_model)
