"""Runtime fixtures of the port's runtime and Serve tests.

``tests/conftest.py`` boots the JAX package's runtime under these names;
a test module of the port imports these, which shadow those for its own
tests: a fresh ray_tpu_torch runtime per test, with no GPU advertised
(the tests run on the CPU).
"""

import pytest

import ray_tpu_torch


@pytest.fixture
def ray_start_regular():
    ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=8, num_gpus=0)
    yield rt
    ray_tpu_torch.shutdown()


@pytest.fixture
def shutdown_only():
    ray_tpu_torch.shutdown()
    yield None
    ray_tpu_torch.shutdown()
