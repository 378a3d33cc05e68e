"""Fixtures of the benchmark's CPU tests: the run's environment prepared
once, and the CPU device."""

import pytest

from portbench.tests.helpers import ROOT


@pytest.fixture(scope="session", autouse=True)
def _env():
    from portbench.lib import env

    env.prepare(ROOT)


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")
