"""Test settings of the benchmark's own tests (``pytest benchmark/tests``).

Tests that need a CUDA card carry the ``card`` marker and skip elsewhere;
whether a card exists is decided inside the ``card`` fixture, never while
a module is imported.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
  config.addinivalue_line(
      "markers", "card: needs a CUDA card; skipped where PyTorch sees none")


@pytest.fixture
def card():
  import torch

  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card; PyTorch sees none")
  return torch.device("cuda", 0)
