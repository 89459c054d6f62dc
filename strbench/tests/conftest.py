"""The benchmark's own tests: `python -m pytest strbench/tests -q`.

Tests marked `cuda` need a card; each decides so inside the test and
skips on a machine without one."""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")
