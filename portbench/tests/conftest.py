"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the root of the checkout (the repository's suite does not collect them).
Tests marked ``cuda`` need a card and skip without one."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

# small sizes at which every cell runs on the CPU in seconds
SMALL = {
    "rollout": {"batch": 48, "fragment_steps": 4,
                "check": {"sample_worlds": 24, "depart_tol": 1e-3}},
    "train": {"batch": 16, "horizon": 4, "checkpoint_segments": 2},
    "shoot": {"batch": 32, "plan_steps": 4},
}
POLICY = {"hidden": 32, "w1_scale": 0.3, "w2_scale": 0.1}
# billiards48's plain collide and solve are slow on the CPU: fewer worlds
SMALL_BY_CELL = {"billiards48.rollout": {"batch": 12, "fragment_steps": 3,
                                         "check": {"sample_worlds": 6, "depart_tol": 1e-3}}}


def small(cell: dict) -> dict:
    return SMALL_BY_CELL.get(cell["name"], SMALL[cell["traffic"]])


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device on this machine")
    return torch.device("cuda")
