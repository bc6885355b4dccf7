"""BASELINE configs 4, 4k and 5 (the envs in reference mode) through the
port's per-world ``Environment.step``, held against the golden
trajectories, with no jax.

``tests/golden/golden_parity.npz`` pins the JAX package's reference-mode
env loop: ``narrowphase="gjk_epa"``, ``ContactSolverConfig.reference()``,
no broadphase, and the random solver modes drawing from the episode
stream (``fold_in(state.key, ...)``), under ``jax.vmap(env.step)`` with
in-graph auto-reset (``tests/test_golden_parity.py:140-290``).  Here the
port's envs run the same rollouts from the same keys (``split(PRNGKey(seed),
B)`` by the port's ``utils/prng.py``) and the same scripted actions
(``tests/torch_scenarios.py:golden_env_case``):

* config 4: the lander, ``random_one_per_body``, B=4, 60 steps;
* config 4k: the lander through the keyed reference replay, B=2, 40 steps;
* config 5: RoboCup (2 x 3 robots), ``random_one_per_body``, B=4, 80
  steps of phase-shifted velocity commands.

Every recorded frame (pos, vel, angle, omega every 10 steps) and every
step's reward within 1e-5 (measured on the CPU: at most 5.4e-7
on configs 4 and 4k and 1.0e-6 on config 5); config 5 also meets the
golden's own sanity bounds (``test_golden_sanity``).  ``chip_smoke.py``
phase 3d runs the same cases on the card.
"""

import os

import numpy as np
import pytest
import torch
from torch_scenarios import golden_env_case, hold_golden_env

torch.set_num_threads(2)
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "golden_parity.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN_PATH)


@pytest.mark.parametrize("name", ["config4", "config4k", "config5"])
def test_env_reference_mode_matches_golden(golden, name):
    hold_golden_env(name, golden_env_case(name, "cpu"), golden)
