"""The candidate lander's train step against the JAX package's, on the CPU.

``LanderConfig(terrain_candidates=True)``: the port's split train step and
its fused one (``broadphase=False, use_cuda_fused=True``: on the CPU the
autograd of the fused step's plain version) against JAX's
``make_train_step`` on its candidate lander (on the CPU JAX runs its XLA
split step for both; one compile, about a minute cold).  The state is
``tests/test_torch_train.py``'s contact scenario on the candidate world
(legs and hull resting on the terrain), the policy its 9-32-2 MLP, the
horizon short (6 steps).  Bars as ``tests/test_torch_train.py`` sets them:
the loss 1e-5 relative, each policy gradient 1e-4 relative in norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train import contact_states, jax_policy, policy_arrays, to_jax, torch_params
from test_torch_train import torch_policy

from parallax_tpu.envs.lunar_lander import LanderConfig as JaxLanderConfig
from parallax_tpu.envs.lunar_lander import LunarLander as JaxLander
from parallax_tpu.parallel.rollout import make_train_step as jax_make_train_step
from parallax_tpu_torch.envs.lunar_lander import LanderConfig, LunarLander
from parallax_tpu_torch.ops import contact_solver, fused_step
from parallax_tpu_torch.parallel import rollout

torch.set_num_threads(2)

TRAIN_B, HORIZON = 8, 6
CONFIGS = {
    "split": LanderConfig(terrain_candidates=True),
    "fused": LanderConfig(terrain_candidates=True, broadphase=False, use_cuda_fused=True),
}


@pytest.fixture(scope="module")
def reference():
    """The contact state and JAX's loss and gradients there; the optimizer
    returns zero updates and keeps the gradients as its state, so they come
    out unrounded."""
    st = contact_states(LunarLander(CONFIGS["split"], device="cpu"), TRAIN_B)
    jenv = JaxLander(JaxLanderConfig(terrain_candidates=True))
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )
    params = {k: jnp.asarray(v) for k, v in policy_arrays().items()}
    step = jax.jit(jax_make_train_step(jenv, jax_policy, keep, HORIZON))
    _, grads, _, metrics = step(params, keep.init(params), to_jax(st))
    return st, float(metrics["loss"]), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("path", ["split", "fused"])
def test_candidate_train_step_matches_jax(reference, path):
    st, loss_j, grads_j = reference
    env = LunarLander(CONFIGS[path], device="cpu")
    params = torch_params()
    before = (contact_solver.launches, fused_step.launches)
    loss, _ = rollout.make_loss_fn(env, torch_policy, HORIZON, 2)(params, st)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert (contact_solver.launches, fused_step.launches) == before  # plain versions on the CPU
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    for k, g in zip(params, grads):
        ref = grads_j[k]
        assert np.linalg.norm(ref) > 1e-3, f"{k}: the gradient must be alive"
        rel = np.linalg.norm(g.numpy() - ref) / np.linalg.norm(ref)
        assert rel < 1e-4, (path, k, rel)
