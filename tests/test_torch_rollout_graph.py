"""The rollout's CUDA-graph path (``envs/plane_env.py``) on the CPU.

The graph engages only on CUDA planes with autograd off, so here every
rollout runs eagerly:

* on CPU tensors, under ``no_grad`` and under autograd, ``rollout_batch``
  captures nothing (``graph_steps`` stays, ``eager_steps`` counts every
  step, the env keeps no graph) and its bits are those of a hand-written
  loop of the eager step;
* ``profiling.edges`` hands a step's span edges to its callback in order,
  in place of the spans, and restores the previous callback after an
  exception.

The card tests (``tests/test_torch_cuda.py``) hold the graphed rollout
against the eager one.
"""

import pytest
import torch

from parallax_tpu_torch.envs import plane_env
from parallax_tpu_torch.envs.lunar_lander import LanderConfig, LunarLander
from parallax_tpu_torch.utils import profiling
from parallax_tpu_torch.utils.pytree import tree_leaves, tree_map

B, STEPS = 4, 3


@pytest.fixture(scope="module")
def lander():
    env = LunarLander(LanderConfig(broadphase=False, use_cuda_fused=True), device="cpu")
    g = torch.Generator().manual_seed(3)
    keys = torch.randint(0, 2**32, (B, 2), generator=g, dtype=torch.int64)
    return env, env.reset_fn_batch(keys), torch.randn((9, 2), generator=g) * 0.3


def _policy(w, obs):
    return torch.tanh(obs @ w)


def _hand_rollout(env, states, w):
    """The eager step in a loop: obs, policy, ``_step_planes``, stacked."""
    ps, traj = env._to_planes(states), []
    for _ in range(STEPS):
        ps, ts = env._step_planes(ps, _policy(w, env.plane_obs(ps.s, ps.aux)))
        traj.append(ts)
    return env._from_planes(ps), tree_map(lambda *xs: torch.stack(xs), *traj)


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_rollout_never_captures(lander, grad):
    env, states, w = lander
    w = w.clone().requires_grad_(grad)
    graphs, eager = plane_env.graph_steps, plane_env.eager_steps
    with torch.set_grad_enabled(grad):
        final, traj = env.rollout_batch(states, _policy, STEPS, w)
        want_final, want_traj = _hand_rollout(env, states, w)
    assert plane_env.graph_steps == graphs
    assert plane_env.eager_steps == eager + STEPS
    assert not getattr(env, "_step_graphs", None)
    assert traj.obs.requires_grad == grad
    for got, want in zip(tree_leaves((final, traj)), tree_leaves((want_final, want_traj))):
        assert torch.equal(got, want)


def test_span_edges_go_to_the_callback(lander):
    env, states, w = lander
    ps = env._to_planes(states)
    actions = _policy(w, env.plane_obs(ps.s, ps.aux))
    seen = []
    with torch.no_grad(), profiling.edges(lambda name, opening: seen.append((name, opening))):
        env._step_planes(ps, actions)
    inner = ["px.pre", "px.physics", "px.post", "px.obs", "px.watchdog", "px.reset"]
    want = [("px.step", True)]
    for name in inner:
        want += [(name, True), (name, False)]
    assert seen == want + [("px.step", False)]
    assert profiling.named("px.step") is profiling._OFF

    with pytest.raises(ZeroDivisionError):
        with profiling.edges(seen.append):
            1 / 0
    assert profiling._EDGES is None
