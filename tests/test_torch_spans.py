"""The port's spans (``utils/profiling.py:named``, ``spans``) on the CPU.

* off by default: a profiled ``rollout_batch`` holds no ``px.`` event;
* on: the rollout's, the step's, the policy's, the env hooks' (pre, post,
  obs), the physics', the split collide's, the watchdog's and the
  auto-reset's spans appear once a wave or a step, on the lander, on a
  billiards step and on a RoboCup Division B fragment (the fused step's
  plain version); a checkpointed train step
  shows its forward, backward and update once each, and the auto-reset's
  span again inside the backward's recompute;
* the outputs with spans on equal those with spans off, to the bit;
* ``spans()`` restores the flag after an exception.
"""

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from parallax_tpu_torch.envs.billiards import Billiards, BilliardsConfig
from parallax_tpu_torch.envs.lunar_lander import LunarLander
from parallax_tpu_torch.envs.robocup import RoboCup, RoboCupConfig
from parallax_tpu_torch.parallel.rollout import adam, make_train_step
from parallax_tpu_torch.utils import profiling
from parallax_tpu_torch.utils.pytree import tree_leaves

B, STEPS = 4, 2


def _keys(n, seed=5):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2**32, (n, 2), generator=g, dtype=torch.int64)


def _params(obs, act, grad=False):
    g = torch.Generator().manual_seed(11)
    p = {"w": torch.randn((obs, act), generator=g) * 0.3, "b": torch.zeros(act)}
    return {k: v.requires_grad_(grad) for k, v in p.items()}


def _policy(p, obs):
    return torch.tanh(obs @ p["w"] + p["b"])


def _profiled(fn):
    """``fn()``'s result and its ``px.`` events as ``(name, start, end)``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("px.")]
    return out, events


@pytest.fixture(scope="module")
def lander():
    env = LunarLander(device="cpu")
    return env, env.reset_fn_batch(_keys(B))


def _rollout(lander):
    env, start = lander
    p = _params(env.observation_size, env.action_size)
    return env.rollout_batch(start, _policy, STEPS, p)


def test_spans_are_off_by_default(lander):
    assert not profiling._ON
    _, events = _profiled(lambda: _rollout(lander))
    assert events == []


def test_rollout_spans_and_bits(lander):
    off = _rollout(lander)
    with profiling.spans():
        on, events = _profiled(lambda: _rollout(lander))
    counts = Counter(n for n, _, _ in events)
    assert counts == {"px.rollout": 1, "px.step": STEPS, "px.policy": STEPS, "px.pre": STEPS,
                      "px.physics": STEPS, "px.collide": STEPS, "px.post": STEPS,
                      "px.obs": STEPS, "px.watchdog": STEPS, "px.reset": STEPS}
    (_, r0, r1), = [e for e in events if e[0] == "px.rollout"]
    assert all(r0 <= s and e <= r1 for _, s, e in events)
    for a, b in zip(tree_leaves(on), tree_leaves(off)):
        assert torch.equal(a, b)


def test_split_billiards_step_shows_the_collide():
    env = Billiards(BilliardsConfig(n_object=2), device="cpu")
    states = env.reset_fn_batch(_keys(B, 3))
    actions = torch.full((B, env.action_size), 0.5)
    off = env.step_batch(states, actions)
    with profiling.spans():
        on, events = _profiled(lambda: env.step_batch(states, actions))
        raw, raw_events = _profiled(lambda: env.step_fn_batch(states, actions))
    hooks = {"px.pre": 1, "px.post": 1, "px.obs": 1}
    assert Counter(n for n, _, _ in events) == {
        "px.step": 1, "px.physics": 1, "px.collide": 1, "px.watchdog": 1, "px.reset": 1, **hooks}
    assert Counter(n for n, _, _ in raw_events) == {
        "px.step": 1, "px.physics": 1, "px.collide": 1, **hooks}
    for a, b in zip(tree_leaves(on), tree_leaves(off)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(raw), tree_leaves(env.step_fn_batch(states, actions))):
        assert torch.equal(a, b)


def test_robocup_division_b_fragment_spans_and_bits():
    """Six robots a team on the fused step's plain version: the hooks' spans
    nest inside each step's ``px.step``, and the fragment's every leaf is
    the same with the spans on and off."""
    env = RoboCup(RoboCupConfig(n_robots_per_team=6, use_cuda_fused=True), device="cpu")
    start = env.reset_fn_batch(_keys(B, 7))
    p = _params(env.observation_size, env.action_size)

    def run():
        return env.rollout_batch(start, _policy, STEPS, p)

    off = run()
    with profiling.spans():
        on, events = _profiled(run)
    counts = Counter(n for n, _, _ in events)
    for name in ("px.step", "px.pre", "px.physics", "px.post", "px.obs", "px.watchdog",
                 "px.reset", "px.policy"):
        assert counts[name] == STEPS, name
    steps = [(s, e) for n, s, e in events if n == "px.step"]
    for n, s, e in events:
        if n in ("px.pre", "px.post", "px.obs"):
            assert any(s0 <= s and e <= e1 for s0, e1 in steps), n
    for a, b in zip(tree_leaves(on), tree_leaves(off)):
        assert torch.equal(a, b)


def test_train_step_spans_and_the_recompute(lander):
    env, start = lander
    horizon = 4

    def run():
        params = _params(env.observation_size, env.action_size, grad=True)
        step = make_train_step(env, _policy, adam(params), horizon, checkpoint_segments=2)
        params, _, metrics = step(params, start)
        return [params["w"].detach().clone(), params["b"].detach().clone(), metrics["loss"]]

    off = run()
    with profiling.spans():
        on, events = _profiled(run)
    counts = Counter(n for n, _, _ in events)
    for part in ("px.train.forward", "px.train.backward", "px.train.update"):
        assert counts[part] == 1, part
    (_, b0, b1), = [e for e in events if e[0] == "px.train.backward"]
    resets = [s for n, s, _ in events if n == "px.reset"]
    assert len(resets) == 2 * horizon
    assert sum(b0 <= s <= b1 for s in resets) == horizon  # the recompute's
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_spans_restore_the_flag_after_an_exception():
    with pytest.raises(RuntimeError, match="inside"):
        with profiling.spans():
            assert profiling._ON
            assert isinstance(profiling.named("px.x"), torch.profiler.record_function)
            raise RuntimeError("inside")
    assert not profiling._ON
    assert profiling.named("px.x") is profiling.named("px.y")  # the shared no-op
    with profiling.spans():
        with profiling.spans():
            pass
        assert profiling._ON
    assert not profiling._ON
