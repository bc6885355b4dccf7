"""The fleet's dry run: the JAX package's two multi-chip programs over a mesh.

The port of ``__graft_entry__.py:dryrun_multichip``, at its shapes per
rank, run by every rank of a world mesh (``parallel/mesh.py``):

1. the LunarLander train step of a fleet above one chunk per device: 5
   worlds a rank at ``max_chunk=2`` (2 full waves and a remainder wave of
   1), 4 steps in 2 checkpoint segments with ``remat_steps``, the 9-16-2
   tanh MLP, Adam at 1e-3 and the gradient all-reduce;
2. RoboCup config 5 (``RoboCupConfig(n_robots_per_team=2)``, 2 worlds a
   rank, 3 steps): the gradient of ``reward.mean() + 1e-3 obs.mean()`` with
   respect to blue robot 0's vx command through the sharded rollout, each
   rank's value and gradient averaged over the ranks.

Keys and weights are the JAX program's (``utils/prng.py`` reproduces
``jax.random``'s threefry keys).  Every check raises on failure; rank 0
prints the two lines JAX prints.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from parallax_tpu_torch.envs.lunar_lander import LunarLander
from parallax_tpu_torch.envs.robocup import RoboCup, RoboCupConfig
from parallax_tpu_torch.parallel.mesh import (
    axis_group,
    gather_batch,
    mesh_device,
    replicated,
    shard_batch,
)
from parallax_tpu_torch.parallel.rollout import adam, make_train_step
from parallax_tpu_torch.utils import prng


def _key(seed: int, device) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed below 2**32."""
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def _same_on_every_rank(label: str, values: torch.Tensor, mesh) -> None:
    rows = gather_batch(values.detach().reshape(1, -1), mesh)
    if not bool((rows == rows[0]).all()):
        raise RuntimeError(f"dryrun_multichip: {label} differs across ranks: {rows.tolist()}")


def _mlp(p, obs):
    return torch.tanh(torch.tanh(obs @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"])


def dryrun_multichip(mesh) -> dict:
    """Run both programs on every rank of the 1-D world ``mesh``; raise on
    any failure.
    Returns this rank's ``{"loss", "mean_return", "reward", "grad"}``."""
    n, rank, group = axis_group(mesh)
    dev = mesh_device(mesh)

    # --- program 1: the lander fleet train step (waves + remainder +
    # checkpoint segments + per-step remat + gradient all-reduce) ---
    env = LunarLander(device=dev)
    chunk, per_rank, n_steps = 2, 5, 4
    B = per_rank * n
    k1, k2 = prng.split(_key(0, dev))
    params = {
        "w1": prng.normal(k1, (env.observation_size, 16)) * 0.1,
        "b1": torch.zeros(16, device=dev),
        "w2": prng.normal(k2, (16, env.action_size)) * 0.1,
        "b2": torch.zeros(env.action_size, device=dev),
    }
    params = replicated({k: v.requires_grad_(True) for k, v in params.items()}, mesh)
    train_step = make_train_step(
        env, _mlp, adam(params, 1e-3), n_steps, checkpoint_segments=2,
        max_chunk=chunk, mesh=mesh, remat_steps=True,
    )
    states = env.reset_fn_batch(shard_batch(prng.split(_key(1, dev), B), mesh))
    params, states, metrics = train_step(params, states)
    loss, ret = metrics["loss"], metrics["mean_return"]
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f"dryrun_multichip: lander fleet loss {loss.item()} is not finite")
    _same_on_every_rank("the lander loss, return and updated params",
                        torch.cat([torch.stack([loss, ret])]
                                  + [p.detach().reshape(-1) for p in params.values()]),
                        mesh)
    if rank == 0:
        print(f"dryrun_multichip fleet OK on {n} devices (B={B}, chunk={chunk}, "
              f"waves=2+rem): loss={loss.item():.4f} mean_return={ret.item():.4f}")

    # --- program 2: RoboCup config 5, the gradient through the sharded
    # rollout ---
    renv = RoboCup(RoboCupConfig(n_robots_per_team=2), device=dev)
    rB = 2 * n
    rstates = renv.reset_fn_batch(shard_batch(prng.split(_key(2, dev), rB), mesh))
    # inside the acceleration-limit band: a saturated clip from rest has a
    # zero gradient
    push = torch.tensor(0.25 * renv.config.robot_max_accel * renv.config.dt,
                        device=dev, requires_grad=True)

    def rpolicy(_, obs):
        rest = torch.zeros(obs.shape[0], renv.action_size - 1, device=dev)
        return torch.cat([push.expand(obs.shape[0], 1), rest], dim=1)  # vx of blue 0

    _, traj = renv.rollout_batch(rstates, rpolicy, 3)
    # the reward alone has no gradient until a robot reaches the ball; the
    # obs (the robot's own state) carries its vx command
    val = traj.reward.mean() + 1e-3 * traj.obs.mean()
    (g,) = torch.autograd.grad(val, push)
    both = torch.stack([val.detach(), g])
    dist.all_reduce(both, op=dist.ReduceOp.SUM, group=group)
    val, g = both / n
    if not (bool(torch.isfinite(val)) and bool(torch.isfinite(g))):
        raise RuntimeError(f"dryrun_multichip: robocup value {val.item()}, grad {g.item()}")
    if g.item() == 0.0:
        raise RuntimeError("dryrun_multichip: the gradient through the sharded robocup rollout died")
    _same_on_every_rank("the robocup value and gradient", torch.stack([val, g]), mesh)
    if rank == 0:
        print(f"dryrun_multichip robocup config-5 OK on {n} devices (B={rB}, 2v2): "
              f"reward={val.item():.4f} grad={g.item():.4f}")
    return {"loss": loss.item(), "mean_return": ret.item(), "reward": val.item(),
            "grad": g.item()}

