"""What the mixes share: the program's env from a configuration file,
the inputs made from the seed, the policy, the faults a test plants in the
program, and the numbers that compare the program with the reference.

Inputs are made on the device from ``--seed`` with one ``torch.Generator``
in a few large calls; the program and the reference are handed the same.
"""

from __future__ import annotations

import importlib

import torch

from portbench.reference import plain


def program_env(config: dict, device):
    """The program's env (``parallax_tpu_torch.envs.<module>``) for a
    configuration file."""
    mod = importlib.import_module(f"parallax_tpu_torch.envs.{config['module']}")
    cfg = getattr(mod, config["config_class"])(**config["config"])
    return getattr(mod, config["env"])(cfg, device=device)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**64)
    return g


def keys(g: torch.Generator, batch: int, device) -> torch.Tensor:
    """``[B, 2]`` PRNG keys, uint32 words held in int64 (the port's layout)."""
    return torch.randint(0, 2**32, (batch, 2), generator=g, dtype=torch.int64, device=device)


def mlp_params(g, obs_size, act_size, policy: dict, device, requires_grad=False) -> dict:
    """The obs -> hidden tanh -> act tanh policy's weights, at the scales of
    the repository's ``bench.py`` train bench (0.3 and 0.1, zero biases)."""
    h = policy["hidden"]
    p = {
        "w1": torch.randn((obs_size, h), generator=g, device=device) * policy["w1_scale"],
        "b1": torch.zeros(h, device=device),
        "w2": torch.randn((h, act_size), generator=g, device=device) * policy["w2_scale"],
        "b2": torch.zeros(act_size, device=device),
    }
    return {k: v.requires_grad_(requires_grad) for k, v in p.items()}


mlp = plain.mlp


def sample_rows(seed: int, batch: int, count: int) -> torch.Tensor:
    """The worlds a check compares, drawn from the seed (sorted)."""
    g = torch.Generator().manual_seed((int(seed) * 7919 + 17) % 2**63)
    return torch.randperm(batch, generator=g)[: min(count, batch)].sort().values


def rows_of(tree, rows, dim=0):
    """Every tensor leaf of a NamedTuple tree indexed by ``rows`` on ``dim``."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(rows_of(x, rows, dim) for x in tree))
    if isinstance(tree, dict):
        return {k: rows_of(v, rows, dim) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.index_select(dim, rows.to(tree.device))
    return tree


# ---------------------------------------------------------------------------
# faults a test plants in the program (never in a benchmark run)
# ---------------------------------------------------------------------------


def plant(env, fault):
    """Break the program's env underneath the timed path: ``frozen`` (a step
    returns its state unchanged), ``half`` (the second half of the batch is
    left out of every step) or ``altered`` (every reward is altered by 0.01
    where it is produced)."""
    if fault is None:
        return
    step = env._plane_step
    post = env.plane_post
    if fault == "frozen":
        def frozen(ps, actions):
            _, aux, t_new, ts = step(ps, actions)
            return ps.s, aux, t_new, ts
        env._plane_step = frozen
    elif fault == "half":
        def half(ps, actions):
            s, aux, t_new, ts = step(ps, actions)
            h = ps.s.px.shape[-1] // 2
            s = type(s)(*(torch.cat([new[..., :h], old[..., h:]], -1) for new, old in zip(s, ps.s)))
            return s, aux, t_new, ts
        env._plane_step = half
    elif fault == "altered":
        def altered(s, aux, con, actions, t_new):
            s, aux, reward, terminated, info = post(s, aux, con, actions, t_new)
            return s, aux, reward + 0.01, terminated, info
        env.plane_post = altered
    elif fault != "optimizer":
        raise ValueError(f"no fault {fault!r}")


# ---------------------------------------------------------------------------
# the numbers compared
# ---------------------------------------------------------------------------


def reset_gap(prog: dict, ref: dict) -> float:
    """Largest difference between the program's and the reference's reset
    states, field by field of the program's published layout, each entry
    over ``max(1, |reference|)``; inf where a field is missing, shaped
    otherwise, or an integer or flag field differs."""
    worst = 0.0
    for name, b in ref.items():
        a = prog.get(name)
        if a is None or tuple(a.shape) != tuple(b.shape):
            return float("inf")
        if b.is_floating_point():
            d = (a.float() - b.float()).abs() / b.float().abs().clamp_min(1.0)
            worst = max(worst, float(torch.nan_to_num(d, nan=float("inf")).max()) if d.numel() else 0.0)
        elif not torch.equal(a.to(b.dtype).cpu(), b.cpu()):
            return float("inf")
    return worst


def step_gaps(p_ts, r_ts) -> torch.Tensor:
    """``[T, K]``: each step's widest gap of a world's observation and
    reward, each entry over ``max(1, |reference|)``; inf where the two
    disagree on terminated or truncated."""
    def rel(a, b):
        d = (a.float() - b.float()).abs() / b.float().abs().clamp_min(1.0)
        return d.reshape(d.shape[0], d.shape[1], -1).amax(-1)

    gap = torch.maximum(rel(p_ts.obs, r_ts.obs), rel(p_ts.reward, r_ts.reward))
    flags = (p_ts.terminated != r_ts.terminated) | (p_ts.truncated != r_ts.truncated)
    gap = torch.where(flags.to(gap.device), torch.full_like(gap, float("inf")), gap)
    return torch.nan_to_num(gap, nan=float("inf"))


def fragment_numbers(p_ts, r_ts, tol: float) -> tuple:
    """``(first_step_gap, departed_share)`` of one fragment: the widest gap
    of its first step over the compared worlds, and the share of worlds
    whose fragment departs from the reference by more than ``tol`` at some
    step (a chaotic world's ulps can grow past any bar within a fragment,
    so the whole fragment is judged by the share)."""
    g = step_gaps(p_ts, r_ts)
    first = float(g[0].max())
    departed = float((g > tol).any(0).float().mean())
    return first, departed


def norm_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf.  Leaves whose reference norm is under a thousandth of the median
    leaf's move by round-off alone and are left out."""
    rn = {k: float(v.float().norm()) for k, v in ref.items()}
    med = sorted(rn.values())[len(rn) // 2]
    worst = 0.0
    for k, v in prog.items():
        if rn[k] < 1e-3 * med:
            continue
        base = max(rn[k], med)
        if base == 0:
            continue
        worst = max(worst, abs(float(v.float().norm()) - rn[k]) / base)
    return worst
