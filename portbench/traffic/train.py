"""The ``train`` mix: ``parallel.rollout.make_train_step``, the whole
rollout, its backward through the physics and one Adam update a unit.

Set-up builds one train step with its policy and optimizer state, resets
the fleet from keys drawn from the seed, and drives the step through its
first ``check.steps`` steps, each from the states the last one reached
(rows that all differ); the window goes on from there with the same
object.  The check holds those first steps against the reference's:
each step's loss, the first gradient's norm (as Adam's first moment holds
it after one step) and the parameters' change over the steps, leaf by
leaf.
"""

from __future__ import annotations

import torch

from portbench import common
from portbench.reference import plain


class Session:
    def __init__(self, ctx):
        from parallax_tpu_torch.parallel.rollout import adam, make_train_step

        p, dev = ctx.params, ctx.device
        self.ctx, self.device = ctx, dev
        self.env = common.program_env(ctx.config, dev)
        common.plant(self.env, ctx.fault)
        g = common.generator(ctx.seed, dev)
        self.keys = common.keys(g, p["batch"], dev)
        self.params = common.mlp_params(g, self.env.observation_size, self.env.action_size,
                                        p["policy"], dev, requires_grad=True)
        self.params0 = {k: v.detach().clone() for k, v in self.params.items()}
        self.opt = adam(self.params, lr=p["lr"])
        if ctx.fault == "optimizer":  # a step that leaves its state unchanged
            self.opt.step = lambda *a, **k: None
        self.train_step = make_train_step(
            self.env, common.mlp, self.opt, p["horizon"],
            checkpoint_segments=p["checkpoint_segments"], discount=p["discount"],
            max_chunk=p["max_chunk"],
        )
        self.steps_per_unit = p["horizon"]
        self.work = p["batch"] * p["horizon"]
        self.trace_units = p["trace_units"]
        self.rate_metric = p["rate_metric"]
        self.states = self.env.reset_fn_batch(self.keys)
        if ctx.fault == "half":  # half the batch left out, the mean over the rest
            self.states = common.rows_of(self.states, torch.arange(p["batch"] // 2, device=dev))
        self.losses = []
        for i in range(p["check"]["steps"]):
            self.losses.append(self.unit())
            if i == 0:
                st = self.opt.state[self.params["w1"]]
                self.grad1 = {k: self.opt.state[v]["exp_avg"].detach().clone() / (1 - 0.9)
                              for k, v in self.params.items()} if st else None
        self.params_n = {k: v.detach().clone() for k, v in self.params.items()}

    def unit(self) -> float:
        self.params, self.states, m = self.train_step(self.params, self.states)
        return float(m["loss"])

    def release(self):
        self.states = None
        self.train_step = None

    def _numbers(self, losses, grad1, params_n, ref):
        l_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, ref[0]))
        g_gap = common.norm_gap(grad1, ref[1]) if grad1 is not None else float("inf")
        change = {k: params_n[k] - self.params0[k] for k in params_n}
        r_change = {k: ref[2][k] - self.params0[k] for k in ref[2]}
        return {"loss_gap": l_gap, "grad_norm_gap": g_gap,
                "change_norm_gap": common.norm_gap(change, r_change)}

    def _reference(self, control):
        if not control and getattr(self, "_sound_ref", None):
            return self._sound_ref
        p = self.ctx.params
        ref = plain.reference_env(self.ctx.config, self.device)
        out = plain.train_steps(ref, self.params0, ref.reset(self.keys), p["check"]["steps"],
                                p["horizon"], p["discount"], p["lr"], control)
        if not control:  # the control's numbers are held against the same sound reading
            self._sound_ref = out
        return out

    def check(self) -> dict:
        """The compared numbers of this run: the program against the reference."""
        return self._numbers(self.losses, self.grad1, self.params_n, self._reference(False))

    def control(self) -> dict:
        """The same numbers for the control: the reference in bfloat16 in the
        program's place."""
        return self._numbers(*self._reference(True), self._reference(False))
