"""The ``shoot`` mix: shooting through ``step_fn_batch`` and its backward.

Set-up resets the fleet from keys drawn from the seed (fixed for the
window), draws the plan ``[plan_steps, B, act]`` from the seed, and runs
the first ``check.steps`` iterations, which the reference follows; the
window goes on with the same plan and optimizer.  The check compares each
iteration's loss, the first gradient's norm (from Adam's first moment after
one step) and the plan's change over the iterations.
"""

from __future__ import annotations

import torch

from portbench import common
from portbench.reference import plain


class Session:
    def __init__(self, ctx):
        p, dev = ctx.params, ctx.device
        self.ctx, self.device = ctx, dev
        self.env = common.program_env(ctx.config, dev)
        common.plant(self.env, ctx.fault)
        g = common.generator(ctx.seed, dev)
        self.keys = common.keys(g, p["batch"], dev)
        self.plan0 = torch.randn((p["plan_steps"], p["batch"], self.env.action_size),
                                 generator=g, device=dev) * p["plan_scale"]
        self.plan = self.plan0.clone().requires_grad_(True)
        self.opt = torch.optim.Adam([self.plan], lr=p["lr"], betas=(0.9, 0.999), eps=1e-8)
        if ctx.fault == "optimizer":
            self.opt.step = lambda *a, **k: None
        self.steps_per_unit = p["plan_steps"]
        self.work = p["batch"] * p["plan_steps"]
        self.trace_units = p["trace_units"]
        self.rate_metric = p["rate_metric"]
        self.start = self.env.reset_fn_batch(self.keys)
        self.rows = p["batch"] // 2 if ctx.fault == "half" else p["batch"]
        self.losses = []
        for i in range(p["check"]["steps"]):
            self.losses.append(self.unit())
            if i == 0:
                st = self.opt.state.get(self.plan)
                self.grad1 = st["exp_avg"].detach().clone() / (1 - 0.9) if st else None
        self.plan_n = self.plan.detach().clone()

    def unit(self) -> float:
        self.opt.zero_grad(set_to_none=True)
        s, total = self.start, 0.0
        for t in range(self.steps_per_unit):
            s, ts = self.env.step_fn_batch(s, self.plan[t])
            total = total + ts.reward
        loss = -torch.mean(total[: self.rows])
        loss.backward()
        self.opt.step()
        return float(loss.detach())

    def release(self):
        pass

    def _numbers(self, losses, grad1, plan_n, ref):
        l_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, ref[0]))
        g_gap = (common.norm_gap({"plan": grad1}, {"plan": ref[1]})
                 if grad1 is not None else float("inf"))
        c_gap = common.norm_gap({"plan": plan_n - self.plan0}, {"plan": ref[2] - self.plan0})
        return {"loss_gap": l_gap, "grad_norm_gap": g_gap, "change_norm_gap": c_gap}

    def _reference(self, control):
        if not control and getattr(self, "_sound_ref", None):
            return self._sound_ref
        p = self.ctx.params
        ref = plain.reference_env(self.ctx.config, self.device)
        out = plain.shoot_steps(ref, ref.reset(self.keys), self.plan0, p["check"]["steps"],
                                p["lr"], control)
        if not control:  # the control's numbers are held against the same sound reading
            self._sound_ref = out
        return out

    def check(self) -> dict:
        """The compared numbers of this run: the program against the reference."""
        return self._numbers(self.losses, self.grad1, self.plan_n, self._reference(False))

    def control(self) -> dict:
        """The same numbers for the control: the reference in bfloat16 in the
        program's place."""
        return self._numbers(*self._reference(True), self._reference(False))
