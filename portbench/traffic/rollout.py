"""The ``rollout`` mix: forward collection through ``rollout_batch``.

Set-up resets ``batch`` worlds from keys drawn from the seed, draws the
policy's weights, and runs the first fragment (the warm-up, which also
loads or builds the kernels).  A unit is one fragment of
``fragment_steps`` steps ending in one host read of its witness.  The
session holds one fragment's trajectory at a time, as a learner would:
the previous one is let go before the next is dispatched, and of the first
only the compared worlds' rows are kept.

The check compares, on worlds drawn from the seed: the reset states with
the reference's own draw from the same keys; the first fragment with the
reference's from its own reset states; and the window's last fragment with
the reference's from the program's state at its start (the reference
follows the program fragment by fragment there).
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
        self.params = common.mlp_params(g, self.env.observation_size, self.env.action_size,
                                        p["policy"], dev)
        self.steps_per_unit = p["fragment_steps"]
        self.work = p["batch"] * p["fragment_steps"]
        self.trace_units = p["trace_units"]
        self.rate_metric = p["rate_metric"]
        self.rows = common.sample_rows(ctx.seed, p["batch"], p["check"]["sample_worlds"])
        self.state = self.env.reset_fn_batch(self.keys)
        self.last = None
        self.unit()
        self.first = self._rows(*self.last)

    def _rows(self, start, traj):
        return common.rows_of(start, self.rows), common.rows_of(traj, self.rows, 1)

    def unit(self) -> float:
        start, self.last = self.state, None
        with torch.no_grad():
            final, traj = self.env.rollout_batch(
                start, common.mlp, self.steps_per_unit, self.params,
                max_chunk=self.ctx.params["max_chunk"],
            )
            witness = traj.reward.sum() + traj.obs.sum() + traj.done.sum()
        self.state, self.last = final, (start, traj)
        return float(witness)

    def release(self):
        """Keep only what the check reads: the compared worlds' rows."""
        self.last = self._rows(*self.last)
        self.state = None

    def _compare(self, control):
        ref = plain.reference_env(self.ctx.config, self.device)
        tol = self.ctx.params["check"]["depart_tol"]
        steps = self.steps_per_unit
        r_reset = ref.reset(self.keys.index_select(0, self.rows.to(self.device)))
        numbers = {"reset_gap": common.reset_gap(
            ref.fields(plain.round_bf16(r_reset)) if control
            else ref.program_fields(self.first[0]), ref.fields(r_reset))}
        firsts, departs = [], []
        for r_start, traj in ((r_reset, self.first[1]),
                              (ref.from_program(self.last[0]), self.last[1])):
            _, r_traj = plain.rollout(ref, r_start, self.params, steps)
            if control:  # the reference in the program's place, in lower precision
                _, traj = plain.rollout(ref, r_start, self.params, steps, control=True)
            first, departed = common.fragment_numbers(traj, r_traj, tol)
            firsts.append(first)
            departs.append(departed)
        numbers["first_step_gap"] = max(firsts)
        numbers["departed_share"] = max(departs)
        return numbers

    def check(self) -> dict:
        """The compared numbers of this run: the program against the reference."""
        return self._compare(False)

    def control(self) -> dict:
        """The same numbers for the control: the reference in bfloat16 in the
        program's place."""
        return self._compare(True)
