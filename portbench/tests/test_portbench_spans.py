"""The span reader (``portbench/spans.py``): kernels and idle gaps go to the
innermost span on the launching thread, annotation ranges are not
kernels, the per-span counts sum to the stretch's kernels; the readers
read nothing without a card or without the program's spans; and on the
card, the readers of ``lunarlander.rollout`` at a small batch."""

from types import SimpleNamespace

import pytest
import torch
from conftest import small

from portbench import harness, spans, tracing

SPEC = harness.load_spec()
NEW = ["reset_kernels.rollout", "watchdog_kernels.rollout", "reset_host_ms.rollout",
       "idle_in_reset.rollout", "collide_device_ms", "backward_share.train"]


def _synthetic():
    """Thread 1 runs a step with an auto-reset inside it; thread 2 (the
    autograd engine's) a backward around the whole stretch; thread 3 no
    span.  ``(device, name, start, end, correlation, thread, annotation)``,
    times in ns."""
    cpu = [
        ("cpu", "px.step", 0, 100, 11, 1, True),
        ("cpu", "px.reset", 50, 90, 12, 1, True),
        ("cpu", "px.train.backward", 0, 400, 13, 2, True),
        ("cpu", "Optimizer.step#Adam.step", 120, 130, 14, 2, True),
        ("cpu", "aten::add", 9, 12, 1, 1, False),  # an op whose own id equals a launch's
        ("cpu", "cudaLaunchKernel", 10, 12, 1, 1, False),
        ("cpu", "cudaLaunchKernel", 60, 61, 2, 1, False),
        ("cpu", "cuLaunchKernel", 60, 61, 3, 2, False),
        ("cpu", "cudaLaunchKernel", 300, 301, 4, 2, False),
        ("cpu", "cudaMemcpyAsync", 95, 96, 5, 1, False),
        ("cpu", "cudaLaunchKernel", 380, 381, 6, 3, False),
        ("cpu", "cudaLaunchKernel", 121, 122, 7, 2, False),
    ]
    cuda = [
        ("cuda", "kernel_a", 20, 30, 1, 0, False),
        ("cuda", "kernel_b", 62, 66, 2, 0, False),
        ("cuda", "kernel_c", 66, 70, 3, 0, False),
        ("cuda", "Memcpy DtoD (Device -> Device)", 100, 110, 5, 0, False),
        ("cuda", "kernel_d", 310, 320, 4, 0, False),
        ("cuda", "kernel_e", 390, 395, 6, 0, False),
        ("cuda", "kernel_f", 123, 125, 7, 0, False),
        # the device's annotation ranges: not kernels, not busy time
        ("cuda", "px.step", 20, 70, 11, 0, True),
        ("cuda", "Optimizer.step#Adam.step", 123, 125, 14, 0, True),
    ]
    return cpu + cuda


def test_kernels_go_to_the_innermost_span_on_the_launching_thread():
    rec = spans.attribute(_synthetic())
    assert rec.kernels == {"px.step": 1, "px.reset": 1, "px.train.backward": 3,
                           spans.UNSPANNED: 1}
    assert rec.n_kernels == sum(rec.kernels.values()) == 6
    assert rec.kernel_s["px.train.backward"] == pytest.approx((4 + 10 + 2) * 1e-9)
    assert rec.host_s == pytest.approx({"px.step": 100e-9, "px.reset": 40e-9,
                                        "px.train.backward": 400e-9})


def test_idle_gaps_go_to_the_narrowest_span_at_their_midpoint():
    rec = spans.attribute(_synthetic())
    # busy: [20,30] [62,70] [100,110] [123,125] [310,320] [390,395] of [0,400]
    assert rec.idle_total_s == pytest.approx((400 - 45) * 1e-9)
    assert rec.idle_s == pytest.approx({"px.step": 52e-9, "px.reset": 30e-9,
                                        "px.train.backward": 273e-9})


def test_spans_opening_together_nest_narrowest_inside():
    inner = spans._Innermost([(0, 100, "px.step"), (0, 50, "px.reset"), (7, 7, "px.empty")])
    assert inner.at(10) == ("px.reset", 50)
    assert inner.at(60) == ("px.step", 100)
    assert inner.at(100) is None and inner.at(-1) is None


def test_readers_read_nothing_without_a_card_or_without_spans(monkeypatch):
    cpu = SimpleNamespace(session=SimpleNamespace(device=torch.device("cpu")))
    for name in NEW:
        assert harness.reader(name).read(cpu) is None
    assert cpu.spans is None
    from parallax_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")  # a program from before the spans
    card = SimpleNamespace(session=SimpleNamespace(device=torch.device("cuda")))
    for name in NEW:
        assert harness.reader(name).read(card) is None


def test_new_metrics_are_listed_only_where_they_read():
    listed = {m["name"]: set(m["workloads"]) for m in SPEC["per_layer"] if m["name"] in NEW}
    assert set(listed) == set(NEW)
    rollouts = {"lunarlander.rollout", "billiards48.rollout"}
    assert listed["collide_device_ms"] == {"billiards48.rollout"}
    assert listed["backward_share.train"] == {"lunarlander.train"}
    assert all(listed[n] == rollouts for n in NEW[:4])


@pytest.mark.cuda
def test_span_readers_on_the_card(card):
    cell = harness.cell_of(SPEC, "lunarlander.rollout")
    ctx = harness.make_context(SPEC, cell["name"], 2**31 + 19, card, small(cell))
    session = harness.mix_module(cell["traffic"]).Session(ctx)
    traced = tracing.trace_units(session, card)
    assert not any(k.startswith("px.") for k in traced.kernels)  # spans off in that stretch
    values = {n: harness.reader(n).read(traced) for n in NEW}
    rec = traced.spans
    assert rec is not None and sum(rec.kernels.values()) == rec.n_kernels > 0
    # every kernel of the spans' stretch attributed, and no annotation range among them
    assert rec.n_kernels / rec.steps == pytest.approx(traced.n_kernels / traced.steps, rel=0.01)
    assert values["collide_device_ms"] is None and values["backward_share.train"] is None
    assert 0 < values["reset_kernels.rollout"]
    assert values["reset_kernels.rollout"] + values["watchdog_kernels.rollout"] \
        <= traced.n_kernels / traced.steps
    assert values["reset_host_ms.rollout"] > 0 and 0 <= values["idle_in_reset.rollout"] <= 100
    torch.cuda.empty_cache()
