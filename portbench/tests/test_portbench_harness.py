"""The harness finds every configuration, mix, reader and limit by name,
divides all the work by the whole window, and refuses to run without a
card."""

import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import harness

SPEC = harness.load_spec()
ROOT = Path(harness.__file__).resolve().parents[1]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files_by_name(cell):
    w = harness.cell_of(SPEC, cell)
    config = harness.config_of(SPEC, w["config"])
    assert config["name"] == w["config"]
    from portbench.reference import plain

    assert plain.reference_env(config, "cpu").action_size == 2
    params = harness.mix_params(w["traffic"])
    assert params["rate_metric"] in {m["name"] for m in harness.metrics_of(SPEC, cell, "end_to_end")}
    assert hasattr(harness.mix_module(w["traffic"]), "Session")
    limits = {k: v for k, v in harness.limits_of(cell).items() if isinstance(v, dict)}
    assert limits and all({"limit", "lower", "upper"} <= set(v) for v in limits.values())
    assert all(v["lower"] <= v["limit"] < v["upper"] for v in limits.values())
    names = {m["name"] for m in harness.metrics_of(SPEC, cell, "end_to_end")}
    assert {"setup_s", "peak_mem_gib"} <= names
    per_layer = harness.metrics_of(SPEC, cell, "per_layer")
    assert per_layer
    for m in per_layer:
        assert callable(harness.reader(m["name"]).read)
        assert m["moves"] in names


def test_metrics_without_a_workloads_list_belong_to_every_cell():
    spec = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}]}
    assert [m["name"] for m in harness.metrics_of(spec, "x", "end_to_end")] == ["a", "b"]
    assert [m["name"] for m in harness.metrics_of(spec, "y", "end_to_end")] == ["a"]


class _Units:
    """A session whose units take a known time and work."""

    work = 1000
    rate_metric = "r"

    def __init__(self, seconds, fail_at=()):
        self.seconds, self.fail_at, self.n = seconds, set(fail_at), 0

    def unit(self):
        self.n += 1
        time.sleep(self.seconds)
        if self.n in self.fail_at:
            raise RuntimeError("planted")
        return 1.0


def test_the_rate_is_all_the_work_over_the_whole_window():
    s = _Units(0.05)
    t0 = time.perf_counter()
    win = harness.window(s, 0.3, torch.device("cpu"))
    wall = time.perf_counter() - t0
    assert win["attempted"] == s.n and win["failed"] == 0
    assert win["seconds"] >= 0.3 and win["seconds"] <= wall
    # the last unit started before the close is counted whole, and its time too
    r = harness.rate(win["work"], win["seconds"])
    assert math.isclose(r, s.n * 1000 / win["seconds"])
    assert r < 1000 / 0.05


def test_a_unit_that_raises_counts_as_failed_and_its_work_not():
    s = _Units(0.01, fail_at={2})
    win = harness.window(s, 0.1, torch.device("cpu"))
    assert win["failed"] == 1
    assert win["work"] == (win["attempted"] - 1) * 1000


def test_judge_needs_every_number_within_its_limit():
    ok, compared = harness.judge({"a": 0.5, "b": 0.0}, {"a": {"limit": 1.0}, "b": {"limit": 0.0}})
    assert ok and compared["a"] == {"value": 0.5, "limit": 1.0}
    assert not harness.judge({"a": 1.5}, {"a": {"limit": 1.0}})[0]
    assert not harness.judge({"a": float("nan")}, {"a": {"limit": 1.0}})[0]
    assert not harness.judge({"a": 0.0}, {})[0]


def test_the_measuring_entry_refuses_to_run_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "lunarlander.rollout",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=env,
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_the_entry_fails_in_a_directory_holding_only_the_benchmark(tmp_path):
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "lunarlander.rollout",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
    )
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_per_world_parts_rule():
    world = SimpleNamespace(parts=SimpleNamespace(body=[0, 1, 1, 2]),
                            static_bodies=(False, True, False))
    assert harness.per_world_parts(world, {"per_world_parts": "static"}) == [1, 2]
    assert harness.per_world_parts(world, {"per_world_parts": "none"}) == []
    with pytest.raises(ValueError):
        harness.per_world_parts(world, {"per_world_parts": "all"})


@pytest.mark.parametrize("metric", ["device_idle.rollout", "device_idle.grad"])
def test_idle_share_is_busy_time_a_unit_over_the_untraced_unit(metric):
    """The traced stretch's own length (slowed by the profiler) is not the
    denominator: 0.3 s busy over 2 traced units, 0.6 s a unit untraced."""
    read = harness.reader(metric).read
    traced = SimpleNamespace(busy_s=0.3, units=2, unit_s=0.6, window_s=5.0)
    assert read(traced) == pytest.approx(75.0)
    assert read(SimpleNamespace(busy_s=0.0, units=2, unit_s=0.6, window_s=5.0)) is None
