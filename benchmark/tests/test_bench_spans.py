"""benchmark/spans.py on a hand-built event list (self time, idle time
under the innermost program range, kernels under the range that launched
them), its readings on synthetic tables, and the tiny CPU traced run of
each pretraining cell with the eager-step block."""

import math
from types import SimpleNamespace as NS

import pytest
import torch

from benchmark import spans
from benchmark.tests import tiny

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _ev(name, a, b, device=CPU, thread=1, id=0, annotation=False):
    return NS(name=name, time_range=NS(start=a, end=b), device_type=device,
              thread=thread, id=id, is_user_annotation=annotation)


def _events():
    """A 100 us window: pretrain.dispatch [10, 50] around graphed.replay
    [20, 40], pretrain.validate [60, 95] around step.views [65, 75]. On
    the device: a graph replay's kernel [25, 55] launched in
    graphed.replay; a kernel [70, 90] launched at 67 from another thread
    (autograd's), inside step.views on the caller's; one [0, 5] launched
    at 3, outside every range; one [92, 94] whose launch is not traced."""
    return [
        _ev("bench.window", 0, 100),
        _ev("pretrain.dispatch", 10, 50), _ev("graphed.replay", 20, 40),
        _ev("pretrain.validate", 60, 95), _ev("step.views", 65, 75),
        _ev("step.encode", 30, 35, thread=2),       # another thread
        _ev("cudaGraphLaunch", 22, 25, id=1),
        _ev("cudaLaunchKernel", 67, 68, thread=2, id=2),
        _ev("cudaLaunchKernel", 3, 4, id=3),
        _ev("bench.window", 0, 100, device=CUDA, annotation=True),
        _ev("k2", 25, 55, device=CUDA, id=1),
        _ev("k3", 70, 90, device=CUDA, id=2),
        _ev("k1", 0, 5, device=CUDA, id=3),
        _ev("k4", 92, 94, device=CUDA, id=99),
    ]


def test_self_idle_and_device_time_by_innermost_range():
    t = spans.read(_events(), "bench.window")
    us = 1e-6
    want = {  # count, total, self, idle, device (us)
        "pretrain.dispatch": (1, 40, 20, 10, 0),
        "graphed.replay": (1, 20, 20, 5, 30),
        "pretrain.validate": (1, 35, 25, 8, 0),
        "step.views": (1, 10, 10, 5, 20),
    }
    for name, (n, total, self_, idle, dev) in want.items():
        r = t[name]
        assert r["count"] == n, name
        for field, v in zip(spans.FIELDS[1:], (total, self_, idle, dev)):
            assert r[field] == pytest.approx(v * us), (name, field)
    assert t[spans.NONE]["idle_s"] == pytest.approx(15 * us)
    assert t[spans.NONE]["device_s"] == pytest.approx(7 * us)
    assert "step.encode" not in t
    assert t["window"]["window_s"] == pytest.approx(100 * us)
    assert t["window"]["idle_s"] == pytest.approx(43 * us)
    assert t["window"]["device_s"] == pytest.approx(57 * us)
    assert spans.named_idle_share(t) == pytest.approx(100 * 28 / 43)
    lines = spans.idle_lines(t)
    assert spans.NONE in lines[1] and "34.88 %" in lines[1]


def test_a_missing_marker_raises():
    with pytest.raises(RuntimeError, match="no 'other'"):
        spans.read(_events(), "other")


def _row(**kw):
    return {**dict.fromkeys(spans.FIELDS, 0.0), "count": 1, **kw}


def test_readings_and_none_where_a_range_is_missing():
    window = {"pretrain.validate": _row(total_s=0.05),
              "pretrain.dispatch": _row(count=16, self_s=0.008),
              "graphed.replay": _row(count=14, device_s=0.168),
              "window": {"window_s": 0.5, "idle_s": 0.1, "device_s": 0.4},
              spans.NONE: _row(count=0, idle_s=0.01)}
    eager = {"step.views": _row(count=4, device_s=0.004),
             "step.encode": _row(count=4, device_s=0.012),
             "window": {"window_s": 0.1, "idle_s": 0.0, "device_s": 0.02}}
    got = spans.readings(window, 16, eager)
    assert got.pop("eager_part_ms") == pytest.approx(
        {"step.encode": 3.0, "step.views": 1.0})
    assert got == pytest.approx({
        "valid_ms_per_epoch": 50.0, "dispatch_ms_per_step": 0.5,
        "aug_ms_per_step": 1.0, "named_idle_share": 90.0,
        "device_ms_per_replay": 12.0, "eager_step_device_ms": 5.0,
        "eager_parts_share": 80.0})
    none = dict.fromkeys(("valid_ms_per_epoch", "dispatch_ms_per_step",
                          "aug_ms_per_step", "named_idle_share",
                          "device_ms_per_replay"))
    assert spans.readings({}, 16) == none
    assert spans.readings(None, 0, None) == none
    assert spans.named_idle_share({"window": {"idle_s": 0.0}}) is None


@pytest.mark.parametrize("cell", ["gin.pretrain_node_b512",
                                  "gcn.pretrain_node_b512",
                                  "gin.pretrain_subgraph_b512"])
def test_tiny_traced_run_gives_its_cells_numbers(monkeypatch, cell):
    """The tiny CPU traced run of a pretraining cell, its profiled
    sub-window read by spans.read and the eager-step block run after the
    window, as the loop's calls would: every number is finite."""
    from benchmark import trace as tracelib
    from benchmark.loops import pretrain as lp

    got = {}
    summarize, profiled, window = tracelib.summarize, lp._profiled, \
        lp._window

    def reading(prof, marker):
        got["window"] = spans.read(prof.events(), marker)
        return summarize(prof, marker)

    def pre(ctx, pt, epoch, orders, out):
        got["steps"] = len(orders)
        return profiled(ctx, pt, epoch, orders, out)

    def win(ctx, pt, *a):
        window(ctx, pt, *a)
        got["eager"] = spans.eager_block(ctx, pt)

    monkeypatch.setattr(tracelib, "summarize", reading)
    monkeypatch.setattr(lp, "_profiled", pre)
    monkeypatch.setattr(lp, "_window", win)
    res = tiny.run(cell, trace=True)
    assert res["correct"]
    nums = spans.readings(got["window"], got["steps"], got["eager"])
    for k in ("valid_ms_per_epoch", "dispatch_ms_per_step",
              "aug_ms_per_step", "eager_step_device_ms"):
        assert nums[k] is not None and math.isfinite(nums[k]), k
    # on the CPU the device is idle throughout, all of it under ranges but
    # the harness's own calls between them
    assert nums["named_idle_share"] > 90.0
    assert set(nums["eager_part_ms"]) == {
        "step.take", "step.views", "step.encode", "step.loss",
        "step.backward", "step.adam"}
    assert got["window"]["pretrain.dispatch"]["count"] == got["steps"]
    assert got["window"]["pretrain.keys"]["count"] == 1
