"""The Graphormer cell's yardstick and readers: roofline_graphormer's
counts on a hand-counted molecule, the four per-layer readers on a
fabricated run record, the range reader on a hand-built event list, the
reference standing alone, and a tiny CPU run of the cell, untraced and
traced."""

import ast
import time
from types import SimpleNamespace as NS

import pytest
import torch

from benchmark import harness
from benchmark import roofline_graphormer as rg
from benchmark.loops import finetune_graphormer as loop

CELL = "graphormer.finetune_hiv_b128"
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def test_counts_on_a_hand_counted_molecule():
    """One molecule of 2 atoms: 3 rows with its graph token, 9 pairs; d 4,
    f 6, 2 heads, 1 layer, 2 outputs. Forward: q, k, v, out 4 x 2 x 3 x
    16 = 384, fc1 and fc2 2 x 2 x 3 x 24 = 288, attention 2 x 2 x 9 x 4
    = 144, head 2 x (16 + 8) = 48: 864. Backward twice the products and
    the head, 8 x 9 x 4 = 288 for the attention: 1,728 more."""
    kw = dict(d=4, f=6, layers=1, out=2)
    assert rg.step_flops(3, 9, 1, backward=False, **kw) == 864
    assert rg.step_flops(3, 9, 1, backward=True, **kw) == 864 + 1728
    assert rg.attention_flops(9, 4, False) == 144
    assert rg.attention_flops(9, 4, True) == 288
    # forward q, k, v, out 4 x 3 x 4 floats, bias 9 x 2; backward 8 x 3
    # x 4 and the bias and its gradient 2 x 9 x 2
    assert rg.attention_bytes(3, 9, 4, 2, False) == 4 * (48 + 18)
    assert rg.attention_bytes(3, 9, 4, 2, True) == 4 * (96 + 36)
    assert rg.attention_bound_s(3, 9, 4, 2, False) == max(
        144 / rg.PEAK_F32, 4 * 66 / rg.HBM_BPS)


def _run(**extra):
    return {"kind": "finetune_graphormer", "model_flops": 6.7e12,
            "window_s": 2.0, "peak_flops": 67e12, "busy_s": 0.9,
            "profiled_window_s": 1.0, "attn_bound_s": 0.002,
            "attn_device_s": 0.01, "bias_device_s": 0.003,
            "eager_steps": 2, **extra}


def test_readers_on_a_fabricated_run():
    got = {name: harness.reader(name)(_run()) for name in (
        "step_mfu.graphormer", "device_idle.graphormer",
        "attn_roofline.graphormer", "bias_ms_per_step.graphormer")}
    assert got == pytest.approx({
        "step_mfu.graphormer": 5.0, "device_idle.graphormer": 10.0,
        "attn_roofline.graphormer": 20.0,
        "bias_ms_per_step.graphormer": 1.5})
    for name in got:
        assert harness.reader(name)({"kind": "finetune"}) is None
        assert harness.reader(name)({}) is None


def _ev(name, a, b, device=CPU, thread=1, id=0):
    return NS(name=name, time_range=NS(start=a, end=b), device_type=device,
              thread=thread, id=id, is_user_annotation=False)


def test_range_reader_places_kernels_by_their_launch():
    """A kernel launched inside graphormer.attn on autograd's thread (the
    backward's range there), one inside graphormer.bias on the caller's,
    one outside every range, one launched before the marker."""
    events = [_ev("mark", 0, 100),
              _ev("graphormer.bias", 10, 20),
              _ev("graphormer.attn", 30, 60, thread=2),
              _ev("cudaLaunchKernel", 12, 13, id=1),
              _ev("cudaLaunchKernel", 40, 41, thread=2, id=2),
              _ev("cudaLaunchKernel", 70, 71, id=3),
              _ev("k1", 14, 18, CUDA, id=1), _ev("k2", 45, 75, CUDA, id=2),
              _ev("k3", 72, 80, CUDA, id=3)]
    got = loop.range_device_s(events, "mark")
    assert got == pytest.approx({"graphormer.bias": 4e-6,
                                 "graphormer.attn": 30e-6,
                                 "graphormer.ffn": 0.0, loop.OTHER: 8e-6})


def test_reference_imports_no_kernel():
    path = harness.HERE / "reference" / "graphormer.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0] if node.level == 0
                      else "." + (node.module or ""))
    assert names <= {"__future__", "contextlib", "torch"}


def _tiny():
    _, _, config, traffic, limits = harness.load_cell(CELL)
    config = dict(config, num_hidden_layers=2, embedding_dim=32,
                  ffn_embedding_dim=32, num_attention_heads=4)
    traffic = dict(traffic, molecules_total=300, batch_size=16)
    return config, traffic, limits


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_on_the_cpu(trace):
    """The cell at a tiny size on the CPU: correct, every step counted;
    traced, the model FLOPs' reading (the CPU run has no device trace, so
    the other three readers find nothing and say so)."""
    config, traffic, limits = _tiny()
    r = harness.run_cell(CELL, 2**31 + 91, 0.5, trace, torch.device("cpu"),
                         time.perf_counter(), config=config,
                         traffic=traffic, limits=limits)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    if trace:
        assert set(r["metrics"]) == {"step_mfu.graphormer"}
    else:
        assert set(r["metrics"]) == {"finetune_mol_per_s", "setup_s"}
