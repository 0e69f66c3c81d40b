"""The roofline and FLOP arithmetic on small shapes counted by hand, and
the trace reading on a made-up profile."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import roofline, trace


def test_gine_bn_fwd_counted_by_hand():
    # ops 2 (50 + 40) 4 + 4 * 20 * 4 * 8 = 3,280; bytes (2*32*4 + 2*16*16
    # + 32*16 + 16*4 + 2*4*8) * 4 + (8 + 8 + 8 + 4) * 4 = 5,744
    got = roofline.gine_bn_fwd_s(32, 16, 20, 50, 40, 4, 8)
    assert got == pytest.approx(max(3280 / 67e12, 5744 / 3.35e12))
    assert got == pytest.approx(5744 / 3.35e12)       # bound by bytes


def test_operations_bound_at_the_real_width():
    # 12,800 atoms at D = 300, D2 = 600: the MLP's products dominate
    n, d, d2 = 12800, 300, 600
    ops = 2 * (3 * n + 3 * n) * d + 4 * n * d * d2
    assert roofline.gine_bn_fwd_s(n, 256, n, 3 * n, 3 * n, d, d2) == \
        pytest.approx(ops / 67e12)


def test_backward_and_members():
    one = roofline.gine_members_s(64, 16, 40, 90, 80, 8, 16, 1, False)
    six = roofline.gine_members_s(64, 16, 40, 90, 80, 8, 16, 6, False)
    assert six < 6 * one                # the adjacency is read once
    assert roofline.gine_bn_bwd_s(64, 16, 40, 90, 80, 8, 16) > \
        roofline.gine_bn_fwd_s(64, 16, 40, 90, 80, 8, 16)


def test_flops_counted_by_hand():
    # GIN layer: sparse 2 (30 + 25) 4 = 440, dense 4 * 10 * 4 * 8 = 1,280
    assert roofline.layer_flops("gin", 10, 30, 25, 4, 8, False) == 1720
    assert roofline.layer_flops("gin", 10, 30, 25, 4, 8, True) == 3000
    # GCN layer: dense 2 * 10 * 4 * 4 = 320
    assert roofline.layer_flops("gcn", 10, 30, 25, 4, 0, False) == 760
    assert roofline.ntxent_flops(3, 5, False) == 360
    assert roofline.ntxent_flops(3, 5, True) == 720
    # feat_lin 2*2*4*8 + projection 2*2*8*8 + 2*2*8*4
    assert roofline.head_flops(2, 4, 8, "project", False) == 512
    # feat_lin 128 + 2*2*8*4 + 2*2*4*4 + 2*2*4*2
    assert roofline.head_flops(2, 4, 8, "predict", False) == 352


def _event(name, start, end, device=False, annotation=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=(torch.autograd.DeviceType.CUDA if device
                     else torch.autograd.DeviceType.CPU),
        is_user_annotation=annotation)


def test_trace_summary():
    events = [_event("mark", 0, 100, annotation=True),
              _event("mark", 0, 100, device=True, annotation=True),
              _event("aten::foo", 40, 60),
              _event("void fbl::k1f_kernel<float>", 10, 30, device=True),
              _event("elementwise", 25, 40, device=True),
              _event("gemm", 60, 70, device=True)]
    prof = SimpleNamespace(events=lambda: events)
    s = trace.summarize(prof, "mark")
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(40e-6)
    assert s["port_kernel_s"] == pytest.approx(20e-6)
    assert s["port_launches"] == 1
    assert [g[0] for g in s["idle_gaps"]] == [
        "host: outside any traced op", "aten::foo",
        "host: outside any traced op"]
    assert [g[1] for g in s["idle_gaps"]] == pytest.approx(
        [30e-6, 20e-6, 10e-6])
