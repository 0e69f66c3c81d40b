"""BN-chained fused GCN layer, forward (kernel K3f), and its edge table.

Port of molclr_tpu/ops/fused_gcn.py (`pack_gcn_etab` and the forward of
`fused_gcn_bn_layer`). Per 256-node tile the layer computes

    y    = relu?(x * a + b)                 the PREVIOUS BatchNorm's affine
    xw   = y @ W
    out  = A[t] @ xw + cnt[t] @ etab + bias
    sums = [sum m * out, sum m * out^2]     over real nodes, m = diag(A) > 0

with y, xw and out cast to the activation dtype where the Pallas kernel
casts, and every product accumulated in f32. etab carries the SCALAR edge
tables broadcast across the D columns (pack_gcn_etab).

`fused_gcn_bn_layer` launches the hand-written sm_90a kernels
(csrc/fused_gcn_bn.cu) on CUDA tensors and runs the plain PyTorch version
`fused_gcn_bn_layer_plain` on CPU tensors.
"""

from __future__ import annotations

import torch

from molclr_tpu_torch.ops import _build
from molclr_tpu_torch.ops.fused_layer import (
    CNT_PAD,
    bn_prologue,
    check_layer_args,
    kernel_fn,
    masked_moments,
    strip_rows,
)


def pack_gcn_etab(e1: torch.Tensor, e2: torch.Tensor, d: int,
                  dtype) -> torch.Tensor:
    """Stack the SCALAR edge tables ([5,1] ++ [3,1] ++ zeros) and broadcast
    them across D columns -> contiguous [CNT_PAD, D]."""
    pad = CNT_PAD - e1.shape[0] - e2.shape[0]
    col = torch.cat([e1, e2, e1.new_zeros(pad, 1)], dim=0).to(dtype)
    return col.expand(CNT_PAD, d).contiguous()


def fused_gcn_bn_layer_plain(x, a, b, adj, cnt, etab, w, bias,
                             relu_in: bool = False):
    """The plain PyTorch version of the layer: the same arithmetic and
    cast points as the kernel. Returns (out [N, D], sums [2, D] f32)."""
    dt = x.dtype
    t, s, _ = adj.shape
    n, d = x.shape
    y = bn_prologue(x, a, b, relu_in)
    xw = (y.float() @ w.float()).to(dt)
    out = torch.bmm(adj.float(), xw.float().reshape(t, s, d)).reshape(n, d)
    outc = (out + cnt.float() @ etab.float() + bias).to(dt)
    return outc, masked_moments(outc, adj)


def fused_gcn_bn_layer(x, a, b, adj, cnt, etab, w, bias,
                       relu_in: bool = False):
    """BN-chained fused GCN layer, forward.

    x     [N, D]   RAW previous conv output (f32 or bf16)
    a, b  [D]      f32 BatchNorm coefficients; identity = (ones, zeros,
                   relu_in=False) for the first layer
    adj   [T, S, S] block-diagonal symmetric adjacency, S % 16 == 0
    cnt   [N, CNT_PAD] per-node edge count matrix
    etab  [CNT_PAD, D] column-broadcast scalar edge tables (pack_gcn_etab)
    w     [D, D] in x's dtype; bias [D] f32

    Returns (out [N, D] in x's dtype, sums [2, D] f32). CUDA tensors run
    the sm_90a kernels (counted in `fused_gcn_bn_layer.launches`); CPU
    tensors run fused_gcn_bn_layer_plain, through which autograd flows. The
    backward kernel (K3b) is not ported yet: on CUDA tensors a call that
    would need a gradient raises NotImplementedError."""
    n, d = x.shape
    check_layer_args("fused_gcn_bn_layer",
                     dict(x=x, adj=adj, cnt=cnt, etab=etab, w=w),
                     dict(a=a, b=b, bias=bias), adj, n, d)
    if w.shape != (d, d) or bias.shape != (d,):
        raise ValueError("fused_gcn_bn_layer: w/bias shapes do not match D")
    if x.device.type == "cpu":
        return fused_gcn_bn_layer_plain(x, a, b, adj, cnt, etab, w, bias,
                                        relu_in)
    if torch.is_grad_enabled() and any(
            v.requires_grad for v in (x, a, b, etab, w, bias)):
        # the kernel's output has no grad_fn: training on the card would
        # silently skip every trunk gradient
        raise NotImplementedError(
            "K3b not ported: fused_gcn_bn_layer has no backward on CUDA "
            "yet (GCN training runs on the CPU only)")
    if x.device.type != "cuda":
        raise ValueError(f"fused_gcn_bn_layer: no kernel for {x.device}")
    t, s, _ = adj.shape
    strip = strip_rows("fused_gcn_bn")
    if s % strip:
        raise ValueError(f"fused_gcn_bn_layer: tile {s} is not a multiple "
                         f"of {strip}")
    suffix = "f32" if x.dtype == torch.float32 else "bf16"
    fn = kernel_fn("fused_gcn_bn", f"gcn_bn_fwd_{suffix}", 12, 4)
    out = torch.empty_like(x)
    xw = torch.empty_like(x)
    sums = torch.empty(2, d, dtype=torch.float32, device=x.device)
    partial = torch.empty(t * (s // strip), 2, d, dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), adj.data_ptr(),
             cnt.data_ptr(), etab.data_ptr(), w.data_ptr(), bias.data_ptr(),
             xw.data_ptr(), out.data_ptr(), partial.data_ptr(),
             sums.data_ptr(), t, s, d, int(bool(relu_in)), stream)
    _build.check(err, "fused_gcn_bn_layer")
    fused_gcn_bn_layer.launches += 1
    return out, sums


fused_gcn_bn_layer.launches = 0
