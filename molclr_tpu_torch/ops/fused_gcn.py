"""Fused GCN layers: the BN-chained forward (kernel K3f) with its edge
table, and the unchained layer of the fine-tuning trunk (kernels K5f /
K5b).

Port of molclr_tpu/ops/fused_gcn.py (`pack_gcn_etab`, the forward of
`fused_gcn_bn_layer`, and `fused_gcn_layer` with its custom VJP, whose
section is at the end of the module). Per 256-node tile the BN-chained
layer computes

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
    BWD_CHUNK_ROWS,
    CNT_PAD,
    bn_prologue,
    check_layer_args,
    cuda_tiles,
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
    t, s = cuda_tiles("fused_gcn_bn_layer", x, adj, "fused_gcn_bn")
    strip = strip_rows("fused_gcn_bn")
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


# ---------------------------------------------------------------------------
# The unchained layer (kernels K5f / K5b): `fused_gcn_layer` of the JAX
# package, which the fine-tuning trunk runs: A @ (x @ W) only; the scalar
# edge term (tile_dense.gcn_edge_term) and the bias stay outside the kernel.


def fused_gcn_layer_plain(x, adj, w):
    """The plain forward (`_fwd_kernel` line by line): xw = rnd(x @ W), out
    = rnd(A @ xw), rnd the cast to x's dtype."""
    dt = x.dtype
    t, s, _ = adj.shape
    n, d = x.shape
    xw = (x.float() @ w.float()).to(dt)
    out = torch.bmm(adj.float(), xw.float().reshape(t, s, d)).reshape(n, d)
    return out.to(dt)


def fused_gcn_layer_bwd_plain(g, x, adj, w):
    """The plain backward (`_bwd_kernel` line by line): dxw = rnd(A @ g),
    dx = rnd(dxw @ W^T), dW = x^T @ dxw in f32. Returns (dx, dW)."""
    dt = g.dtype
    t, s, _ = adj.shape
    n, d = g.shape
    # adjacency blocks are symmetric: the adjoint of A @ . is A @ .
    dxw = torch.bmm(adj.float(), g.float().reshape(t, s, d)).reshape(n, d)
    dxw = dxw.to(dt)
    return (dxw.float() @ w.float().t()).to(dt), x.float().t() @ dxw.float()


def _check_gcn_args(name, x, adj, w):
    n, d = x.shape
    check_layer_args(name, dict(x=x, adj=adj, w=w), {}, adj, n, d)
    if w.shape != (d, d):
        raise ValueError(f"{name}: w {tuple(w.shape)} does not match D")


def fused_gcn_layer_fwd(x, adj, w):
    """Forward of the unchained layer (kernel K5f, counted in
    `fused_gcn_layer.launches`) on CUDA tensors; the plain version on CPU
    tensors."""
    if x.device.type == "cpu":
        return fused_gcn_layer_plain(x, adj, w)
    t, s = cuda_tiles("fused_gcn_layer", x, adj, "fused_gcn_bn")
    d = x.shape[1]
    suffix = "f32" if x.dtype == torch.float32 else "bf16"
    fn = kernel_fn("fused_gcn_bn", f"gcn_fwd_{suffix}", 5, 3)
    xw, out = torch.empty_like(x), torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), adj.data_ptr(), w.data_ptr(), xw.data_ptr(),
             out.data_ptr(), t, s, d, stream)
    _build.check(err, "fused_gcn_layer")
    fused_gcn_layer.launches += 1
    return out


def fused_gcn_layer_bwd(g, x, adj, w):
    """Backward of the unchained layer (kernel K5b): (dx in g's dtype, dW
    f32). CUDA tensors run the sm_90a kernels (counted in
    `fused_gcn_layer_bwd.launches`); CPU tensors run the plain version. x
    is the saved input: nothing is recomputed but xw's adjoint."""
    _check_gcn_args("fused_gcn_layer_bwd", g, adj, w)
    if x.shape != g.shape or x.dtype != g.dtype or not x.is_contiguous():
        raise ValueError("fused_gcn_layer_bwd: x must match g")
    if g.device.type == "cpu":
        return fused_gcn_layer_bwd_plain(g, x, adj, w)
    t, s = cuda_tiles("fused_gcn_layer_bwd", g, adj, "fused_gcn_bn")
    n, d = g.shape
    suffix = "f32" if g.dtype == torch.float32 else "bf16"
    fn = kernel_fn("fused_gcn_bn", f"gcn_bwd_{suffix}", 9, 4)
    chunks = -(-n // BWD_CHUNK_ROWS)
    wt, dxw, dx = w.new_empty(d, d), torch.empty_like(g), torch.empty_like(g)
    part_w = torch.empty(chunks, d * d, dtype=torch.float32, device=g.device)
    dw = torch.empty(d, d, dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(*(v.data_ptr() for v in (g, x, adj, w, wt, dxw, dx, part_w, dw)),
             t, s, d, chunks, stream)
    _build.check(err, "fused_gcn_layer_bwd")
    fused_gcn_layer_bwd.launches += 1
    return dx, dw


fused_gcn_layer_bwd.launches = 0


class _Gcn(torch.autograd.Function):
    """K5f forward, K5b backward (`_fused_fwd` / `_fused_bwd` of the JAX
    package: x saved, dW returned in w's dtype)."""

    @staticmethod
    def forward(ctx, x, adj, w):
        ctx.save_for_backward(x, adj, w)
        return fused_gcn_layer_fwd(x, adj, w)

    @staticmethod
    def backward(ctx, g):
        x, adj, w = ctx.saved_tensors
        dx, dw = fused_gcn_layer_bwd(g.contiguous(), x, adj, w)
        return dx, None, dw.to(w.dtype)


def fused_gcn_layer(x, adj, w):
    """A @ (x @ W) per 256-node tile.

    x   [N, D]    node features (f32 or bf16)
    adj [T, S, S] block-diagonal symmetric adjacency, S % 16 == 0
    w   [D, D]    in x's dtype

    Returns out [N, D] in x's dtype. CUDA tensors run the sm_90a kernels
    (counted in `fused_gcn_layer.launches`); CPU tensors run
    fused_gcn_layer_plain. Differentiable in x and w when grad mode is on
    and either requires a gradient (backward K5b); adj gets none."""
    _check_gcn_args("fused_gcn_layer", x, adj, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Gcn.apply(x, adj, w)
    return fused_gcn_layer_fwd(x, adj, w)


fused_gcn_layer.launches = 0
