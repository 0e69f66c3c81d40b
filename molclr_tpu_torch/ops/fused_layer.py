"""Fused GINE layers: the BN-chained layer (kernels K1f / K1b), the
unchained layer of the fine-tuning trunk (kernels K4f / K4b), and their
helpers.

Port of molclr_tpu/ops/fused_layer.py (`CNT_PAD`, `pack_cnt`, `pack_etab`,
`_adj_diag_mask`, `fused_gine_bn_layer` and `fused_gine_layer` with their
custom VJPs). `fused_gine_layer` is the BN-chained layer below without
the prologue and the moments (out = relu((A @ h + cnt @ etab) @ W1 + b1)
@ W2 + b2); its section is at the end of the module. Per 256-node tile the
BN-chained layer computes

    y    = relu?(h * a + b)            the PREVIOUS BatchNorm's affine
    agg  = A[t] @ y + cnt[t] @ etab    neighbor sum + edge-embedding sum
    out  = relu(agg @ W1 + b1) @ W2 + b2
    sums = [sum m * out, sum m * out^2]  over real nodes, m = diag(A) > 0

with y, agg, mid and out cast to the activation dtype exactly where the
Pallas kernel casts, and every product accumulated in f32. The backward
takes the cotangents (g, dsums) of (out, sums) as `_bn_fused_bwd` does and
returns the gradients of h, a, b, etab, W1, b1, W2 and b2 (none for adj and
cnt, which are mask-derived constants).

`fused_gine_bn_layer` launches the hand-written sm_90a kernels
(csrc/fused_gine_bn.cu) on CUDA tensors and runs the plain PyTorch versions
(`fused_gine_bn_layer_plain`, `fused_gine_bn_layer_bwd_plain`) on CPU
tensors. When a gradient is needed it goes through `torch.autograd.
Function`: K1f then also writes the residuals agg and mid, and the backward
is K1b (or the plain backward on the CPU, so that bf16 rounds where the
kernel rounds).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from molclr_tpu_torch.ops import _build

# cnt is padded to this many columns (bond-type counts ++ bond-dir counts ++
# zeros); etab rows beyond the real tables are zero.
CNT_PAD = 16

_ACT_DTYPES = (torch.float32, torch.bfloat16)


def adj_diag_mask(adj: torch.Tensor) -> torch.Tensor:
    """Node mask [N, 1] (f32) from the adjacency diagonal: real nodes always
    carry the slot-0 self-loop and padded rows are all-zero, so
    diag(A) > 0 IS node_mask."""
    diag = torch.diagonal(adj.float(), dim1=1, dim2=2).reshape(-1, 1)
    return (diag > 0.0).float()


def pack_cnt(cnt_t: torch.Tensor, cnt_d: torch.Tensor) -> torch.Tensor:
    """[N, 5] bond-type counts ++ [N, 3] bond-dir counts -> [N, CNT_PAD]."""
    n = cnt_t.shape[0]
    pad = CNT_PAD - cnt_t.shape[1] - cnt_d.shape[1]
    return torch.cat([cnt_t, cnt_d, cnt_t.new_zeros(n, pad)], dim=1)


def pack_etab(e1: torch.Tensor, e2: torch.Tensor, dtype) -> torch.Tensor:
    """Stack the edge tables into [CNT_PAD, D] (zero rows beyond them)."""
    pad = CNT_PAD - e1.shape[0] - e2.shape[0]
    return torch.cat([e1, e2, e1.new_zeros(pad, e1.shape[1])],
                     dim=0).to(dtype)


def bn_prologue(h: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                relu_in: bool) -> torch.Tensor:
    """relu?(h * a + b) in f32, cast to h's dtype."""
    y = h.float() * a + b
    if relu_in:
        y = torch.relu(y)
    return y.to(h.dtype)


def masked_moments(outc: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """[sum m * out, sum m * out^2] over rows -> [2, D] f32, with m from
    the adjacency diagonal; outc is the CAST output."""
    of = outc.float()
    ob = of * adj_diag_mask(adj)
    return torch.stack([ob.sum(dim=0), (ob * of).sum(dim=0)])


def fused_gine_bn_layer_fwd_plain(h, a, b, adj, cnt, etab, w1, b1, w2, b2,
                                  relu_in: bool):
    """The plain forward with its residuals: (out, sums, agg, mid)."""
    dt = h.dtype
    t, s, _ = adj.shape
    n, d = h.shape
    y = bn_prologue(h, a, b, relu_in)
    agg = torch.bmm(adj.float(), y.float().reshape(t, s, d)).reshape(n, d)
    aggc = (agg + cnt.float() @ etab.float()).to(dt)
    mid = torch.relu(aggc.float() @ w1.float() + b1).to(dt)
    outc = (mid.float() @ w2.float() + b2).to(dt)
    return outc, masked_moments(outc, adj), aggc, mid


def fused_gine_bn_layer_plain(h, a, b, adj, cnt, etab, w1, b1, w2, b2,
                              relu_in: bool = False):
    """The plain PyTorch version of the layer: the same arithmetic and
    cast points as the kernel. Returns (out [N, D], sums [2, D] f32)."""
    return fused_gine_bn_layer_fwd_plain(h, a, b, adj, cnt, etab, w1, b1, w2,
                                         b2, relu_in)[:2]


def fused_gine_bn_layer_bwd_plain(g, dsums, h, a, b, adj, cnt, agg, mid,
                                  out, w1, w2, relu_in: bool = False):
    """The plain PyTorch version of the backward (`_bn_bwd_kernel` line by
    line, the same cast points as K1b). Returns (dh [N, D] act, da [D],
    db [D], dW1 [D, 2D], db1 [2D], dW2 [2D, D], db2 [D], detab
    [CNT_PAD, D]), all but dh in f32."""
    dt = g.dtype
    t, s, _ = adj.shape
    n, d = g.shape
    m = adj_diag_mask(adj)
    # total output cotangent: downstream grad + the moment sums' adjoint
    gt = g.float() + m * (dsums[0] + 2.0 * out.float() * dsums[1])
    gtc = gt.to(dt)
    dmid = gtc.float() @ w2.float().t()
    dmid = torch.where(mid.float() > 0.0, dmid, 0.0)
    dmidc = dmid.to(dt)
    daggc = (dmidc.float() @ w1.float().t()).to(dt)
    # adjacency blocks are symmetric: the adjoint of A @ . is A @ .
    dx = torch.bmm(adj.float(), daggc.float().reshape(t, s, d)).reshape(n, d)
    hf = h.float()
    dpre = torch.where(hf * a + b > 0.0, dx, 0.0) if relu_in else dx
    return ((dpre * a).to(dt), (dpre * hf).sum(dim=0), dpre.sum(dim=0),
            agg.float().t() @ dmidc.float(), dmid.sum(dim=0),
            mid.float().t() @ gtc.float(), gt.sum(dim=0),
            cnt.float().t() @ daggc.float())


def check_layer_args(name: str, act: dict, f32: dict, adj: torch.Tensor,
                     n: int, d: int) -> None:
    """Shared argument checks of the fused layer wrappers: activation-dtype
    tensors `act`, f32 tensors `f32`, one device, contiguous, the tile
    layout n = T * S with adj [T, S, S], and the shapes of the BatchNorm
    coefficients a, b and of cnt / etab where they are given."""
    dev = adj.device
    dt = next(iter(act.values())).dtype
    if dt not in _ACT_DTYPES:
        raise TypeError(f"{name}: activation dtype {dt} not in {_ACT_DTYPES}")
    for k, v in {**act, **f32}.items():
        want = dt if k in act else torch.float32
        if v.dtype != want:
            raise TypeError(f"{name}: {k} is {v.dtype}, expected {want}")
        if v.device != dev:
            raise ValueError(f"{name}: {k} on {v.device}, adj on {dev}")
        if not v.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    t, s, s2 = adj.shape
    if s != s2 or t * s != n:
        raise ValueError(f"{name}: adj {tuple(adj.shape)} does not tile "
                         f"{n} nodes")
    for k in ("a", "b"):
        if k in f32 and f32[k].shape != (d,):
            raise ValueError(f"{name}: {k} has shape {tuple(f32[k].shape)}")
    if ("cnt" in act and act["cnt"].shape != (n, CNT_PAD)) or (
            "etab" in act and act["etab"].shape != (CNT_PAD, d)):
        raise ValueError(f"{name}: cnt/etab must be [N, {CNT_PAD}] and "
                         f"[{CNT_PAD}, D]")


@functools.lru_cache(maxsize=None)
def kernel_fn(source: str, fn: str, n_ptr: int, n_int: int):
    """The C entry point `fn` of csrc/<source>.cu with its ctypes
    signature: n_ptr pointers, n_int ints, then the stream."""
    f = getattr(_build.load(source), fn)
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


@functools.lru_cache(maxsize=None)
def strip_rows(source: str) -> int:
    """Rows per block of the kernels in csrc/<source>.cu; tiles must be a
    multiple of it."""
    f = _build.load(source).fbl_strip_rows
    f.argtypes = []
    f.restype = ctypes.c_int
    return f()


def cuda_tiles(name: str, h: torch.Tensor, adj: torch.Tensor,
               source: str = "fused_gine_bn"):
    """(T, S) of a CUDA call into csrc/<source>.cu, after checking the
    device and the strip."""
    if h.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {h.device}")
    t, s, _ = adj.shape
    strip = strip_rows(source)
    if s % strip:
        raise ValueError(f"{name}: tile {s} is not a multiple of {strip}")
    return t, s


def fused_gine_bn_layer_fwd(h, a, b, adj, cnt, etab, w1, b1, w2, b2,
                            relu_in: bool, residuals: bool):
    """Forward of the layer (kernel K1f) with its residuals: (out, sums,
    agg, mid); agg and mid are None unless `residuals` (the CPU path, the
    plain version, always has them). Launches K1f on CUDA tensors."""
    if h.device.type == "cpu":
        return fused_gine_bn_layer_fwd_plain(h, a, b, adj, cnt, etab, w1, b1,
                                             w2, b2, relu_in)
    t, s = cuda_tiles("fused_gine_bn_layer", h, adj)
    n, d = h.shape
    d2 = w1.shape[1]
    suffix = "f32" if h.dtype == torch.float32 else "bf16"
    fn = kernel_fn("fused_gine_bn", f"gine_bn_fwd_{suffix}", 15, 5)
    out = torch.empty_like(h)
    agg = torch.empty_like(h) if residuals else None
    mid = h.new_empty(n, d2) if residuals else None
    sums = torch.empty(2, d, dtype=torch.float32, device=h.device)
    partial = torch.empty(t * (s // strip_rows("fused_gine_bn")), 2, d,
                          dtype=torch.float32, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = fn(h.data_ptr(), a.data_ptr(), b.data_ptr(), adj.data_ptr(),
             cnt.data_ptr(), etab.data_ptr(), w1.data_ptr(), b1.data_ptr(),
             w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
             None if agg is None else agg.data_ptr(),
             None if mid is None else mid.data_ptr(), partial.data_ptr(),
             sums.data_ptr(), t, s, d, d2, int(bool(relu_in)), stream)
    _build.check(err, "fused_gine_bn_layer")
    fused_gine_bn_layer.launches += 1
    return out, sums, agg, mid


# K1b splits the weight-gradient sums over N into chunks of this many rows
# (per-chunk partials, then a fixed-order sum).
BWD_CHUNK_ROWS = 1024


def fused_gine_bn_layer_bwd(g, dsums, h, a, b, adj, cnt, agg, mid, out, w1,
                            w2, relu_in: bool = False):
    """Backward of the layer (kernel K1b): the arguments and results of
    fused_gine_bn_layer_bwd_plain. CUDA tensors run the sm_90a kernels
    (counted in `fused_gine_bn_layer_bwd.launches`); CPU tensors run the
    plain version."""
    n, d = g.shape
    d2 = w1.shape[1]
    check_layer_args("fused_gine_bn_layer_bwd",
                     dict(g=g, h=h, adj=adj, cnt=cnt, agg=agg, mid=mid,
                          out=out, w1=w1, w2=w2),
                     dict(dsums=dsums, a=a, b=b), adj, n, d)
    if dsums.shape != (2, d) or agg.shape != (n, d) or mid.shape != (n, d2) \
            or out.shape != (n, d) or w1.shape != (d, d2) \
            or w2.shape != (d2, d):
        raise ValueError("fused_gine_bn_layer_bwd: shapes do not match")
    if g.device.type == "cpu":
        return fused_gine_bn_layer_bwd_plain(g, dsums, h, a, b, adj, cnt,
                                             agg, mid, out, w1, w2, relu_in)
    t, s = cuda_tiles("fused_gine_bn_layer_bwd", g, adj)
    suffix = "f32" if g.dtype == torch.float32 else "bf16"
    fn = kernel_fn("fused_gine_bn", f"gine_bn_bwd_{suffix}", 24, 6)
    nblk = t * (s // strip_rows("fused_gine_bn"))
    chunks = -(-n // BWD_CHUNK_ROWS)
    width = 2 * d * d2 + CNT_PAD * d
    f32 = dict(dtype=torch.float32, device=g.device)
    gtc, daggc, dh = (torch.empty_like(g) for _ in range(3))
    dmidc = g.new_empty(n, d2)
    w1t, w2t = w1.new_empty(d2, d), w2.new_empty(d, d2)
    part_rows = torch.empty(nblk, d2 + d, **f32)
    part_adj = torch.empty(nblk, 2 * d, **f32)
    part_w = torch.empty(chunks, width, **f32)
    sums_rows = torch.empty(d2 + d, **f32)
    sums_adj = torch.empty(2 * d, **f32)
    wgrad = torch.empty(width, **f32)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(*(x.data_ptr() for x in (
        g, dsums, h, a, b, adj, cnt, agg, mid, out, w1, w2, w1t, w2t, gtc,
        dmidc, daggc, part_rows, part_adj, part_w, dh, sums_rows, sums_adj,
        wgrad)),
        t, s, d, d2, int(bool(relu_in)), chunks, stream)
    _build.check(err, "fused_gine_bn_layer_bwd")
    fused_gine_bn_layer_bwd.launches += 1
    dw1, dw2, detab = wgrad.split([d * d2, d2 * d, CNT_PAD * d])
    return (dh, sums_adj[:d], sums_adj[d:], dw1.view(d, d2), sums_rows[:d2],
            dw2.view(d2, d), sums_rows[d2:], detab.view(CNT_PAD, d))


fused_gine_bn_layer_bwd.launches = 0


class _GineBN(torch.autograd.Function):
    """K1f with residuals forward, K1b backward (`_bn_fused_fwd` /
    `_bn_fused_bwd` of the JAX package)."""

    @staticmethod
    def forward(ctx, h, a, b, adj, cnt, etab, w1, b1, w2, b2, relu_in):
        out, sums, agg, mid = fused_gine_bn_layer_fwd(
            h, a, b, adj, cnt, etab, w1, b1, w2, b2, relu_in, residuals=True)
        ctx.save_for_backward(h, a, b, adj, cnt, agg, mid, out, w1, w2)
        ctx.relu_in = relu_in
        return out, sums

    @staticmethod
    def backward(ctx, g, dsums):
        h, a, b, adj, cnt, agg, mid, out, w1, w2 = ctx.saved_tensors
        dh, da, db, dw1, db1, dw2, db2, detab = fused_gine_bn_layer_bwd(
            g.contiguous(), dsums.contiguous(), h, a, b, adj, cnt, agg, mid,
            out, w1, w2, ctx.relu_in)
        return (dh, da, db, None, None, detab.to(w1.dtype), dw1.to(w1.dtype),
                db1, dw2.to(w2.dtype), db2, None)


def fused_gine_bn_layer(h, a, b, adj, cnt, etab, w1, b1, w2, b2,
                        relu_in: bool = False):
    """BN-chained fused GINE layer.

    h     [N, D]   RAW previous conv output (f32 or bf16)
    a, b  [D]      f32 BatchNorm coefficients; identity = (ones, zeros,
                   relu_in=False) for the first layer
    adj   [T, S, S] block-diagonal symmetric adjacency, S % 16 == 0
    cnt   [N, CNT_PAD] per-node edge count matrix
    etab  [CNT_PAD, D] stacked edge tables
    w1 [D, 2D], w2 [2D, D] in h's dtype; b1 [2D], b2 [D] f32

    Returns (out [N, D] in h's dtype, sums [2, D] f32). CUDA tensors run
    the sm_90a kernel (counted in `fused_gine_bn_layer.launches`); CPU
    tensors run fused_gine_bn_layer_plain. When grad mode is on and an
    input requires a gradient, the call is differentiable: K1f writes its
    residuals and the backward runs K1b."""
    n, d = h.shape
    d2 = w1.shape[1]
    check_layer_args("fused_gine_bn_layer",
                     dict(h=h, adj=adj, cnt=cnt, etab=etab, w1=w1, w2=w2),
                     dict(a=a, b=b, b1=b1, b2=b2), adj, n, d)
    if w1.shape != (d, d2) or w2.shape != (d2, d) or b1.shape != (d2,) \
            or b2.shape != (d,):
        raise ValueError("fused_gine_bn_layer: MLP shapes do not match D")
    args = (h, a, b, adj, cnt, etab, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return _GineBN.apply(*args, relu_in)
    return fused_gine_bn_layer_fwd(*args, relu_in, residuals=False)[:2]


fused_gine_bn_layer.launches = 0


# ---------------------------------------------------------------------------
# The unchained layer (kernels K4f / K4b): `fused_gine_layer` of the JAX
# package, which the fine-tuning trunk runs (drop_ratio > 0 leaves the BN
# chain): no BatchNorm prologue and no moment epilogue; BatchNorm, relu and
# dropout run outside the kernel.


def fused_gine_layer_fwd_plain(h, adj, cnt, etab, w1, b1, w2, b2):
    """The plain forward (`_fwd_kernel` line by line): (out, agg, mid) with
    agg, mid and out cast to h's dtype."""
    dt = h.dtype
    t, s, _ = adj.shape
    n, d = h.shape
    agg = torch.bmm(adj.float(), h.float().reshape(t, s, d)).reshape(n, d)
    aggc = (agg + cnt.float() @ etab.float()).to(dt)
    mid = torch.relu(aggc.float() @ w1.float() + b1).to(dt)
    out = (mid.float() @ w2.float() + b2).to(dt)
    return out, aggc, mid


def fused_gine_layer_bwd_plain(g, adj, cnt, agg, mid, w1, w2):
    """The plain backward (`_bwd_kernel` line by line, the same cast points
    as K4b): (dh [N, D] in g's dtype, dW1 [D, 2D], db1 [2D], dW2 [2D, D],
    db2 [D], detab [CNT_PAD, D], all f32). dmid is rounded for dagg and
    dW1, db1 sums it uncast; daggc feeds both dh and detab."""
    dt = g.dtype
    t, s, _ = adj.shape
    n, d = g.shape
    gf = g.float()
    dmid = gf @ w2.float().t()
    dmid = torch.where(mid.float() > 0.0, dmid, 0.0)
    dmidc = dmid.to(dt)
    daggc = (dmidc.float() @ w1.float().t()).to(dt)
    # adjacency blocks are symmetric: the adjoint of A @ . is A @ .
    dh = torch.bmm(adj.float(), daggc.float().reshape(t, s, d)).reshape(n, d)
    return (dh.to(dt), agg.float().t() @ dmidc.float(), dmid.sum(dim=0),
            mid.float().t() @ gf, gf.sum(dim=0),
            cnt.float().t() @ daggc.float())


def _check_gine_args(name, h, adj, cnt, etab, w1, b1, w2, b2):
    n, d = h.shape
    d2 = w1.shape[1]
    check_layer_args(name, dict(h=h, adj=adj, cnt=cnt, etab=etab, w1=w1,
                                w2=w2), dict(b1=b1, b2=b2), adj, n, d)
    if w1.shape != (d, d2) or w2.shape != (d2, d) or b1.shape != (d2,) \
            or b2.shape != (d,):
        raise ValueError(f"{name}: MLP shapes do not match D")


def fused_gine_layer_fwd(h, adj, cnt, etab, w1, b1, w2, b2,
                         residuals: bool):
    """Forward of the unchained layer (kernel K4f): (out, agg, mid); agg
    and mid are None unless `residuals` (the CPU path, the plain version,
    always has them). Launches K4f on CUDA tensors, counted in
    `fused_gine_layer.launches`."""
    if h.device.type == "cpu":
        return fused_gine_layer_fwd_plain(h, adj, cnt, etab, w1, b1, w2, b2)
    t, s = cuda_tiles("fused_gine_layer", h, adj)
    n, d = h.shape
    d2 = w1.shape[1]
    suffix = "f32" if h.dtype == torch.float32 else "bf16"
    fn = kernel_fn("fused_gine_bn", f"gine_fwd_{suffix}", 11, 4)
    out = torch.empty_like(h)
    agg = torch.empty_like(h) if residuals else None
    mid = h.new_empty(n, d2) if residuals else None
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = fn(h.data_ptr(), adj.data_ptr(), cnt.data_ptr(), etab.data_ptr(),
             w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
             out.data_ptr(), None if agg is None else agg.data_ptr(),
             None if mid is None else mid.data_ptr(), t, s, d, d2, stream)
    _build.check(err, "fused_gine_layer")
    fused_gine_layer.launches += 1
    return out, agg, mid


def fused_gine_layer_bwd(g, adj, cnt, agg, mid, w1, w2):
    """Backward of the unchained layer (kernel K4b): the arguments and
    results of fused_gine_layer_bwd_plain. CUDA tensors run the sm_90a
    kernels (counted in `fused_gine_layer_bwd.launches`); CPU tensors run
    the plain version."""
    n, d = g.shape
    d2 = w1.shape[1]
    check_layer_args("fused_gine_layer_bwd",
                     dict(g=g, adj=adj, cnt=cnt, agg=agg, mid=mid, w1=w1,
                          w2=w2), {}, adj, n, d)
    if agg.shape != (n, d) or mid.shape != (n, d2) or w1.shape != (d, d2) \
            or w2.shape != (d2, d):
        raise ValueError("fused_gine_layer_bwd: shapes do not match")
    if g.device.type == "cpu":
        return fused_gine_layer_bwd_plain(g, adj, cnt, agg, mid, w1, w2)
    t, s = cuda_tiles("fused_gine_layer_bwd", g, adj)
    suffix = "f32" if g.dtype == torch.float32 else "bf16"
    fn = kernel_fn("fused_gine_bn", f"gine_bwd_{suffix}", 16, 5)
    nblk = t * (s // strip_rows("fused_gine_bn"))
    chunks = -(-n // BWD_CHUNK_ROWS)
    width = 2 * d * d2 + CNT_PAD * d
    f32 = dict(dtype=torch.float32, device=g.device)
    daggc, dh = torch.empty_like(g), torch.empty_like(g)
    dmidc = g.new_empty(n, d2)
    w1t, w2t = w1.new_empty(d2, d), w2.new_empty(d, d2)
    part_rows = torch.empty(nblk, d2 + d, **f32)
    part_w = torch.empty(chunks, width, **f32)
    sums_rows = torch.empty(d2 + d, **f32)
    wgrad = torch.empty(width, **f32)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(*(x.data_ptr() for x in (
        g, adj, cnt, agg, mid, w1, w2, w1t, w2t, dmidc, daggc, part_rows,
        part_w, dh, sums_rows, wgrad)), t, s, d, d2, chunks, stream)
    _build.check(err, "fused_gine_layer_bwd")
    fused_gine_layer_bwd.launches += 1
    dw1, dw2, detab = wgrad.split([d * d2, d2 * d, CNT_PAD * d])
    return (dh, dw1.view(d, d2), sums_rows[:d2], dw2.view(d2, d),
            sums_rows[d2:], detab.view(CNT_PAD, d))


fused_gine_layer_bwd.launches = 0


class _Gine(torch.autograd.Function):
    """K4f with residuals forward, K4b backward (`_fused_fwd` /
    `_fused_bwd` of the JAX package: agg and mid saved from the forward,
    the weight gradients returned in the weights' dtype, the bias
    gradients in f32)."""

    @staticmethod
    def forward(ctx, h, adj, cnt, etab, w1, b1, w2, b2):
        out, agg, mid = fused_gine_layer_fwd(h, adj, cnt, etab, w1, b1, w2,
                                             b2, residuals=True)
        ctx.save_for_backward(adj, cnt, agg, mid, w1, w2)
        return out

    @staticmethod
    def backward(ctx, g):
        adj, cnt, agg, mid, w1, w2 = ctx.saved_tensors
        dh, dw1, db1, dw2, db2, detab = fused_gine_layer_bwd(
            g.contiguous(), adj, cnt, agg, mid, w1, w2)
        return (dh, None, None, detab.to(w1.dtype), dw1.to(w1.dtype), db1,
                dw2.to(w2.dtype), db2)


def fused_gine_layer(h, adj, cnt, etab, w1, b1, w2, b2):
    """relu((A @ h + cnt @ etab) @ W1 + b1) @ W2 + b2 per 256-node tile.

    h    [N, D]    node features (f32 or bf16)
    adj  [T, S, S] block-diagonal symmetric adjacency, S % 16 == 0
    cnt  [N, CNT_PAD] per-node edge count matrix
    etab [CNT_PAD, D] stacked edge tables
    w1 [D, 2D], w2 [2D, D] in h's dtype; b1 [2D], b2 [D] f32

    Returns out [N, D] in h's dtype. CUDA tensors run the sm_90a kernel
    (counted in `fused_gine_layer.launches`); CPU tensors run
    fused_gine_layer_fwd_plain. When grad mode is on and an input requires
    a gradient, the call is differentiable: K4f writes its residuals and the
    backward runs K4b. adj and cnt get no gradient."""
    args = (h, adj, cnt, etab, w1, b1, w2, b2)
    _check_gine_args("fused_gine_layer", *args)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return _Gine.apply(*args)
    return fused_gine_layer_fwd(*args, residuals=False)[0]


fused_gine_layer.launches = 0
