"""Fused GCN layers: the BN-chained layer (kernels K3f / K3b) with its edge
table, and the unchained layer of the fine-tuning trunk (kernels K5f /
K5b).

Port of molclr_tpu/ops/fused_gcn.py (`pack_gcn_etab`, `fused_gcn_bn_layer`
and `fused_gcn_layer` with their custom VJPs; the unchained layer's section
is at the end of the module). Per 256-node tile the BN-chained layer
computes

    y    = relu?(x * a + b)                 the PREVIOUS BatchNorm's affine
    xw   = y @ W
    out  = A[t] @ xw + cnt[t] @ etab + bias
    sums = [sum m * out, sum m * out^2]     over real nodes, m = diag(A) > 0

with y, xw and out cast to the activation dtype where the Pallas kernel
casts, and every product accumulated in f32. etab carries the SCALAR edge
tables broadcast across the D columns (pack_gcn_etab).

`fused_gcn_bn_layer` launches the hand-written sm_90a kernels
(csrc/fused_gcn_bn.cu) on CUDA tensors and runs the plain PyTorch versions
(`fused_gcn_bn_layer_plain`, `fused_gcn_bn_layer_bwd_plain`) on CPU
tensors. When a gradient is needed it goes through a
`torch.autograd.Function` whose backward is K3b (or the plain backward on
the CPU, so that bf16 rounds where the kernel rounds). With normalize_gcn
the trunk hands it an adjacency scaled by dis_i * dis_j and norm-weighted
counts; the layer itself is the same.
"""

from __future__ import annotations

import torch

from molclr_tpu_torch.ops import _build
from molclr_tpu_torch.ops.fused_layer import (
    CNT_PAD,
    COL_SLICE,
    DW_MAX_ROWS,
    DW_TILE,
    H100_SMS,
    STRIP_ROWS,
    adj_diag_mask,
    bn_prologue,
    carve_scratch,
    check_fits,
    check_layer_args,
    cuda_tiles,
    kernel_fn,
    kernel_plan,
    masked_moments,
    members_plain,
    sm_count,
    weight_pass_shape,
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
    xw = (bn_prologue(x, a, b, relu_in).float() @ w.float()).to(x.dtype)
    return gcn_bn_out_plain(xw, adj, cnt, etab, bias)


def gcn_bn_out_plain(xw, adj, cnt, etab, bias):
    """The plain version of K3f's adjacency pass on its xw [N, D]: out =
    rnd(A @ xw + cnt @ etab + bias) and its masked moments."""
    t, s, _ = adj.shape
    n, d = xw.shape
    out = torch.bmm(adj.float(), xw.float().reshape(t, s, d)).reshape(n, d)
    outc = (out + cnt.float() @ etab.float() + bias).to(xw.dtype)
    return outc, masked_moments(outc, adj)


def fused_gcn_bn_layer_bwd_plain(g, dsums, x, a, b, adj, cnt, out, w,
                                 relu_in: bool = False):
    """The plain PyTorch version of the backward (`_bn_bwd_kernel` line by
    line, the same cast points as K3b). Returns (dx [N, D] in g's dtype,
    da [D], db [D], dW [D, D], dbias [D], detab [CNT_PAD, D], all f32).
    dxc = dxw @ W^T stays f32 into the prologue adjoint; dW multiplies the
    recomputed, rounded prologue output xc; dbias sums the uncast gt, the
    products take gtc."""
    dt = g.dtype
    t, s, _ = adj.shape
    n, d = g.shape
    m = adj_diag_mask(adj)
    # total output cotangent: downstream grad + the moment sums' adjoint
    gt = g.float() + m * (dsums[0] + 2.0 * out.float() * dsums[1])
    gtc = gt.to(dt)
    # adjacency blocks are symmetric (normalization weights included): the
    # adjoint of A @ . is A @ .
    dxw = torch.bmm(adj.float(), gtc.float().reshape(t, s, d)).reshape(n, d)
    dxw = dxw.to(dt)
    dxc = dxw.float() @ w.float().t()
    xf = x.float()
    dpre = torch.where(xf * a + b > 0.0, dxc, 0.0) if relu_in else dxc
    xc = bn_prologue(x, a, b, relu_in)
    return ((dpre * a).to(dt), (dpre * xf).sum(dim=0), dpre.sum(dim=0),
            xc.float().t() @ dxw.float(), gt.sum(dim=0),
            cnt.float().t() @ gtc.float())


def fused_gcn_bn_layer_fwd(x, a, b, adj, cnt, etab, w, bias, relu_in: bool):
    """Forward of the layer (kernel K3f, counted in
    `fused_gcn_bn_layer.launches`) on CUDA tensors; the plain version on
    CPU tensors. Returns (out, sums)."""
    if x.device.type == "cpu":
        return fused_gcn_bn_layer_plain(x, a, b, adj, cnt, etab, w, bias,
                                        relu_in)
    n, d = x.shape
    t, s = cuda_tiles("fused_gcn_bn_layer", x, adj, "fused_gcn_bn")
    suffix = "f32" if x.dtype == torch.float32 else "bf16"
    fn = kernel_fn("fused_gcn_bn", f"gcn_bn_fwd_{suffix}", 12, 4)
    check_fits(x.device, 2 * x.element_size() * n * d
               + 4 * (n // STRIP_ROWS + 1) * 2 * d,
               f"fused_gcn_bn_layer at D = {d}")
    out = torch.empty_like(x)
    xw = torch.empty_like(x)
    sums = torch.empty(2, d, dtype=torch.float32, device=x.device)
    # one [2, D] row of moment partials per 16-row strip
    partial = torch.empty(n // STRIP_ROWS, 2, d, dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), adj.data_ptr(),
             cnt.data_ptr(), etab.data_ptr(), w.data_ptr(), bias.data_ptr(),
             xw.data_ptr(), out.data_ptr(), partial.data_ptr(),
             sums.data_ptr(), t, s, d, int(bool(relu_in)), stream)
    _build.check(err, "fused_gcn_bn_layer")
    fused_gcn_bn_layer.launches += 1
    return out, sums


def gcn_bn_bwd_weight_shape(n: int, d: int, dtype: torch.dtype,
                            sms: int = H100_SMS) -> tuple[int, int, int]:
    """fused_layer.weight_pass_shape of K3b's weight pass: dW [d, d] and
    detab [CNT_PAD, d] in one launch."""
    return weight_pass_shape(n, ((d, d), (CNT_PAD, d)), dtype, sms)


def k3f_plan(adj: torch.Tensor, cnt: torch.Tensor, d: int) -> dict:
    """What K3f skips on this batch and its grids, decided as its launches
    decide it from the data they load (tests and chip_smoke.py only; the
    wrapper never calls it): `xw` is kernel_plan of the xw pass (16-row
    strips whose A rows are all zero write zeros), `adj` of the adjacency
    pass (its dead strips also have all-zero cnt rows: rows rnd(bias)), and
    grids {launch: (strips, column slices)}."""
    n = adj.shape[0] * adj.shape[1]
    grid = (n // STRIP_ROWS, -(-d // COL_SLICE))
    return dict(xw=kernel_plan(adj, None, STRIP_ROWS),
                adj=kernel_plan(adj, cnt, STRIP_ROWS),
                grids=dict(xw=grid, adj=grid))


def k3b_plan(adj: torch.Tensor, cnt: torch.Tensor, d: int,
             dtype: torch.dtype = torch.float32,
             sms: int = H100_SMS) -> dict:
    """What K3b skips on this batch and how it is launched (tests and
    chip_smoke.py only): `adj` is kernel_plan of the strip pass (dxw = 0
    with no product on strips whose A rows are all zero); dead_strips [N /
    16] the strips that the weight pass skips (A and cnt rows all zero:
    their dxw and cnt rows multiply only zeros); dw_chunks, dw_rows,
    dw_tile_rows (gcn_bn_bwd_weight_shape) with live_chunks [dw_chunks], a
    strip of the chunk is live; grids {launch: (strips, column slices)} of
    the gt and strip passes and the weight pass's {problem: (chunks, tile
    rows, tile columns)}."""
    n = adj.shape[0] * adj.shape[1]
    strips = n // STRIP_ROWS
    plan = kernel_plan(adj, None, STRIP_ROWS)
    dead = plan["dead_strips"] & ~(cnt != 0).reshape(
        strips, STRIP_ROWS * CNT_PAD).any(dim=1)
    chunks, rows, tile_rows = gcn_bn_bwd_weight_shape(n, d, dtype, sms)
    per = rows // STRIP_ROWS
    live = torch.nn.functional.pad(~dead, (0, chunks * per - strips))
    grids = dict(gt=(strips, 1), strip=(strips, -(-d // COL_SLICE)),
                 weights={k: (chunks, -(-m // tile_rows), -(-c // DW_TILE))
                          for k, (m, c) in (("dw", (d, d)),
                                            ("detab", (CNT_PAD, d)))})
    return dict(adj=plan, dead_strips=dead, dw_chunks=chunks, dw_rows=rows,
                dw_tile_rows=tile_rows,
                live_chunks=live.reshape(chunks, per).any(dim=1),
                grids=grids)


def fused_gcn_bn_layer_bwd(g, dsums, x, a, b, adj, cnt, out, w,
                           relu_in: bool = False):
    """Backward of the layer (kernel K3b): the arguments and results of
    fused_gcn_bn_layer_bwd_plain. CUDA tensors run the sm_90a kernels
    (counted in `fused_gcn_bn_layer_bwd.launches`); CPU tensors run the
    plain version."""
    n, d = g.shape
    check_layer_args("fused_gcn_bn_layer_bwd",
                     dict(g=g, x=x, adj=adj, cnt=cnt, out=out, w=w),
                     dict(dsums=dsums, a=a, b=b), adj, n, d)
    if dsums.shape != (2, d) or x.shape != (n, d) or out.shape != (n, d) \
            or w.shape != (d, d):
        raise ValueError("fused_gcn_bn_layer_bwd: shapes do not match")
    if g.device.type == "cpu":
        return fused_gcn_bn_layer_bwd_plain(g, dsums, x, a, b, adj, cnt, out,
                                            w, relu_in)
    t, s = cuda_tiles("fused_gcn_bn_layer_bwd", g, adj, "fused_gcn_bn")
    suffix = "f32" if g.dtype == torch.float32 else "bf16"
    fn = kernel_fn("fused_gcn_bn", f"gcn_bn_bwd_{suffix}", 21, 7)
    strips = n // STRIP_ROWS
    chunks, rows, tile_rows = gcn_bn_bwd_weight_shape(n, d, g.dtype,
                                                      sm_count(g.device))
    width = d * d + CNT_PAD * d
    es = g.element_size()
    # W^T, gtc, dxw, xc, the strip flags (int32) and the partials of the gt,
    # strip and weight passes (f32)
    _buf, (wt, gtc, dxw, xc, live, part_gt, part_adj, part_w) = \
        carve_scratch(g.device, (d * d * es, n * d * es, n * d * es,
                                 n * d * es, 4 * strips, 4 * strips * d,
                                 4 * strips * 2 * d, 4 * chunks * width),
                      f"fused_gcn_bn_layer_bwd at D = {d}", width)
    dx = torch.empty_like(g)
    # dbias, [da | db], [dW | detab]
    res = torch.empty(d + 2 * d + width, dtype=torch.float32,
                      device=g.device)
    dbias, sums_adj, wgrad = res.split([d, 2 * d, width])
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(*(v.data_ptr() for v in (g, dsums, x, a, b, adj, cnt, out, w)),
             wt, gtc, dxw, xc, live, part_gt, part_adj, part_w,
             dx.data_ptr(), dbias.data_ptr(), sums_adj.data_ptr(),
             wgrad.data_ptr(), t, s, d, int(bool(relu_in)), chunks, rows,
             tile_rows, stream)
    _build.check(err, "fused_gcn_bn_layer_bwd")
    fused_gcn_bn_layer_bwd.launches += 1
    dw, detab = wgrad.split([d * d, CNT_PAD * d])
    return (dx, sums_adj[:d], sums_adj[d:], dw.view(d, d), dbias,
            detab.view(CNT_PAD, d))


fused_gcn_bn_layer_bwd.launches = 0


class _GcnBN(torch.autograd.Function):
    """K3f forward, K3b backward (`_bn_fused_fwd` / `_bn_fused_bwd` of the
    JAX package: x and the forward's own output saved, dW and detab
    returned in w's dtype, the vector gradients in f32)."""

    @staticmethod
    def forward(ctx, x, a, b, adj, cnt, etab, w, bias, relu_in):
        out, sums = fused_gcn_bn_layer_fwd(x, a, b, adj, cnt, etab, w, bias,
                                           relu_in)
        ctx.save_for_backward(x, a, b, adj, cnt, out, w)
        ctx.relu_in = relu_in
        return out, sums

    @staticmethod
    def backward(ctx, g, dsums):
        x, a, b, adj, cnt, out, w = ctx.saved_tensors
        dx, da, db, dw, dbias, detab = fused_gcn_bn_layer_bwd(
            g.contiguous(), dsums.contiguous(), x, a, b, adj, cnt, out, w,
            ctx.relu_in)
        return (dx, da, db, None, None, detab.to(w.dtype), dw.to(w.dtype),
                dbias, None)


def fused_gcn_bn_layer(x, a, b, adj, cnt, etab, w, bias,
                       relu_in: bool = False):
    """BN-chained fused GCN layer.

    x     [N, D]   RAW previous conv output (f32 or bf16)
    a, b  [D]      f32 BatchNorm coefficients; identity = (ones, zeros,
                   relu_in=False) for the first layer
    adj   [T, S, S] block-diagonal symmetric adjacency, S % 16 == 0
                   (dis_i * dis_j-weighted when normalize_gcn)
    cnt   [N, CNT_PAD] per-node edge count matrix (norm-weighted when
                   normalize_gcn)
    etab  [CNT_PAD, D] column-broadcast scalar edge tables (pack_gcn_etab)
    w     [D, D] in x's dtype; bias [D] f32

    Returns (out [N, D] in x's dtype, sums [2, D] f32). CUDA tensors run
    the sm_90a kernel (counted in `fused_gcn_bn_layer.launches`); CPU
    tensors run fused_gcn_bn_layer_plain. When grad mode is on and an
    input requires a gradient, the call is differentiable in x, a, b,
    etab, w and bias: the backward runs K3b (adj and cnt get none)."""
    n, d = x.shape
    check_layer_args("fused_gcn_bn_layer",
                     dict(x=x, adj=adj, cnt=cnt, etab=etab, w=w),
                     dict(a=a, b=b, bias=bias), adj, n, d)
    if w.shape != (d, d) or bias.shape != (d,):
        raise ValueError("fused_gcn_bn_layer: w/bias shapes do not match D")
    args = (x, a, b, adj, cnt, etab, w, bias)
    if torch.is_grad_enabled() and any(v.requires_grad for v in args):
        return _GcnBN.apply(*args, relu_in)
    return fused_gcn_bn_layer_fwd(*args, relu_in)


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


def fused_gcn_layer_members_plain(x, adj, w):
    """The plain forward of M members (x [M, N, D], w [M, D, D], adj
    shared): fused_gcn_layer_plain member by member, stacked."""
    return members_plain(lambda x, w, adj: (fused_gcn_layer_plain(x, adj, w),),
                         dict(adj=adj), x, w)[0]


def fused_gcn_layer_members_bwd_plain(g, x, adj, w):
    """The plain backward of M members: fused_gcn_layer_bwd_plain member by
    member, (dx [M, N, D], dW [M, D, D]) stacked."""
    return members_plain(
        lambda g, x, w, adj: fused_gcn_layer_bwd_plain(g, x, adj, w),
        dict(adj=adj), g, x, w)


def _check_gcn_args(name, x, adj, w):
    """One layer's arguments, or a stack of M (x [M, N, D], w [M, D, D])."""
    n, d = x.shape[-2:]
    check_layer_args(name, dict(x=x, adj=adj, w=w), {}, adj, n, d)
    if x.dim() not in (2, 3) or w.shape != (*x.shape[:-2], d, d):
        raise ValueError(f"{name}: w {tuple(w.shape)} does not match D")


def _gcn_fwd_cuda(x, adj, w):
    """K5f on CUDA tensors, one launch for one layer (x [N, D], w [D, D])
    or a stack of M (x [M, N, D], w [M, D, D]; adj shared): out with x's
    leading axes."""
    t, s = cuda_tiles("fused_gcn_layer", x, adj, "fused_gcn_bn")
    lead = x.shape[:-2]
    d = x.shape[-1]
    suffix = "f32" if x.dtype == torch.float32 else "bf16"
    fn = kernel_fn("fused_gcn_bn", f"gcn_fwd_{suffix}", 5, 4)
    check_fits(x.device, 2 * x.element_size() * x.numel(),
               f"fused_gcn_layer at D = {d}")
    xw, out = torch.empty_like(x), torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), adj.data_ptr(), w.data_ptr(), xw.data_ptr(),
             out.data_ptr(), t, s, d, lead[0] if lead else 1, stream)
    _build.check(err, "fused_gcn_layer")
    fused_gcn_layer.launches += 1
    return out


def fused_gcn_layer_fwd(x, adj, w):
    """Forward of the unchained layer (kernel K5f, the one-member case of
    the member-axis launch, counted in `fused_gcn_layer.launches`) on CUDA
    tensors; the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return fused_gcn_layer_plain(x, adj, w)
    return _gcn_fwd_cuda(x, adj, w)


def fused_gcn_layer_members_fwd(x, adj, w):
    """Forward of M unchained layers on one batch (kernel K5f with its
    member grid axis; the JAX package's `jax.vmap` of `fused_gcn_layer`):
    x [M, N, D], w [M, D, D], adj shared; out [M, N, D]. One launch on CUDA
    tensors, counted in `fused_gcn_layer.launches`, member m's result a
    one-member launch's bit for bit; the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return fused_gcn_layer_members_plain(x, adj, w)
    return _gcn_fwd_cuda(x, adj, w)


def dw_chunks(n: int, d: int, sms: int = H100_SMS) -> tuple[int, int]:
    """(chunks, rows per chunk) of K5b's weight pass over n rows
    (csrc/fused_bn_common.cuh wgrad_kernel, which takes them as they are):
    DW_TILE x DW_TILE tiles of dW times row chunks, enough chunks for two
    blocks per SM of a card with `sms` SMs, chunks of whole strips, at most
    DW_MAX_ROWS rows each. They order the sums, so a stack of members takes
    each member's as one member would."""
    tiles = (-(-d // DW_TILE)) ** 2
    want = max(-(-2 * sms // tiles), -(-n // DW_MAX_ROWS))
    want = min(want, n // STRIP_ROWS)
    rows = -(-(-(-n // want)) // STRIP_ROWS) * STRIP_ROWS
    return -(-n // rows), rows


def k5b_plan(adj: torch.Tensor, d: int, sms: int = H100_SMS) -> dict:
    """What K5b skips on this adjacency (tests and chip_smoke.py only):
    kernel_plan of its 16-row strip pass, and its weight pass's row chunks
    (dw_chunks) with live_chunks [chunks], True where a strip of the chunk
    is live (its dxw rows can be nonzero)."""
    plan = kernel_plan(adj, None, STRIP_ROWS)
    n = adj.shape[0] * adj.shape[1]
    chunks, rows = dw_chunks(n, d, sms)
    live = ~plan["dead_strips"]
    per = rows // STRIP_ROWS
    live = torch.nn.functional.pad(live, (0, chunks * per - live.shape[0]))
    plan.update(dw_chunks=chunks, dw_rows=rows,
                live_chunks=live.reshape(chunks, per).any(dim=1))
    return plan


def _gcn_bwd_cuda(g, x, adj, w):
    """K5b on CUDA tensors, one launch for one layer or a stack of M (as
    _gcn_fwd_cuda): (dx, dW) with g's leading axes."""
    t, s = cuda_tiles("fused_gcn_layer_bwd", g, adj, "fused_gcn_bn")
    lead = g.shape[:-2]
    m = lead[0] if lead else 1
    n, d = g.shape[-2:]
    suffix = "f32" if g.dtype == torch.float32 else "bf16"
    fn = kernel_fn("fused_gcn_bn", f"gcn_bwd_{suffix}", 10, 6)
    # the chunks of one member: they order its sums
    chunks, rows = dw_chunks(n, d, sm_count(g.device))
    dx = torch.empty_like(g)
    dw = torch.empty(*lead, d, d, dtype=torch.float32, device=g.device)
    # W^T, dxw, the strip flags (int32) and the weight pass's chunk
    # partials (f32), each member's
    es = g.element_size()
    _buf, (wt, dxw, strip_live, part_w) = carve_scratch(
        g.device, tuple(m * b for b in (
            d * d * es, n * d * es, 4 * (n // STRIP_ROWS),
            4 * chunks * d * d)),
        f"fused_gcn_layer_bwd at D = {d}, {m} members", d * d)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(g.data_ptr(), x.data_ptr(), adj.data_ptr(), w.data_ptr(), wt,
             dxw, dx.data_ptr(), strip_live, part_w, dw.data_ptr(), t, s, d,
             chunks, rows, m, stream)
    _build.check(err, "fused_gcn_layer_bwd")
    fused_gcn_layer_bwd.launches += 1
    return dx, dw


def _check_gcn_bwd_args(g, x, adj, w):
    _check_gcn_args("fused_gcn_layer_bwd", g, adj, w)
    if x.shape != g.shape or x.dtype != g.dtype or not x.is_contiguous():
        raise ValueError("fused_gcn_layer_bwd: x must match g")


def fused_gcn_layer_bwd(g, x, adj, w):
    """Backward of the unchained layer (kernel K5b): (dx in g's dtype, dW
    f32). CUDA tensors run the sm_90a kernels (the one-member case of the
    member-axis launch, counted in `fused_gcn_layer_bwd.launches`); CPU
    tensors run the plain version. x is the saved input: nothing is
    recomputed but xw's adjoint."""
    _check_gcn_bwd_args(g, x, adj, w)
    if g.dim() != 2:
        raise ValueError("fused_gcn_layer_bwd: g must be [N, D]")
    if g.device.type == "cpu":
        return fused_gcn_layer_bwd_plain(g, x, adj, w)
    return _gcn_bwd_cuda(g, x, adj, w)


def fused_gcn_layer_members_bwd(g, x, adj, w):
    """Backward of M unchained layers (kernel K5b with its member grid
    axis): g, x [M, N, D], w [M, D, D], adj shared; (dx [M, N, D] in g's
    dtype, dW [M, D, D] f32). One launch on CUDA tensors (counted in
    `fused_gcn_layer_bwd.launches`), member m's results a one-member
    launch's bit for bit; the plain version on CPU tensors."""
    _check_gcn_bwd_args(g, x, adj, w)
    if g.dim() != 3:
        raise ValueError("fused_gcn_layer_members_bwd: g must be [M, N, D]")
    if g.device.type == "cpu":
        return fused_gcn_layer_members_bwd_plain(g, x, adj, w)
    return _gcn_bwd_cuda(g, x, adj, w)


fused_gcn_layer_bwd.launches = 0


class _Gcn(torch.autograd.Function):
    """K5f forward, K5b backward (`_fused_fwd` / `_fused_bwd` of the JAX
    package: x saved, dW returned in w's dtype). One layer, or
    (`members`) a stack of M."""

    @staticmethod
    def forward(ctx, x, adj, w, members):
        ctx.save_for_backward(x, adj, w)
        ctx.members = members
        return (fused_gcn_layer_members_fwd if members
                else fused_gcn_layer_fwd)(x, adj, w)

    @staticmethod
    def backward(ctx, g):
        x, adj, w = ctx.saved_tensors
        dx, dw = (fused_gcn_layer_members_bwd if ctx.members
                  else fused_gcn_layer_bwd)(g.contiguous(), x, adj, w)
        return dx, None, dw.to(w.dtype), None


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
    if x.dim() != 2:
        raise ValueError("fused_gcn_layer: x must be [N, D]")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Gcn.apply(x, adj, w, False)
    return fused_gcn_layer_fwd(x, adj, w)


fused_gcn_layer.launches = 0


def fused_gcn_layer_members(x, adj, w):
    """fused_gcn_layer of M members on one batch, as the JAX FineTuner's
    vmap runs it (x [M, N, D], w [M, D, D], adj shared): one K5f launch
    (one K5b in the backward) over all members, counted as one in
    `fused_gcn_layer.launches`; CPU tensors run the plain version member
    by member. Returns out [M, N, D]."""
    _check_gcn_args("fused_gcn_layer", x, adj, w)
    if x.dim() != 3:
        raise ValueError("fused_gcn_layer_members: x must be [M, N, D]")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Gcn.apply(x, adj, w, True)
    return fused_gcn_layer_members_fwd(x, adj, w)
