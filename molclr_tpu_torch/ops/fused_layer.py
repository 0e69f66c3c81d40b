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
(csrc/fused_gine_bn.cu, the backwards csrc/fused_gine_bwd.cu) on CUDA
tensors and runs the plain PyTorch versions
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

# The kernels' layout, which the wrappers and the plan helpers (kernel_plan,
# unchained_fwd_plan, fused_gcn.dw_chunks) work with: the strip of the tile
# layout, the adjacency column chunk that the row-block kernels skip when it
# is all zero, the weight pass's output tile and most rows per chunk (its
# rows step one strip at a time), and the columns of a row-block pass. Each
# library states its own (fbl_layout in csrc/fused_bn_common.cuh);
# strip_rows checks them at its first use.
STRIP_ROWS = 16
ADJ_CHUNK = 32
DW_TILE = 64
DW_MAX_ROWS = 1024
COL_SLICE = 128
LAYOUT = (STRIP_ROWS, ADJ_CHUNK, DW_TILE, STRIP_ROWS, DW_MAX_ROWS, COL_SLICE)
# K1f's rows per block at the reference widths (csrc/fused_gine_bn.cu
# K1F_RB; 16 where wider layers do not fit: k1f_block_rows)
K1F_BLOCK_ROWS = 32
# SMs of an H100, for the plans when no card is at hand
H100_SMS = 132

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
    # (a member stack's etab is [M, CNT_PAD, D]; cnt is shared)
    if ("cnt" in act and act["cnt"].shape != (n, CNT_PAD)) or (
            "etab" in act and act["etab"].shape[-2:] != (CNT_PAD, d)):
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
    """Rows per strip of the kernels in csrc/<source>.cu; tiles must be a
    multiple of it. Raises if the library's layout is not LAYOUT."""
    f = _build.load(source).fbl_layout
    f.argtypes = [ctypes.c_int]
    f.restype = ctypes.c_int
    got = tuple(f(i) for i in range(len(LAYOUT)))
    if got != LAYOUT or f(len(LAYOUT)) != -1:
        raise RuntimeError(f"csrc/{source}.cu states the layout {got}, "
                           f"ops/fused_layer.py LAYOUT {LAYOUT}")
    return STRIP_ROWS


def _k1f_query(kind: str, dtype: torch.dtype, s: int, d: int,
               d2: int) -> int:
    suffix = "f32" if dtype == torch.float32 else "bf16"
    f = getattr(_build.load("fused_gine_bn"), f"gine_bn_fwd_{kind}_{suffix}")
    f.argtypes = [ctypes.c_int] * 3
    f.restype = ctypes.c_int
    return f(s, d, d2)


@functools.lru_cache(maxsize=None)
def k1f_block_rows(dtype: torch.dtype, s: int, d: int, d2: int) -> int:
    """Rows per block that K1f launches with at tile s and widths d, d2:
    K1F_BLOCK_ROWS, or 16 where a 32-row block's operands do not fit in
    shared memory, and 16 in the split design where no one-launch block
    fits (k1f_splits); 0 where nothing fits. Needs the built library."""
    return _k1f_query("rows", dtype, s, d, d2)


@functools.lru_cache(maxsize=None)
def k1f_splits(dtype: torch.dtype, s: int, d: int, d2: int) -> bool:
    """Whether K1f takes its split design at tile s and widths d, d2
    (csrc/fused_gine_bn.cu gine_bn_fwd_split: mid [16, D2] does not fit in
    shared memory beside agg, so a launch of its own writes agg to device
    memory, the mid launch streams it and writes mid, and out is a launch
    of its own): the wrapper then passes agg and mid buffers, scratch
    without residuals. Needs the built library."""
    return bool(_k1f_query("split", dtype, s, d, d2))


@functools.lru_cache(maxsize=None)
def gine_streams_agg(dtype: torch.dtype, s: int, d: int, d2: int) -> bool:
    """Whether K4f takes its streamed design at tile s and widths d, d2
    (csrc/fused_gine_bn.cu agg_then_mid: agg [16, D] does not fit in
    shared memory beside the mid launch's adjacency operand, so a launch of
    its own writes agg to device memory and the mid launch streams it): the
    wrapper then passes an agg buffer, scratch without residuals. Needs the
    built library."""
    suffix = "f32" if dtype == torch.float32 else "bf16"
    f = getattr(_build.load("fused_gine_bn"), f"gine_streams_agg_{suffix}")
    f.argtypes = [ctypes.c_int] * 3
    f.restype = ctypes.c_int
    return bool(f(s, d, d2))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """SMs of a CUDA device, which the launch plans fill."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def device_memory(device: torch.device) -> int:
    """Bytes of a CUDA device's memory, which a kernel's scratch must fit."""
    return torch.cuda.get_device_properties(device).total_memory


# The weight passes index one member's row of partials ([dW1 | dW2 | detab]
# and the like) in 32-bit ints (csrc/fused_bn_common.cuh wgrad_kernel,
# sum_partials): a width that reaches 2^31 elements (the GINE backwards
# near D = 23,000 at D2 = 2 D) is refused before any launch.
MAX_WIDTH = 2 ** 31 - 1


def check_fits(device, nbytes: int, what: str, width: int = 0) -> None:
    """Raise a ValueError naming `what` (the call and its widths) where the
    card's memory cannot hold nbytes, or a weight pass's row of partials
    would be `width` > MAX_WIDTH elements: the limits a wide layer meets,
    since every launch plan streams what shared memory cannot hold."""
    total = device_memory(device)
    if nbytes > total:
        raise ValueError(f"{what} needs {nbytes} bytes of device memory, "
                         f"more than the card's {total}")
    if width > MAX_WIDTH:
        raise ValueError(f"{what}: a weight-pass row of {width} elements, "
                         f"more than the kernels' 32-bit index reaches "
                         f"({MAX_WIDTH})")


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
    # the split design's mid launch reads agg, its out launch mid: scratch
    # without residuals
    with_agg = with_mid = residuals or k1f_splits(h.dtype, s, d, d2)
    es = h.element_size()
    check_fits(h.device, es * n * (d * (1 + with_agg) + d2 * with_mid)
               + 4 * (n // STRIP_ROWS + 2) * 2 * d,
               f"fused_gine_bn_layer at D = {d}, D2 = {d2}")
    out = torch.empty_like(h)
    agg = torch.empty_like(h) if with_agg else None
    mid = h.new_empty(n, d2) if with_mid else None
    sums = torch.empty(2, d, dtype=torch.float32, device=h.device)
    # one [2, D] row per 16-row strip, and one for the dead blocks' row
    partial = torch.empty(n // STRIP_ROWS + 1, 2, d, dtype=torch.float32,
                          device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = fn(h.data_ptr(), a.data_ptr(), b.data_ptr(), adj.data_ptr(),
             cnt.data_ptr(), etab.data_ptr(), w1.data_ptr(), b1.data_ptr(),
             w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
             None if agg is None else agg.data_ptr(),
             None if mid is None else mid.data_ptr(), partial.data_ptr(),
             sums.data_ptr(), t, s, d, d2, int(bool(relu_in)), stream)
    _build.check(err, "fused_gine_bn_layer")
    fused_gine_bn_layer.launches += 1
    return (out, sums, agg if residuals else None,
            mid if residuals else None)


def kernel_plan(adj: torch.Tensor, cnt: torch.Tensor | None = None,
                block_rows: int = K1F_BLOCK_ROWS) -> dict:
    """What the row-block kernels skip on this adjacency, decided as they
    decide it from the data they load (K1f: block_rows k1f_block_rows, 32
    at the reference widths, with cnt; K4f's mid launch: block_rows 16,
    with cnt; K5f's passes and K5b's strip pass: block_rows 16, no cnt).
    Only the tests and chip_smoke.py call it; the kernels' wrappers never
    do.

    strip_chunks [N / 16, C]  chunk j (tile columns 32 j .. 32 j + 31) of
                              a 16-row strip's A rows has a nonzero
    dead_strips  [N / 16]     the strip's A rows (and cnt rows) are all 0
    dead_blocks  [ceil(N / block_rows)]  every row of the block is dead: the
                              kernel computes one constant row for it
    block_chunks, dense_chunks  (block, tile chunk) pairs the kernel
                              multiplies, and those a dense strip would"""
    t, s, _ = adj.shape
    n = t * s
    nch = -(-s // ADJ_CHUNK)
    nz = adj.reshape(n, s) != 0
    padded = torch.nn.functional.pad(nz, (0, nch * ADJ_CHUNK - s))
    strip_chunks = padded.reshape(n // STRIP_ROWS, STRIP_ROWS, nch,
                                  ADJ_CHUNK).any(dim=3).any(dim=1)
    live_rows = nz.any(dim=1)
    if cnt is not None:
        live_rows = live_rows | (cnt != 0).any(dim=1)
    nb = -(-n // block_rows)
    dead_blocks = ~torch.nn.functional.pad(
        live_rows, (0, nb * block_rows - n)).reshape(nb, block_rows).any(1)
    strip = torch.arange(n // STRIP_ROWS)
    key = (strip * STRIP_ROWS // s)[:, None] * nch + torch.arange(nch)
    block = (strip * STRIP_ROWS // block_rows)[:, None].expand(-1, nch)
    pairs = torch.stack([block[strip_chunks], key[strip_chunks]], dim=1)
    return dict(
        block_rows=block_rows, strip_chunks=strip_chunks,
        dead_strips=~live_rows.reshape(-1, STRIP_ROWS).any(dim=1),
        dead_blocks=dead_blocks,
        block_chunks=int(torch.unique(pairs, dim=0).shape[0]),
        dense_chunks=nb * nch)


# In f32 the weight pass of K1b and K4b sums over N in chunks of at most
# this many rows (per-chunk partials, then a fixed-order sum), the first
# design's chunks, so that its f32 sums keep their order.
BWD_CHUNK_ROWS = 1024


@functools.lru_cache(maxsize=None)
def weight_pass_shape(n: int, problems: tuple, dtype: torch.dtype,
                      sms: int = H100_SMS,
                      members: int = 1) -> tuple[int, int, int]:
    """(chunks, rows per chunk, output tile rows) of a backward's weight
    pass over n rows (csrc/fused_bn_common.cuh wgrad_kernel over the
    problems' outputs ((m, c), ...) in one launch, which takes them as they
    are). Chunks are whole 16-row strips, at most DW_MAX_ROWS rows. f32
    keeps the first design's chunks (ceil(n / BWD_CHUNK_ROWS) of equal
    size, so each output is the same ascending sum) and takes 32-row output
    tiles where 64-row ones give fewer than two blocks per SM of a card with
    `sms` SMs over the launch's `members` members (the tile sets no f32
    sum's order); bf16 takes 64 x 64 tiles and enough chunks for two blocks
    per SM of one member, as K5b's dw_chunks does: the chunks set the order
    of the bf16 sums, so a member's do not depend on how many share its
    launch."""
    def tiles(tr):
        return sum(-(-m // tr) * -(-c // DW_TILE) for m, c in problems)

    if dtype == torch.float32:
        want = -(-n // BWD_CHUNK_ROWS)
    else:
        want = max(-(-2 * sms // tiles(DW_TILE)), -(-n // DW_MAX_ROWS))
        want = min(want, n // STRIP_ROWS)
    rows = -(-(-(-n // want)) // STRIP_ROWS) * STRIP_ROWS
    chunks = -(-n // rows)
    tile_rows = DW_TILE
    if dtype == torch.float32 and \
            members * chunks * tiles(DW_TILE) < 2 * sms:
        tile_rows = DW_TILE // 2
    return chunks, rows, tile_rows


def gine_bwd_weight_shape(n: int, d: int, d2: int, dtype: torch.dtype,
                          sms: int = H100_SMS,
                          members: int = 1) -> tuple[int, int, int]:
    """weight_pass_shape of K1b's and K4b's weight pass: dW1 [d, d2], dW2
    [d2, d] and detab [CNT_PAD, d] (of each of `members` members)."""
    return weight_pass_shape(n, ((d, d2), (d2, d), (CNT_PAD, d)), dtype, sms,
                             members)


def gine_bwd_gt(g, dsums, adj, out):
    """The total output cotangent gt [N, D] (f32) that K1b computes and
    fused_gine_bn_layer_bwd_plain sums into db2: g + m (ds0 + 2 out ds1).
    For gine_bwd_plan; K4b's gt is g itself."""
    m = adj_diag_mask(adj)
    return g.float() + m * (dsums[0] + 2.0 * out.float() * dsums[1])


def gine_bwd_plan(gt: torch.Tensor, adj: torch.Tensor, d2: int,
                  dtype: torch.dtype | None = None,
                  sms: int = H100_SMS) -> dict:
    """What K1b's and K4b's passes skip and how they are launched, decided
    as the kernels decide it (csrc/fused_gine_bwd.cu gine_bwd): gt [N, D]
    is the total cotangent (gine_bwd_gt for K1b, g for K4b), dtype the
    activation type (gt's by default). Only the tests and chip_smoke.py
    call it; the wrappers never do.

    dead_strips [N / 16]    every gt value of the 16-row strip is exactly
                            zero (padding rows count): the dmid and dagg
                            launches write zeros there and the weight pass
                            skips it
    adj                     kernel_plan of the adjacency pass (16-row
                            strips, no cnt): its strip_chunks, dead_strips,
                            block_chunks and dense_chunks
    dw_chunks, dw_rows, dw_tile_rows  gine_bwd_weight_shape
    live_chunks [dw_chunks] a strip of the chunk is live
    grids                   {launch: (strips, column slices)} of the
                            dmid, dagg and adjacency launches, and the
                            weight pass's {problem: (chunks, tile rows,
                            tile columns)}"""
    n, d = gt.shape
    dtype = dtype or gt.dtype
    dead = ~(gt != 0).reshape(n // STRIP_ROWS, STRIP_ROWS * d).any(dim=1)
    chunks, rows, tile_rows = gine_bwd_weight_shape(n, d, d2, dtype, sms)
    per = rows // STRIP_ROWS
    live = torch.nn.functional.pad(~dead, (0, chunks * per - dead.shape[0]))
    strips = n // STRIP_ROWS
    grids = dict(dmid=(strips, -(-d2 // COL_SLICE)),
                 dagg=(strips, -(-d // COL_SLICE)),
                 adj=(strips, -(-d // COL_SLICE)),
                 weights={k: (chunks, -(-m // tile_rows), -(-c // DW_TILE))
                          for k, (m, c) in (("dw1", (d, d2)),
                                            ("dw2", (d2, d)),
                                            ("detab", (CNT_PAD, d)))})
    return dict(dead_strips=dead, adj=kernel_plan(adj, None, STRIP_ROWS),
                dw_chunks=chunks, dw_rows=rows, dw_tile_rows=tile_rows,
                live_chunks=live.reshape(chunks, per).any(dim=1),
                grids=grids)


def carve_scratch(device, sizes, what: str, width: int = 0):
    """One scratch allocation on `device` cut at 256-byte offsets into
    pieces of the given byte sizes: (the buffer, which must outlive the
    launches, and the pieces' addresses). Raises a ValueError naming
    `what` (the call and its widths) where the card's memory cannot hold
    the scratch or the weight pass's row of partials is `width` elements
    past MAX_WIDTH (check_fits)."""
    offs = [0]
    for size in sizes:
        offs.append(offs[-1] + -(-size // 256) * 256)
    check_fits(device, offs[-1], what, width)
    buf = torch.empty(offs[-1], dtype=torch.uint8, device=device)
    return buf, [buf.data_ptr() + o for o in offs[:-1]]


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
    t, s = cuda_tiles("fused_gine_bn_layer_bwd", g, adj, "fused_gine_bwd")
    suffix = "f32" if g.dtype == torch.float32 else "bf16"
    fn = kernel_fn("fused_gine_bwd", f"gine_bn_bwd_{suffix}", 25, 8)
    strips, sms = n // STRIP_ROWS, sm_count(g.device)
    chunks, rows, tile_rows = gine_bwd_weight_shape(n, d, d2, g.dtype, sms)
    width = 2 * d * d2 + CNT_PAD * d
    es = g.element_size()
    # W1^T, W2^T, gtc, dmidc, daggc, the strip flags (int32) and the
    # partials of the row, adjacency and weight passes (f32)
    _buf, (w1t, w2t, gtc, dmidc, daggc, live, part_rows, part_adj,
           part_w) = carve_scratch(g.device, (
               d2 * d * es, d * d2 * es, n * d * es, n * d2 * es, n * d * es,
               4 * strips, 4 * strips * (d2 + d), 4 * strips * 2 * d,
               4 * chunks * width),
               f"fused_gine_bn_layer_bwd at D = {d}, D2 = {d2}", width)
    dh = torch.empty_like(g)
    # [db1 | db2], [da | db], [dW1 | dW2 | detab]
    res = torch.empty(d2 + d + 2 * d + width, dtype=torch.float32,
                      device=g.device)
    sums_rows, sums_adj, wgrad = res.split([d2 + d, 2 * d, width])
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(*(x.data_ptr() for x in (g, dsums, h, a, b, adj, cnt, agg, mid,
                                      out, w1, w2)),
             w1t, w2t, gtc, dmidc, daggc, live, part_rows, part_adj, part_w,
             dh.data_ptr(), sums_rows.data_ptr(), sums_adj.data_ptr(),
             wgrad.data_ptr(), t, s, d, d2, int(bool(relu_in)), chunks, rows,
             tile_rows, stream)
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


def members_plain(fn, shared: dict, *stacked):
    """fn member by member on stacks of M (the JAX package's vmap with the
    `shared` keyword arguments unmapped, as its FineTuner maps the member
    axis over a shared batch), its results stacked along a new first
    axis."""
    outs = [fn(*(x[m] for x in stacked), **shared)
            for m in range(stacked[0].shape[0])]
    return tuple(torch.stack(r) for r in zip(*outs))


def fused_gine_layer_members_fwd_plain(h, adj, cnt, etab, w1, b1, w2, b2):
    """The plain forward of M members (h [M, N, D], etab [M, CNT_PAD, D],
    w1 [M, D, 2D], b1 [M, 2D], w2 [M, 2D, D], b2 [M, D]; adj and cnt
    shared): fused_gine_layer_fwd_plain member by member, (out, agg, mid)
    stacked."""
    return members_plain(
        lambda h, etab, w1, b1, w2, b2, adj, cnt: fused_gine_layer_fwd_plain(
            h, adj, cnt, etab, w1, b1, w2, b2),
        dict(adj=adj, cnt=cnt), h, etab, w1, b1, w2, b2)


def fused_gine_layer_members_bwd_plain(g, adj, cnt, agg, mid, w1, w2):
    """The plain backward of M members: fused_gine_layer_bwd_plain member
    by member on stacks of g, agg, mid, w1 and w2, its six results
    stacked."""
    return members_plain(
        lambda g, agg, mid, w1, w2, adj, cnt: fused_gine_layer_bwd_plain(
            g, adj, cnt, agg, mid, w1, w2),
        dict(adj=adj, cnt=cnt), g, agg, mid, w1, w2)


def _check_gine_args(name, h, adj, cnt, etab, w1, b1, w2, b2):
    """The unchained layer's arguments, one layer or a stack of M (h [M,
    N, D] and every parameter with a leading member axis)."""
    lead = h.shape[:-2]
    n, d = h.shape[-2:]
    d2 = w1.shape[-1]
    check_layer_args(name, dict(h=h, adj=adj, cnt=cnt, etab=etab, w1=w1,
                                w2=w2), dict(b1=b1, b2=b2), adj, n, d)
    if h.dim() not in (2, 3) or etab.shape[:-2] != lead \
            or w1.shape != (*lead, d, d2) or w2.shape != (*lead, d2, d) \
            or b1.shape != (*lead, d2) or b2.shape != (*lead, d):
        raise ValueError(f"{name}: MLP shapes do not match D")


def unchained_fwd_plan(t: int, s: int, d: int, d2: int) -> dict:
    """The grids of the unchained forwards K4f and K5f at T = t tiles of s
    rows and widths d and d2 (W1 [d, d2]), {launch: (row blocks, column
    slices)}: K4f's mid and out launches and K5f's xw and out passes each
    run one block per (16-row block, COL_SLICE-column slice of its output)
    (csrc/fused_gine_bn.cu gine_fwd, csrc/fused_gcn_bn.cu gcn_fwd). Tests
    and chip_smoke.py only; the kernels' wrappers never call it."""
    rows = t * s // STRIP_ROWS
    slices_mid, slices_out = -(-d2 // COL_SLICE), -(-d // COL_SLICE)
    return dict(k4f_mid=(rows, slices_mid), k4f_out=(rows, slices_out),
                k5f_xw=(rows, slices_out), k5f_out=(rows, slices_out))


def _gine_fwd_cuda(h, adj, cnt, etab, w1, b1, w2, b2, residuals: bool):
    """K4f on CUDA tensors, one launch for one layer (h [N, D] and its
    parameters) or a stack of M (a leading member axis on h and every
    parameter; adj and cnt shared): (out, agg, mid) with h's leading axes,
    agg and mid None unless `residuals`."""
    t, s = cuda_tiles("fused_gine_layer", h, adj)
    lead = h.shape[:-2]
    n, d = h.shape[-2:]
    d2 = w1.shape[-1]
    suffix = "f32" if h.dtype == torch.float32 else "bf16"
    fn = kernel_fn("fused_gine_bn", f"gine_fwd_{suffix}", 11, 5)
    # the out launch reads mid, the streamed design's mid launch agg:
    # scratch when no residuals are asked for
    with_agg = residuals or gine_streams_agg(h.dtype, s, d, d2)
    m = lead[0] if lead else 1
    check_fits(h.device, h.element_size() * m * n * (d * (1 + with_agg)
                                                      + d2),
               f"fused_gine_layer at D = {d}, D2 = {d2}, {m} members")
    out = torch.empty_like(h)
    agg = torch.empty_like(h) if with_agg else None
    mid = h.new_empty(*lead, n, d2)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = fn(h.data_ptr(), adj.data_ptr(), cnt.data_ptr(), etab.data_ptr(),
             w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
             out.data_ptr(), None if agg is None else agg.data_ptr(),
             mid.data_ptr(), t, s, d, d2, m, stream)
    _build.check(err, "fused_gine_layer")
    fused_gine_layer.launches += 1
    return out, agg if residuals else None, mid if residuals else None


def fused_gine_layer_fwd(h, adj, cnt, etab, w1, b1, w2, b2,
                         residuals: bool):
    """Forward of the unchained layer (kernel K4f): (out, agg, mid); agg
    and mid are None unless `residuals` (the CPU path, the plain version,
    always has them). Launches K4f on CUDA tensors (the one-member case of
    the member-axis launch), counted in `fused_gine_layer.launches`."""
    if h.device.type == "cpu":
        return fused_gine_layer_fwd_plain(h, adj, cnt, etab, w1, b1, w2, b2)
    return _gine_fwd_cuda(h, adj, cnt, etab, w1, b1, w2, b2, residuals)


def fused_gine_layer_members_fwd(h, adj, cnt, etab, w1, b1, w2, b2,
                                 residuals: bool):
    """Forward of M unchained layers on one batch (kernel K4f with its
    member grid axis; the JAX package's `jax.vmap` of `fused_gine_layer`
    over an ensemble): h [M, N, D], etab [M, CNT_PAD, D], w1 [M, D, D2],
    b1 [M, D2], w2 [M, D2, D], b2 [M, D], adj and cnt shared. Returns
    (out, agg, mid) [M, ...] as fused_gine_layer_fwd does. One launch on
    CUDA tensors, counted in `fused_gine_layer.launches`; member m's
    result equals a one-member launch's bit for bit."""
    if h.device.type == "cpu":
        return fused_gine_layer_members_fwd_plain(h, adj, cnt, etab, w1, b1,
                                                  w2, b2)
    return _gine_fwd_cuda(h, adj, cnt, etab, w1, b1, w2, b2, residuals)


def _check_gine_bwd_args(g, adj, cnt, agg, mid, w1, w2):
    """The unchained backward's arguments, one layer or a stack of M."""
    lead = g.shape[:-2]
    n, d = g.shape[-2:]
    d2 = w1.shape[-1]
    check_layer_args("fused_gine_layer_bwd",
                     dict(g=g, adj=adj, cnt=cnt, agg=agg, mid=mid, w1=w1,
                          w2=w2), {}, adj, n, d)
    if agg.shape != (*lead, n, d) or mid.shape != (*lead, n, d2) \
            or w1.shape != (*lead, d, d2) or w2.shape != (*lead, d2, d):
        raise ValueError("fused_gine_layer_bwd: shapes do not match")


def _gine_bwd_cuda(g, adj, cnt, agg, mid, w1, w2):
    """K4b on CUDA tensors, one launch for one layer or a stack of M (as
    _gine_fwd_cuda): fused_gine_layer_bwd_plain's results with g's
    leading axes."""
    t, s = cuda_tiles("fused_gine_layer_bwd", g, adj, "fused_gine_bwd")
    lead = g.shape[:-2]
    m = lead[0] if lead else 1
    n, d = g.shape[-2:]
    d2 = w1.shape[-1]
    suffix = "f32" if g.dtype == torch.float32 else "bf16"
    fn = kernel_fn("fused_gine_bwd", f"gine_bwd_{suffix}", 17, 8)
    strips, sms = n // STRIP_ROWS, sm_count(g.device)
    # the chunks of one member (they order its bf16 sums); the tile rows
    # for the whole launch
    chunks, rows, tile_rows = gine_bwd_weight_shape(n, d, d2, g.dtype, sms,
                                                    m)
    width = 2 * d * d2 + CNT_PAD * d
    es = g.element_size()
    # W1^T, W2^T, dmidc, daggc, the strip flags (int32) and the partials of
    # the row and weight passes (f32), each member's
    _buf, (w1t, w2t, dmidc, daggc, live, part_rows, part_w) = carve_scratch(
        g.device, tuple(m * b for b in (
            d2 * d * es, d * d2 * es, n * d2 * es, n * d * es, 4 * strips,
            4 * strips * (d2 + d), 4 * chunks * width)),
        f"fused_gine_layer_bwd at D = {d}, D2 = {d2}, {m} members", width)
    dh = torch.empty_like(g)
    # [db1 | db2] and [dW1 | dW2 | detab], each a stack over the members
    sums_rows = torch.empty(*lead, d2 + d, dtype=torch.float32,
                            device=g.device)
    wgrad = torch.empty(*lead, width, dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(*(x.data_ptr() for x in (g, adj, cnt, agg, mid, w1, w2)), w1t,
             w2t, dmidc, daggc, live, part_rows, part_w, dh.data_ptr(),
             sums_rows.data_ptr(), wgrad.data_ptr(), t, s, d, d2, chunks,
             rows, tile_rows, m, stream)
    _build.check(err, "fused_gine_layer_bwd")
    fused_gine_layer_bwd.launches += 1
    dw1, dw2, detab = wgrad.split([d * d2, d2 * d, CNT_PAD * d], dim=-1)
    return (dh, dw1.view(*lead, d, d2), sums_rows[..., :d2],
            dw2.view(*lead, d2, d), sums_rows[..., d2:],
            detab.view(*lead, CNT_PAD, d))


def fused_gine_layer_bwd(g, adj, cnt, agg, mid, w1, w2):
    """Backward of the unchained layer (kernel K4b): the arguments and
    results of fused_gine_layer_bwd_plain. CUDA tensors run the sm_90a
    kernels (the one-member case of the member-axis launch, counted in
    `fused_gine_layer_bwd.launches`); CPU tensors run the plain version."""
    _check_gine_bwd_args(g, adj, cnt, agg, mid, w1, w2)
    if g.dim() != 2:
        raise ValueError("fused_gine_layer_bwd: g must be [N, D]")
    if g.device.type == "cpu":
        return fused_gine_layer_bwd_plain(g, adj, cnt, agg, mid, w1, w2)
    return _gine_bwd_cuda(g, adj, cnt, agg, mid, w1, w2)


def fused_gine_layer_members_bwd(g, adj, cnt, agg, mid, w1, w2):
    """Backward of M unchained layers (kernel K4b with its member grid
    axis): g, agg, mid [M, N, .], w1 [M, D, D2], w2 [M, D2, D], adj and cnt
    shared. Returns (dh [M, N, D] in g's dtype, dW1, db1, dW2, db2, detab,
    each [M, ...] f32). One launch on CUDA tensors (counted in
    `fused_gine_layer_bwd.launches`), member m's results a one-member
    launch's bit for bit; the plain version on CPU tensors."""
    _check_gine_bwd_args(g, adj, cnt, agg, mid, w1, w2)
    if g.dim() != 3:
        raise ValueError("fused_gine_layer_members_bwd: g must be "
                         "[M, N, D]")
    if g.device.type == "cpu":
        return fused_gine_layer_members_bwd_plain(g, adj, cnt, agg, mid, w1,
                                                  w2)
    return _gine_bwd_cuda(g, adj, cnt, agg, mid, w1, w2)


fused_gine_layer_bwd.launches = 0


class _Gine(torch.autograd.Function):
    """K4f with residuals forward, K4b backward (`_fused_fwd` /
    `_fused_bwd` of the JAX package: agg and mid saved from the forward,
    the weight gradients returned in the weights' dtype, the bias
    gradients in f32). One layer, or (`members`) a stack of M."""

    @staticmethod
    def forward(ctx, h, adj, cnt, etab, w1, b1, w2, b2, members):
        fwd = (fused_gine_layer_members_fwd if members
               else fused_gine_layer_fwd)
        out, agg, mid = fwd(h, adj, cnt, etab, w1, b1, w2, b2,
                            residuals=True)
        ctx.save_for_backward(adj, cnt, agg, mid, w1, w2)
        ctx.members = members
        return out

    @staticmethod
    def backward(ctx, g):
        adj, cnt, agg, mid, w1, w2 = ctx.saved_tensors
        bwd = (fused_gine_layer_members_bwd if ctx.members
               else fused_gine_layer_bwd)
        dh, dw1, db1, dw2, db2, detab = bwd(g.contiguous(), adj, cnt, agg,
                                            mid, w1, w2)
        return (dh, None, None, detab.to(w1.dtype), dw1.to(w1.dtype), db1,
                dw2.to(w2.dtype), db2, None)


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
    if h.dim() != 2:
        raise ValueError("fused_gine_layer: h must be [N, D]")
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return _Gine.apply(*args, False)
    return fused_gine_layer_fwd(*args, residuals=False)[0]


fused_gine_layer.launches = 0


def fused_gine_layer_members(h, adj, cnt, etab, w1, b1, w2, b2):
    """fused_gine_layer of M members on one batch, as the JAX FineTuner's
    vmap runs it (member axis first on h [M, N, D], etab [M, CNT_PAD, D],
    w1 [M, D, 2D], b1 [M, 2D], w2 [M, 2D, D] and b2 [M, D]; adj and cnt
    shared): one K4f launch (and one K4b in the backward) over all members,
    counted as one in `fused_gine_layer.launches`; CPU tensors run the
    plain version member by member. Returns out [M, N, D]."""
    args = (h, adj, cnt, etab, w1, b1, w2, b2)
    _check_gine_args("fused_gine_layer", *args)
    if h.dim() != 3:
        raise ValueError("fused_gine_layer_members: h must be [M, N, D]")
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return _Gine.apply(*args, True)
    return fused_gine_layer_members_fwd(*args, residuals=False)[0]
