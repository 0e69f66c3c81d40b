"""Fused NT-Xent loss: forward (kernel K2f) and backward (kernel K2b).

Port of molclr_tpu/ops/pallas_ntxent.py. Flash-attention style: the
[2B, 2B] similarity matrix is never materialized. The forward sweeps
column blocks with an online (max, sum-exp) per row plus the positive
logit; the backward recomputes the blocks and accumulates

    dreps = (P + P^T) @ reps / T,
    P_ij  = valid_i * (softmax_row_i(S masked)_j - onehot_partner(i)_j)
            / n_valid

Cosine normalization, the padding of odd B and the masked mean run as
torch ops around the kernels, so their gradients compose by autograd.
Semantics match losses.nt_xent_loss: masked pairs contribute neither
positives nor negatives, and the loss is the mean over valid rows.

`ntxent_fwd` / `ntxent_bwd` launch the hand-written sm_90a kernels
(csrc/ntxent.cu) on CUDA tensors and run the plain versions
`ntxent_fwd_plain` / `ntxent_bwd_plain` (which mirror the Pallas kernels
block by block) on CPU tensors. `ntxent_plan` cuts the similarity into the
kernels' blocks (row tiles times column splits), and `split_stats_plain`
with `merge_stats_plain` mirror K2f's per-split statistics and their merge.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from molclr_tpu_torch.ops import _build
from molclr_tpu_torch.ops.fused_layer import H100_SMS, sm_count

NEG = -1e30
# the kernels' row and column tiles (csrc/ntxent.cu RB, CB) and the plain
# versions' columns per sweep step
BLK = 64
# csrc/ntxent.cu: K2f's depth of an s chunk and ring stages (KC, NS), K2b's
# (BKC, BNS), its output columns per block (DO) and column rows per product
# chunk (PC)
KC, STAGES, BWD_KC, BWD_STAGES, DO, PC = 32, 3, 64, 2, 256, 32
# K2f blocks resident on one SM (64 threads and FWD_SMEM bytes each), which
# ntxent_plan fills
FWD_BLOCKS_PER_SM = 4
# pairs per half are padded to a multiple of this (so 2B % 128 == 0)
PAIR_MULTIPLE = 64


def cosine_normalize(reps: torch.Tensor) -> torch.Tensor:
    """reps / max(||reps||, 1e-12) row-wise."""
    norm = torch.linalg.vector_norm(reps, dim=-1, keepdim=True)
    return reps / torch.clamp(norm, min=1e-12)


def _partner(n: int, device) -> torch.Tensor:
    i = torch.arange(n, device=device)
    return torch.where(i < n // 2, i + n // 2, i - n // 2)


def ntxent_fwd_plain(reps, valid, inv_t: float):
    """Per-row (m, l, pos) over the masked similarity (`_fwd_kernel`, all
    row blocks at once, the same column blocks in the same order)."""
    return _sweep_stats(reps, valid, inv_t, 0, reps.shape[0])


def _sweep_stats(reps, valid, inv_t: float, c0: int, c1: int):
    """(m, l, pos) of every row over the columns [c0, c1), BLK at a time
    in order."""
    n = reps.shape[0]
    rows = torch.arange(n, device=reps.device)
    partner = _partner(n, reps.device)
    m = torch.full((n,), NEG, device=reps.device)
    l = torch.zeros(n, device=reps.device)
    pos = torch.zeros(n, device=reps.device)
    for j0 in range(c0, c1, BLK):
        cols = reps[j0:j0 + BLK]
        col_ids = rows[j0:j0 + BLK]
        s = (reps @ cols.t()) * inv_t
        dead = (col_ids[None, :] == rows[:, None]) \
            | (valid[j0:j0 + BLK][None, :] == 0.0)
        s = torch.where(dead, NEG, s)
        is_pos = col_ids[None, :] == partner[:, None]
        pos = pos + torch.where(is_pos, s, 0.0).sum(dim=1)
        m_new = torch.maximum(m, s.max(dim=1).values)
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[:, None]).sum(dim=1)
        m = m_new
    return m, l, pos


def ntxent_plan(n: int, sms: int = H100_SMS) -> dict:
    """How K2f and K2b cut the [n, n] similarity (csrc/ntxent.cu, which
    takes the plan as it is and only checks it): one block per (BLK-row
    tile, column split), a split being a contiguous run of
    `tiles_per_split` BLK-column tiles (`runs`: [first, end) of each).
    The splits are the most whose blocks fit one wave of
    FWD_BLOCKS_PER_SM blocks on each of `sms` SMs (at least one), so the
    blocks fill the card at 2B = 1,024 as at 8,192 and the partials stay
    few. `smem_fwd` / `smem_bwd`: the kernels' shared memory in bytes,
    the same for every D (K2b cuts D into slices of DO itself)."""
    tiles = n // BLK
    want = min(tiles, max(1, FWD_BLOCKS_PER_SM * sms // tiles))
    tps = -(-tiles // want)
    splits = -(-tiles // tps)         # no split is empty
    bwd_stage = max(2 * BLK * (BWD_KC + 4), PC * (DO + 4))
    return dict(rows=BLK, splits=splits, tiles_per_split=tps,
                runs=tuple((s * tps, min((s + 1) * tps, tiles))
                           for s in range(splits)),
                smem_fwd=4 * STAGES * 2 * BLK * (KC + 4),
                smem_bwd=4 * (BWD_STAGES * bwd_stage + BLK * (BLK + 4)))


def split_stats_plain(reps, valid, inv_t: float, plan: dict):
    """[splits, n] (m_s, l_s, pos_s): the plain sweep over each split's
    columns alone, as K2f's blocks leave them."""
    stats = [_sweep_stats(reps, valid, inv_t, a * BLK, b * BLK)
             for a, b in plan["runs"]]
    return tuple(torch.stack(x) for x in zip(*stats))


def merge_stats_plain(m_s, l_s, pos_s):
    """K2f's merge of the splits (ntxent_merge_kernel), in split order: m =
    max m_s, l = sum l_s exp(m_s - m), pos = sum pos_s. A split whose
    columns are all dead (m_s = -1e30, l_s its column count) adds 0 to a
    live row and keeps a dead row's (m, l) finite."""
    m = m_s.max(dim=0).values
    l = torch.zeros_like(m)
    pos = torch.zeros_like(m)
    for s in range(m_s.shape[0]):
        l = l + l_s[s] * torch.exp(m_s[s] - m)
        pos = pos + pos_s[s]
    return m, l, pos


def ntxent_bwd_plain(reps, valid, inv_t: float, scale, m, l):
    """dreps = (P + P^T) @ reps / T from the saved (m, l) (`_bwd_kernel`,
    all row blocks at once). scale is 1 / n_valid (a 0-d tensor)."""
    n = reps.shape[0]
    rows = torch.arange(n, device=reps.device)
    partner = _partner(n, reps.device)
    acc = torch.zeros_like(reps)
    for j0 in range(0, n, BLK):
        cols = reps[j0:j0 + BLK]
        col_ids = rows[j0:j0 + BLK]
        v_cols, m_cols, l_cols = (x[j0:j0 + BLK] for x in (valid, m, l))
        s = (reps @ cols.t()) * inv_t
        diag = col_ids[None, :] == rows[:, None]
        # P block for my rows: columns dead when padded or diagonal
        s_mine = torch.where(diag | (v_cols[None, :] == 0.0), NEG, s)
        p = torch.exp(s_mine - m[:, None]) / l[:, None]
        p = p - (col_ids[None, :] == partner[:, None]).float()
        p = p * (scale * valid[:, None])
        acc = acc + p @ cols
        # P^T block: the cols' softmax at my rows, dead where my row is
        # padded
        s_theirs = torch.where(diag | (valid[:, None] == 0.0), NEG, s)
        pt = torch.exp(s_theirs - m_cols[None, :]) / l_cols[None, :]
        pt = pt - (partner[j0:j0 + BLK][None, :] == rows[:, None]).float()
        pt = pt * (scale * v_cols[None, :])
        acc = acc + pt @ cols
    return acc * inv_t


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entry points' parameters: (reps, valid, inv_t, outputs, scratch,
# n, d, splits, tiles per split, shared bytes, stream)
ARGTYPES = {
    "ntxent_fwd": [_P, _P, _F, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ntxent_bwd": [_P, _P, _F, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


@functools.lru_cache(maxsize=None)
def _kernel(fn: str):
    f = getattr(_build.load("ntxent"), fn)
    f.argtypes = ARGTYPES[fn]
    f.restype = ctypes.c_int
    return f


def _check(name: str, reps, valid):
    n, _ = reps.shape
    if reps.dtype != torch.float32 or valid.dtype != torch.float32:
        raise TypeError(f"{name}: reps and valid must be float32")
    if valid.shape != (n,) or valid.device != reps.device:
        raise ValueError(f"{name}: valid must be [{n}] on {reps.device}")
    if not (reps.is_contiguous() and valid.is_contiguous()):
        raise ValueError(f"{name}: reps and valid must be contiguous")
    if n % (2 * PAIR_MULTIPLE):
        raise ValueError(f"{name}: 2B = {n} is not a multiple of "
                         f"{2 * PAIR_MULTIPLE}")
    if reps.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {reps.device}")


def ntxent_fwd(reps, valid, inv_t: float):
    """(m, l, pos) [2B] f32 of pre-normalized reps [2B, D] f32 with valid
    [2B] 0/1. CUDA tensors run K2f (counted in `ntxent_fwd.launches`); CPU
    tensors run ntxent_fwd_plain."""
    _check("ntxent_fwd", reps, valid)
    if reps.device.type == "cpu":
        return ntxent_fwd_plain(reps, valid, inv_t)
    n, d = reps.shape
    plan = ntxent_plan(n, sm_count(reps.device))
    m, l, pos = (torch.empty(n, dtype=torch.float32, device=reps.device)
                 for _ in range(3))
    part = torch.empty(3, plan["splits"], n, dtype=torch.float32,
                       device=reps.device)
    stream = torch.cuda.current_stream(reps.device).cuda_stream
    err = _kernel("ntxent_fwd")(reps.data_ptr(), valid.data_ptr(), inv_t,
                                m.data_ptr(), l.data_ptr(), pos.data_ptr(),
                                part.data_ptr(), n, d, plan["splits"],
                                plan["tiles_per_split"], plan["smem_fwd"],
                                stream)
    _build.check(err, "ntxent_fwd")
    ntxent_fwd.launches += 1
    return m, l, pos


ntxent_fwd.launches = 0


def ntxent_bwd(reps, valid, inv_t: float, scale, m, l):
    """dreps [2B, D] f32 from the forward's (m, l); scale = 1 / n_valid as
    a 0-d f32 tensor. CUDA tensors run K2b (counted in
    `ntxent_bwd.launches`); CPU tensors run ntxent_bwd_plain."""
    _check("ntxent_bwd", reps, valid)
    if reps.device.type == "cpu":
        return ntxent_bwd_plain(reps, valid, inv_t, scale, m, l)
    n, d = reps.shape
    plan = ntxent_plan(n, sm_count(reps.device))
    dreps = torch.empty_like(reps)
    part = torch.empty(plan["splits"], n, d, dtype=torch.float32,
                       device=reps.device)
    scale, m, l = (x.contiguous() for x in (scale, m, l))
    stream = torch.cuda.current_stream(reps.device).cuda_stream
    err = _kernel("ntxent_bwd")(reps.data_ptr(), valid.data_ptr(), inv_t,
                                scale.data_ptr(), m.data_ptr(), l.data_ptr(),
                                dreps.data_ptr(), part.data_ptr(), n, d,
                                plan["splits"], plan["tiles_per_split"],
                                plan["smem_bwd"], stream)
    _build.check(err, "ntxent_bwd")
    ntxent_bwd.launches += 1
    return dreps


ntxent_bwd.launches = 0


def masked_mean(m, l, pos, valid):
    """mean over valid rows of m + log(l) - pos (`_masked_mean`)."""
    per_row = m + torch.log(l) - pos          # garbage-but-finite on dead
    n_valid = torch.clamp(valid.sum(), min=1.0)
    return torch.where(valid > 0, per_row, 0.0).sum() / n_valid


class _NTXentCore(torch.autograd.Function):
    """The loss of pre-normalized reps [2B, D] f32 (`_ntxent_core`)."""

    @staticmethod
    def forward(ctx, reps, valid, inv_t):
        m, l, pos = ntxent_fwd(reps, valid, inv_t)
        ctx.save_for_backward(reps, valid, m, l)
        ctx.inv_t = inv_t
        return masked_mean(m, l, pos, valid)

    @staticmethod
    def backward(ctx, g):
        reps, valid, m, l = ctx.saved_tensors
        scale = 1.0 / torch.clamp(valid.sum(), min=1.0)
        dreps = ntxent_bwd(reps, valid, ctx.inv_t, scale, m, l)
        return dreps * g, None, None


def nt_xent_kernel(zis, zjs, temperature: float = 0.1,
                   use_cosine: bool = True, pair_mask=None):
    """Drop-in for losses.nt_xent_loss through the kernels
    (`nt_xent_pallas`). Any B: both halves are padded with dead pairs to a
    multiple of 64 pairs, so 2B is a multiple of 128."""
    b = zis.shape[0]
    pad = (-b) % PAIR_MULTIPLE
    if pad:
        # pad PER HALF so that the +-B partner offsets stay aligned
        zpad = zis.new_zeros(pad, zis.shape[-1])
        zis = torch.cat([zis, zpad])
        zjs = torch.cat([zjs, zpad.to(zjs.dtype)])
        if pair_mask is None:
            pair_mask = torch.arange(b + pad, device=zis.device) < b
        else:
            pair_mask = torch.cat([pair_mask.bool(), pair_mask.new_zeros(
                pad, dtype=torch.bool)])
    reps = torch.cat([zjs, zis]).float()
    if use_cosine:
        reps = cosine_normalize(reps)
    if pair_mask is None:
        valid = torch.ones(reps.shape[0], device=reps.device)
    else:
        valid = torch.cat([pair_mask, pair_mask]).float()
    # the kernels take 1/T rounded to f32, as the Pallas kernels do
    inv_t = float(torch.tensor(1.0 / temperature, dtype=torch.float32))
    return _NTXentCore.apply(reps.contiguous(), valid.contiguous(), inv_t)
