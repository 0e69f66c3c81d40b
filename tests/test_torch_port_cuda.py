"""The PyTorch port's hand-written kernels on the card.

Every test here needs an NVIDIA GPU: it is marked `cuda` and skips without
one. The file imports nothing of JAX, so it runs on a machine that has only
PyTorch; tests/conftest.py imports JAX, so run it there without it:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances: kernel against its plain version on the same inputs, max error
<= 1e-4 (f32) / 3e-2 (bf16) of max|plain| (f32 sums in another order; bf16
may round one intermediate the other way); the embed CLI on the card
against --cpu, 1e-4 * max(1, max|cpu|); a training step's gradients on the
card against the CPU, 1e-3 of each gradient's max + 1e-6 (f32 through
three layers, a BatchNorm each); a training step replayed as a CUDA graph
against the same step run eagerly from the same state, with the same
optimizer object: bit-identical (tolerance 0)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from molclr_tpu_torch.cli import embed as port_embed
from molclr_tpu_torch.data.augment import unflatten_keys
from molclr_tpu_torch.data.featurize import featurize_smiles
from molclr_tpu_torch.data.graphs import pack_batch
from molclr_tpu_torch.data.loader import spec_for_graphs
from molclr_tpu_torch.data.synthetic import synthetic_corpus
from molclr_tpu_torch.models import MolCLRNet
from molclr_tpu_torch.losses import nt_xent_loss
from molclr_tpu_torch.ops import fused_gcn, fused_layer, ntxent, \
    scatter_free, segment
from molclr_tpu_torch.data.regroup import concat_units, epoch_unit_orders
from molclr_tpu_torch.train import checkpoints as ckpt_lib
from molclr_tpu_torch.train.config import FineTuneConfig, ModelConfig, \
    PretrainConfig
from molclr_tpu_torch.train.finetune import FineTuner
from molclr_tpu_torch.train.graphed import GRAPH_WARMUP_STEPS, \
    GraphedSteps, launch_counts
from molclr_tpu_torch.train.optim import load_optimizer_state
from molclr_tpu_torch.train.pretrain import PROFILE_STEPS, Pretrainer, \
    train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest --noconftest "
                    "tests/test_torch_port_cuda.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _problem(seed, tiles, s, d, padded_rows, layout="random",
             normalized=False):
    """Random block-diagonal symmetric adjacency with self-loops on real
    rows; the last `padded_rows` rows of every tile are padding. With
    layout "molecules" each tile holds small molecules (6-20 atoms, bonds
    within a molecule only), so most 32-column chunks of a strip are zero,
    and the last tile is padding in full. `normalized` scales A by dis_i
    dis_j and the counts by per-node weights, as normalize_gcn hands them
    to the GCN layer."""
    rng = np.random.RandomState(seed)
    n, pad = tiles * s, fused_layer.CNT_PAD
    adj = np.zeros((tiles, s, s), np.float32)
    for t in range(tiles):
        if layout == "molecules":
            a = np.zeros((s, s), np.float32)
            lo = 0
            while t < tiles - 1 and lo < s - padded_rows:
                hi = min(lo + rng.randint(6, 21), s - padded_rows)
                m = (rng.rand(hi - lo, hi - lo) < 0.3).astype(np.float32)
                a[lo:hi, lo:hi] = np.maximum(m, m.T)
                a[np.arange(lo, hi), np.arange(lo, hi)] = 1.0
                lo = hi
        else:
            a = (rng.rand(s, s) < 0.1).astype(np.float32)
            a = np.maximum(a, a.T)
            np.fill_diagonal(a, 1.0)
        a[s - padded_rows:, :] = 0
        a[:, s - padded_rows:] = 0
        adj[t] = a
    real = np.diagonal(adj, axis1=1, axis2=2).reshape(-1) > 0
    cnt = np.zeros((n, pad), np.float32)
    cnt[:, :8] = rng.randint(0, 3, (n, 8))
    cnt[~real] = 0
    if normalized:
        dis = 1.0 / np.sqrt(np.maximum(adj.sum(2), 1.0))
        adj = adj * dis[:, :, None] * dis[:, None, :]
        cnt = cnt * rng.rand(n, 1)
    x = dict(h=rng.randn(n, d), a=rng.rand(d) + 0.5, b=0.2 * rng.randn(d),
             adj=adj, cnt=cnt)
    etab = np.zeros((pad, d))
    etab[:8] = 0.3 * rng.randn(8, d)
    gine = dict(etab=etab, w1=rng.randn(d, 2 * d) / d ** 0.5,
                b1=0.1 * rng.randn(2 * d), w2=rng.randn(2 * d, d) / d ** 0.5,
                b2=0.1 * rng.randn(d))
    col = np.zeros((pad, 1))
    col[:8] = rng.randn(8, 1)
    gcn = dict(etab=np.repeat(col, d, axis=1), w=rng.randn(d, d) / d ** 0.5,
               bias=0.1 * rng.randn(d))
    return x, gine, gcn


ACT = {"h", "adj", "cnt", "etab", "w1", "w2", "w"}
# (tiles, tile, D, padded rows per tile[, layout]): ragged widths; a tile of
# 16 or 48 (K1f's 32-row blocks then span two tiles); the full width (S =
# 256, D = 300, D2 = 600) with molecule-like adjacency: all-zero A chunks,
# strips half padded (8 padded rows) and a padded tile
SHAPES = [(4, 64, 40, 9), (3, 16, 37, 5), (2, 256, 300, 100),
          (3, 256, 300, 8, "molecules"), (5, 48, 37, 8, "molecules")]


def _seed(shape):
    return sum(shape[:4])


def _to(m, dev, dt):
    return {k: torch.tensor(np.asarray(v, np.float32), device=dev,
                            dtype=dt if k in ACT else torch.float32)
            for k, v in m.items()}


def _run(layer, f, x, p, relu_in):
    if layer == "gine":
        return f(x["h"], x["a"], x["b"], x["adj"], x["cnt"], p["etab"],
                 p["w1"], p["b1"], p["w2"], p["b2"], relu_in)
    return f(x["h"], x["a"], x["b"], x["adj"], x["cnt"], p["etab"], p["w"],
             p["bias"], relu_in)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("layer", ["gine", "gcn"])
def test_kernel_matches_plain(cuda, shape, dtype, relu_in, layer):
    """The kernel against its plain version on the card, including ragged
    widths and padded rows; two runs are bit-identical (no atomics), and
    the launch count grows by one per call."""
    dt = getattr(torch, dtype)
    x, pg, pc = _problem(_seed(shape), *shape)
    x, p = _to(x, cuda, dt), _to(pg if layer == "gine" else pc, cuda, dt)
    kern, plain = ((fused_layer.fused_gine_bn_layer,
                    fused_layer.fused_gine_bn_layer_plain) if layer == "gine"
                   else (fused_gcn.fused_gcn_bn_layer,
                         fused_gcn.fused_gcn_bn_layer_plain))
    before = kern.launches
    out, sums = _run(layer, kern, x, p, relu_in)
    out2, sums2 = _run(layer, kern, x, p, relu_in)
    ref_out, ref_sums = _run(layer, plain, x, p, relu_in)
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    assert out.dtype == dt and out.shape == ref_out.shape
    rtol = 1e-4 if dt == torch.float32 else 3e-2
    err = (out.float() - ref_out.float()).abs().max().item()
    assert err <= rtol * ref_out.float().abs().max().item()
    err = (sums - ref_sums).abs().max().item()
    assert err <= rtol * ref_sums.abs().max().item()
    assert torch.equal(out, out2) and torch.equal(sums, sums2)


def _gine_args(x, p):
    return (x["h"], x["a"], x["b"], x["adj"], x["cnt"], p["etab"], p["w1"],
            p["b1"], p["w2"], p["b2"])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu_in", [False, True])
def test_backward_kernel_matches_plain(cuda, shape, dtype, relu_in):
    """K1f's residuals and K1b against the plain versions on the card, on
    the same residuals and random cotangents; two runs bit-identical."""
    dt = getattr(torch, dtype)
    x, pg, _ = _problem(_seed(shape) + 1, *shape)
    x, p = _to(x, cuda, dt), _to(pg, cuda, dt)
    args = _gine_args(x, p)
    out, sums, agg, mid = fused_layer.fused_gine_bn_layer_fwd(*args, relu_in,
                                               residuals=True)
    ref = fused_layer.fused_gine_bn_layer_fwd_plain(*args, relu_in)
    rtol = 1e-4 if dt == torch.float32 else 3e-2
    for got, want in zip((out, sums, agg, mid), ref):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= rtol * want.float().abs().max().item()
    gen = torch.Generator().manual_seed(_seed(shape))
    g = torch.randn(out.shape, generator=gen).to(cuda, dt)
    dsums = (0.05 * torch.randn(sums.shape, generator=gen)).to(cuda)
    bargs = (g, dsums, x["h"], x["a"], x["b"], x["adj"], x["cnt"], agg, mid,
             out, p["w1"], p["w2"], relu_in)
    before = fused_layer.fused_gine_bn_layer_bwd.launches
    got = fused_layer.fused_gine_bn_layer_bwd(*bargs)
    again = fused_layer.fused_gine_bn_layer_bwd(*bargs)
    want = fused_layer.fused_gine_bn_layer_bwd_plain(*bargs)
    torch.cuda.synchronize()
    assert fused_layer.fused_gine_bn_layer_bwd.launches == before + 2
    for name, a, b, c in zip(("dh", "da", "db", "dw1", "db1", "dw2", "db2",
                              "detab"), got, again, want):
        assert a.dtype == c.dtype and a.shape == c.shape, name
        err = (a.float() - c.float()).abs().max().item()
        assert err <= rtol * c.float().abs().max().item(), (name, err)
        assert torch.equal(a, b), name


# The eight layer kernels beyond the reference width (D = 384, 512, 1,024
# with D2 = 2 D; a tile of 512). The row-block kernels take a shallower f32
# weight ring where the first does not fit, and K1f then 16-row blocks (its
# rows expected here). K1b's and K4b's dagg launch
# holds a [16, D2] f32 operand: 1,280 / 2,560 fits with the 32 KB ring
# (the first design's row pass, 16 x (D + D2) floats, stopped just above
# D = 1,024). At D = 2,048 / D2 = 4,096 (tiles 128 and 256) no one-launch
# K1f block fits in shared memory: K1f splits (agg and mid through device
# memory, the mid launch streaming agg, out a launch of its own streaming
# mid; rows 16), and K4f's out launch and the
# dagg launch stream their [16, D2] operand in K-chunks; so do they at
# D2 = 3,072 (D = 1,536), the first width above the old f32 limit of
# about D2 = 3,000. Past f32 D = 2,752 at tile 256 no launch holds a
# [16, D] operand whole either: K4f's mid launch writes agg
# to device memory and streams it, K5f's / K3f's xw pass streams x, K5b's /
# K3b's strip pass writes dxw and streams it, K1b's / K4b's dmid launch
# streams gtc; at D = 3,000 (not a multiple of 32, tile 128) and D = 4,096
# (tile 256), also for the member-axis kernels (k4f_m ..: M = 2).
WIDE = [((3, 256, 384, 8, "molecules"), 32),
        ((3, 256, 512, 8, "molecules"), 32),
        ((3, 512, 300, 8, "molecules"), 32),
        ((3, 128, 1024, 8, "molecules"), 16)]
WIDEST = [((2, 128, 2048, 8, "molecules"), 16),
          ((2, 256, 2048, 8, "molecules"), 16)]
WIDE_D2 = ((2, 128, 1536, 8, "molecules"), 16)
WIDE_BWD = ((2, 128, 1280, 8, "molecules"), 0)
STREAMED = [((2, 128, 3000, 8, "molecules"), 16),
            ((2, 256, 4096, 8, "molecules"), 16)]
LAYER_KERNELS = ("k1f", "k1b", "k3f", "k3b", "k4f", "k4b", "k5f", "k5b")
MEMBER_KERNELS = ("k4f_m", "k4b_m", "k5f_m", "k5b_m")
WIDE_CASES = ([(k, *w) for k in LAYER_KERNELS for w in WIDE + WIDEST]
              + [(k, *WIDE_D2) for k in ("k4f", "k1b", "k4b")]
              + [("k1b", *WIDE_BWD), ("k4b", *WIDE_BWD)]
              + [(k, *w) for k in LAYER_KERNELS + MEMBER_KERNELS
                 for w in STREAMED])


def _wide_member_calls(kernel, shape, dt, dev):
    """_wide_calls of a member-axis kernel (M = 2 on one adjacency)."""
    x, pgs, pcs, hs, gs = _member_stack(shape, 2, dt, dev, _seed(shape) + 9)
    adj, cnt = x["adj"], x["cnt"]
    h, g = torch.stack(hs), torch.stack(gs)
    pg = [_stack(pgs, k) for k in ("etab", "w1", "b1", "w2", "b2")]
    w = _stack(pcs, "w")
    uargs = (h, adj, cnt, *pg)
    if kernel == "k4f_m":
        return [(("out", "agg", "mid"),
                 lambda: fused_layer.fused_gine_layer_members_fwd(
                     *uargs, residuals=True),
                 lambda: fused_layer.fused_gine_layer_members_fwd_plain(
                     *uargs))]
    if kernel == "k4b_m":
        _, agg, mid = fused_layer.fused_gine_layer_members_fwd_plain(*uargs)
        bargs = (g, adj, cnt, agg, mid, pg[1], pg[3])
        return [(("dh", "dw1", "db1", "dw2", "db2", "detab"),
                 lambda: fused_layer.fused_gine_layer_members_bwd(*bargs),
                 lambda: fused_layer.fused_gine_layer_members_bwd_plain(
                     *bargs))]
    if kernel == "k5f_m":
        return [(("out",),
                 lambda: (fused_gcn.fused_gcn_layer_members_fwd(h, adj, w),),
                 lambda: (fused_gcn.fused_gcn_layer_members_plain(h, adj,
                                                                  w),))]
    return [(("dx", "dw"),
             lambda: fused_gcn.fused_gcn_layer_members_bwd(g, h, adj, w),
             lambda: fused_gcn.fused_gcn_layer_members_bwd_plain(g, h, adj,
                                                                 w))]


def _wide_calls(kernel, x, pg, pc, g, dsums):
    """[(output names, kernel call, plain call)] of one layer kernel on a
    problem (each call returns a tuple); the backward kernels take the
    plain forward's outputs as their residuals."""
    h, a, b, adj, cnt = (x[k] for k in ("h", "a", "b", "adj", "cnt"))
    gargs = _gine_args(x, pg)
    cargs = (h, a, b, adj, cnt, pc["etab"], pc["w"], pc["bias"])
    uargs = (h, adj, cnt, pg["etab"], pg["w1"], pg["b1"], pg["w2"], pg["b2"])
    calls = []
    for relu_in in (False, True):
        if kernel == "k1f":
            calls.append((("out", "sums", "agg", "mid"),
                          lambda r=relu_in: fused_layer.fused_gine_bn_layer_fwd(
                              *gargs, r, residuals=True),
                          lambda r=relu_in:
                          fused_layer.fused_gine_bn_layer_fwd_plain(*gargs, r)))
        elif kernel == "k1b":
            out, _, agg, mid = fused_layer.fused_gine_bn_layer_fwd_plain(
                *gargs, relu_in)
            bargs = (g, dsums, h, a, b, adj, cnt, agg, mid, out, pg["w1"],
                     pg["w2"], relu_in)
            calls.append((("dh", "da", "db", "dw1", "db1", "dw2", "db2",
                           "detab"),
                          lambda v=bargs: fused_layer.fused_gine_bn_layer_bwd(
                              *v),
                          lambda v=bargs:
                          fused_layer.fused_gine_bn_layer_bwd_plain(*v)))
        elif kernel == "k3f":
            calls.append((("out", "sums"),
                          lambda r=relu_in: fused_gcn.fused_gcn_bn_layer(
                              *cargs, r),
                          lambda r=relu_in: fused_gcn.fused_gcn_bn_layer_plain(
                              *cargs, r)))
        elif kernel == "k3b":
            out, _ = fused_gcn.fused_gcn_bn_layer_plain(*cargs, relu_in)
            bargs = (g, dsums, h, a, b, adj, cnt, out, pc["w"], relu_in)
            calls.append((("dx", "da", "db", "dw", "dbias", "detab"),
                          lambda v=bargs: fused_gcn.fused_gcn_bn_layer_bwd(*v),
                          lambda v=bargs:
                          fused_gcn.fused_gcn_bn_layer_bwd_plain(*v)))
    if kernel == "k4f":
        calls.append((("out", "agg", "mid"),
                      lambda: fused_layer.fused_gine_layer_fwd(
                          *uargs, residuals=True),
                      lambda: fused_layer.fused_gine_layer_fwd_plain(*uargs)))
    elif kernel == "k4b":
        _, agg, mid = fused_layer.fused_gine_layer_fwd_plain(*uargs)
        bargs = (g, adj, cnt, agg, mid, pg["w1"], pg["w2"])
        calls.append((("dh", "dw1", "db1", "dw2", "db2", "detab"),
                      lambda: fused_layer.fused_gine_layer_bwd(*bargs),
                      lambda: fused_layer.fused_gine_layer_bwd_plain(*bargs)))
    elif kernel == "k5f":
        calls.append((("out",),
                      lambda: (fused_gcn.fused_gcn_layer_fwd(h, adj,
                                                             pc["w"]),),
                      lambda: (fused_gcn.fused_gcn_layer_plain(h, adj,
                                                               pc["w"]),)))
    elif kernel == "k5b":
        calls.append((("dx", "dw"),
                      lambda: fused_gcn.fused_gcn_layer_bwd(g, h, adj,
                                                            pc["w"]),
                      lambda: fused_gcn.fused_gcn_layer_bwd_plain(
                          g, h, adj, pc["w"])))
    return calls


@pytest.mark.parametrize("kernel,shape,rows", WIDE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_layer_kernels_match_plain(cuda, kernel, shape, rows, dtype):
    """Each layer kernel (relu_in off and on where it has a prologue) and
    each member-axis kernel against its plain version at wide layers and
    tiles, up to D = 4,096 / D2 = 8,192; two runs bit-identical; K1f's rows
    per block as k1f_block_rows gives them."""
    dt = getattr(torch, dtype)
    _, s, d = shape[:3]
    rtol = 1e-4 if dt == torch.float32 else 3e-2
    if kernel in MEMBER_KERNELS:
        calls = _wide_member_calls(kernel, shape, dt, cuda)
    else:
        x, pg, pc = _problem(_seed(shape) + 5, *shape)
        x, pg, pc = _to(x, cuda, dt), _to(pg, cuda, dt), _to(pc, cuda, dt)
        if kernel == "k1f":
            assert fused_layer.k1f_block_rows(dt, s, d, 2 * d) == rows
        gen = torch.Generator().manual_seed(_seed(shape))
        g = torch.randn(x["h"].shape, generator=gen).to(cuda, dt)
        dsums = (0.05 * torch.randn(2, d, generator=gen)).to(cuda)
        calls = _wide_calls(kernel, x, pg, pc, g, dsums)
    for names, run, plain in calls:
        got, again, want = run(), run(), plain()
        torch.cuda.synchronize()
        for name, a, b, c in zip(names, got, again, want):
            assert a.dtype == c.dtype and a.shape == c.shape, name
            err = (a.float() - c.float()).abs().max().item()
            assert err <= rtol * c.float().abs().max().item(), (name, err)
            assert torch.equal(a, b), name


@pytest.mark.parametrize("tiles", [4, 22, 44])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["k1b", "k4b"])
def test_gine_backward_at_the_trainers_tile_counts(cuda, tiles, dtype,
                                                    kernel):
    """K1b (relu_in off and on) and K4b at the full width (D = 300, D2 =
    600, tile 256, molecule-like adjacency) and the trainers' tile counts
    (T = 4 fine-tuning, 22 pretraining, 44 concat_views), with a cotangent
    that is nonzero on padding rows (every tile's last rows and the padded
    last tile's first strip: those strips stay live, and dW2 / db2 sum g
    there), against the plain versions within 1e-4 / 3e-2 of max|plain|;
    two runs bit-identical, one launch counted per call."""
    dt = getattr(torch, dtype)
    shape = (tiles, 256, 300, 8, "molecules")
    x, pg, _ = _problem(_seed(shape) + 6, *shape)
    x, pg = _to(x, cuda, dt), _to(pg, cuda, dt)
    h, a, b, adj, cnt = (x[k] for k in ("h", "a", "b", "adj", "cnt"))
    gen = torch.Generator().manual_seed(_seed(shape))
    n, d = h.shape
    g = torch.randn(n, d, generator=gen)
    real = fused_layer.adj_diag_mask(adj.cpu()).bool().reshape(-1)
    padding = ~real
    padding[(tiles - 1) * 256 + 16:] = False   # the rest of the last tile
    g = torch.where(real[:, None] | padding[:, None], g, 0.0).to(cuda, dt)
    dsums = (0.05 * torch.randn(2, d, generator=gen)).to(cuda)
    rtol = 1e-4 if dt == torch.float32 else 3e-2
    calls = []
    if kernel == "k1b":
        for relu_in in (False, True):
            out, _, agg, mid = fused_layer.fused_gine_bn_layer_fwd_plain(
                *_gine_args(x, pg), relu_in)
            calls.append((fused_layer.fused_gine_bn_layer_bwd,
                          fused_layer.fused_gine_bn_layer_bwd_plain,
                          (g, dsums, h, a, b, adj, cnt, agg, mid, out,
                           pg["w1"], pg["w2"], relu_in)))
    else:
        _, agg, mid = fused_layer.fused_gine_layer_fwd_plain(
            h, adj, cnt, pg["etab"], pg["w1"], pg["b1"], pg["w2"], pg["b2"])
        calls.append((fused_layer.fused_gine_layer_bwd,
                      fused_layer.fused_gine_layer_bwd_plain,
                      (g, adj, cnt, agg, mid, pg["w1"], pg["w2"])))
    for kern, plain, args in calls:
        before = kern.launches
        got, again, want = kern(*args), kern(*args), plain(*args)
        torch.cuda.synchronize()
        assert kern.launches == before + 2
        for i, (u, v, w) in enumerate(zip(got, again, want)):
            assert u.dtype == w.dtype and u.shape == w.shape, i
            err = (u.float() - w.float()).abs().max().item()
            assert err <= rtol * w.float().abs().max().item(), (i, err)
            assert torch.equal(u, v), i


@pytest.mark.parametrize("n,d", [(128, 32), (256, 256), (384, 100),
                                 (1024, 300), (1024, 512), (512, 1024),
                                 (4096, 256)])
@pytest.mark.parametrize("dead", [0, 7])
def test_ntxent_kernels_match_plain(cuda, n, d, dead):
    """K2f and K2b against their plain versions on the card, with dead
    pairs, at widths past the first design's D <= 256 (any D, as the
    Pallas kernels); two runs bit-identical."""
    gen = torch.Generator().manual_seed(n + d + dead)
    reps = torch.randn(n, d, generator=gen)
    reps = (reps / reps.norm(dim=1, keepdim=True)).to(cuda)
    valid = torch.ones(n)
    if dead:
        pairs = torch.randperm(n // 2, generator=gen)[:dead]
        valid[pairs] = 0
        valid[pairs + n // 2] = 0
    valid = valid.to(cuda)
    _ntxent_against_plain(reps, valid)


def _ntxent_against_plain(reps, valid):
    got = ntxent.ntxent_fwd(reps, valid, 10.0)
    again = ntxent.ntxent_fwd(reps, valid, 10.0)
    want = ntxent.ntxent_fwd_plain(reps, valid, 10.0)
    live = valid > 0
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        err = (a - c)[live].abs().max().item()
        assert err <= 1e-4 * max(1.0, c[live].abs().max().item())
    scale = 1.0 / valid.sum()
    m, l, _ = got
    dr = ntxent.ntxent_bwd(reps, valid, 10.0, scale, m, l)
    dr2 = ntxent.ntxent_bwd(reps, valid, 10.0, scale, m, l)
    ref = ntxent.ntxent_bwd_plain(reps, valid, 10.0, scale, m, l)
    torch.cuda.synchronize()
    assert torch.equal(dr, dr2)
    assert (dr - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    return got, dr


@pytest.mark.parametrize("n", [1024, 4096])
def test_ntxent_all_dead_split_stays_finite(cuda, n):
    """Every pair with a column in the second column split of the card's
    plan is dead, so that split's statistics are all dead on every row:
    the merged (m, l) stay finite on every row, dreps has no NaN, and the
    loss and gradient match the closed form."""
    plan = ntxent.ntxent_plan(n, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    a, b = plan["runs"][1]
    gen = torch.Generator().manual_seed(n)
    reps = torch.randn(n, 256, generator=gen)
    reps = (reps / reps.norm(dim=1, keepdim=True)).to(cuda)
    valid = torch.ones(n)
    cols = torch.arange(a * ntxent.BLK, b * ntxent.BLK) % (n // 2)
    valid[cols] = 0
    valid[cols + n // 2] = 0
    valid = valid.to(cuda)
    (m, l, pos), dr = _ntxent_against_plain(reps, valid)
    for x in (m, l, pos, dr):
        assert torch.isfinite(x).all()
    assert bool((l >= 1.0).all())
    rq = reps.clone().requires_grad_(True)
    sim = rq @ rq.t() * 10.0
    dead = torch.eye(n, dtype=torch.bool, device=cuda) | (valid == 0)[None]
    partner = torch.cat([torch.diagonal(sim, n // 2),
                         torch.diagonal(sim, -n // 2)])
    per_row = torch.logsumexp(sim.masked_fill(dead, float("-inf")), 1) \
        - partner
    closed = (per_row * valid).sum() / valid.sum()
    (grad,) = torch.autograd.grad(closed, rq)
    loss = ntxent.masked_mean(m, l, pos, valid)
    assert abs(loss.item() - closed.item()) <= 1e-5 * abs(closed.item())
    assert (dr - grad).abs().max().item() <= 1e-4 * grad.abs().max().item()


def test_ntxent_kernel_loss_matches_closed_form_on_card(cuda):
    gen = torch.Generator().manual_seed(3)
    zi = torch.randn(200, 64, generator=gen)
    zj = zi + 0.5 * torch.randn(200, 64, generator=gen)
    mask = torch.rand(200, generator=gen) > 0.1
    res = []
    for fn in (ntxent.nt_xent_kernel, nt_xent_loss):
        a = zi.to(cuda).requires_grad_(True)
        b = zj.to(cuda).requires_grad_(True)
        loss = fn(a, b, 0.1, True, pair_mask=mask.to(cuda))
        loss.backward()
        res.append((loss.item(), a.grad, b.grad))
    (l0, a0, b0), (l1, a1, b1) = res
    assert abs(l0 - l1) <= 1e-5 * max(1.0, abs(l1))
    assert (a0 - a1).abs().max().item() <= 1e-4 * a1.abs().max().item()
    assert (b0 - b1).abs().max().item() <= 1e-4 * b1.abs().max().item()


def test_trunk_gets_gradients_on_card(cuda):
    """Training MolCLRNet on the card gives every parameter a non-zero
    gradient, equal to the CPU's within 1e-3 of its max: GIN through K1b,
    GCN (with and without normalize_gcn) through K3b, one backward launch
    per layer and view."""
    smiles = synthetic_corpus(24, seed=5)
    gp = [featurize_smiles(s) for s in smiles]
    batch = pack_batch(gp, spec_for_graphs(gp, 24, tile=32, sizing="max"))
    for gnn, normalize in (("gin", False), ("gcn", False), ("gcn", True)):
        kern = (fused_layer.fused_gine_bn_layer_bwd if gnn == "gin"
                else fused_gcn.fused_gcn_bn_layer_bwd)
        grads = []
        for dev in (cuda, torch.device("cpu")):
            model = MolCLRNet(num_layers=3, emb_dim=32, feat_dim=64, tile=32,
                              gnn_type=gnn, normalize_gcn=normalize,
                              generator=torch.Generator().manual_seed(2))
            model = model.to(dev).train()
            b = batch.to(dev)
            before = kern.launches
            _, zi = model(b)
            _, zj = model(b)
            nt_xent_loss(zi, zj, 0.1, True, pair_mask=b.graph_mask).backward()
            if dev.type == "cuda":
                assert kern.launches == before + 6, gnn
            grads.append({k: p.grad.cpu()
                          for k, p in model.named_parameters()})
        for k, g in grads[0].items():
            ref = grads[1][k]
            # (+1e-6: the conv output biases feed a BatchNorm, so their
            # exact gradient is 0 and both devices hold f32 noise there)
            assert (g - ref).abs().max() <= 1e-3 * ref.abs().max() + 1e-6, \
                (gnn, normalize, k)
            assert g.abs().max() > 0, (gnn, normalize, k)


# K3b's shapes: SHAPES, the GCN mix step's tile count (T = 47) at the full
# width, and the normalize_gcn weights (A scaled by dis_i dis_j, weighted
# counts) on molecule-like tiles
GCN_BWD_SHAPES = SHAPES + [(47, 256, 300, 8, "molecules"),
                           (3, 256, 300, 8, "molecules", True)]


@pytest.mark.parametrize("shape", GCN_BWD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu_in", [False, True])
def test_gcn_backward_kernel_matches_plain(cuda, shape, dtype, relu_in):
    """K3b against its plain version on the card, on K3f's output and
    random cotangents, ragged widths, padded rows, the GCN mix step's 47
    tiles and the normalize_gcn weights included; two runs bit-identical,
    one launch counted per call."""
    dt = getattr(torch, dtype)
    x, _, pc = _problem(_seed(shape) + 4, *shape)
    x, p = _to(x, cuda, dt), _to(pc, cuda, dt)
    args = (x["h"], x["a"], x["b"], x["adj"], x["cnt"], p["etab"], p["w"],
            p["bias"])
    out, sums = fused_gcn.fused_gcn_bn_layer(*args, relu_in)
    gen = torch.Generator().manual_seed(_seed(shape))
    g = torch.randn(out.shape, generator=gen).to(cuda, dt)
    dsums = (0.05 * torch.randn(sums.shape, generator=gen)).to(cuda)
    bargs = (g, dsums, x["h"], x["a"], x["b"], x["adj"], x["cnt"], out,
             p["w"], relu_in)
    rtol = 1e-4 if dt == torch.float32 else 3e-2
    before = fused_gcn.fused_gcn_bn_layer_bwd.launches
    got = fused_gcn.fused_gcn_bn_layer_bwd(*bargs)
    again = fused_gcn.fused_gcn_bn_layer_bwd(*bargs)
    want = fused_gcn.fused_gcn_bn_layer_bwd_plain(*bargs)
    torch.cuda.synchronize()
    assert fused_gcn.fused_gcn_bn_layer_bwd.launches == before + 2
    for name, a, b, c in zip(("dx", "da", "db", "dw", "dbias", "detab"),
                             got, again, want):
        assert a.dtype == c.dtype and a.shape == c.shape, name
        err = (a.float() - c.float()).abs().max().item()
        assert err <= rtol * c.float().abs().max().item(), (name, err)
        assert torch.equal(a, b), name


@pytest.mark.parametrize("kind", ["subgraph", "mix"])
@pytest.mark.parametrize("tile", [0, 128])
def test_bfs_views_on_card_equal_cpu(cuda, kind, tile):
    """Subgraph and mix views drawn on the card equal the CPU's given the
    same CPU-drawn keys (integer and boolean work: tolerance 0)."""
    from molclr_tpu_torch.data import augment

    smiles = synthetic_corpus(30, seed=8) + ["C" * 25, "CC(=O)[O-].[Na+]"]
    gp = [featurize_smiles(s, add_hs=kind == "mix") for s in smiles]
    spec = spec_for_graphs(gp, len(gp), tile=tile or 128, sizing="max")
    batch = pack_batch(gp, spec)
    views = [augment.paired_augment(
        batch.to(dev), torch.Generator().manual_seed(3), kind, tile=tile,
        bond_window=spec.max_graph_bonds, max_waves=40)
        for dev in (cuda, torch.device("cpu"))]
    for got, want in zip(*views):
        for f in augment.AUG_DELTA_FIELDS:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


def test_layer_past_the_card_memory_raises_a_value_error(cuda, monkeypatch):
    """Every launch plan streams what shared memory cannot hold, so the
    limit of a layer's width is the card's memory: a call whose buffers
    do not fit (here a card taken to hold 64 KiB) raises a ValueError that
    names it, before any launch, for each of the eight layer kernels."""
    shape = (2, 128, 256, 8, "molecules")
    x, pg, pc = _problem(_seed(shape) + 5, *shape)
    x, pg, pc = (_to(v, cuda, torch.float32) for v in (x, pg, pc))
    gen = torch.Generator().manual_seed(3)
    g = torch.randn(x["h"].shape, generator=gen).to(cuda)
    dsums = (0.05 * torch.randn(2, 256, generator=gen)).to(cuda)
    monkeypatch.setattr(fused_layer, "device_memory", lambda dev: 1 << 16)
    for kernel in LAYER_KERNELS:
        for _, run, _ in _wide_calls(kernel, x, pg, pc, g, dsums):
            with pytest.raises(ValueError, match="device memory"):
                run()


def test_kernel_rejects_a_tile_that_is_not_a_multiple_of_the_strip(cuda):
    x, pg, _ = _problem(1, 2, 24, 8, 2)
    with pytest.raises(ValueError, match="multiple"):
        _run("gine", fused_layer.fused_gine_bn_layer,
             _to(x, cuda, torch.float32), _to(pg, cuda, torch.float32),
             False)


@pytest.mark.parametrize("gnn", ["gin", "gcn"])
def test_embed_cli_on_card_matches_cpu(cuda, tmp_path, gnn):
    """The embed CLI on the card (kernels) against --cpu (plain path), with
    one launch of the layer's kernel per layer and batch."""
    layers, tile = 2, 32
    smiles = synthetic_corpus(40, seed=21)
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(smiles) + "\n")
    model = MolCLRNet(num_layers=layers, emb_dim=32, feat_dim=64,
                      gnn_type=gnn, tile=tile,
                      generator=torch.Generator().manual_seed(9))
    gp = [featurize_smiles(s) for s in smiles[:16]]
    with torch.no_grad():
        model.train()(pack_batch(gp, spec_for_graphs(
            gp, 16, tile=tile, sizing="max")).to("cpu"))
    ckpt = tmp_path / "m.pth"
    torch.save(model.state_dict(), ckpt)
    args = ["--checkpoint", str(ckpt), "--model", gnn, "--layers",
            str(layers), "--emb-dim", "32", "--feat-dim", "64",
            "--batch-size", "16", "--tile", str(tile)]
    kern = (fused_layer.fused_gine_bn_layer if gnn == "gin"
            else fused_gcn.fused_gcn_bn_layer)
    kern.launches = 0
    assert port_embed.main([str(corpus), str(tmp_path / "g.npy"), *args]) == 0
    assert kern.launches == layers * 3                    # 40 molecules / 16
    assert port_embed.main([str(corpus), str(tmp_path / "c.npy"), *args,
                            "--cpu"]) == 0
    emb, ref = np.load(tmp_path / "g.npy"), np.load(tmp_path / "c.npy")
    assert emb.shape == ref.shape == (40, 64)
    assert np.abs(emb - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


# ----------------------------------------------- the unchained layers K4, K5


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unchained_gine_kernels_match_plain(cuda, shape, dtype):
    """K4f (with and without residuals) and K4b against their plain
    versions on the card, with random cotangents; two runs bit-identical,
    one launch counted per call."""
    dt = getattr(torch, dtype)
    x, pg, _ = _problem(_seed(shape) + 2, *shape)
    x, p = _to(x, cuda, dt), _to(pg, cuda, dt)
    args = (x["h"], x["adj"], x["cnt"], p["etab"], p["w1"], p["b1"],
            p["w2"], p["b2"])
    rtol = 1e-4 if dt == torch.float32 else 3e-2
    before = fused_layer.fused_gine_layer.launches
    res = fused_layer.fused_gine_layer_fwd(*args, residuals=True)
    res2 = fused_layer.fused_gine_layer_fwd(*args, residuals=True)
    lean = fused_layer.fused_gine_layer_fwd(*args, residuals=False)
    ref = fused_layer.fused_gine_layer_fwd_plain(*args)
    torch.cuda.synchronize()
    assert fused_layer.fused_gine_layer.launches == before + 3
    assert lean[1] is None and torch.equal(lean[0], res[0])
    for name, a, b, c in zip(("out", "agg", "mid"), res, res2, ref):
        assert a.dtype == dt and a.shape == c.shape, name
        err = (a.float() - c.float()).abs().max().item()
        assert err <= rtol * c.float().abs().max().item(), (name, err)
        assert torch.equal(a, b), name
    out, agg, mid = res
    gen = torch.Generator().manual_seed(_seed(shape))
    g = torch.randn(out.shape, generator=gen).to(cuda, dt)
    bargs = (g, x["adj"], x["cnt"], agg, mid, p["w1"], p["w2"])
    before = fused_layer.fused_gine_layer_bwd.launches
    got = fused_layer.fused_gine_layer_bwd(*bargs)
    again = fused_layer.fused_gine_layer_bwd(*bargs)
    want = fused_layer.fused_gine_layer_bwd_plain(*bargs)
    torch.cuda.synchronize()
    assert fused_layer.fused_gine_layer_bwd.launches == before + 2
    for name, a, b, c in zip(("dh", "dw1", "db1", "dw2", "db2", "detab"),
                             got, again, want):
        assert a.dtype == c.dtype and a.shape == c.shape, name
        err = (a.float() - c.float()).abs().max().item()
        assert err <= rtol * c.float().abs().max().item(), (name, err)
        assert torch.equal(a, b), name


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unchained_gcn_kernels_match_plain(cuda, shape, dtype):
    """K5f and K5b against their plain versions on the card; two runs
    bit-identical, one launch counted per call."""
    dt = getattr(torch, dtype)
    x, _, pc = _problem(_seed(shape) + 3, *shape)
    x, p = _to(x, cuda, dt), _to(pc, cuda, dt)
    rtol = 1e-4 if dt == torch.float32 else 3e-2
    before = fused_gcn.fused_gcn_layer.launches
    out = fused_gcn.fused_gcn_layer_fwd(x["h"], x["adj"], p["w"])
    out2 = fused_gcn.fused_gcn_layer_fwd(x["h"], x["adj"], p["w"])
    ref = fused_gcn.fused_gcn_layer_plain(x["h"], x["adj"], p["w"])
    torch.cuda.synchronize()
    assert fused_gcn.fused_gcn_layer.launches == before + 2
    assert out.dtype == dt and torch.equal(out, out2)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= rtol * ref.float().abs().max().item()
    gen = torch.Generator().manual_seed(_seed(shape))
    g = torch.randn(out.shape, generator=gen).to(cuda, dt)
    before = fused_gcn.fused_gcn_layer_bwd.launches
    got = fused_gcn.fused_gcn_layer_bwd(g, x["h"], x["adj"], p["w"])
    again = fused_gcn.fused_gcn_layer_bwd(g, x["h"], x["adj"], p["w"])
    want = fused_gcn.fused_gcn_layer_bwd_plain(g, x["h"], x["adj"], p["w"])
    torch.cuda.synchronize()
    assert fused_gcn.fused_gcn_layer_bwd.launches == before + 2
    for name, a, b, c in zip(("dx", "dw"), got, again, want):
        assert a.dtype == c.dtype and a.shape == c.shape, name
        err = (a.float() - c.float()).abs().max().item()
        assert err <= rtol * c.float().abs().max().item(), (name, err)
        assert torch.equal(a, b), name


def _member_stack(shape, m, dt, dev, seed):
    """m members' problems on one shared adjacency and counts: (shared x,
    [member gine params], [member gcn params], [member features], [member
    cotangents])."""
    x, _, _ = _problem(seed, *shape)
    x = _to(x, dev, dt)
    real = fused_layer.adj_diag_mask(x["adj"]).to(dt)
    pgs, pcs, hs, gs = [], [], [], []
    for i in range(m):
        xi, pg, pc = _problem(seed + 1 + i, *shape)
        pgs.append(_to(pg, dev, dt))
        pcs.append(_to(pc, dev, dt))
        hs.append(_to(xi, dev, dt)["h"] * real)
        gen = torch.Generator().manual_seed(seed + 100 + i)
        gs.append(torch.randn(hs[-1].shape, generator=gen).to(dev, dt)
                  * real)
    return x, pgs, pcs, hs, gs


def _stack(items, key):
    return torch.stack([p[key] for p in items])


@pytest.mark.parametrize("m", [1, 3, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["k4", "k5"])
def test_member_kernels_equal_single_launches(cuda, m, dtype, kernel):
    """K4f / K4b (kernel k4) and K5f / K5b (k5) with the member grid axis at
    the fine-tuning shape (T = 4 tiles of 256, D = 300, molecule-like
    adjacency shared by the members): one launch over m members, counted
    once, equals m one-member launches bit for bit and is within 1e-4 /
    3e-2 of max|plain| of the plain version member by member."""
    dt = getattr(torch, dtype)
    shape = (4, 256, 300, 8, "molecules")
    x, pgs, pcs, hs, gs = _member_stack(shape, m, dt, cuda, 40 + m)
    adj, cnt = x["adj"], x["cnt"]
    rtol = 1e-4 if dt == torch.float32 else 3e-2
    h, g = torch.stack(hs), torch.stack(gs)
    if kernel == "k4":
        params = [_stack(pgs, k) for k in ("etab", "w1", "b1", "w2", "b2")]
        fwd, fwd_plain = (fused_layer.fused_gine_layer_members_fwd,
                          fused_layer.fused_gine_layer_members_fwd_plain)
        bwd, bwd_plain = (fused_layer.fused_gine_layer_members_bwd,
                          fused_layer.fused_gine_layer_members_bwd_plain)
        counters = (fused_layer.fused_gine_layer,
                    fused_layer.fused_gine_layer_bwd)
        before = [c.launches for c in counters]
        got = fwd(h, adj, cnt, *params, residuals=True)
        bargs = (g, adj, cnt, got[1], got[2], params[1], params[3])
        dgot = bwd(*bargs)
        torch.cuda.synchronize()
        assert [c.launches for c in counters] == [b + 1 for b in before]
        want = fwd_plain(h, adj, cnt, *params)
        dwant = bwd_plain(*bargs)
        one = [fused_layer.fused_gine_layer_fwd(
            hs[i], adj, cnt, *(pgs[i][k] for k in (
                "etab", "w1", "b1", "w2", "b2")), residuals=True)
            for i in range(m)]
        done = [fused_layer.fused_gine_layer_bwd(
            gs[i], adj, cnt, one[i][1], one[i][2], pgs[i]["w1"],
            pgs[i]["w2"]) for i in range(m)]
    else:
        w = _stack(pcs, "w")
        counters = (fused_gcn.fused_gcn_layer, fused_gcn.fused_gcn_layer_bwd)
        before = [c.launches for c in counters]
        got = (fused_gcn.fused_gcn_layer_members_fwd(h, adj, w),)
        dgot = fused_gcn.fused_gcn_layer_members_bwd(g, h, adj, w)
        torch.cuda.synchronize()
        assert [c.launches for c in counters] == [b + 1 for b in before]
        want = (fused_gcn.fused_gcn_layer_members_plain(h, adj, w),)
        dwant = fused_gcn.fused_gcn_layer_members_bwd_plain(g, h, adj, w)
        one = [(fused_gcn.fused_gcn_layer_fwd(hs[i], adj, pcs[i]["w"]),)
               for i in range(m)]
        done = [fused_gcn.fused_gcn_layer_bwd(gs[i], hs[i], adj,
                                              pcs[i]["w"])
                for i in range(m)]
    torch.cuda.synchronize()
    for outs, plain, singles in ((got, want, one), (dgot, dwant, done)):
        for j, (a, c) in enumerate(zip(outs, plain)):
            assert a.dtype == c.dtype and a.shape == c.shape, j
            err = (a.float() - c.float()).abs().max().item()
            assert err <= rtol * c.float().abs().max().item(), (j, err)
            for i in range(m):
                assert torch.equal(a[i], singles[i][j]), (j, i)


@pytest.mark.parametrize("gnn", ["gin", "gcn"])
def test_finetune_trunk_gets_gradients_on_card(cuda, gnn):
    """A train-mode FineTuneNet step (drop_ratio 0.3, the unchained trunk)
    on the card gives every parameter a gradient through K4b / K5b (one
    launch per layer), equal to the CPU's with the same dropout masks
    within 1e-3 of its max (+1e-6, as above); all are non-zero but the
    conv output biases, whose exact gradient is 0 ahead of a BatchNorm."""
    from molclr_tpu_torch.models import FineTuneNet
    from molclr_tpu_torch.train.finetune import compute_loss

    layers, d = 3, 32
    smiles = synthetic_corpus(24, seed=6)
    gp = [featurize_smiles(s, add_hs=True) for s in smiles]
    batch = pack_batch(gp, spec_for_graphs(gp, 24, tile=64, sizing="max"))
    gen = torch.Generator().manual_seed(4)
    n = batch.nbr.shape[0]
    masks = [torch.rand(n, d, generator=gen) < 0.7 for _ in range(layers)]
    labels = torch.randint(0, 2, (24,), generator=gen).float()
    kern = (fused_layer.fused_gine_layer_bwd if gnn == "gin"
            else fused_gcn.fused_gcn_layer_bwd)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        model = FineTuneNet(num_layers=layers, emb_dim=d, feat_dim=64,
                            gnn_type=gnn, drop_ratio=0.3, tile=64,
                            generator=torch.Generator().manual_seed(2))
        model = model.to(dev).train()
        b = batch.to(dev)
        before = kern.launches
        _, pred = model(b, dropout_masks=[m.to(dev) for m in masks])
        compute_loss(pred, labels.to(dev), b.graph_mask, "ce").backward()
        if dev.type == "cuda":
            assert kern.launches == before + layers
        grads.append({k: p.grad.cpu() for k, p in model.named_parameters()})
    for k, g in grads[0].items():
        ref = grads[1][k]
        assert (g - ref).abs().max() <= 1e-3 * ref.abs().max() + 1e-6, k
        if not (k.endswith("mlp.2.bias") or (gnn == "gcn" and k.startswith(
                "gnns.") and k.endswith(".bias"))):
            assert g.abs().max() > 0, k


# ------------------------------------------------ CUDA-graph training steps


def _resident_pretrainer(cuda, tmp_path, **kw):
    """A small Pretrainer on the card with its tile-unit stack uploaded."""
    model = dict(num_layers=2, emb_dim=32, feat_dim=64, tile=64)
    model.update(kw.pop("model", {}))
    cfg = PretrainConfig(batch_size=16, epochs=4, warm_up=1, valid_size=0.1,
                         ckpt_dir=str(tmp_path / "ck"),
                         model=ModelConfig(**model), **kw)
    pre = Pretrainer(cfg, cuda).setup_data(synthetic_corpus(150, seed=3))
    pre.setup_state()
    pre._activate_units(lambda *_: None)
    assert pre._units
    return pre


def _state(pre):
    return ({k: v.clone() for k, v in pre.model.state_dict().items()},
            {k: v.clone() if torch.is_tensor(v) else v
             for k, v in _flat_opt_state(pre.opt).items()})


def _flat_opt_state(opt):
    sd = opt.state_dict()
    if "state" not in sd:                     # FusedAdam
        return sd
    return {f"{i}.{k}": v for i, st in sd["state"].items()
            for k, v in st.items()}


def _eager_then_graphed(pre, rows, warm=None):
    """The rows' steps run eagerly and then, from the same state and with
    the same optimizer object, replayed as a CUDA graph of
    pre.graph_steps steps; returns both runs' (losses, state). `warm`: the
    rows of the eager warm-up steps (default: the units path's first)."""
    import copy

    log = lambda *_: None  # noqa: E731
    k = pre.graph_steps
    if warm is None:
        warm = epoch_unit_orders(pre._n_units, pre._units_per_batch, 0,
                                 0)[:GRAPH_WARMUP_STEPS]
    pre._resident_epoch(0, warm, log)
    snap = (copy.deepcopy(pre.model.state_dict()),
            copy.deepcopy(pre.opt.state_dict()), pre.step)
    pre.graph_steps = 0
    eager = (pre._resident_epoch(0, rows, log), _state(pre))
    pre.model.load_state_dict(snap[0])
    load_optimizer_state(pre.opt, copy.deepcopy(snap[1]))
    pre.step = snap[2]
    pre.graph_steps = k
    graphed = (pre._resident_epoch(0, rows, log), _state(pre))
    return eager, graphed


@pytest.mark.parametrize("adam", ["chain", "fused"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("gnn", ["gin", "gcn"])
def test_graphed_steps_bit_identical_to_eager(cuda, tmp_path, gnn, bf16,
                                              adam):
    """Seven units-path steps (node augmentation) replayed as a CUDA graph
    against the same steps run eagerly from the same state: the losses, parameters, BatchNorm stats and Adam moments
    bit-identical; the graph captured once and replayed per step, its
    captured launches those of one step."""
    pre = _resident_pretrainer(cuda, tmp_path, adam_impl=adam,
                               model=dict(gnn_type=gnn, bf16=bf16))
    assert pre.graph_steps == 1
    orders = epoch_unit_orders(pre._n_units, pre._units_per_batch, 0, 1)
    (le, se), (lg, sg) = _eager_then_graphed(pre, orders[:7])
    assert le == lg
    for a, b in zip(se, sg):
        for k in a:
            assert torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) \
                else a[k] == b[k], k
    assert pre.graphed.replays == 7
    bwd = "fused_gine_bn_layer_bwd" if gnn == "gin" \
        else "fused_gcn_bn_layer_bwd"
    assert pre.graphed.launches[bwd] == 2 * 2


def test_graph_of_several_steps_bit_identical_to_eager(cuda, tmp_path):
    """steps_per_dispatch = 3: three steps per graph, an epoch's remainder
    eager; the same bits as eager steps."""
    pre = _resident_pretrainer(cuda, tmp_path, steps_per_dispatch=3)
    assert pre.graph_steps == 3
    orders = epoch_unit_orders(pre._n_units, pre._units_per_batch, 0, 1)
    (le, se), (lg, sg) = _eager_then_graphed(pre, orders[:7])
    assert le == lg
    assert all(torch.equal(se[0][k], sg[0][k]) for k in se[0])
    assert pre.graphed.replays == 2
    assert pre.graphed.launches["fused_gine_bn_layer_bwd"] == 3 * 2 * 2


def test_spans_in_a_graph_body_change_no_launch_and_no_bit(cuda, tmp_path):
    """A graph captured and replayed while torch.profiler records (the
    step's ranges live in its body during the capture) against one
    captured and replayed without it, from the same state: the same
    captured launches, and the same losses, parameters, BatchNorm stats
    and Adam moments bit for bit. The profiled run's replays and capture
    are its `graphed.replay` and `graphed.capture` ranges, inside
    `pretrain.dispatch`."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    log = lambda *_: None  # noqa: E731
    pre = _resident_pretrainer(cuda, tmp_path)
    orders = epoch_unit_orders(pre._n_units, pre._units_per_batch, 0, 0)
    pre._resident_epoch(0, orders[:GRAPH_WARMUP_STEPS], log)
    snap = (copy.deepcopy(pre.model.state_dict()),
            copy.deepcopy(pre.opt.state_dict()), pre.step)
    rows = orders[GRAPH_WARMUP_STEPS: GRAPH_WARMUP_STEPS + 3]
    plain = (pre._resident_epoch(0, rows, log), _state(pre),
             dict(pre.graphed.launches))
    pre.model.load_state_dict(snap[0])
    load_optimizer_state(pre.opt, copy.deepcopy(snap[1]))
    pre.step = snap[2]
    pre.graphed = None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = (pre._resident_epoch(0, rows, log), _state(pre),
                  dict(pre.graphed.launches))
    assert traced[0] == plain[0] and traced[2] == plain[2]
    for a, b in zip(traced[1], plain[1]):
        for k in a:
            assert torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) \
                else a[k] == b[k], k
    ranges = [e for e in prof.events() if e.device_type.name == "CPU"
              and e.name.startswith(("graphed.", "pretrain."))]
    parent = {e.name: e.cpu_parent.name for e in ranges if e.cpu_parent}
    assert sum(e.name == "graphed.replay" for e in ranges) == 3
    assert sum(e.name == "graphed.capture" for e in ranges) == 1
    assert parent["graphed.replay"] == "pretrain.dispatch"
    assert parent["graphed.capture"] == "graphed.replay"
    assert (pre.graphed.captures, pre.graphed.replays) == (1, 3)


@pytest.mark.parametrize("path", ["units", "host"])
def test_profile_dir_traces_steady_steps_on_card(cuda, tmp_path, path):
    """--profile-dir on the card: on the units path the profiler starts
    after the graph capture and traces PROFILE_STEPS replays (their
    `graphed.replay` ranges; no capture, no eager step); on the host path,
    with the graph steps the card resolves where a corpus exceeds
    device_cache_mb, after GRAPH_WARMUP_STEPS steps, with each step's
    parts."""
    lines = []
    cfg = PretrainConfig(batch_size=16, epochs=1, warm_up=1, valid_size=0.1,
                         ckpt_dir=str(tmp_path / "ck"),
                         profile_dir=str(tmp_path / "prof"),
                         model=ModelConfig(num_layers=2, emb_dim=32,
                                           feat_dim=64, tile=64),
                         **({"device_cache_mb": 0} if path == "host"
                            else {}))
    pre = Pretrainer(cfg, cuda).setup_data(synthetic_corpus(300, seed=3))
    pre.setup_state()
    assert pre.steps_per_epoch >= GRAPH_WARMUP_STEPS + 1 + PROFILE_STEPS
    if path == "host":
        pre.graph_steps = 1             # the default's, on the host path
    pre.train(log=lines.append)
    assert (pre._stack is None) == (path == "host")
    replays = PROFILE_STEPS if path == "units" else 0
    start = GRAPH_WARMUP_STEPS + (path == "units")
    assert f"profiler: tracing from step {start}" in lines
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    # the host's ranges (with CUDA activity each also has a device-side
    # annotation, category gpu_user_annotation)
    names = [e["name"] for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert names.count("pretrain.dispatch") == replays
    assert names.count("graphed.replay") == replays
    assert names.count("step.views") == PROFILE_STEPS - replays
    assert names.count("step.adam") == PROFILE_STEPS - replays
    assert "graphed.capture" not in names
    assert "pretrain.eager_step" not in names


def test_default_pretrainer_on_card_replays_the_units_path(cuda, tmp_path):
    """The default config on the card: the units path, every step after
    the warm-up replayed; device_cache_mb 0 streams from the host with
    eager steps. Both learn to finite losses."""
    pre = _resident_pretrainer(cuda, tmp_path / "u")
    pre.train(log=lambda *_: None)
    assert pre.graphed is not None
    assert pre.graphed.replays == 4 * pre.steps_per_epoch - GRAPH_WARMUP_STEPS
    assert np.isfinite(np.concatenate(pre.epoch_losses)).all()
    cfg = PretrainConfig(batch_size=16, epochs=2, valid_size=0.1,
                         device_cache_mb=0, ckpt_dir=str(tmp_path / "h"),
                         model=ModelConfig(num_layers=2, emb_dim=32,
                                           feat_dim=64, tile=64))
    host = Pretrainer(cfg, cuda).setup_data(synthetic_corpus(150, seed=3))
    host.setup_state().train(log=lambda *_: None)
    assert host._stack is None and host.graphed is None
    assert np.isfinite(np.concatenate(host.epoch_losses)).all()


def test_frozen_cache_and_replanned_units_replay_on_card(cuda, tmp_path):
    """The frozen batch cache (fresh_compositions False: host epoch 0,
    then the cached batches uploaded and every later step replayed) and a
    replan (replan_units_every 2: the new stack gets a new graph, which
    replays the steps after it)."""
    cfg = PretrainConfig(batch_size=16, epochs=3, warm_up=1, valid_size=0.1,
                         fresh_compositions=False,
                         ckpt_dir=str(tmp_path / "f"),
                         model=ModelConfig(num_layers=2, emb_dim=32,
                                           feat_dim=64, tile=64))
    frozen = Pretrainer(cfg, cuda).setup_data(synthetic_corpus(150, seed=3))
    frozen.setup_state().train(log=lambda *_: None)
    assert frozen._stack is not None and not frozen._units
    spe = frozen.steps_per_epoch
    assert frozen.graphed.replays == 2 * spe - GRAPH_WARMUP_STEPS
    assert np.isfinite(np.concatenate(frozen.epoch_losses)).all()
    pre = _resident_pretrainer(cuda, tmp_path / "r", replan_units_every=2)
    pre.train(log=lambda *_: None)
    assert pre._units_plan_epoch == 2
    assert pre.graphed.replays == 2 * pre.steps_per_epoch
    assert np.isfinite(np.concatenate(pre.epoch_losses)).all()


@pytest.mark.parametrize("first_mb,then_mb", [(0, 2048), (2048, 0)])
def test_resume_across_host_and_graphed_paths(cuda, tmp_path, first_mb,
                                              then_mb):
    """A checkpoint written on the host path (device_cache_mb 0: eager
    steps) resumes on the default units path (the steps after the warm-up
    replayed), and one written there resumes on the host path: the
    resumed run takes its epoch to finite losses, its Adam step counts on
    the card, where the capturable Adam that the Pretrainer builds on the
    card on either path keeps them."""
    smiles = synthetic_corpus(150, seed=3)

    def run(cache_mb, **kw):
        cfg = PretrainConfig(batch_size=16, epochs=2, warm_up=1,
                             valid_size=0.1, device_cache_mb=cache_mb,
                             ckpt_dir=str(tmp_path),
                             model=ModelConfig(num_layers=2, emb_dim=32,
                                               feat_dim=64, tile=64), **kw)
        pre = Pretrainer(cfg, cuda).setup_data(smiles).setup_state()
        pre.train(log=lambda *_: None)
        return pre

    first = run(first_mb, stop_after_epochs=1)
    assert (first.graphed is not None) == (first_mb > 0)
    then = run(then_mb,
               resume_from=ckpt_lib.latest_checkpoint(str(tmp_path)))
    assert then._start_epoch == 1 and len(then.epoch_losses) == 1
    assert np.isfinite(then.epoch_losses[0]).all()
    if then_mb:
        assert then.graphed.replays == (then.steps_per_epoch
                                        - GRAPH_WARMUP_STEPS)
    else:
        assert then.graphed is None
    assert all(st["step"].device.type == "cuda"
               for st in then.opt.state.values())


def test_host_path_and_graphed_step_take_one_adam(cuda, tmp_path):
    """The Pretrainer builds one Adam on the card whatever its path: the
    host path's (device_cache_mb 0) is the capturable torch.optim.Adam of
    the graphed units path. From the same state (the units path's after
    its eager warm-up, loaded into the host path's model and Adam), one
    host-path step (train_step, eager) and one graphed step (a replay) on
    the same batch and augmentation keys give the same loss, parameters,
    BatchNorm stats and Adam moments bit for bit."""
    import copy

    log = lambda *_: None  # noqa: E731
    pre = _resident_pretrainer(cuda, tmp_path / "g")
    cfg = dataclasses.replace(pre.cfg, device_cache_mb=0,
                              ckpt_dir=str(tmp_path / "h"))
    host = Pretrainer(cfg, cuda).setup_data(synthetic_corpus(150, seed=3))
    host.setup_state()
    assert host.graph_steps == 0 and pre.graph_steps == 1
    for p in (pre, host):
        assert type(p.opt) is torch.optim.Adam
        assert all(g["capturable"] for g in p.opt.param_groups)
    orders = epoch_unit_orders(pre._n_units, pre._units_per_batch, 0, 0)
    pre._resident_epoch(0, orders[:GRAPH_WARMUP_STEPS], log)
    host.model.load_state_dict(copy.deepcopy(pre.model.state_dict()))
    load_optimizer_state(host.opt, copy.deepcopy(pre.opt.state_dict()))
    step, row = pre.step, orders[GRAPH_WARMUP_STEPS]
    keys = pre._key_window(step, 1)[0]
    batch = concat_units(pre._stack, torch.as_tensor(row, device=cuda))
    lr = pre.schedule(step)
    graphed = pre._resident_epoch(0, orders[GRAPH_WARMUP_STEPS:
                                            GRAPH_WARMUP_STEPS + 1], log)
    assert pre.graphed.replays == 1
    loss = train_step(host.model, host.opt, batch, cfg, step, lr,
                      keys=unflatten_keys(cfg.aug, keys, batch.num_nodes,
                                          batch.num_graphs),
                      bond_window=pre.spec.max_graph_bonds,
                      max_waves=pre.max_waves)
    assert [loss.item()] == graphed
    for a, b in zip(_state(pre), _state(host)):
        for k in a:
            assert torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) \
                else a[k] == b[k], k


def test_a_capture_that_fails_raises(cuda, tmp_path):
    """A step that reads a device value on the host cannot be captured:
    the capture raises, in GraphedSteps and through Pretrainer.train."""
    def body(j, idx, keys):
        return torch.zeros((), device=cuda) + float(idx.sum())

    runner = GraphedSteps(body, 1, [((3,), torch.long), ((4,), torch.long)],
                          cuda)
    with pytest.raises(RuntimeError):
        runner.run(torch.zeros(1, 3, dtype=torch.long, device=cuda),
                   torch.zeros(1, 4, dtype=torch.long, device=cuda))
    assert runner.graph is None
    torch.cuda.synchronize()
    pre = _resident_pretrainer(cuda, tmp_path)
    inner = pre._graph_body

    def syncing(j, idx, keys):
        loss = inner(j, idx, keys)
        return loss * float(loss)

    pre._graph_body = syncing
    with pytest.raises(RuntimeError):
        pre.train(log=lambda *_: None)
    torch.cuda.synchronize()
    ft = _finetuner(cuda, tmp_path / "ft")
    step = ft._step

    def syncing_step(j, idx):
        losses = step(j, idx)
        return losses * float(losses.sum())

    ft._step = syncing_step
    with pytest.raises(RuntimeError):
        ft.train(log=lambda *_: None)


@pytest.mark.parametrize("adam", ["chain", "fused"])
@pytest.mark.parametrize("dispatch,k", [(0, 1), (3, 3)])
def test_graphed_dropout_steps_bit_identical_to_eager(cuda, tmp_path,
                                                      dispatch, k, adam):
    """Pretraining with dropout 0.1: seven units-path steps replayed as a
    CUDA graph of k steps (its dropout generators registered and reseeded
    per step before each replay) against the same steps run eagerly, each
    drawing from a fresh generator of (seed, step, view): losses,
    parameters, BatchNorm stats and Adam moments bit-identical; K4f and
    K4b captured, 2 views x 2 layers per step."""
    pre = _resident_pretrainer(cuda, tmp_path, steps_per_dispatch=dispatch,
                               adam_impl=adam, model=dict(drop_ratio=0.1))
    assert pre.graph_steps == k
    orders = epoch_unit_orders(pre._n_units, pre._units_per_batch, 0, 1)
    (le, se), (lg, sg) = _eager_then_graphed(pre, orders[:7])
    assert le == lg
    for a, b in zip(se, sg):
        for key in a:
            assert torch.equal(a[key], b[key]) if torch.is_tensor(a[key]) \
                else a[key] == b[key], key
    assert pre.graphed.launches["fused_gine_layer"] == k * 2 * 2
    assert pre.graphed.launches["fused_gine_layer_bwd"] == k * 2 * 2
    assert pre.graphed.launches["fused_gine_bn_layer"] == 0


# ------------------------------------------- fine-tuning steps and eval


def _finetuner(cuda, tmp, graphed=True, task="BBBP", targets=None,
               **kw):
    """A small FineTuner on the card (2 layers, emb 32, tile 64: the
    synthetic task molecules carry hydrogens), dropout 0.3."""
    model = dict(num_layers=2, emb_dim=32, feat_dim=64, tile=64,
                 drop_ratio=0.3)
    model.update(kw.pop("model", {}))
    cfg = FineTuneConfig(task_name=task, data_root=str(tmp / "data"),
                         synthetic_fallback=True, synthetic_n=240,
                         batch_size=16, epochs=2, ckpt_dir=str(tmp / "ck"),
                         model=ModelConfig(**model), **kw)
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        ft = FineTuner(cfg, cuda, targets=targets, graphed=graphed)
        ft.setup_data()
    return ft.setup_state()


def _ft_eager_then_graphed(ft, cuda):
    """Ten steps after the warm-up run eagerly and then, from the same
    state and dropout generator states, replayed as a CUDA graph: the
    members' losses, parameters, BatchNorm stats and Adam moments
    bit-identical, ten replays."""
    import copy

    _, order = ft._train_epoch_stack()
    rows = torch.from_numpy(np.asarray(order, np.int64)[:, None]).to(cuda)
    assert rows.shape[0] >= GRAPH_WARMUP_STEPS + 10
    ft._run_steps(rows[:GRAPH_WARMUP_STEPS])
    snap = (ft.member_states(), copy.deepcopy(ft.opt.state_dict()),
            [g.get_state() for g in ft.dropout_gens])
    rows = rows[GRAPH_WARMUP_STEPS: GRAPH_WARMUP_STEPS + 10]
    ft.graphed = False
    eager = ft._run_steps(rows).cpu()
    want = _finetune_state(ft)
    ft.load_member_states(snap[0])
    load_optimizer_state(ft.opt, copy.deepcopy(snap[1]))
    for g, st in zip(ft.dropout_gens, snap[2]):
        g.set_state(st)
    ft.graphed = True
    graphed = ft._run_steps(rows).cpu()
    got = _finetune_state(ft)
    assert torch.equal(eager, graphed)
    assert [k for k in want if not (torch.equal(want[k], got[k])
            if torch.is_tensor(want[k]) else want[k] == got[k])] == []
    assert ft._train_graph.replays == 10


def _finetune_state(ft):
    out = {f"m{m}.{k}": v.clone() for m, model in enumerate(ft.models)
           for k, v in model.state_dict().items()}
    out.update({f"adam.{k}": v.clone() if torch.is_tensor(v) else v
                for k, v in _flat_opt_state(ft.opt).items()})
    return out


@pytest.mark.parametrize("case", ["gin", "gcn", "motifs", "gin_3_seeds",
                                  "clintox_2x2"])
def test_graphed_finetune_steps_bit_identical_to_eager(cuda, tmp_path,
                                                       case):
    """Ten fine-tuning steps (dropout 0.3, all members) replayed as a CUDA
    graph against the same steps run eagerly from the same state and the
    same dropout generator states: the members' losses, parameters,
    BatchNorm stats and Adam moments bit-identical; the capture holds one
    step's launches, one of each layer kernel per layer (an ensemble's
    members' trunks run in lockstep, one member-axis launch a layer)."""
    import copy

    kw = dict(gin=dict(), gcn=dict(model=dict(gnn_type="gcn")),
              motifs=dict(use_motifs=True), gin_3_seeds=dict(n_seeds=3),
              clintox_2x2=dict(task="ClinTox", n_seeds=2,
                               targets=["CT_TOX", "FDA_APPROVED"]))[case]
    ft = _finetuner(cuda, tmp_path, **kw)
    _ft_eager_then_graphed(ft, cuda)
    layers = ft.cfg.model.num_layers
    fwd = "fused_gcn_layer" if case == "gcn" else "fused_gine_layer"
    assert ft._train_graph.launches[fwd] == layers
    assert ft._train_graph.launches[fwd + "_bwd"] == layers


def test_graphed_eval_bit_identical_to_eager(cuda, tmp_path):
    """An evaluation replayed over the split's stack (three members, the
    motif head) equals the eager pass bit for bit, and so do the metrics;
    a second call replays the same graph."""
    ft = _finetuner(cuda, tmp_path, use_motifs=True, n_seeds=3)
    ft._train_epoch()
    for split in ("valid", "test"):
        ft._split_stack(split)
        eager = ft._predict_split(split).cpu().numpy()
        graphed = ft.predictions(split)
        assert np.array_equal(eager, graphed)
        assert np.array_equal(ft.predictions(split), graphed)
        assert ft._eval_graphs[split].replays == 2
    ft.graphed = False
    want = ft.evaluate("valid")
    ft.graphed = True
    np.testing.assert_equal(ft.evaluate("valid"), want)


# ------------------------------------- model options: the ELL trunk, max pool

def _ell_case(op, dt, dev, seed=4):
    """A packed batch at tile 0 (a 300-atom chain among drug-like
    molecules) and random h, tables and cotangent on `dev`; returns the
    inputs, the op's extra arguments and the cotangent."""
    smiles = synthetic_corpus(60, seed=seed) + ["C" * 300]
    graphs = [featurize_smiles(s) for s in smiles]
    b = pack_batch(graphs, spec_for_graphs(graphs, len(graphs), tile=0,
                                           sizing="max")).to(dev)
    gen = torch.Generator().manual_seed(seed)
    n, d = b.num_nodes, 64
    cols = d if op == "gine" else 1
    h, tt, td, g = (torch.randn(shape, generator=gen).to(dev, dt)
                    for shape in ((n, d), (5, cols), (3, cols), (n, d)))
    extra = (b.nbr, b.nbr_bond_type, b.nbr_bond_dir, b.nbr_mask)
    if op == "gcn_norm":
        deg = b.nbr_mask.sum(dim=1).to(dt)
        dis = torch.rsqrt(torch.clamp(deg, min=1.0))
        extra += (dis[b.nbr] * dis[:, None],)
    return (h, tt, td), extra, g


@pytest.mark.parametrize("op", ["gine", "gcn", "gcn_norm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_aggregations_on_card_repeat_and_match_cpu(cuda, op, dtype):
    """gine_aggregate / gcn_aggregate forward and backward on the card:
    two runs bit-identical (no atomics), and against the same call on the
    CPU within 1e-6 (f32) / 1e-2 (bf16) of the largest value."""
    dt = getattr(torch, dtype)
    fn = scatter_free.gine_aggregate if op == "gine" \
        else scatter_free.gcn_aggregate
    outs = []
    for dev in (cuda, cuda, torch.device("cpu")):
        prim, extra, g = _ell_case(op, dt, dev)
        prim = [p.requires_grad_() for p in prim]
        out = fn(*prim, *extra)
        out.backward(g)
        outs.append([out.detach().cpu()] + [p.grad.cpu() for p in prim])
    rtol = 1e-6 if dtype == "float32" else 1e-2
    for a, b, c in zip(*outs):
        assert torch.equal(a, b)
        err = float((a.float() - c.float()).abs().max())
        assert err <= rtol * max(1.0, float(c.float().abs().max())), err


def test_graph_pool_max_on_card_repeats_and_matches_cpu(cuda):
    """graph_pool(method='max') with planted ties (nodes copied within
    their graph): forward and backward equal to the CPU's bit for bit
    (the max is exact, the tie split a one-hot count), two runs
    identical."""
    smiles = synthetic_corpus(40, seed=5)
    graphs = [featurize_smiles(s) for s in smiles]
    b = pack_batch(graphs, spec_for_graphs(graphs, 48, tile=64,
                                           sizing="max"))
    gen = torch.Generator().manual_seed(3)
    h = torch.randn(b.nbr.shape[0], 300, generator=gen)
    real = np.flatnonzero(b.node_mask)
    first = torch.as_tensor(real[np.unique(b.node_graph[real],
                                           return_index=True)[1]])
    h[first + 1] = h[first]                 # ties: atoms 0 and 1 of each
    g = torch.randn(48, 300, generator=gen)
    outs = []
    for dev in (cuda, cuda, torch.device("cpu")):
        bd = b.to(dev)
        x = h.to(dev, copy=True).requires_grad_()
        out = segment.graph_pool(x, bd.node_graph, bd.node_mask, 48,
                                 method="max")
        out.backward(g.to(dev))
        outs.append((out.detach().cpu(), x.grad.cpu()))
    for a, b2, c in zip(*outs):
        assert torch.equal(a, b2) and torch.equal(a, c)
    assert torch.equal(outs[0][1][first], outs[0][1][first + 1])


@pytest.mark.parametrize("case", ["gin_tile0", "gcn_norm_tile0_max",
                                  "gin_max"])
def test_graphed_option_steps_bit_identical_to_eager(cuda, tmp_path, case):
    """Seven resident steps replayed as a CUDA graph against the same steps
    run eagerly from the same state: the ELL trunk at tile 0 (the cached
    batches after a host epoch; GIN, and GCN with normalize_gcn and pool
    max, no layer kernel launched) and pool max on the units path (GIN,
    K1b per layer and view). Losses, parameters, BatchNorm stats and Adam
    moments bit-identical."""
    model = dict(gin_tile0=dict(tile=0),
                 gcn_norm_tile0_max=dict(tile=0, gnn_type="gcn",
                                         normalize_gcn=True, pool="max"),
                 gin_max=dict(pool="max"))[case]
    log = lambda *_: None  # noqa: E731
    if model.get("tile", 64):
        pre = _resident_pretrainer(cuda, tmp_path, model=model)
        rows, warm = epoch_unit_orders(pre._n_units, pre._units_per_batch,
                                       0, 1)[:7], None
    else:
        cfg = PretrainConfig(batch_size=16, epochs=4, warm_up=1,
                             valid_size=0.1, ckpt_dir=str(tmp_path / "ck"),
                             model=ModelConfig(num_layers=2, emb_dim=32,
                                               feat_dim=64, **model))
        pre = Pretrainer(cfg, cuda).setup_data(
            synthetic_corpus(150, seed=3) + ["C" * 300])
        pre.setup_state()
        pre._activate_units(log)
        assert not pre._units
        pre._host_epoch(0, log)
        pre._maybe_upload_cache(log)
        order = pre.train_iter.cached_epoch_order()[:, None]
        warm, rows = order[:GRAPH_WARMUP_STEPS], order[:7]
    before = launch_counts()
    (le, se), (lg, sg) = _eager_then_graphed(pre, rows, warm)
    assert le == lg and np.isfinite(le).all()
    for a, b in zip(se, sg):
        for k in a:
            assert torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) \
                else a[k] == b[k], k
    assert pre.graphed.replays == 7
    if model.get("tile", 64):
        assert pre.graphed.launches["fused_gine_bn_layer_bwd"] == 2 * 2
    else:
        assert launch_counts() == before
        assert not any(pre.graphed.launches.values())


@pytest.mark.parametrize("pool", ["mean", "max"])
def test_graphed_finetune_steps_tile0_bit_identical_to_eager(cuda, tmp_path,
                                                             pool):
    """The FineTuner on the ELL trunk (tile 0, dropout 0.3): ten graphed
    steps bit-identical to ten eager ones, no layer kernel launched."""
    ft = _finetuner(cuda, tmp_path, model=dict(tile=0, pool=pool))
    before = launch_counts()
    _ft_eager_then_graphed(ft, cuda)
    assert launch_counts() == before


def test_embed_cli_tile0_on_card_matches_cpu(cuda, tmp_path):
    """`cli.embed --tile 0` on the card embeds a 300-atom chain with the
    rest, no layer kernel launched, within 1e-4 * max(1, max|cpu|) of the
    --cpu run."""
    smiles = synthetic_corpus(30, seed=21) + ["C" * 300]
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(smiles) + "\n")
    model = MolCLRNet(num_layers=2, emb_dim=32, feat_dim=64, tile=0,
                      generator=torch.Generator().manual_seed(9))
    ckpt = tmp_path / "m.pth"
    torch.save(model.state_dict(), ckpt)
    args = ["--checkpoint", str(ckpt), "--layers", "2", "--emb-dim", "32",
            "--feat-dim", "64", "--batch-size", "16", "--tile", "0"]
    before = launch_counts()
    assert port_embed.main([str(corpus), str(tmp_path / "g.npy"), *args]) == 0
    assert launch_counts() == before
    assert port_embed.main([str(corpus), str(tmp_path / "c.npy"), *args,
                            "--cpu"]) == 0
    emb, ref = np.load(tmp_path / "g.npy"), np.load(tmp_path / "c.npy")
    assert emb.shape == ref.shape == (31, 64)
    assert np.abs(emb - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())
