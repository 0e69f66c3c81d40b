"""What the redesigned layer kernels (K1f, K1b, K3f, K3b, K4f, K4b, K5f,
K5b) skip, held to the plain versions and JAX.

The row-block kernels skip work that the data they load shows to be dead:
the all-zero 32-column chunks of an adjacency strip (with the features of
their nodes), row blocks whose adjacency and count rows are all zero (K1f
writes one constant row there, K4f agg = 0 and mid = rnd(relu(b1)), K5f
zeros), K5b's weight-pass row chunks and strips whose dxw rows are zero,
and the strips whose total cotangent gt is all zero in K4b and K1b (their
dmid and dagg launches write zeros there, their weight pass skips them);
K3f's xw and adjacency passes skip strips as K5f's do (the adjacency pass
with the counts: a strip whose A and cnt rows are all zero writes
rnd(bias)), and K3b's weight pass the strips whose A and cnt rows are all
zero. `fused_layer.kernel_plan`, `fused_gcn.k5b_plan`,
`fused_layer.gine_bwd_plan`, `fused_gcn.k3f_plan` and `fused_gcn.k3b_plan`
state those decisions, `fused_layer.unchained_fwd_plan` K4f's and K5f's
grids.
Here, on packed batches of `synthetic_corpus` at tile 64 and 256, in f32
and bf16:

  * the plain version run on inputs where every skipped operand is replaced
    by other finite values, with the dead blocks' constant row written in,
    equals the plain version on the real inputs bit for bit (so the skipped
    work cannot change a result);
  * that restricted result agrees with JAX's Pallas kernel in interpreter
    mode (`_bn_run_fwd`, `_fused_bwd`, `_run_fwd`, `_run_bwd`,
    `_bn_run_bwd` of fused_layer and fused_gcn) within the tolerances of
    tests/test_torch_port_ops.py and tests/test_torch_port_finetune_ops.py:
    1e-5 (f32) and 3e-2 (bf16, one bf16 rounding of an intermediate) of
    max(1, max|jax|);
  * K5b's weight pass has enough blocks for two per SM of an H100 (132)
    at the fine-tuning shape, and K4f's, K5f's, K4b's, K1b's and K3b's
    launches cover every output once and keep the card's SMs busy on the
    trainers' batches;
  * the layout constants and every C entry point that the wrappers bind
    with `fused_layer.kernel_fn` agree with the kernels' sources.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molclr_tpu.ops import fused_gcn as jax_fused_gcn
from molclr_tpu.ops import fused_layer as jax_fused_layer
from molclr_tpu_torch.data.featurize import NUM_BOND_DIRS, NUM_BOND_TYPES
from molclr_tpu_torch.data.graphs import pack_batch
from molclr_tpu_torch.data.loader import featurize_many, spec_for_graphs
from molclr_tpu_torch.data.synthetic import synthetic_corpus
from molclr_tpu_torch.ops import fused_gcn, fused_layer
from molclr_tpu_torch.ops.scatter_free import _counts
from molclr_tpu_torch.ops.tile_dense import build_tile_adjacency

CSRC = Path(fused_layer.__file__).resolve().parent.parent / "csrc"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
GARBAGE = 7.0


def assert_close(port, ref, rtol):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32).reshape(port.shape)
    err = float(np.abs(port - ref).max())
    assert err <= rtol * max(1.0, float(np.abs(ref).max())), err


@pytest.fixture(scope="module", params=[64, 256])
def packed(request):
    """A training batch packed as the trainers pack one ('total' sizing):
    tile 64, 40 molecules; tile 256, the fine-tuning shape's 32 molecules
    with their hydrogens. Returns (tile, adj [T, S, S] f32, cnt f32)."""
    tile = request.param
    if tile == 64:
        graphs, _ = featurize_many(synthetic_corpus(40, seed=7))
    else:
        graphs, _ = featurize_many(synthetic_corpus(32, seed=0), add_hs=True)
    batch = pack_batch(graphs, spec_for_graphs(graphs, len(graphs),
                                               tile=tile)).to("cpu")
    adj = build_tile_adjacency(batch.nbr, batch.nbr_mask, tile,
                               dtype=torch.float32)
    w = batch.nbr_mask.float()
    cnt = fused_layer.pack_cnt(_counts(batch.nbr_bond_type, w, NUM_BOND_TYPES),
                               _counts(batch.nbr_bond_dir, w, NUM_BOND_DIRS))
    return tile, adj, cnt.contiguous()


def _chunk_mask(plan, s):
    """[T, S, S] bool: the A entries inside a live (strip, chunk) pair."""
    sc = plan["strip_chunks"]
    cols = sc.repeat_interleave(fused_layer.ADJ_CHUNK, dim=1)[:, :s]
    return cols.repeat_interleave(fused_layer.STRIP_ROWS, dim=0).reshape(
        -1, s, s)


def _used_nodes(plan, s):
    """[N] bool: nodes in a (tile, chunk) that some strip of the tile
    multiplies; the features of every other node are never loaded."""
    sc = plan["strip_chunks"]
    t = sc.shape[0] * fused_layer.STRIP_ROWS // s
    per_tile = sc.reshape(t, -1, sc.shape[1]).any(dim=1)
    cols = per_tile.repeat_interleave(fused_layer.ADJ_CHUNK, dim=1)[:, :s]
    return cols.reshape(-1)


def _rows(mask, rows, n):
    return mask.repeat_interleave(rows)[:n]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu_in", [False, True])
def test_k1f_skips_only_dead_work(packed, dtype, relu_in):
    jdt, tdt, rtol = DTYPES[dtype]
    tile, adj, cnt = packed
    n, d, d2 = adj.shape[0] * tile, 20, 40
    rng = np.random.RandomState(tile + d)
    etab = np.zeros((fused_layer.CNT_PAD, d), np.float32)
    etab[:8] = 0.3 * rng.randn(8, d)
    x = dict(h=rng.randn(n, d), a=rng.rand(d) + 0.5, b=0.2 * rng.randn(d),
             adj=adj.numpy(), cnt=cnt.numpy(), etab=etab,
             w1=0.3 * rng.randn(d, d2), b1=0.3 * rng.randn(d2),
             w2=0.3 * rng.randn(d2, d), b2=0.1 * rng.randn(d))
    f32 = {"a", "b", "b1", "b2"}
    tx = {k: torch.tensor(np.asarray(v, np.float32)).to(
        torch.float32 if k in f32 else tdt) for k, v in x.items()}
    keys = ("h", "a", "b", "adj", "cnt", "etab", "w1", "b1", "w2", "b2")
    full = fused_layer.fused_gine_bn_layer_fwd_plain(
        *(tx[k] for k in keys), relu_in)

    plan = fused_layer.kernel_plan(tx["adj"], tx["cnt"])
    assert plan["dead_blocks"].any()
    assert plan["block_chunks"] < plan["dense_chunks"]
    mask = _chunk_mask(plan, tile)
    used = _used_nodes(plan, tile)
    rx = dict(tx, adj=torch.where(mask, tx["adj"], 0).to(tdt),
              h=torch.where(used[:, None], tx["h"], GARBAGE).to(tdt))
    out, sums, agg, mid = (v.clone() for v in
                           fused_layer.fused_gine_bn_layer_fwd_plain(
                               *(rx[k] for k in keys), relu_in))
    dead = _rows(plan["dead_blocks"], plan["block_rows"], n)
    first = int(torch.nonzero(dead)[0])
    out[dead] = out[first].clone()
    agg[dead] = 0
    mid[dead] = torch.relu(tx["b1"]).to(tdt)
    for got, want in zip((out, sums, agg, mid), full):
        assert torch.equal(got, want)

    jx = {k: jnp.asarray(np.asarray(v, np.float32),
                         jnp.float32 if k in f32 else jdt)
          for k, v in x.items()}
    ref = jax_fused_layer._bn_run_fwd(*(jx[k] for k in keys), relu_in, True)
    for got, want in zip((out, sums, agg, mid), ref):
        assert_close(got, want, rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5b_skips_only_dead_work(packed, dtype):
    jdt, tdt, rtol = DTYPES[dtype]
    tile, adj, _ = packed
    n, d = adj.shape[0] * tile, 20
    rng = np.random.RandomState(tile + 3)
    x = dict(x=rng.randn(n, d), adj=adj.numpy(), w=rng.randn(d, d) / d ** 0.5,
             g=rng.randn(n, d))
    tx = {k: torch.tensor(np.asarray(v, np.float32)).to(tdt)
          for k, v in x.items()}
    full = fused_gcn.fused_gcn_layer_bwd_plain(tx["g"], tx["x"], tx["adj"],
                                               tx["w"])

    plan = fused_gcn.k5b_plan(tx["adj"], d)
    assert plan["dead_strips"].any() and not plan["live_chunks"].all()
    mask = _chunk_mask(plan, tile)
    used = _used_nodes(plan, tile)
    # the weight pass loads x only for the live strips of live chunks
    live_x = ~_rows(plan["dead_strips"], fused_layer.STRIP_ROWS, n)
    live_x &= _rows(plan["live_chunks"], plan["dw_rows"], n)
    dx, dw = fused_gcn.fused_gcn_layer_bwd_plain(
        torch.where(used[:, None], tx["g"], GARBAGE).to(tdt),
        torch.where(live_x[:, None], tx["x"], GARBAGE).to(tdt),
        torch.where(mask, tx["adj"], 0).to(tdt), tx["w"])
    dead = _rows(plan["dead_strips"], fused_layer.STRIP_ROWS, n)
    assert not dx[dead].any()
    assert torch.equal(dx, full[0]) and torch.equal(dw, full[1])

    jx = {k: jnp.asarray(np.asarray(v, np.float32), jdt) for k, v in x.items()}
    jdx, _, jdw = jax_fused_gcn._fused_bwd(True, (jx["x"], jx["adj"], jx["w"]),
                                           jx["g"])
    assert_close(dx, jdx, rtol)
    assert_close(dw.to(tdt), jdw, rtol)


def _gine_problem(tile, adj, cnt, seed):
    n, d, d2 = adj.shape[0] * tile, 20, 40
    rng = np.random.RandomState(seed)
    etab = np.zeros((fused_layer.CNT_PAD, d), np.float32)
    etab[:8] = 0.3 * rng.randn(8, d)
    real = (np.diagonal(adj.numpy(), axis1=1, axis2=2).reshape(-1) > 0)
    h = rng.randn(n, d) * real[:, None]
    return dict(h=h, adj=adj.numpy(), cnt=cnt.numpy(), etab=etab,
                w1=0.3 * rng.randn(d, d2), b1=0.3 * rng.randn(d2),
                w2=0.3 * rng.randn(d2, d), b2=0.1 * rng.randn(d))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4f_skips_only_dead_work(packed, dtype):
    """K4f's mid launch on 16-row blocks: the plain forward with the skipped adjacency chunks zeroed and the
    features reached only through them replaced equals the full one bit
    for bit; dead blocks' rows are agg = 0 and mid = rnd(relu(b1)), the
    constants the kernel writes there with no product (its out launch
    runs every row); JAX's `_run_fwd` agrees within the tolerance."""
    jdt, tdt, rtol = DTYPES[dtype]
    tile, adj, cnt = packed
    x = _gine_problem(tile, adj, cnt, tile + 16)
    n = adj.shape[0] * tile
    f32 = {"b1", "b2"}
    tx = {k: torch.tensor(np.asarray(v, np.float32)).to(
        torch.float32 if k in f32 else tdt) for k, v in x.items()}
    keys = ("h", "adj", "cnt", "etab", "w1", "b1", "w2", "b2")
    full = fused_layer.fused_gine_layer_fwd_plain(*(tx[k] for k in keys))

    plan = fused_layer.kernel_plan(tx["adj"], tx["cnt"], 16)
    assert plan["dead_blocks"].any()
    assert plan["block_chunks"] < plan["dense_chunks"]
    mask = _chunk_mask(plan, tile)
    used = _used_nodes(plan, tile)
    rx = dict(tx, adj=torch.where(mask, tx["adj"], 0).to(tdt),
              h=torch.where(used[:, None], tx["h"], GARBAGE).to(tdt))
    got = fused_layer.fused_gine_layer_fwd_plain(*(rx[k] for k in keys))
    for a, b in zip(got, full):
        assert torch.equal(a, b)
    dead = _rows(plan["dead_blocks"], 16, n)
    _, agg, mid = full
    assert not agg[dead].any()
    assert torch.equal(mid[dead], torch.relu(0.0 + tx["b1"]).to(tdt).expand(
        int(dead.sum()), -1))

    jx = {k: jnp.asarray(np.asarray(v, np.float32),
                         jnp.float32 if k in f32 else jdt)
          for k, v in x.items()}
    ref = jax_fused_layer._run_fwd(*(jx[k] for k in keys), True)
    for a, b in zip(got, ref):
        assert_close(a, b, rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5f_skips_only_dead_work(packed, dtype):
    """K5f's passes on 16-row strips: the plain forward with the skipped
    adjacency chunks zeroed, the x rows reached only through them replaced
    and the x rows of dead strips zero (the kernel writes their xw rows as
    zeros) equals the full one bit for bit; dead strips' out rows are 0;
    JAX's `_run_fwd` agrees within the tolerance."""
    jdt, tdt, rtol = DTYPES[dtype]
    tile, adj, _ = packed
    n, d = adj.shape[0] * tile, 20
    rng = np.random.RandomState(tile + 5)
    x = dict(x=rng.randn(n, d), adj=adj.numpy(),
             w=rng.randn(d, d) / d ** 0.5)
    tx = {k: torch.tensor(np.asarray(v, np.float32)).to(tdt)
          for k, v in x.items()}
    full = fused_gcn.fused_gcn_layer_plain(tx["x"], tx["adj"], tx["w"])

    plan = fused_layer.kernel_plan(tx["adj"], None, fused_layer.STRIP_ROWS)
    assert plan["dead_strips"].any()
    assert plan["block_chunks"] < plan["dense_chunks"]
    mask = _chunk_mask(plan, tile)
    used = _used_nodes(plan, tile)
    dead = _rows(plan["dead_strips"], fused_layer.STRIP_ROWS, n)
    rxx = torch.where(used[:, None], tx["x"], GARBAGE)
    rxx = torch.where(dead[:, None], 0.0, rxx).to(tdt)
    got = fused_gcn.fused_gcn_layer_plain(
        rxx, torch.where(mask, tx["adj"], 0).to(tdt), tx["w"])
    assert torch.equal(got, full)
    assert not got[dead].any()

    jx = {k: jnp.asarray(np.asarray(v, np.float32), jdt) for k, v in x.items()}
    assert_close(got, jax_fused_gcn._run_fwd(jx["x"], jx["adj"], jx["w"],
                                             True), rtol)


def _gine_bwd_problem(tile, adj, cnt, seed, dtype, pad_g):
    """K1b's / K4b's inputs at small widths (D = 20, D2 = 40): random layer
    inputs, the plain K1f forward's residuals (out, agg, mid) and a
    cotangent g on the real rows; with pad_g also on one padding row of
    each of the first two strips that hold no real row (a caller's g need
    not be zero there). Returns (numpy inputs, torch inputs in dtype, the
    strips given padding g)."""
    n, d, d2 = adj.shape[0] * tile, 20, 40
    rng = np.random.RandomState(seed)
    etab = np.zeros((fused_layer.CNT_PAD, d), np.float32)
    etab[:8] = 0.3 * rng.randn(8, d)
    real = np.diagonal(adj.numpy(), axis1=1, axis2=2).reshape(-1) > 0
    x = dict(h=rng.randn(n, d), a=rng.rand(d) + 0.5, b=0.2 * rng.randn(d),
             adj=adj.numpy(), cnt=cnt.numpy(), etab=etab,
             w1=0.3 * rng.randn(d, d2), b1=0.3 * rng.randn(d2),
             w2=0.3 * rng.randn(d2, d), b2=0.1 * rng.randn(d),
             g=rng.randn(n, d) * real[:, None],
             dsums=0.05 * rng.randn(2, d))
    padded = np.flatnonzero(~real.reshape(-1, fused_layer.STRIP_ROWS)
                            .any(axis=1))[:2]
    if pad_g:
        for k in padded:
            x["g"][k * fused_layer.STRIP_ROWS + 3] = rng.randn(d)
    f32 = {"a", "b", "b1", "b2", "dsums"}
    tx = {k: torch.tensor(np.asarray(v, np.float32)).to(
        torch.float32 if k in f32 else dtype) for k, v in x.items()}
    out, _, agg, mid = fused_layer.fused_gine_bn_layer_fwd_plain(
        *(tx[k] for k in ("h", "a", "b", "adj", "cnt", "etab", "w1", "b1",
                          "w2", "b2")), True)
    tx.update(out=out, agg=agg, mid=mid)
    return x, tx, (padded if pad_g else padded[:0])


def _gine_bwd_skipped_inputs(tx, plan, tile):
    """tx with what K1b's and K4b's passes never read replaced: the A
    entries outside the live adjacency chunks zeroed, and the mid, agg and
    cnt rows of the dead strips (the dmid launch writes zeros there without
    reading mid, and the weight pass skips them) set to garbage."""
    n = tx["g"].shape[0]
    dead = _rows(plan["dead_strips"], fused_layer.STRIP_ROWS, n)[:, None]
    mask = _chunk_mask(plan["adj"], tile)
    return dict(tx, adj=torch.where(mask, tx["adj"], 0).to(tx["adj"].dtype),
                **{k: torch.where(dead, GARBAGE, tx[k]).to(tx[k].dtype)
                   for k in ("mid", "agg", "cnt")})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("pad_g", [False, True])
def test_k1b_skips_only_dead_work(packed, dtype, relu_in, pad_g):
    """K1b's passes (gine_bwd_plan): the plain backward with the skipped
    adjacency chunks zeroed and the mid, agg and cnt rows of the strips
    whose gt is all zero replaced equals the full one bit for bit; strips
    with nonzero g on padding rows stay live; JAX's `_bn_run_bwd` agrees
    within the tolerance (dW2 and db2 included, which sum g on padding
    rows)."""
    jdt, tdt, rtol = DTYPES[dtype]
    tile, adj, cnt = packed
    x, tx, padded = _gine_bwd_problem(tile, adj, cnt, tile + 31, tdt, pad_g)
    keys = ("g", "dsums", "h", "a", "b", "adj", "cnt", "agg", "mid", "out",
            "w1", "w2")
    full = fused_layer.fused_gine_bn_layer_bwd_plain(
        *(tx[k] for k in keys), relu_in)

    gt = fused_layer.gine_bwd_gt(tx["g"], tx["dsums"], tx["adj"], tx["out"])
    plan = fused_layer.gine_bwd_plan(gt, tx["adj"], 40, tdt)
    assert plan["dead_strips"].any()
    assert plan["adj"]["block_chunks"] < plan["adj"]["dense_chunks"]
    assert len(padded) == 2 * pad_g
    assert not plan["dead_strips"][list(padded)].any()
    rx = _gine_bwd_skipped_inputs(tx, plan, tile)
    got = fused_layer.fused_gine_bn_layer_bwd_plain(
        *(rx[k] for k in keys), relu_in)
    for a, b in zip(got, full):
        assert torch.equal(a, b)

    f32 = {"a", "b", "dsums"}
    jx = {k: jnp.asarray(np.asarray(tx[k].float(), np.float32),
                         jnp.float32 if k in f32 else jdt) for k in keys}
    ref = jax_fused_layer._bn_run_bwd(*(jx[k] for k in keys), relu_in, True)
    for a, b in zip(got, ref):
        assert_close(a, b, rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pad_g", [False, True])
def test_k4b_skips_only_dead_work(packed, dtype, pad_g):
    """K4b's passes (gine_bwd_plan with gt = g): the plain backward with
    the skipped adjacency chunks zeroed and the mid, agg and cnt rows of
    the strips whose g is all zero replaced equals the full one bit for
    bit; strips with nonzero g on padding rows stay live; JAX's `_run_bwd`
    agrees within the tolerance."""
    jdt, tdt, rtol = DTYPES[dtype]
    tile, adj, cnt = packed
    _, tx, padded = _gine_bwd_problem(tile, adj, cnt, tile + 37, tdt, pad_g)
    keys = ("g", "adj", "cnt", "agg", "mid", "w1", "w2")
    full = fused_layer.fused_gine_layer_bwd_plain(*(tx[k] for k in keys))

    plan = fused_layer.gine_bwd_plan(tx["g"], tx["adj"], 40)
    assert plan["dead_strips"].any()
    assert plan["adj"]["block_chunks"] < plan["adj"]["dense_chunks"]
    assert len(padded) == 2 * pad_g
    assert not plan["dead_strips"][list(padded)].any()
    rx = _gine_bwd_skipped_inputs(tx, plan, tile)
    got = fused_layer.fused_gine_layer_bwd_plain(*(rx[k] for k in keys))
    for a, b in zip(got, full):
        assert torch.equal(a, b)

    jx = {k: jnp.asarray(np.asarray(tx[k].float(), np.float32), jdt)
          for k in keys}
    ref = jax_fused_layer._run_bwd(*(jx[k] for k in keys), True)
    for a, b in zip(got, ref):
        assert_close(a, b, rtol)


def _gcn_problem(tile, adj, cnt, seed, dtype, normalized):
    """K3's inputs at a small width (D = 20): random layer inputs, the
    column-broadcast scalar edge tables, the plain K3f forward's output and
    a cotangent g on every row (padding included: K3b's gt pass sums it
    into dbias and its weight pass multiplies gtc by cnt). `normalized`
    scales A by dis_i dis_j and the counts by per-node weights, as
    normalize_gcn hands them to the layer. Returns (numpy inputs, torch
    inputs in dtype)."""
    n, d = adj.shape[0] * tile, 20
    rng = np.random.RandomState(seed)
    a_np, c_np = adj.numpy(), cnt.numpy()
    if normalized:
        dis = 1.0 / np.sqrt(np.maximum(a_np.sum(2), 1.0))
        a_np = a_np * dis[:, :, None] * dis[:, None, :]
        c_np = c_np * rng.rand(n, 1)
    col = np.zeros((fused_layer.CNT_PAD, 1))
    col[:8] = rng.randn(8, 1)
    x = dict(x=rng.randn(n, d), a=rng.rand(d) + 0.5, b=0.2 * rng.randn(d),
             adj=a_np, cnt=c_np, etab=np.repeat(col, d, axis=1),
             w=rng.randn(d, d) / d ** 0.5, bias=0.1 * rng.randn(d),
             g=rng.randn(n, d), dsums=0.05 * rng.randn(2, d))
    f32 = {"a", "b", "bias", "dsums"}
    tx = {k: torch.tensor(np.asarray(v, np.float32)).to(
        torch.float32 if k in f32 else dtype) for k, v in x.items()}
    return x, tx


GCN_FWD = ("x", "a", "b", "adj", "cnt", "etab", "w", "bias")
GCN_BWD = ("g", "dsums", "x", "a", "b", "adj", "cnt", "out", "w")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("normalized", [False, True])
def test_k3f_skips_only_dead_work(packed, dtype, relu_in, normalized):
    """K3f's two launches (k3f_plan): the plain adjacency pass
    (gcn_bn_out_plain) on the xw that the xw pass leaves (computed from x
    rows replaced by garbage on the strips whose A rows are all zero, then
    zero on those strips, as the pass writes them, and garbage on the
    nodes that no live adjacency chunk reaches), with the skipped chunks
    zeroed, equals the full plain forward bit for bit; the out rows of the
    adjacency pass's dead strips (A and cnt rows all zero) are rnd(bias),
    their moments 0; JAX's `_bn_run_fwd` agrees within the tolerance. With
    normalize_gcn's weights the dead strips are the same (liveness is
    decided by value)."""
    jdt, tdt, rtol = DTYPES[dtype]
    tile, adj, cnt = packed
    x, tx = _gcn_problem(tile, adj, cnt, tile + 41, tdt, normalized)
    n, d = tx["x"].shape
    full = fused_gcn.fused_gcn_bn_layer_plain(*(tx[k] for k in GCN_FWD),
                                              relu_in)

    plan = fused_gcn.k3f_plan(tx["adj"], tx["cnt"], d)
    assert plan["grids"] == {"xw": (n // 16, 1), "adj": (n // 16, 1)}
    xw_dead = _rows(plan["xw"]["dead_strips"], fused_layer.STRIP_ROWS, n)
    adj_dead = _rows(plan["adj"]["dead_strips"], fused_layer.STRIP_ROWS, n)
    assert xw_dead.any() and adj_dead.any()
    assert torch.equal(plan["xw"]["dead_strips"],
                       fused_layer.kernel_plan(adj, None, 16)["dead_strips"])
    assert plan["adj"]["block_chunks"] < plan["adj"]["dense_chunks"]
    mask = _chunk_mask(plan["adj"], tile)
    used = _used_nodes(plan["adj"], tile)
    rx = torch.where(xw_dead[:, None], GARBAGE, tx["x"]).to(tdt)
    xw = (fused_layer.bn_prologue(rx, tx["a"], tx["b"], relu_in).float()
          @ tx["w"].float()).to(tdt)
    xw = torch.where(xw_dead[:, None], 0.0, xw)
    xw = torch.where(used[:, None], xw, GARBAGE).to(tdt)
    got = fused_gcn.gcn_bn_out_plain(
        xw, torch.where(mask, tx["adj"], 0).to(tdt), tx["cnt"], tx["etab"],
        tx["bias"])
    for a, b in zip(got, full):
        assert torch.equal(a, b)
    out = got[0]
    assert torch.equal(out[adj_dead], tx["bias"].to(tdt).expand(
        int(adj_dead.sum()), -1))

    jx = {k: jnp.asarray(np.asarray(tx[k].float(), np.float32),
                         jnp.float32 if k in ("a", "b", "bias") else jdt)
          for k in GCN_FWD}
    ref = jax_fused_gcn._bn_run_fwd(*(jx[k] for k in GCN_FWD), relu_in,
                                    True)
    for a, b in zip(got, ref):
        assert_close(a, b, rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("normalized", [False, True])
def test_k3b_skips_only_dead_work(packed, dtype, relu_in, normalized):
    """K3b's launches (k3b_plan): the plain backward with the skipped
    adjacency chunks zeroed and the x and out rows of the strips that its
    weight pass skips (A and cnt rows all zero: the strip pass runs its
    epilogue there on dxc = 0, and their gt is g) replaced by garbage
    equals the full one bit for bit; with their g rows replaced too, every
    output but dbias does (the gt pass sums every row of g into dbias, as
    the kernel does); g is nonzero on padding rows and no strip is flagged
    by it. JAX's `_bn_run_bwd` agrees within the tolerance."""
    jdt, tdt, rtol = DTYPES[dtype]
    tile, adj, cnt = packed
    x, tx = _gcn_problem(tile, adj, cnt, tile + 43, tdt, normalized)
    n, d = tx["x"].shape
    tx["out"], _ = fused_gcn.fused_gcn_bn_layer_plain(
        *(tx[k] for k in GCN_FWD), relu_in)
    full = fused_gcn.fused_gcn_bn_layer_bwd_plain(
        *(tx[k] for k in GCN_BWD), relu_in)

    plan = fused_gcn.k3b_plan(tx["adj"], tx["cnt"], d, tdt)
    dead = _rows(plan["dead_strips"], fused_layer.STRIP_ROWS, n)
    assert dead.any() and (tx["g"][dead] != 0).any()
    assert torch.equal(plan["adj"]["dead_strips"] & ~plan["dead_strips"],
                       torch.zeros_like(plan["dead_strips"]))
    assert plan["adj"]["block_chunks"] < plan["adj"]["dense_chunks"]
    mask = _chunk_mask(plan["adj"], tile)
    rx = dict(tx, adj=torch.where(mask, tx["adj"], 0).to(tdt),
              **{k: torch.where(dead[:, None], GARBAGE, tx[k]).to(tdt)
                 for k in ("x", "out")})
    got = fused_gcn.fused_gcn_bn_layer_bwd_plain(
        *(rx[k] for k in GCN_BWD), relu_in)
    for a, b in zip(got, full):
        assert torch.equal(a, b)
    rx["g"] = torch.where(dead[:, None], GARBAGE, tx["g"]).to(tdt)
    again = fused_gcn.fused_gcn_bn_layer_bwd_plain(
        *(rx[k] for k in GCN_BWD), relu_in)
    for i, (a, b) in enumerate(zip(again, full)):
        assert torch.equal(a, b) != (i == 4), i

    f32 = {"a", "b", "dsums"}
    jx = {k: jnp.asarray(np.asarray(tx[k].float(), np.float32),
                         jnp.float32 if k in f32 else jdt) for k in GCN_BWD}
    ref = jax_fused_gcn._bn_run_bwd(*(jx[k] for k in GCN_BWD), relu_in,
                                    True)
    for a, b in zip(got, ref):
        assert_close(a, b, rtol)


@functools.lru_cache(maxsize=None)
def _tiles_batch(t):
    """(adj, cnt) of a batch as the trainers pack it at tile 256 with t
    tiles: the fine-tuning batch (t = 4, 32 molecules with hydrogens), a
    larger fine-tuning batch (t = 6, 48) and the pretraining batch (t =
    22, 512 molecules)."""
    n_mols, add_hs = {4: (32, True), 6: (48, True), 22: (512, False)}[t]
    graphs, _ = featurize_many(synthetic_corpus(n_mols, seed=7 if t == 22
                                                else 0), add_hs=add_hs)
    batch = pack_batch(graphs, spec_for_graphs(graphs, n_mols,
                                               tile=256)).to("cpu")
    adj = build_tile_adjacency(batch.nbr, batch.nbr_mask, 256,
                               dtype=torch.float32)
    assert adj.shape[0] == t
    w = batch.nbr_mask.float()
    cnt = fused_layer.pack_cnt(_counts(batch.nbr_bond_type, w, NUM_BOND_TYPES),
                               _counts(batch.nbr_bond_dir, w, NUM_BOND_DIRS))
    return adj, cnt


@pytest.mark.parametrize("t", [4, 6, 22])
@pytest.mark.parametrize("sms", [78, 114, 132])
def test_unchained_forward_plan_fills_the_card(t, sms):
    """unchained_fwd_plan at the reference widths (D = 300, D2 = 600, tile
    256): each launch's 16-row blocks cover every (row, column) of its
    output once, and the blocks that do work (K4f's mid launch and K5f's
    passes skip dead row blocks, K4f's out launch runs all) reach the SM
    count on the trainers' batches; only K5f's three column slices of the
    fine-tuning batch's 40 live strips stay short of 132 SMs."""
    s, d, d2 = 256, 300, 600
    n = t * s
    grids = fused_layer.unchained_fwd_plan(t, s, d, d2)
    cols = {"k4f_mid": d2, "k4f_out": d, "k5f_xw": d, "k5f_out": d}
    for name, (blocks, slices) in grids.items():
        assert blocks * fused_layer.STRIP_ROWS == n, name
        width = fused_layer.COL_SLICE
        assert (slices - 1) * width < cols[name] <= slices * width, name

    adj, cnt = _tiles_batch(t)
    live = int((~fused_layer.kernel_plan(adj, cnt, 16)["dead_blocks"]).sum())
    strips = int((~fused_layer.kernel_plan(adj, None, 16)["dead_strips"])
                 .sum())
    busy = {"k4f_mid": live * grids["k4f_mid"][1],
            "k4f_out": grids["k4f_out"][0] * grids["k4f_out"][1],
            "k5f_xw": strips * grids["k5f_xw"][1],
            "k5f_out": strips * grids["k5f_out"][1]}
    for name, blocks in busy.items():
        assert blocks >= sms or (name.startswith("k5f") and t == 4
                                 and strips == 40), (name, blocks)


@pytest.mark.parametrize("t", [4, 22, 44])
@pytest.mark.parametrize("sms", [78, 114, 132])
def test_gine_bwd_plan_fills_the_card(t, sms):
    """gine_bwd_plan at the reference widths (D = 300, D2 = 600, tile 256)
    on the trainers' batches (T = 4: fine-tuning; 22: pretraining; 44:
    concat_views' two views, here the pretraining batch twice), g on the
    real rows: the dmid, dagg and adjacency launches cover every (row,
    column) of their outputs once, and so do the weight pass's chunks and
    tiles (f32: the first design's ceil(N / 1,024) chunks of at most 1,024
    rows, equal up to one strip each); the blocks that do work reach the SM
    count, but for the dagg and adjacency launches' three column slices of
    the fine-tuning batch's 40 live strips (as K5f's)."""
    s, d, d2 = 256, 300, 600
    adj, _ = _tiles_batch(min(t, 22))
    if t == 44:
        adj = torch.cat([adj, adj])
    n = t * s
    real = fused_layer.adj_diag_mask(adj)
    g = torch.randn(n, d, generator=torch.Generator().manual_seed(t)) * real
    for dtype in (torch.float32, torch.bfloat16):
        plan = fused_layer.gine_bwd_plan(g, adj, d2, dtype, sms)
        grids = plan["grids"]
        for name, width in (("dmid", d2), ("dagg", d), ("adj", d)):
            rows, slices = grids[name]
            assert rows * 16 == n, name
            cw = fused_layer.COL_SLICE
            assert (slices - 1) * cw < width <= slices * cw, name
        chunks, rows = plan["dw_chunks"], plan["dw_rows"]
        assert rows % 16 == 0 and rows <= fused_layer.DW_MAX_ROWS
        assert (chunks - 1) * rows < n <= chunks * rows
        if dtype == torch.float32:
            assert chunks == -(-n // fused_layer.BWD_CHUNK_ROWS)
            assert rows <= fused_layer.BWD_CHUNK_ROWS
            assert rows - (n - (chunks - 1) * rows) <= 16 * (chunks - 1)
        tr = plan["dw_tile_rows"]
        for name, (m, c) in (("dw1", (d, d2)), ("dw2", (d2, d)),
                             ("detab", (fused_layer.CNT_PAD, d))):
            ch, tm, tc = grids["weights"][name]
            assert ch == chunks
            assert (tm - 1) * tr < m <= tm * tr, name
            assert (tc - 1) * fused_layer.DW_TILE < c <= \
                tc * fused_layer.DW_TILE, name

        live = int((~plan["dead_strips"]).sum())
        adj_live = int((~plan["adj"]["dead_strips"]).sum())
        tiles = sum(tm * tc for _, tm, tc in grids["weights"].values())
        busy = {"dmid": live * grids["dmid"][1],
                "dagg": live * grids["dagg"][1],
                "adj": adj_live * grids["adj"][1],
                "weights": int(plan["live_chunks"].sum()) * tiles}
        for name, blocks in busy.items():
            assert blocks >= sms or (name in ("dagg", "adj") and t == 4
                                     and live == adj_live == 40), \
                (dtype, name, blocks)


@pytest.mark.parametrize("t", [22, 47])
@pytest.mark.parametrize("sms", [78, 114, 132])
def test_k3b_plan_fills_the_card(t, sms):
    """k3b_plan at the reference width (D = 300, tile 256) on the GCN
    trainers' tile counts (T = 22: pretraining; 47: GCN mix, here the
    pretraining batch twice and three of its tiles): the gt and strip
    passes cover every (row, column) once, and so do the weight pass's
    chunks and tiles; f32 keeps the first design's ceil(N / 1,024) chunks
    of at most 1,024 rows, equal up to one strip each; in f32 and bf16 the
    weight pass launches at least two blocks per SM and its blocks that
    load rows reach the SM count, as do the strip pass's live blocks."""
    s, d = 256, 300
    adj, cnt = _tiles_batch(22)
    if t == 47:
        adj = torch.cat([adj, adj, adj[:3]])
        cnt = torch.cat([cnt, cnt, cnt[:3 * s]])
    n = t * s
    for dtype in (torch.float32, torch.bfloat16):
        plan = fused_gcn.k3b_plan(adj, cnt, d, dtype, sms)
        grids = plan["grids"]
        for name, width in (("gt", 1), ("strip", d)):
            rows, slices = grids[name]
            assert rows * 16 == n, name
            cw = fused_layer.COL_SLICE if name == "strip" else width
            assert (slices - 1) * cw < width <= slices * cw, name
        chunks, rows = plan["dw_chunks"], plan["dw_rows"]
        assert rows % 16 == 0 and rows <= fused_layer.DW_MAX_ROWS
        assert (chunks - 1) * rows < n <= chunks * rows
        if dtype == torch.float32:
            assert chunks == -(-n // fused_layer.BWD_CHUNK_ROWS)
            assert rows - (n - (chunks - 1) * rows) <= 16 * (chunks - 1)
        tr = plan["dw_tile_rows"]
        for name, (m, c) in (("dw", (d, d)),
                             ("detab", (fused_layer.CNT_PAD, d))):
            ch, tm, tc = grids["weights"][name]
            assert ch == chunks
            assert (tm - 1) * tr < m <= tm * tr, name
            assert (tc - 1) * fused_layer.DW_TILE < c <= \
                tc * fused_layer.DW_TILE, name
        tiles = sum(tm * tc for _, tm, tc in grids["weights"].values())
        assert chunks * tiles >= 2 * sms, dtype
        assert int(plan["live_chunks"].sum()) * tiles >= sms, dtype
        live = int((~plan["adj"]["dead_strips"]).sum())
        assert live * grids["strip"][1] >= sms


@pytest.mark.parametrize("n,d", [(1024, 300), (1536, 300), (5632, 300),
                                 (48, 20)])
def test_k5b_weight_pass_fills_the_card(n, d):
    """At the fine-tuning shape (T = 4 tiles of 256, D = 300) chunks x 64 x
    64 tiles reach 2 x 132 blocks; chunks are whole 16-row strips of at
    most 1,024 rows and cover the rows once."""
    chunks, rows = fused_gcn.dw_chunks(n, d)
    tiles = (-(-d // 64)) ** 2
    assert rows % 16 == 0 and rows <= 1024
    assert (chunks - 1) * rows < n <= chunks * rows
    if n >= 1024:
        assert chunks * tiles >= 2 * 132
    else:
        assert chunks == n // 16


@pytest.mark.parametrize("sms", [78, 114, 132])
def test_k5b_weight_pass_follows_the_sm_count(sms):
    """The wrapper plans the weight pass with the card's SM count: two
    blocks per SM at the fine-tuning shape, whole strips, rows covered
    once."""
    n, d = 1024, 300
    chunks, rows = fused_gcn.dw_chunks(n, d, sms)
    assert chunks * (-(-d // 64)) ** 2 >= 2 * sms
    assert rows % 16 == 0 and (chunks - 1) * rows < n <= chunks * rows


def _constexpr(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_width_limits_raise_value_errors_naming_them(monkeypatch):
    """check_fits, which every layer wrapper calls before its launches:
    buffers past the card's memory, or a weight pass's row of partials past
    the kernels' 32-bit index, raise a ValueError naming the call; what
    fits passes."""
    monkeypatch.setattr(fused_layer, "device_memory", lambda dev: 1 << 30)
    dev = torch.device("cpu")
    fused_layer.check_fits(dev, 1 << 30, "fits",
                           width=fused_layer.MAX_WIDTH)
    with pytest.raises(ValueError, match="K at D = 9 needs 1073741825 "
                                         "bytes of device memory"):
        fused_layer.check_fits(dev, (1 << 30) + 1, "K at D = 9")
    with pytest.raises(ValueError, match="K at D = 9: a weight-pass row"):
        fused_layer.check_fits(dev, 0, "K at D = 9",
                               width=fused_layer.MAX_WIDTH + 1)
    # the GINE backwards' row [dW1 | dW2 | detab] reaches the index near
    # D = 23,170 at D2 = 2 D
    width = lambda d: 2 * d * 2 * d + fused_layer.CNT_PAD * d  # noqa: E731
    assert width(23_160) <= fused_layer.MAX_WIDTH < width(23_180)


def test_layout_matches_the_kernel_sources():
    """fused_layer.LAYOUT and K1F_BLOCK_ROWS, with which the
    plan helpers and the wrappers work, are the constants in the kernels'
    sources (on the card, strip_rows also holds LAYOUT to each built
    library's fbl_layout)."""
    common = (CSRC / "fused_bn_common.cuh").read_text()
    names = re.search(r"const int v\[\] = \{([^}]*)\}", common).group(1)
    got = tuple(_constexpr(common, v.strip().removeprefix("fbl::"))
                for v in names.split(","))
    assert got == fused_layer.LAYOUT
    gine = (CSRC / "fused_gine_bn.cu").read_text()
    assert _constexpr(gine, "K1F_RB") == fused_layer.K1F_BLOCK_ROWS


def _bindings():
    """(source, entry point, pointers, ints) of every kernel_fn call of the
    wrappers in ops/."""
    pat = re.compile(r'kernel_fn\("(\w+)", f"(\w+)_\{suffix\}", (\d+), '
                     r'(\d+)\)')
    ops = CSRC.parent / "ops"
    return sorted({m.groups() for p in ops.glob("*.py")
                   for m in pat.finditer(p.read_text())})


@pytest.mark.parametrize("source,entry,n_ptr,n_int", _bindings(),
                         ids=[b[1] for b in _bindings()])
def test_bindings_match_the_entry_points(source, entry, n_ptr, n_int):
    """Each wrapper's ctypes signature (n_ptr pointers, n_int ints, then
    the stream) is the parameter list of its C entry point (the f32 and
    bf16 forms come from one macro)."""
    src = (CSRC / f"{source}.cu").read_text().replace("\\\n", " ")
    head = re.search(rf"int {entry}_##suffix\(([^)]*)\)", src)
    assert head, entry
    params = [p.strip() for p in head.group(1).split(",")]
    kinds = ["int" if re.fullmatch(r"int \w+", p) else
             "ptr" if "*" in p else p for p in params]
    assert kinds == (["ptr"] * int(n_ptr) + ["int"] * int(n_int)
                     + ["ptr"]), params
    assert params[-1] == "void* stream"
