"""What the redesigned K1f and K5b skip, held to the plain versions and JAX.

The row-block kernels skip work that the data they load shows to be dead:
the all-zero 32-column chunks of an adjacency strip (with the features of
their nodes), 32-row blocks whose adjacency and count rows are all zero
(K1f writes one constant row there), and K5b's weight-pass row chunks and
strips whose dxw rows are zero. `fused_layer.kernel_plan` and
`fused_gcn.k5b_plan` state those decisions. Here, on packed batches of
`synthetic_corpus` at tile 64 and 256, in f32 and bf16:

  * the plain version run on inputs where every skipped operand is replaced
    by other finite values, with the dead blocks' constant row written in,
    equals the plain version on the real inputs bit for bit (so the skipped
    work cannot change a result);
  * that restricted result agrees with JAX's Pallas kernel in interpreter
    mode (`_bn_run_fwd`, `_fused_bwd`) within the tolerances of
    tests/test_torch_port_ops.py and tests/test_torch_port_finetune_ops.py:
    1e-5 (f32) and 3e-2 (bf16, one bf16 rounding of an intermediate) of
    max(1, max|jax|);
  * K5b's weight pass has enough blocks for two per SM of an H100 (132)
    at the fine-tuning shape.
"""

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


def test_layout_matches_the_kernel_sources():
    """fused_layer.LAYOUT and K1F_BLOCK_ROWS, with which the plan helpers
    and the wrappers work, are the constants in the kernels' sources (on
    the card, strip_rows also holds LAYOUT to each built library's
    fbl_layout)."""
    common = (CSRC / "fused_bn_common.cuh").read_text()
    names = re.search(r"const int v\[\] = \{([^}]*)\}", common).group(1)
    got = tuple(_constexpr(common, v.strip().removeprefix("fbl::"))
                for v in names.split(","))
    assert got == fused_layer.LAYOUT
    gine = (CSRC / "fused_gine_bn.cu").read_text()
    assert _constexpr(gine, "K1F_RB") == fused_layer.K1F_BLOCK_ROWS
