"""The PyTorch port's GCN pretraining pieces against the JAX package, on
the CPU, at small sizes: the BN-chained GCN layer's VJP (K3f forward with
the plain K3b backward behind its autograd.Function) against jax.vjp of the
Pallas layer in interpreter mode, with and without the normalize_gcn
weights; the GCN MolCLRNet's forward and backward in both trunks (drop 0,
the BN chain; drop 0.3, the unchained trunk with JAX's dropout masks),
normalize_gcn off and on; and the pretrain CLI with GCN and mix
augmentation. (Three GCN train steps and one step each of subgraph, mix,
dropout and concat_views against the JAX Pretrainer are in
tests/test_torch_port_pretrain.py.)

Tolerances: the layer f32 max|port - jax| <= 1e-5 * max(1, max|jax|) (sums
in another order); bf16 3e-2 of max|jax|: the edge-table gradients of
e1 / e2 are the kernel's [CNT_PAD, D] cotangent cast to bf16 and summed
over the D columns, which JAX sums in bf16 and PyTorch with an f32
accumulator (8.8e-3 seen; one bf16 ulp is 2^-8 ~ 4e-3), every other
gradient agrees to f32 rounding. The whole model 1e-4 (f32, two layers,
a BatchNorm each); its bf16 forward and running stats within BF16_RTOL,
where one flipped rounding of a bf16 activation moves what follows by a
bf16 ulp. The normalize_gcn weights
(dis, the slot weights, the scaled adjacency, the weighted counts) are
bit-equal to JAX's in f32 and bf16."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molclr_tpu.data import featurize_smiles as jax_featurize_smiles
from molclr_tpu.data import pack_batch as jax_pack_batch
from molclr_tpu.data.featurize import NUM_BOND_DIRS, NUM_BOND_TYPES
from molclr_tpu.data.loader import spec_for_graphs as jax_spec_for_graphs
from molclr_tpu.data.synthetic import synthetic_corpus
from molclr_tpu.models import MolCLRNet as JaxMolCLRNet
from molclr_tpu.ops import fused_gcn as jax_fused_gcn
from molclr_tpu.ops import tile_dense as jax_tile_dense
from molclr_tpu.ops.fused_layer import pack_cnt as jax_pack_cnt
from molclr_tpu.ops.scatter_free import _counts as jax_counts
from molclr_tpu_torch.cli import pretrain as port_cli
from molclr_tpu_torch.data.featurize import featurize_smiles
from molclr_tpu_torch.data.graphs import pack_batch
from molclr_tpu_torch.data.loader import spec_for_graphs
from molclr_tpu_torch.models import MolCLRNet
from molclr_tpu_torch.models.layers import edge_counts
from molclr_tpu_torch.ops import fused_gcn, fused_layer, tile_dense
from molclr_tpu_torch.train.checkpoints import state_dict_from_jax, \
    transfer_state

RTOL = 1e-5
BF16_RTOL = 3e-2
MODEL_RTOL = 1e-4
PARAMS = ("x", "a", "b", "e1", "e2", "w", "bias")
ACT = {"x", "adj", "cnt", "w"}
SMALL = dict(num_layers=2, emb_dim=32, feat_dim=64, tile=32)


def assert_close(port, ref, rtol=RTOL):
    port = port.detach().float().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    lim = rtol * max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
    assert err <= lim, (err, lim)


# --------------------------------------------------------- the K3 layer


def _problem(seed, tiles=3, s=16, d=12, padded_rows=0, normalized=False):
    """Random block-diagonal symmetric adjacency with self-loops on real
    rows (the last `padded_rows` of every tile are padding), edge counts,
    the scalar edge tables, features, weights and random cotangents (g,
    dsums). `normalized` scales A by dis_i dis_j and the counts by
    per-node weights, as normalize_gcn hands them to the layer."""
    rng = np.random.RandomState(seed)
    n = tiles * s
    adj = np.zeros((tiles, s, s), np.float32)
    for k in range(tiles):
        a = (rng.rand(s, s) < 0.3).astype(np.float32)
        a = np.maximum(a, a.T)
        np.fill_diagonal(a, 1.0)
        if padded_rows:
            a[s - padded_rows:, :] = 0
            a[:, s - padded_rows:] = 0
        adj[k] = a
    real = np.diagonal(adj, axis1=1, axis2=2).reshape(-1) > 0
    cnt = np.zeros((n, fused_layer.CNT_PAD), np.float32)
    cnt[:, :8] = rng.randint(0, 3, (n, 8))
    cnt[~real] = 0
    if normalized:
        dis = 1.0 / np.sqrt(np.maximum(adj.sum(2), 1.0))
        adj = adj * dis[:, :, None] * dis[:, None, :]
        cnt = cnt * rng.rand(n, 1)
    x = dict(x=rng.randn(n, d), a=rng.rand(d) + 0.5, b=0.2 * rng.randn(d),
             adj=adj, cnt=cnt, e1=rng.randn(5, 1), e2=rng.randn(3, 1),
             w=rng.randn(d, d) / d ** 0.5, bias=0.1 * rng.randn(d))
    cot = dict(g=rng.randn(n, d), dsums=0.05 * rng.randn(2, d))
    return ({k: np.asarray(v, np.float32) for k, v in x.items()},
            {k: np.asarray(v, np.float32) for k, v in cot.items()}, real)


def _jax_vjp(x, cot, relu_in, dt):
    """(out, sums) of JAX's fused_gcn_bn_layer (interpret mode) and its
    gradients w.r.t. PARAMS, the edge tables through pack_gcn_etab."""
    jx = {k: jnp.asarray(v, dt if k in ACT else jnp.float32)
          for k, v in x.items()}
    d = x["x"].shape[1]

    def f(xx, a, b, e1, e2, w, bias):
        return jax_fused_gcn.fused_gcn_bn_layer(
            xx, a, b, jx["adj"], jx["cnt"],
            jax_fused_gcn.pack_gcn_etab(e1, e2, d, dt), w, bias, relu_in,
            True)

    outs, vjp = jax.vjp(f, *(jx[k] for k in PARAMS))
    grads = vjp((jnp.asarray(cot["g"], dt), jnp.asarray(cot["dsums"])))
    return outs, {k: np.asarray(v, np.float32) for k, v in zip(PARAMS, grads)}


def _port_grads(x, cot, relu_in, dt):
    tx = {k: torch.tensor(v).to(dt if k in ACT else torch.float32)
          for k, v in x.items()}
    for k in PARAMS:
        tx[k].requires_grad_(True)
    etab = fused_gcn.pack_gcn_etab(tx["e1"], tx["e2"], x["x"].shape[1], dt)
    out, sums = fused_gcn.fused_gcn_bn_layer(
        tx["x"], tx["a"], tx["b"], tx["adj"], tx["cnt"], etab, tx["w"],
        tx["bias"], relu_in)
    torch.autograd.backward([out, sums], [torch.tensor(cot["g"]).to(dt),
                                          torch.tensor(cot["dsums"])])
    return (out, sums), {k: tx[k].grad for k in PARAMS}


@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("padded_rows", [0, 5])
@pytest.mark.parametrize("normalized", [False, True])
def test_fused_gcn_bn_layer_vjp_matches_jax(relu_in, padded_rows,
                                            normalized):
    """The autograd.Function (plain K3f, plain K3b) against jax.vjp of the
    Pallas layer, random (g, dsums): dx, da, db, dW, dbias and the e1 / e2
    gradients through pack_gcn_etab, f32."""
    x, cot, _ = _problem(10 + padded_rows + 2 * relu_in, padded_rows=padded_rows,
                         normalized=normalized)
    (jout, jsums), jgrads = _jax_vjp(x, cot, relu_in, jnp.float32)
    (out, sums), grads = _port_grads(x, cot, relu_in, torch.float32)
    assert type(out.grad_fn).__name__ == "_GcnBNBackward"
    assert_close(out, jout)
    assert_close(sums, jsums)
    for k in PARAMS:
        assert grads[k].dtype == torch.float32, k
        assert_close(grads[k], jgrads[k]), k


@pytest.mark.parametrize("normalized", [False, True])
def test_fused_gcn_bn_layer_vjp_bf16_matches_jax(normalized):
    """bf16 activations: gtc, dxw, xc and dx round where the Pallas kernel
    rounds (dx and dW equal JAX's to f32 rounding), dW and detab come back
    in w's dtype, the vector gradients in f32; e1 / e2 within BF16_RTOL
    (see the module docstring)."""
    x, cot, _ = _problem(31, padded_rows=3, normalized=normalized)
    _, jgrads = _jax_vjp(x, cot, True, jnp.bfloat16)
    _, grads = _port_grads(x, cot, True, torch.bfloat16)
    for k in PARAMS:
        want = torch.bfloat16 if k in ACT else torch.float32
        assert grads[k].dtype == want, k
        assert_close(grads[k], jgrads[k],
                     rtol=BF16_RTOL if k in ("e1", "e2") else RTOL)


def test_gcn_bwd_wrapper_runs_the_plain_backward_on_cpu():
    """fused_gcn_bn_layer_bwd on CPU tensors is the plain backward and
    launches no kernel; its results are the autograd.Function's."""
    x, cot, _ = _problem(40, padded_rows=2)
    tx = {k: torch.tensor(v) for k, v in x.items()}
    etab = fused_gcn.pack_gcn_etab(tx["e1"], tx["e2"], x["x"].shape[1],
                                   torch.float32)
    out, _ = fused_gcn.fused_gcn_bn_layer_fwd(
        tx["x"], tx["a"], tx["b"], tx["adj"], tx["cnt"], etab, tx["w"],
        tx["bias"], True)
    before = fused_gcn.fused_gcn_bn_layer_bwd.launches
    args = (torch.tensor(cot["g"]), torch.tensor(cot["dsums"]), tx["x"],
            tx["a"], tx["b"], tx["adj"], tx["cnt"], out, tx["w"], True)
    got = fused_gcn.fused_gcn_bn_layer_bwd(*args)
    want = fused_gcn.fused_gcn_bn_layer_bwd_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fused_gcn.fused_gcn_bn_layer_bwd.launches == before
    _, grads = _port_grads(x, cot, True, torch.float32)
    for k, g in (("x", got[0]), ("a", got[1]), ("b", got[2]), ("w", got[3]),
                 ("bias", got[4])):
        assert torch.equal(grads[k], g), k
    with pytest.raises(ValueError, match="shapes"):
        fused_gcn.fused_gcn_bn_layer_bwd(*args[:2], tx["x"][:, :5].
                                         contiguous(), *args[3:])


# -------------------------------------------------------- the GCN model


@pytest.fixture(scope="module")
def batches():
    smiles = synthetic_corpus(24, seed=12)
    gj = [jax_featurize_smiles(s) for s in smiles]
    bj = jax_pack_batch(gj, jax_spec_for_graphs(gj, 24, tile=32,
                                                sizing="max"),
                        prefer_native=False)
    gp = [featurize_smiles(s) for s in smiles]
    bp = pack_batch(gp, spec_for_graphs(gp, 24, tile=32, sizing="max"))
    return bj, bp.to("cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gcn_normalization_bit_equal_to_jax(batches, dtype):
    """gcn_normalization's (dis, w), normalize_tile_adjacency and the
    weighted edge counts equal, bit for bit, the JAX trunk's
    (molclr_tpu/models/nets.py:110-122; GCNConv computes the same per
    layer, models/layers.py:290-308): deg cast to the activation dtype
    before rsqrt, dis[nbr] * dis rounded in it, w = mask * norm in it, and
    dis_i * dis_j rounded in it and then cast to adj's dtype."""
    bj, bp = batches
    jdt, tdt, tile = getattr(jnp, dtype), getattr(torch, dtype), SMALL["tile"]
    deg = bj.nbr_mask.sum(axis=1).astype(jdt)
    jdis = jax.lax.rsqrt(jnp.maximum(deg, 1.0))
    norm = jnp.take(jdis, bj.nbr, axis=0) * jdis[:, None]
    jw = bj.nbr_mask.astype(jdt) * norm.astype(jdt)
    jadj = jax_tile_dense.build_tile_adjacency(bj.nbr, bj.nbr_mask, tile, jdt)
    dis_b = jdis.reshape(-1, tile)
    jadj = jadj * (dis_b[:, :, None] * dis_b[:, None, :]).astype(jadj.dtype)
    jcnt = jax_pack_cnt(jax_counts(bj.nbr_bond_type, jw, NUM_BOND_TYPES),
                        jax_counts(bj.nbr_bond_dir, jw, NUM_BOND_DIRS))

    dis, w = tile_dense.gcn_normalization(bp.nbr, bp.nbr_mask, tdt)
    adj = tile_dense.normalize_tile_adjacency(
        tile_dense.build_tile_adjacency(bp.nbr, bp.nbr_mask, tile, dtype=tdt),
        dis)
    cnt = edge_counts(bp, w)
    # (rounding shows: several degrees give dis_i * dis_j off the bf16 grid)
    assert len(np.unique(np.asarray(jadj, np.float32))) > 4
    for name, got, want in (("dis", dis, jdis), ("w", w, jw),
                            ("adj", adj, jadj), ("cnt", cnt, jcnt)):
        want = np.asarray(want.astype(jnp.float32))
        assert got.dtype == tdt, name
        assert got.shape == want.shape, name
        assert np.array_equal(got.float().numpy(), want), name


def _model_vs_jax(batches, normalize, drop, dtype, rtol, grads=True):
    """A train-mode forward of the GCN MolCLRNet in activation dtype
    `dtype`, the running stats and, with `grads`, the gradients of
    sum(r_h * h) + sum(r_z * z) w.r.t. every parameter, against the JAX
    model with the same weights and, at drop > 0, JAX's dropout masks;
    max|port - jax| <= rtol * max(1, max|jax|)."""
    bj, bp = batches
    model = JaxMolCLRNet(gnn_type="gcn", fused=True, normalize_gcn=normalize,
                         drop_ratio=drop, dtype=getattr(jnp, dtype), **SMALL)
    v = model.init(jax.random.PRNGKey(4), bj, train=False)
    rngs = {"dropout": jax.random.PRNGKey(11)}
    rng = np.random.RandomState(5)
    g = bp.num_graphs
    r_h = rng.randn(g, SMALL["feat_dim"]).astype(np.float32)
    r_z = rng.randn(g, SMALL["feat_dim"] // 2).astype(np.float32)

    def loss(params):
        (h, z), upd = model.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, bj,
            train=True, rngs=rngs, mutable=["batch_stats", "intermediates"],
            capture_intermediates=True)
        return ((h.astype(jnp.float32) * r_h).sum()
                + (z.astype(jnp.float32) * r_z).sum()), (h, z, upd)

    (_, (hj, zj, upd)), jgrads = jax.value_and_grad(loss, has_aux=True)(
        v["params"])
    masks = None
    if drop:
        # flax's Dropout outputs are non-zero exactly where kept (and where
        # an input is 0 the mask changes nothing)
        trunk = upd["intermediates"]["trunk"]
        masks = [torch.from_numpy(np.asarray(
            trunk[f"Dropout_{i}"]["__call__"][0]) != 0)
            for i in range(SMALL["num_layers"])]
    port = MolCLRNet(gnn_type="gcn", normalize_gcn=normalize,
                     drop_ratio=drop, dtype=getattr(torch, dtype), **SMALL)
    assert transfer_state(state_dict_from_jax(v["params"], v["batch_stats"]),
                          port)["skipped"] == []
    launches = fused_gcn.fused_gcn_bn_layer_bwd.launches
    h, z = port.train()(bp, dropout_masks=masks)
    ((h.float() * torch.from_numpy(r_h)).sum()
     + (z.float() * torch.from_numpy(r_z)).sum()).backward()
    assert fused_gcn.fused_gcn_bn_layer_bwd.launches == launches
    assert h.dtype == z.dtype == getattr(torch, dtype)
    assert_close(h, np.asarray(hj.astype(jnp.float32)), rtol)
    assert_close(z, np.asarray(zj.astype(jnp.float32)), rtol)
    got = {k: p.grad for k, p in port.named_parameters()}
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(got) == set(want)
    for k, gk in got.items():
        assert gk.dtype == torch.float32, k
        if grads:
            assert_close(gk, want[k].numpy(), rtol), k
    for i in range(SMALL["num_layers"]):
        stats = upd["batch_stats"]["trunk"][f"bn_{i}"]
        assert_close(port.batch_norms[i].running_mean, stats["mean"], rtol)
        assert_close(port.batch_norms[i].running_var, stats["var"], rtol)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_gcn_model_forward_and_backward_match_jax(batches, normalize, drop):
    """The GCN MolCLRNet in f32, both trunks (the BN chain at drop 0; the
    unchained trunk at 0.3), normalize_gcn off and on: forward, gradients
    and running stats against the JAX model within MODEL_RTOL."""
    _model_vs_jax(batches, normalize, drop, "float32", MODEL_RTOL)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_gcn_model_bf16_matches_jax(batches, normalize, drop):
    """As above with bf16 activations (the JAX model's dtype bfloat16), so
    normalize_gcn's weights are rounded in bf16 on both sides: the forward
    and running stats within BF16_RTOL. The gradients are not compared:
    XLA on the CPU reduces a bf16 broadcast's cotangent (the last
    BatchNorm's affine, the dense biases, the edge tables) in bf16 partials
    where PyTorch accumulates in f32, and the BatchNorm backward amplifies
    that rounding (ROADMAP.md queue 3)."""
    _model_vs_jax(batches, normalize, drop, "bfloat16", BF16_RTOL,
                  grads=False)


# ----------------------------------------------------------------- CLI


def test_cli_pretrain_gcn_mix_cpu_runs_and_resumes(tmp_path):
    """`--model gcn --aug mix --cpu`: two epochs in two runs (a stop after
    the first, then --resume latest), with finite losses and the step
    count continuing; the bucket is packed with hydrogens (mix)."""
    yaml_path = tmp_path / "small.yaml"
    yaml_path.write_text("batch_size: 16\nepochs: 2\nwarm_up: 1\nmodel:\n"
                         "  num_layer: 2\n  emb_dim: 16\n  feat_dim: 32\n"
                         "  tile: 64\n")
    base = ["--config", str(yaml_path), "--synthetic", "50", "--data",
            str(tmp_path / "c.txt"), "--ckpt-dir", str(tmp_path / "ck"),
            "--model", "gcn", "--aug", "mix", "--cpu"]
    assert port_cli.main(base + ["--stop-after-epoch", "1"]) == 0
    assert port_cli.main(base + ["--resume", "latest"]) == 0
    recs = [json.loads(line) for line in
            (tmp_path / "ck" / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in recs] == [0, 1]
    assert recs[1]["step"] == 2 * recs[0]["step"]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["valid_loss"])
               for r in recs)
    cfg = json.loads((tmp_path / "ck" / "config.json").read_text())
    assert cfg["aug"] == "mix" and cfg["model"]["gnn_type"] == "gcn"
