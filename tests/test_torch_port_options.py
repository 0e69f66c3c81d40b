"""The PyTorch port's model options against the JAX package, on the CPU:
the segment reductions and `graph_pool(method="max")`, the ELL and COO
aggregations, `gine_aggregate` / `gcn_aggregate` with their custom VJPs,
the ELL trunk (tile 0) in MolCLRNet and FineTuneNet, LinkFineTuneNet, the
Pretrainer and the FineTuner at tile 0 and with pool max, `cli.embed --tile
0`, and the TensorBoard scalars.

Inputs come from numpy seeds and go through both packages; the models at
small sizes (2-3 layers, emb 16-32, tile 0 and 32), weights carried across
by state_dict_from_jax. Tolerances:
  * ops in f32: max |port - jax| <= 1e-6 * max(1, max |jax|) (sums in
    another order); the max and its tie split exactly;
  * ops in bf16: 1e-2 of the largest value (one bf16 ulp is 2^-8 = 3.9e-3;
    JAX may round a sum of slots once where the port rounds each add);
  * models: 1e-5 * max(1, max |jax|) forward, gradients 1e-4 of the
    largest (five products and a BatchNorm per layer in another order);
    the port's tile 0 against its tile-dense trunk: 1e-5;
  * trainer steps: the limits of tests/test_torch_port_pretrain.py and
    tests/test_torch_port_finetune.py;
  * the embed CLI against JAX's: 1e-5 * max(1, max |jax|).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molclr_tpu.data import featurize_smiles as jax_featurize_smiles
from molclr_tpu.data import pack_batch as jax_pack_batch
from molclr_tpu.data.loader import spec_for_graphs as jax_spec_for_graphs
from molclr_tpu.data.synthetic import synthetic_corpus
from molclr_tpu.models import FineTuneNet as JaxFineTuneNet
from molclr_tpu.models import LinkFineTuneNet as JaxLinkFineTuneNet
from molclr_tpu.models import MolCLRNet as JaxMolCLRNet
from molclr_tpu.ops import ell as jax_ell
from molclr_tpu.ops import scatter_free as jax_sf
from molclr_tpu.ops import segment as jax_seg
from molclr_tpu_torch.data.graphs import GraphBatch
from molclr_tpu_torch.models import FineTuneNet, LinkFineTuneNet, MolCLRNet
from molclr_tpu_torch.ops import ell, scatter_free, segment
from molclr_tpu_torch.train.checkpoints import state_dict_from_jax, \
    transfer_state

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
OP_RTOL = {"float32": 1e-6, "bfloat16": 1e-2}


def assert_close(port, ref, rtol):
    port = np.asarray((port.detach().float().numpy()
                       if torch.is_tensor(port) else port), np.float64)
    ref = np.asarray(np.asarray(ref, np.float32), np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = float(np.abs(port - ref).max()) if port.size else 0.0
    lim = rtol * max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
    assert err <= lim, (err, lim)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    return t.to(getattr(torch, dtype)) if dtype else t


def _port_batch(bj) -> GraphBatch:
    return GraphBatch(**{f.name: np.asarray(getattr(bj, f.name))
                         for f in dataclasses.fields(GraphBatch)}).to("cpu")


def _jax_batch(smiles, tile, n_graphs=None):
    graphs = [jax_featurize_smiles(s) for s in smiles]
    spec = jax_spec_for_graphs(graphs, n_graphs or len(graphs), tile=tile,
                               sizing="max")
    return jax_pack_batch(graphs, spec, prefer_native=False)


# ------------------------------------------------------------ segment ops


def _segment_problem(dtype, d=6):
    """Rows in 5 segments, segment 3 empty, segment 4 holding only masked
    rows, a dropped id (5); ties planted in segment 1 (two rows equal to
    its max) and segment 2 (three)."""
    rng = np.random.RandomState(7)
    n = 24
    ids = np.array([0] * 5 + [1] * 6 + [2] * 7 + [4] * 3 + [5] + [0] * 2)
    x = rng.randn(n, d).astype(np.float32)
    x = np.array(jnp.asarray(x, JDT[dtype]).astype(jnp.float32))
    x[[5, 8]] = x[5:11].max(axis=0) + 1.0
    x[[11, 14, 17]] = x[11:18].max(axis=0) + 0.5
    mask = np.ones(n, bool)
    mask[18:21] = False
    mask[1] = False
    g = rng.randn(5, d).astype(np.float32)
    return x, ids, mask, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_max_and_its_tie_split_match_jax(dtype):
    """segment_max forward and VJP: exact in both dtypes. Tied rows split
    the cotangent equally (g / 2, g / 3), masked rows, empty segments and
    dropped ids get 0, as JAX's gradient gives them."""
    x, ids, mask, g = _segment_problem(dtype)
    jdt = JDT[dtype]

    def jf(v):
        return jax_seg.segment_max(v, jnp.asarray(ids), 5, jnp.asarray(mask))

    want, vjp = jax.vjp(jf, jnp.asarray(x, jdt))
    (jgrad,) = vjp(jnp.asarray(g, jdt))
    xt = _t(x, dtype).requires_grad_()
    got = segment.segment_max(xt, _t(ids), 5, _t(mask))
    got.backward(_t(g, dtype))
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(jgrad, np.float32))
    gx = xt.grad.float().numpy()
    gf = np.asarray(jnp.asarray(g, jdt).astype(jnp.float32))
    half = np.asarray(jnp.asarray(gf[1] * np.float32(0.5), jdt)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(gx[5], half)
    np.testing.assert_array_equal(gx[8], half)
    assert not gx[[1, 18, 19, 20, 21]].any()     # masked and dropped rows
    assert not got[3].any() and not got[4].any()  # empty, all masked


def test_segment_sum_mean_softmax_match_jax():
    """segment_sum (with a mask), segment_mean (counts from the mask and
    given), segment_softmax ([N] and [N, H] logits, masked), forward and
    VJP in f32."""
    x, ids, mask, _ = _segment_problem("float32")
    ids_in = np.where(ids == 5, 4, ids)          # softmax: ids in range
    rng = np.random.RandomState(3)
    counts = np.array([3, 6, 7, 0, 2], np.int32)
    cases = [
        ("sum", lambda m, v, i: m.segment_sum(v, i, 5, mask=M(m)), ids),
        ("mean", lambda m, v, i: m.segment_mean(v, i, 5, mask=M(m)), ids),
        ("mean_counts", lambda m, v, i: m.segment_mean(
            v, i, 5, counts=C(m)), ids),
        ("softmax", lambda m, v, i: m.segment_softmax(v, i, 5, mask=M(m)),
         ids_in),
        ("softmax_1d", lambda m, v, i: m.segment_softmax(
            v[:, 0], i, 5, mask=M(m)), ids_in),
    ]

    def M(m):
        return jnp.asarray(mask) if m is jax_seg else _t(mask)

    def C(m):
        return jnp.asarray(counts) if m is jax_seg else _t(counts)

    for name, fn, seg_ids in cases:
        want, vjp = jax.vjp(lambda v: fn(jax_seg, v, jnp.asarray(seg_ids)),
                            jnp.asarray(x))
        g = rng.randn(*want.shape).astype(np.float32)
        (jgrad,) = vjp(jnp.asarray(g))
        xt = _t(x).requires_grad_()
        got = fn(segment, xt, _t(seg_ids))
        got.backward(_t(g))
        assert_close(got, want, 1e-6)
        assert_close(xt.grad, jgrad, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_pool_max_matches_jax(dtype):
    """graph_pool(method='max') on a packed batch (a padded graph, padded
    nodes), forward and VJP, against JAX's: exact."""
    bj = _jax_batch(synthetic_corpus(9, seed=4), 32, n_graphs=11)
    bp = _port_batch(bj)
    rng = np.random.RandomState(5)
    h = np.asarray(jnp.asarray(rng.randn(bp.num_nodes, 8), JDT[dtype]))
    g = np.asarray(jnp.asarray(rng.randn(bp.num_graphs, 8), JDT[dtype]))

    def jf(v):
        return jax_seg.graph_pool(v, bj.node_graph, bj.node_mask,
                                  bj.num_graphs, bj.graph_n_nodes, "max")

    want, vjp = jax.vjp(jf, jnp.asarray(h))
    (jgrad,) = vjp(jnp.asarray(g))
    ht = _t(h.astype(np.float32), dtype).requires_grad_()
    got = segment.graph_pool(ht, bp.node_graph, bp.node_mask, bp.num_graphs,
                             bp.graph_n_nodes, "max")
    got.backward(_t(g.astype(np.float32), dtype))
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(ht.grad.float().numpy(),
                                  np.asarray(jgrad, np.float32))
    assert not got[-2:].any()                     # the padded graphs
    with pytest.raises(ValueError, match="unknown pool"):
        segment.graph_pool(ht, bp.node_graph, bp.node_mask, 2, None, "min")


# ------------------------------------------------------ ELL aggregations


def _ell_inputs(dtype, d=12, seed=2):
    bj = _jax_batch(["CC(=O)Oc1ccccc1C(=O)O", "CCO", "C",
                     "CN1CCC[C@H]1c1cccnc1", "C" * 40], 0, n_graphs=6)
    rng = np.random.RandomState(seed)
    n = bj.num_nodes
    h = (rng.randn(n, d) * np.asarray(bj.node_mask)[:, None]).astype(
        np.float32)
    h = np.array(jnp.asarray(h, JDT[dtype]).astype(jnp.float32))
    g = np.array(jnp.asarray(rng.randn(n, d), JDT[dtype])
                   .astype(jnp.float32))
    return bj, h, g, rng


def test_ell_and_coo_aggregate_match_jax_and_each_other():
    """ell_aggregate (with and without per-slot edge embeddings) and
    coo_aggregate (with the self-loop embedding) against JAX's and against
    each other."""
    bj, h, _, rng = _ell_inputs("float32")
    bp = _port_batch(bj)
    n, k = np.asarray(bj.nbr).shape
    d = h.shape[1]
    e_ell = rng.randn(n, k, d).astype(np.float32)
    loop = rng.randn(d).astype(np.float32)
    e_coo = rng.randn(bp.src.shape[0], d).astype(np.float32)
    for emb in (None, e_ell):
        want = jax_ell.ell_aggregate(jnp.asarray(h), bj.nbr, bj.nbr_mask,
                                     None if emb is None
                                     else jnp.asarray(emb))
        got = ell.ell_aggregate(_t(h), bp.nbr, bp.nbr_mask,
                                None if emb is None else _t(emb))
        assert_close(got, want, 1e-6)
    args = (bj.src, bj.dst, bj.edge_mask, n)
    want = jax_ell.coo_aggregate(jnp.asarray(h), *args, jnp.asarray(e_coo),
                                 jnp.asarray(loop), bj.node_mask)
    got = ell.coo_aggregate(_t(h), bp.src, bp.dst, bp.edge_mask, n,
                            _t(e_coo), _t(loop), bp.node_mask)
    assert_close(got, want, 1e-6)
    # the two views of one batch: the COO edges with the self-loop term
    # equal the ELL slots (slot 0 the self-loop)
    plain = ell.coo_aggregate(_t(h), bp.src, bp.dst, bp.edge_mask, n,
                              node_mask=bp.node_mask)
    assert_close(plain, ell.ell_aggregate(_t(h), bp.nbr, bp.nbr_mask), 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gine_aggregate_matches_jax(dtype):
    """gine_aggregate forward and VJP (dh, d t_type, d t_dir) against the
    JAX custom VJP, tables in h's dtype as the layer hands them."""
    bj, h, g, rng = _ell_inputs(dtype)
    bp = _port_batch(bj)
    d, jdt = h.shape[1], JDT[dtype]
    tt = rng.randn(5, d).astype(np.float32)
    td = rng.randn(3, d).astype(np.float32)

    def jf(h_, a, b):
        return jax_sf.gine_aggregate(h_, a, b, bj.nbr, bj.nbr_bond_type,
                                     bj.nbr_bond_dir, bj.nbr_mask)

    prim = [jnp.asarray(v, jdt) for v in (h, tt, td)]
    want, vjp = jax.vjp(jf, *prim)
    jgrads = vjp(jnp.asarray(g, jdt))
    args = [_t(v, dtype).requires_grad_() for v in (h, tt, td)]
    got = scatter_free.gine_aggregate(*args, bp.nbr, bp.nbr_bond_type,
                                      bp.nbr_bond_dir, bp.nbr_mask)
    got.backward(_t(g, dtype))
    assert got.dtype == args[0].dtype
    assert_close(got, want, OP_RTOL[dtype])
    for a, jg in zip(args, jgrads):
        assert a.grad.dtype == a.dtype
        assert_close(a.grad, jg, OP_RTOL[dtype])


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gcn_aggregate_matches_jax(dtype, normalize):
    """gcn_aggregate forward and VJP (dx and the scalar tables) against the
    JAX custom VJP, norm None and the symmetric normalization."""
    bj, h, g, rng = _ell_inputs(dtype, seed=3)
    bp = _port_batch(bj)
    jdt = JDT[dtype]
    tt = rng.randn(5, 1).astype(np.float32)
    td = rng.randn(3, 1).astype(np.float32)
    jnorm = pnorm = None
    if normalize:
        deg = bj.nbr_mask.sum(axis=1).astype(jdt)
        dis = jax.lax.rsqrt(jnp.maximum(deg, 1.0))
        jnorm = jnp.take(dis, bj.nbr, axis=0) * dis[:, None]
        pnorm = _t(np.asarray(jnorm.astype(jnp.float32)), dtype)

    def jf(x, a, b):
        return jax_sf.gcn_aggregate(x, a, b, bj.nbr, bj.nbr_bond_type,
                                    bj.nbr_bond_dir, bj.nbr_mask, jnorm)

    prim = [jnp.asarray(v, jdt) for v in (h, tt, td)]
    want, vjp = jax.vjp(jf, *prim)
    jgrads = vjp(jnp.asarray(g, jdt))
    args = [_t(v, dtype).requires_grad_() for v in (h, tt, td)]
    got = scatter_free.gcn_aggregate(*args, bp.nbr, bp.nbr_bond_type,
                                     bp.nbr_bond_dir, bp.nbr_mask, pnorm)
    got.backward(_t(g, dtype))
    assert_close(got, want, OP_RTOL[dtype])
    for a, jg in zip(args, jgrads):
        assert_close(a.grad, jg, OP_RTOL[dtype])


# ---------------------------------------------------------------- models


MODEL = dict(num_layers=3, emb_dim=32, feat_dim=64)
MODEL_SMILES = synthetic_corpus(14, seed=11) + ["C" * 40]


def _grads_close(model, jgrads, rtol=1e-4):
    """Each parameter's gradient within rtol of its own largest JAX
    gradient, plus rtol of the model's largest (the exact-zero gradients
    of the conv biases ahead of a BatchNorm carry f32 noise)."""
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    top = max(float(np.abs(v.numpy()).max()) for v in want.values())
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for k, v in want.items():
        err = float((got[k].grad - v).abs().max())
        lim = rtol * (float(v.abs().max()) + top)
        assert err <= lim, (k, err, lim)


@pytest.mark.parametrize("gnn,normalize,pool", [
    ("gin", False, "mean"), ("gin", False, "max"), ("gcn", False, "mean"),
    ("gcn", True, "max")])
def test_molclr_net_tile0_matches_jax_and_the_tile_trunk(gnn, normalize, pool):
    """MolCLRNet on the ELL trunk (tile 0, a 40-atom chain in the batch) in
    train mode: h, z, the BatchNorm running stats and every parameter's
    gradient of sum(z * r) against the JAX model's (fused=False, its path
    at tile 0); the port's tile-64 trunk (the fused kernels' plain
    versions) on a tile-64 packing of the same molecules gives the same h
    and z."""
    bj = _jax_batch(MODEL_SMILES, 0, n_graphs=16)
    bp = _port_batch(bj)
    kw = dict(MODEL, gnn_type=gnn, pool=pool, normalize_gcn=normalize)
    jnet = JaxMolCLRNet(tile=0, **kw)
    variables = jnet.init(jax.random.PRNGKey(3), bj, train=False)
    r = np.random.RandomState(1).randn(bp.num_graphs, 32).astype(np.float32)

    def jloss(params):
        (h, z), upd = jnet.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, bj,
            train=True, mutable=["batch_stats"])
        return (z * r).sum(), (h, z, upd)

    (_, (jh, jz, upd)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])
    ported = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))
    net = MolCLRNet(tile=0, **kw)
    assert transfer_state(ported, net)["skipped"] == []
    h, z = net(bp)
    (z * _t(r)).sum().backward()
    assert_close(h, jh, 1e-5)
    assert_close(z, jz, 1e-5)
    _grads_close(net, jgrads)
    stats = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, upd["batch_stats"]))
    for k, v in net.state_dict().items():
        if "running_" in k:
            assert_close(v, stats[k].numpy(), 1e-5)
    tiled = MolCLRNet(tile=64, **kw)
    transfer_state(ported, tiled)
    bt = _port_batch(_jax_batch(MODEL_SMILES, 64, n_graphs=16))
    ht, zt = tiled(bt)
    assert_close(ht, h.detach().numpy(), 1e-5)
    assert_close(zt, z.detach().numpy(), 1e-5)


@pytest.mark.parametrize("gnn,pool", [("gin", "max"), ("gcn", "mean")])
def test_finetune_net_tile0_eval_matches_jax(gnn, pool):
    """FineTuneNet at tile 0, drop 0.3, eval mode (the running stats moved
    by one train pass) against the JAX model."""
    bj = _jax_batch(MODEL_SMILES, 0, n_graphs=16)
    bp = _port_batch(bj)
    kw = dict(MODEL, gnn_type=gnn, pool=pool, drop_ratio=0.3,
              task="classification")
    jnet = JaxFineTuneNet(tile=0, **kw)
    variables = jnet.init(jax.random.PRNGKey(4), bj, train=False)
    _, upd = jnet.apply(variables, bj, train=True, mutable=["batch_stats"],
                        rngs={"dropout": jax.random.PRNGKey(6)})
    variables = {"params": variables["params"], **upd}
    jh, jpred = jnet.apply(variables, bj, train=False)
    net = FineTuneNet(tile=0, **kw)
    assert transfer_state(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, variables["batch_stats"])),
        net)["skipped"] == []
    net.eval()
    with torch.no_grad():
        h, pred = net(bp)
    assert_close(h, jh, 1e-5)
    assert_close(pred, jpred, 1e-5)


@pytest.mark.parametrize("tile", [0, 32])
def test_link_finetune_net_matches_jax(tile):
    """LinkFineTuneNet in train mode (drop 0): h, the [G, 2] scores and
    every parameter's gradient of sum(pred * r) against the JAX model's
    (unfused), at tile 0 (ELL) and tile 32 (the port's fused trunk); one
    shared head, a nonzero label_embedding gradient, and every state-dict
    entry carried by state_dict_from_jax."""
    smiles = MODEL_SMILES[:-1] if tile else MODEL_SMILES
    bj = _jax_batch(smiles, tile, n_graphs=16)
    bp = _port_batch(bj)
    kw = dict(num_layers=2, emb_dim=16, feat_dim=32)
    jnet = JaxLinkFineTuneNet(tile=tile, **kw)
    variables = jnet.init(jax.random.PRNGKey(8), bj, train=False)
    r = np.random.RandomState(2).randn(bp.num_graphs, 2).astype(np.float32)

    def jloss(params):
        (h, p), _ = jnet.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, bj,
            train=True, mutable=["batch_stats"])
        return (p * r).sum(), (h, p)

    (_, (jh, jp)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])
    net = LinkFineTuneNet(tile=tile, generator=torch.Generator()
                          .manual_seed(0), **kw)
    got = transfer_state(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, variables["batch_stats"])), net)
    assert got["skipped"] == [] and got["copied"] == len(
        [k for k in net.state_dict() if "num_batches" not in k])
    np.testing.assert_array_equal(
        net.label_embedding.detach().numpy(),
        np.asarray(variables["params"]["label_embedding"]))
    heads = [k for k in net.state_dict() if k.startswith("pred_head")]
    assert heads == ["pred_head.0.weight", "pred_head.0.bias",
                     "pred_head.2.weight", "pred_head.2.bias",
                     "pred_head.4.weight", "pred_head.4.bias"]
    assert net.pred_head[0].in_features == 2 * kw["feat_dim"]
    assert net.pred_head[4].out_features == 1
    h, pred = net(bp)
    (pred * _t(r)).sum().backward()
    assert pred.shape == (bp.num_graphs, 2)
    assert_close(h, jh, 1e-5)
    assert_close(pred, jp, 1e-5)
    assert float(net.label_embedding.grad.abs().sum()) > 0
    _grads_close(net, jgrads)


# --------------------------------------------------------------- trainers


def _pretrain_steps_against_jax(tmp_path, steps, tile, pool):
    """`steps` steps of the port's train_step (GIN, node augmentation)
    against the JAX Pretrainer's jitted _train_step from the same weights,
    both given JAX's views, with the limits of
    tests/test_torch_port_pretrain.py."""
    from molclr_tpu.data.augment import paired_augment as jax_paired_augment
    from molclr_tpu.train.config import ModelConfig as JaxModelConfig
    from molclr_tpu.train.config import PretrainConfig as JaxPretrainConfig
    from molclr_tpu.train.pretrain import Pretrainer as JaxPretrainer
    from molclr_tpu_torch.train import optim
    from molclr_tpu_torch.train.config import ModelConfig, PretrainConfig
    from molclr_tpu_torch.train.pretrain import build_model, train_step
    from test_torch_port_pretrain import _adam_moments, _compare_states, \
        _port_views

    model_kw = dict(num_layers=3, emb_dim=32, feat_dim=64, tile=tile,
                    pool=pool)
    smiles = synthetic_corpus(42, seed=23) + ["C" * 40] * (0 if tile
                                                          else 2)
    cfg_j = JaxPretrainConfig(
        batch_size=20, epochs=3, warm_up=0, init_lr=5e-4, weight_decay=1e-5,
        aug="node", valid_size=0.05, seed=0, featurize_processes=0,
        steps_per_dispatch=1, device_cache_mb=0,
        ckpt_dir=str(tmp_path / "jax"),
        model=JaxModelConfig(**model_kw))
    pre = JaxPretrainer(cfg_j).setup_data(smiles)
    batches = [b for b, _, _ in pre.train_iter]
    assert len(batches) == 2
    pre.setup_state(batches[0])
    pre._build_steps()
    state = pre.state
    bw = pre.spec.max_graph_bonds
    cfg_p = PretrainConfig(batch_size=20, epochs=3, warm_up=0,
                           init_lr=5e-4, weight_decay=1e-5,
                           model=ModelConfig(**model_kw))
    model = build_model(cfg_p)
    got = transfer_state(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params),
        jax.tree_util.tree_map(np.asarray, state.batch_stats)), model)
    assert got["skipped"] == []
    opt = optim.adam_torch(model.parameters(), cfg_p.weight_decay)
    schedule = optim.warmup_then_cosine(cfg_p.init_lr, 2, 3, 0)
    grads0 = None
    for step in range(steps):
        bj = batches[step % 2]
        rng = jax.random.fold_in(jax.random.PRNGKey(9), step)
        vj = jax_paired_augment(bj, rng, "node", tile=tile, bond_window=bw,
                                max_waves=pre._max_waves)
        p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
        state, jloss = pre._train_step(state, bj, rng, vj)
        bp = _port_batch(bj)
        loss = train_step(model, opt, bp, cfg_p, step, schedule(step),
                          views=_port_views(bp, vj), bond_window=bw)
        np.testing.assert_allclose(
            float(loss), float(jloss), rtol=1e-5 if step == 0 else 1e-3,
            atol=0.0 if step == 0 else 2e-5, err_msg=f"loss at step {step}")
        if step == 0:
            mu, _ = _adam_moments(state.opt_state)
            grads0 = {k: p.grad.numpy().copy()
                      for k, p in model.named_parameters()}
            for k in grads0:
                jg = mu[k].numpy() / 0.1 - cfg_p.weight_decay * p0[k].numpy()
                np.testing.assert_allclose(grads0[k], jg, rtol=2e-4,
                                           atol=1e-5, err_msg=k)
        _compare_states(state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, state.params),
            jax.tree_util.tree_map(np.asarray, state.batch_stats)),
            model, grads0, steps=step + 1, lr=cfg_p.init_lr,
            tight=step == 0)


@pytest.mark.parametrize("steps,tile,pool", [(3, 0, "mean"),
                                             (1, 32, "max")])
def test_pretrain_steps_match_jax(tmp_path, steps, tile, pool):
    """Three GIN steps on the ELL trunk (tile 0, 40-atom chains in the
    corpus) and one with pool max on the tile trunk (K1's plain versions)
    against the JAX Pretrainer (its unfused model, which its own tests
    hold to the fused one)."""
    _pretrain_steps_against_jax(tmp_path, steps, tile, pool)


@pytest.mark.parametrize("gnn,pool", [("gin", "max"), ("gcn", "mean")])
def test_finetune_steps_tile0_match_jax(tmp_path, gnn, pool):
    """Three FineTuner steps on the ELL trunk (dropout 0.3 with JAX's
    masks) against the JAX FineTuner's jitted _train_step, with the limits
    of tests/test_torch_port_finetune.py; then the validation metric of
    the same state through the port's FineTuner at tile 0."""
    from molclr_tpu.train import finetune as jax_finetune
    from molclr_tpu.train.config import FineTuneConfig as JaxFineTuneConfig
    from molclr_tpu.train.config import ModelConfig as JaxModelConfig
    from molclr_tpu_torch.train.config import FineTuneConfig, ModelConfig
    from molclr_tpu_torch.train.finetune import FineTuner, train_step
    from molclr_tpu_torch.train.optim import two_group_adam
    from test_torch_port_finetune import _compare, _dropout_masks, \
        _jax_state

    small = dict(num_layers=2, emb_dim=16, feat_dim=32, tile=0,
                 gnn_type=gnn, pool=pool, drop_ratio=0.3)
    jcfg = JaxFineTuneConfig(
        task_name="BBBP", data_root=str(tmp_path), synthetic_fallback=True,
        synthetic_n=120, batch_size=16, epochs=1,
        ckpt_dir=str(tmp_path / "ck"), model=JaxModelConfig(**small))
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        ft = jax_finetune.FineTuner(jcfg).setup_data()
    ft.setup_state(next(iter(ft.iters["train"]))[0])
    ft._build_steps()
    items = ft._epoch_items("train")
    net = FineTuneNet(task="classification", **small)
    assert transfer_state(_jax_state(ft.state), net)["skipped"] == []
    opt = two_group_adam(net, jcfg.init_lr, jcfg.init_base_lr,
                         jcfg.weight_decay)
    state, rng, grads0 = ft.state, jax.random.PRNGKey(17), None
    for step in range(3):
        item = items[step]
        masks = _dropout_masks(ft, state, item, rng)
        state, jloss = ft._train_step(state, item[0], (), item[1], rng)
        loss = train_step([net], opt, _port_batch(item[0]),
                          torch.from_numpy(item[1]), (), "ce",
                          seed_masks=[masks])[0]
        np.testing.assert_allclose(float(loss), float(jloss),
                                   rtol=1e-5 if step == 0 else 1e-4,
                                   err_msg=f"loss at step {step}")
        if step == 0:
            grads0 = {k: p.grad.numpy().copy()
                      for k, p in net.named_parameters()}
        _compare(_jax_state(state), net, grads0, step + 1,
                 max(jcfg.init_lr, jcfg.init_base_lr), tight=step == 0)
    ft.state = state
    port = FineTuner(FineTuneConfig(
        task_name="BBBP", data_root=str(tmp_path), synthetic_fallback=True,
        synthetic_n=120, batch_size=16, epochs=1,
        ckpt_dir=str(tmp_path / "ck"), model=ModelConfig(**small)),
        "cpu").setup_data()
    port.models = [net]
    got, want = port.evaluate("valid"), ft.evaluate("valid")
    assert got["n"] == want["n"] > 0
    assert abs(got["metric"] - want["metric"]) <= 1e-6, (got, want)


# -------------------------------------------------------------------- CLI


@pytest.mark.parametrize("gnn", ["gin", "gcn"])
def test_embed_cli_tile0_embeds_every_molecule_as_jax(tmp_path, gnn):
    """`cli.embed --tile 0 --cpu` on a corpus with a 300-atom chain and a
    ring with a 262-atom tail: every parseable molecule embedded (no
    skip), within 1e-5 of the JAX CLI at --tile 0 from the same .pth."""
    from molclr_tpu.cli import embed as jax_embed
    from molclr_tpu_torch.cli import embed as port_embed

    big = ["C" * 300, "C1CCCCC1" + "C" * 262]
    smiles = synthetic_corpus(20, seed=21) + big + ["C1CC"]
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(smiles) + "\n")
    port = MolCLRNet(gnn_type=gnn, generator=torch.Generator()
                     .manual_seed(9), tile=0, **MODEL)
    bp = _port_batch(_jax_batch(smiles[:16], 0))
    with torch.no_grad():                                # non-trivial stats
        port.train()(bp)
    ckpt = tmp_path / f"{gnn}.pth"
    torch.save(port.state_dict(), ckpt)
    args = ["--checkpoint", str(ckpt), "--model", gnn, "--layers",
            str(MODEL["num_layers"]), "--emb-dim", str(MODEL["emb_dim"]),
            "--feat-dim", str(MODEL["feat_dim"]), "--batch-size", "8",
            "--tile", "0", "--cpu"]
    assert port_embed.main([str(corpus), str(tmp_path / "port.npy"),
                            *args]) == 0
    assert jax_embed.main([str(corpus), str(tmp_path / "jax.npy"),
                           *args]) == 0
    emb, ref = np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy")
    assert emb.shape == (22, MODEL["feat_dim"])
    assert_close(emb, ref, 1e-5)
    side = (tmp_path / "port.smiles.txt").read_text().splitlines()
    assert side == smiles[:-1]
    assert side == (tmp_path / "jax.smiles.txt").read_text().splitlines()


# ------------------------------------------------------------ TensorBoard


def _scalar_steps(run_dir) -> dict:
    """{tag: [steps]} of the TensorBoard event files in run_dir."""
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    acc = EventAccumulator(str(run_dir))
    acc.Reload()
    return {tag: [e.step for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_tensorboard_scalars_match_jax_tags_and_steps(tmp_path,
                                                      monkeypatch):
    """With tensorboard on, the port's Pretrainer (tile 0, 2 epochs, the
    validation loss only after the second, so the first's NaN is skipped)
    and FineTuner (2 epochs) write the JAX trainers' tags at their steps;
    the YAML key is read; NullWriter.scalars does nothing. (tensorflow,
    which the tensorboard package loads where it is installed, is kept
    out: the events are the same without it, and the import is 8 s
    shorter.)"""
    import sys

    monkeypatch.setitem(sys.modules, "tensorflow", None)
    from molclr_tpu.train import finetune as jax_finetune
    from molclr_tpu.train.config import FineTuneConfig as JaxFineTuneConfig
    from molclr_tpu.train.config import ModelConfig as JaxModelConfig
    from molclr_tpu.train.config import PretrainConfig as JaxPretrainConfig
    from molclr_tpu.train.pretrain import Pretrainer as JaxPretrainer
    from molclr_tpu_torch.train.config import FineTuneConfig, ModelConfig, \
        PretrainConfig, finetune_from_yaml, pretrain_from_yaml
    from molclr_tpu_torch.train.finetune import FineTuner
    from molclr_tpu_torch.train.logging_util import NullWriter
    from molclr_tpu_torch.train.pretrain import Pretrainer

    smiles = synthetic_corpus(60, seed=1)
    small = dict(num_layers=2, emb_dim=16, feat_dim=32, tile=0)
    common = dict(batch_size=16, epochs=2, warm_up=0, valid_size=0.1,
                  eval_every_epochs=2, tensorboard=True)
    runs = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg / "pre"
        if pkg == "jax":
            pre = JaxPretrainer(JaxPretrainConfig(
                featurize_processes=0, ckpt_dir=str(d),
                model=JaxModelConfig(**small), **common)).setup_data(smiles)
            pre.setup_state(next(iter(pre.train_iter))[0])
        else:
            pre = Pretrainer(PretrainConfig(
                ckpt_dir=str(d), model=ModelConfig(**small), **common),
                "cpu").setup_data(smiles).setup_state()
        pre.train(log=lambda *_: None)
        runs[pkg, "pre"] = _scalar_steps(d)
    assert runs["port", "pre"] == runs["jax", "pre"]
    assert runs["port", "pre"]["validation_loss"] == [6]
    assert runs["port", "pre"]["train_loss"] == [3, 6]
    ft_kw = dict(task_name="BBBP", epochs=2, synthetic_fallback=True,
                 synthetic_n=80, batch_size=16, tensorboard=True)
    for pkg in ("jax", "port"):
        d = tmp_path / pkg / "ft"
        with pytest.warns(UserWarning, match="SYNTHETIC"):
            if pkg == "jax":
                ft = jax_finetune.FineTuner(JaxFineTuneConfig(
                    ckpt_dir=str(d), data_root=str(d), model=JaxModelConfig(
                        drop_ratio=0.3, **small), **ft_kw)).setup_data()
                ft.setup_state(next(iter(ft.iters["train"]))[0])
            else:
                ft = FineTuner(FineTuneConfig(
                    ckpt_dir=str(d), data_root=str(d), model=ModelConfig(
                        drop_ratio=0.3, **small), **ft_kw),
                    "cpu").setup_data().setup_state()
        ft.train(log=lambda *_: None)
        runs[pkg, "ft"] = _scalar_steps(d / "BBBP_p_np")
    assert runs["port", "ft"] == runs["jax", "ft"] == {
        "train_loss": [0, 1], "valid_roc_auc": [0, 1]}
    yaml_path = tmp_path / "tb.yaml"
    yaml_path.write_text("tensorboard: true\nbatch_size: 8\n")
    assert pretrain_from_yaml(str(yaml_path)).tensorboard
    assert finetune_from_yaml(str(yaml_path)).tensorboard
    assert not PretrainConfig().tensorboard
    assert NullWriter().scalars(3, train_loss=1.0) is None


def test_metric_writer_without_tensorboard_says_so(tmp_path, monkeypatch,
                                                    capsys):
    """Where torch.utils.tensorboard does not import (as on a machine
    without the tensorboard package), the writer writes no events and
    prints one line; metrics.jsonl is written as ever."""
    import sys

    from molclr_tpu_torch.train.logging_util import MetricWriter

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = MetricWriter(str(tmp_path), tensorboard=True)
    w.scalars(1, train_loss=0.5)
    w.record({"epoch": 0})
    w.close()
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and "writing no TensorBoard events" in out[0]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["metrics.jsonl"]
