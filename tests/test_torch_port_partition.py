"""The PyTorch port's node-row-sharded giant-batch pretraining
(molclr_tpu_torch/parallel/partition.py) and sharded aggregation
(parallel/edgepart.py) against the JAX package, on the CPU. Ranks are
processes of tests/torch_dp_worker.py on a gloo group (modes `part` and
`part1`), each with a hard time limit; the JAX side runs in this process on
a 4-device CPU mesh while the ranks run.

- concat_shards -> shard_graph_batch -> _localize gives back every
  per-shard batch field for field, as JAX's _localize does (the layout of
  tests/test_partition.py: 4 shards, tile 32, 4 graphs per shard);
- 4 ranks, aug 'none': the return_grads call against JAX's
  build_partitioned_pretrain_step(return_grads=True) and against JAX's
  unsharded step on the concatenated batch (tests/test_partition.py's
  limits: loss rtol 1e-5, gradients rtol 2e-4 / atol 1e-6), leaving the
  state as it was; then three Adam steps against JAX's partitioned step
  at tests/test_torch_port_dp.py's step-parity limits;
- 4 ranks, aug 'node' on the views JAX draws inside its partitioned step
  (fold_in(fold_in(rng, step), rank), split in three, paired_augment on
  the localized shard), fed through AUG_DELTA_FIELDS: three GIN steps, one
  GCN step, one GIN step with 'pallas' NT-Xent (JAX's kernel in
  interpreter mode), three GIN steps at drop_ratio 0.1 on JAX's keep
  masks (the unchained trunk) and three in bf16 against JAX's BN-chained
  layers (test_torch_port_dp's BF16_LIMITS); the ranks bit-identical; the
  all-reduces per step;
- tile 0 refused, by the port as by JAX;
- world 1: the partitioned step and its return_grads bit for bit the
  one-card step;
- the running statistics' mean at 3 ranks equal to JAX's pmean bit for
  bit;
- edgepart on 4 ranks (tests/test_edgepart.py's molecules, 128 nodes, 32
  rows per rank, halo 16, tile 16): each variant's forward and its
  gradients of h and the two tables against the port's single-rank
  gine_aggregate and JAX's variant on a 4-device mesh (1e-5 forward, 1e-4
  gradients); no molecule crosses a shard; the tile variant makes no
  collective, the others one per pass of the expected size.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from molclr_tpu.data import featurize_smiles, pack_batch
from molclr_tpu.data.augment import paired_augment as jax_paired_augment
from molclr_tpu.data.graphs import PadSpec, concat_shards as jax_concat
from molclr_tpu.data.synthetic import synthetic_corpus
from molclr_tpu.losses import nt_xent_loss as jax_nt_xent
from molclr_tpu.models import MolCLRNet as JaxMolCLRNet
from molclr_tpu.parallel import build_partitioned_pretrain_step, make_mesh, \
    shard_graph_batch as jax_shard_graph_batch
from molclr_tpu.parallel import edgepart as jax_edgepart
from molclr_tpu.parallel.partition import _localize as jax_localize
from molclr_tpu.train.optim import adam_torch as jax_adam_torch
from molclr_tpu.train.state import TrainState
from molclr_tpu_torch.data.graphs import GraphBatch, concat_shards
from molclr_tpu_torch.ops.scatter_free import gine_aggregate
from molclr_tpu_torch.parallel import DPGroup, mean_running_stats, \
    partitioned_train_step, shard_ell_rows, shard_graph_batch
from molclr_tpu_torch.parallel.partition import _localize
from molclr_tpu_torch.train.checkpoints import state_dict_from_jax
from molclr_tpu_torch.train.config import ModelConfig, PretrainConfig
from molclr_tpu_torch.train.pretrain import build_model
from test_torch_port_dp import LR, WD, _compare_states, _deltas, \
    _free_port, _np, _start, _wait, jax_dropout_masks, ranks_identical, \
    steps_against_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dp_worker.py")
S, TILE, PER = 4, 32, 4
MODEL = dict(num_layers=3, emb_dim=32, feat_dim=64, tile=TILE)
STEPS = 3
# per rank and GIN step: 2 views x 3 layers of BatchNorm moment sums
# forward and backward, the pairs' gather forward and backward, the pair
# mask's gather, the gradient mean (the data-parallel step's), and the
# running statistics' mean
PART_COLLECTIVES = 4 * MODEL["num_layers"] + 4 + 1
# The GIN convs' output biases feed a BatchNorm, which subtracts their
# mean: their exact gradient is 0, and every side holds f32 rounding noise
# there (up to 1.9e-6 against JAX's unsharded step, whose own partitioned
# step differs from it by 1.3e-6: two noises, not within atol 1e-6 of
# each other). Each side is held within ZERO_GRAD_ATOL of 0 instead; a
# real gradient of these biases is of the order of the others (1e-2).
ZERO_GRAD_SUFFIX, ZERO_GRAD_ATOL = "mlp.2.bias", 1e-5


def _shard_batches(seed=0):
    """tests/test_partition.py's layout: S packed batches of PER graphs at
    tile 32, 64 node rows each."""
    graphs = [g for g in (featurize_smiles(s) for s in
                          synthetic_corpus(S * PER, seed=seed))
              if g is not None and g.max_degree <= 6]
    max_bonds = max(g.edge_src.shape[0] // 2 for g in graphs)
    spec = PadSpec(n_graphs=PER, n_nodes=2 * TILE, n_edges=56 * PER,
                   max_degree=6, tile=TILE, max_graph_bonds=max_bonds)
    return [pack_batch(graphs[i * PER: (i + 1) * PER], spec)
            for i in range(S)], max_bonds


def _segment(cat, i, world=S):
    """Shard i of `world` of a JAX concat batch, as JAX arrays."""
    def seg(x):
        n = x.shape[0] // world
        return jnp.asarray(np.asarray(x)[i * n: (i + 1) * n])

    return jax.tree_util.tree_map(seg, cat)


# ------------------------------------------------------- the JAX side


def _jax_model(gnn, axis=None, fused=True, drop=0.0, bf16=False):
    """JAX's MolCLRNet at MODEL: by default its BN-chained fused layers
    (Pallas in interpreter mode), JAX's path on a TPU (resolve_fused) and
    the port's; fused=False the unchained XLA layers with classic
    BatchNorm; drop its dropout rate, bf16 bfloat16 activations."""
    return JaxMolCLRNet(gnn_type=gnn, num_layers=MODEL["num_layers"],
                        emb_dim=MODEL["emb_dim"], feat_dim=MODEL["feat_dim"],
                        tile=TILE, bn_axis_name=axis, fused=fused,
                        drop_ratio=drop,
                        dtype=jnp.bfloat16 if bf16 else jnp.float32)


def _jax_init(gnn, cat):
    v = jax.tree_util.tree_map(np.asarray, _jax_model(gnn, fused=False).init(
        jax.random.PRNGKey(0), cat, train=False))
    return v["params"], v["batch_stats"]


def _jax_view_batches(cat, aug, rng, bond_window, steps=STEPS, world=S):
    """Per step and rank, the views JAX's partitioned step draws on the
    localized shard (None for 'none')."""
    if aug == "none":
        return [None] * steps
    locs = [jax_localize(_segment(cat, d, world), d, world)
            for d in range(world)]
    return [[jax_paired_augment(
        locs[d], jax.random.split(jax.random.fold_in(
            jax.random.fold_in(rng, s), d), 3)[0], aug, tile=TILE,
        bond_window=bond_window) for d in range(world)]
        for s in range(steps)]


def _jax_views(cat, aug, rng, bond_window, steps=STEPS, world=S):
    """Per step and rank, the AUG_DELTA_FIELDS of _jax_view_batches."""
    return [None if v is None else [_deltas(x) for x in v]
            for v in _jax_view_batches(cat, aug, rng, bond_window, steps,
                                       world)]


def _adam(state):
    return [x for x in jax.tree_util.tree_leaves(
        state.opt_state,
        is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState)][0]


def _jax_masks(c, cat, params, stats, steps):
    """Per step the keep masks per rank of JAX's partitioned step for
    configuration c (drop_ratio > 0; jax_dropout_masks)."""
    masks = jax_dropout_masks(
        _jax_model(c["gnn"], "part", c["fused"], c["drop"], c["bf16"]),
        params, stats, make_mesh(S, axis="part"), "part")
    views = _jax_view_batches(cat, c["aug"], c["rng"], c["bond_window"],
                              steps)
    return [masks(views[s], c["rng"], s) for s in range(steps)]


def _jax_steps(c, cat, params, stats, steps):
    """JAX's partitioned step for configuration c, `steps` times: the loss,
    the state and Adam's moments after each."""
    tx = jax_adam_torch(LR, WD)
    mesh = make_mesh(S, axis="part")
    step_fn = build_partitioned_pretrain_step(
        _jax_model(c["gnn"], "part", c["fused"], c["drop"], c["bf16"]), tx,
        mesh, aug=c["aug"], axis="part", tile=TILE,
        bond_window=c["bond_window"], ntxent_impl=c["impl"],
        ntxent_interpret=True)
    state = TrainState(params=params, batch_stats=stats,
                       opt_state=tx.init(params), step=0)
    sharded = jax_shard_graph_batch(cat, mesh, "part")
    out = []
    for _ in range(steps):
        state, loss = step_fn(state, sharded, c["rng"])
        host = jax.tree_util.tree_map(np.asarray, (state.params,
                                                   state.batch_stats))
        adam = _adam(state)
        out.append({
            "loss": float(loss), "state": state_dict_from_jax(*host),
            "mu": state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             adam.mu)),
            "nu": state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             adam.nu))})
    return out


def _jax_grads(cat, params, stats):
    """JAX's partitioned return_grads call and its unsharded fwd + bwd on
    the concatenated batch (aug 'none'): (loss, grads) each, as port state
    dicts."""
    tx = jax_adam_torch(LR, WD)
    mesh = make_mesh(S, axis="part")
    pstep = build_partitioned_pretrain_step(
        _jax_model("gin", "part"), tx, mesh, aug="none", axis="part",
        tile=TILE, return_grads=True)
    state = TrainState(params=params, batch_stats=stats,
                       opt_state=tx.init(params), step=0)
    loss, grads = pstep(state, jax_shard_graph_batch(cat, mesh, "part"),
                        jax.random.PRNGKey(1))
    model_u = _jax_model("gin")

    def loss_u(p, st):
        (_, zi), upd = model_u.apply({"params": p, "batch_stats": st}, cat,
                                     train=True, mutable=["batch_stats"])
        (_, zj), _ = model_u.apply(
            {"params": p, "batch_stats": upd["batch_stats"]}, cat,
            train=True, mutable=["batch_stats"])
        return jax_nt_xent(zi, zj, 0.1, True, pair_mask=cat.graph_mask)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_u))(params, stats)
    conv = lambda g: {k: v.numpy() for k, v in state_dict_from_jax(  # noqa
        jax.tree_util.tree_map(np.asarray, g)).items()}
    return ((float(loss), conv(grads)), (float(ref_loss), conv(ref_grads)))


# --------------------------------------------------- the edgepart inputs

EDGE_SMILES = ["CC(=O)Oc1ccccc1C(=O)O", "Cn1cnc2c1c(=O)n(C)c(=O)n2C",
               "CCO", "CN1CCC[C@H]1c1cccnc1", "O=S(=O)(N)c1ccccc1",
               "CCCCCCCC", "c1ccc2ccccc2c1", "C"]
EDGE_SPEC = dict(n_graphs=8, n_nodes=128, n_edges=288, max_degree=6)
HALO, EDGE_TILE, EDGE_D = 16, 16, 24


def _edge_inputs():
    """tests/test_edgepart.py's molecules packed plain and at tile 16, with
    seeded h, tables and cotangents."""
    graphs = [featurize_smiles(s) for s in EDGE_SMILES]
    batches = {"plain": pack_batch(graphs, PadSpec(**EDGE_SPEC)),
               "tiled": pack_batch(graphs, PadSpec(**EDGE_SPEC,
                                                   tile=EDGE_TILE))}
    rng = np.random.RandomState(0)
    e = {"t1": rng.randn(5, EDGE_D).astype(np.float32),
         "t2": rng.randn(3, EDGE_D).astype(np.float32),
         "halo": HALO, "tile": EDGE_TILE}
    for k, b in batches.items():
        e[k] = _np(b)
        e[f"h_{k}"] = (rng.randn(b.num_nodes, EDGE_D)
                       * np.asarray(b.node_mask)[:, None]).astype(np.float32)
        e[f"cot_{k}"] = rng.randn(b.num_nodes, EDGE_D).astype(np.float32)
    return batches, e


def _jax_edge(batches, e):
    """JAX's three variants on a 4-device mesh: per variant (out, dh, dt1,
    dt2) for the loss <out, cot>."""
    mesh = make_mesh(S, axis="shard")
    a = P("shard")
    res = {}
    for variant, packing in (("gather", "plain"), ("halo", "plain"),
                             ("tile", "tiled")):
        batch = batches[packing]
        sh = jax_edgepart.shard_ell_rows(batch, S)
        ell = (sh["nbr"], sh["nbr_bond_type"], sh["nbr_bond_dir"],
               sh["nbr_mask"])
        h_sh = jnp.asarray(e[f"h_{packing}"].reshape(S, -1, EDGE_D))
        cot_sh = e[f"cot_{packing}"].reshape(S, -1, EDGE_D)

        def local(h_s, t1, t2, nbr, bt, bd, mask, cot_s):
            sq = lambda x: x.reshape((-1,) + x.shape[2:])  # noqa: E731
            args = (sq(h_s), t1, t2, sq(nbr), sq(bt), sq(bd), sq(mask))
            if variant == "gather":
                out = jax_edgepart.gine_aggregate_sharded(*args, "shard")
            elif variant == "halo":
                out = jax_edgepart.gine_aggregate_halo(*args, "shard", HALO)
            else:
                out = jax_edgepart.local_tile_aggregate(*args, "shard",
                                                        EDGE_TILE)
            return jax.lax.psum((out * sq(cot_s)).sum(), "shard"), out[None]

        fn = shard_map(local, mesh=mesh,
                       in_specs=(a, P(), P(), a, a, a, a, a),
                       out_specs=(P(), a), check_vma=False)

        def loss(h_s, t1, t2):
            return fn(h_s, t1, t2, *ell, cot_sh)

        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(h_sh, e["t1"], e["t2"])
        res[variant] = [np.asarray(out).reshape(-1, EDGE_D),
                        np.asarray(grads[0]).reshape(-1, EDGE_D),
                        np.asarray(grads[1]), np.asarray(grads[2])]
    return res


def _port_single_rank(batch, e, packing):
    """The port's single-rank gine_aggregate: (out, dh, dt1, dt2)."""
    bt = GraphBatch(**_np(batch)).to("cpu")
    h, t1, t2 = (torch.from_numpy(x).requires_grad_() for x in (
        e[f"h_{packing}"], e["t1"], e["t2"]))
    out = gine_aggregate(h, t1, t2, bt.nbr, bt.nbr_bond_type,
                         bt.nbr_bond_dir, bt.nbr_mask)
    out.backward(torch.from_numpy(e[f"cot_{packing}"]))
    return [out.detach().numpy(), h.grad.numpy(), t1.grad.numpy(),
            t2.grad.numpy()]


# ------------------------------------------------------------ the ranks


def _start_ranks(tmp_path, mode: str, world: int, inp: dict):
    """`world` worker processes on one gloo group, started now; _results
    waits for them (within test_torch_port_dp's RANK_TIMEOUT_S)."""
    inp_path = tmp_path / f"{mode}{world}.in.pt"
    out_dir = tmp_path / f"{mode}{world}"
    out_dir.mkdir()
    torch.save(inp, inp_path)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    cmds = [[sys.executable, WORKER, mode, str(inp_path), str(out_dir),
             str(r), str(world), str(port)] for r in range(world)]
    return _start(cmds, ROOT, env, out_dir), out_dir


def _results(started, out_dir) -> list[dict]:
    for r, log in enumerate(_wait(started)):
        assert log is None, f"rank {r} failed:\n{log}"
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(len(started[0]))]


# (name, gnn, aug, ntxent_impl, steps, rng seed, JAX's fused layers,
# drop_ratio, bf16): aug 'none' against JAX's BN-chained layers, whose
# arithmetic is the port's (the gradients' limits are JAX's own, 2e-4 /
# 1e-6); the augmented steps, held at the step-parity limits, against its
# unchained XLA layers (the cheaper compile), as
# tests/test_torch_port_dp.py's 2-rank cases: GIN with dropout 0.1 on
# JAX's keep masks too (the port's unchained trunk, K4f / K4b per rank);
# GIN in bf16 against its BN-chained layers, at tests/test_torch_port_dp's
# BF16_LIMITS
PART_CASES = [("gin-none", "gin", "none", "xla", STEPS, 1, True, 0.0, False),
              ("gin-node", "gin", "node", "xla", STEPS, 2, False, 0.0, False),
              ("gcn-node", "gcn", "node", "xla", 1, 3, False, 0.0, False),
              ("gin-pallas", "gin", "node", "pallas", 1, 4, False, 0.0,
               False),
              ("gin-drop", "gin", "node", "xla", STEPS, 5, False, 0.1, False),
              ("gin-bf16", "gin", "node", "xla", STEPS, 6, True, 0.0, True)]


def _world_one_configs():
    """GIN with node augmentation and GCN with none, two steps each, on one
    shard of PER graphs: the world-1 rank's configurations."""
    batches, max_bonds = _shard_batches(seed=1)
    one = jax_concat(batches[:1])
    configs = []
    for gnn, aug in (("gin", "node"), ("gcn", "none")):
        configs.append(dict(
            name=gnn, aug=aug, impl="xla", bond_window=max_bonds,
            batch_size=PER, lr=LR, weight_decay=WD,
            model=dict(MODEL, gnn_type=gnn),
            init=state_dict_from_jax(*_jax_init(gnn, one)),
            shards=[_np(batches[0])], return_grads=True,
            views=_jax_views(one, aug, jax.random.PRNGKey(7), max_bonds,
                             steps=2, world=1)))
    return configs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's 4 ranks on every configuration of PART_CASES and on the
    edgepart inputs, its world-1 rank on _world_one_configs, and JAX's
    results on the same inputs, computed while the ranks run."""
    tmp = tmp_path_factory.mktemp("part")
    one = _start_ranks(tmp, "part1", 1, {"configs": _world_one_configs()})
    batches, max_bonds = _shard_batches()
    cat = jax_concat(batches)
    inits = {gnn: _jax_init(gnn, cat) for gnn in ("gin", "gcn")}
    configs = []
    for name, gnn, aug, impl, steps, seed, fused, drop, bf16 in PART_CASES:
        rng = jax.random.PRNGKey(seed)
        c = dict(
            name=name, gnn=gnn, aug=aug, impl=impl, rng=rng, fused=fused,
            drop=drop, bf16=bf16, bond_window=max_bonds, batch_size=S * PER,
            lr=LR, weight_decay=WD,
            model=dict(MODEL, gnn_type=gnn, drop_ratio=drop, bf16=bf16),
            init=state_dict_from_jax(*inits[gnn]),
            shards=[_np(b) for b in batches],
            views=_jax_views(cat, aug, rng, max_bonds, steps),
            return_grads=aug == "none")
        if drop:
            c["masks"] = _jax_masks(c, cat, *inits[gnn], steps)
        configs.append(c)
    edge_batches, edge = _edge_inputs()
    four = _start_ranks(
        tmp, "part", S, {"configs": [
            {k: v for k, v in c.items()
             if k not in ("rng", "gnn", "fused", "drop", "bf16")}
            for c in configs], "edge": edge})
    try:
        jax_res = {c["name"]: _jax_steps(c, cat, *inits[c["gnn"]],
                                         len(c["views"])) for c in configs}
        jax_grads = _jax_grads(cat, *inits["gin"])
        jax_edge = _jax_edge(edge_batches, edge)
    except BaseException:
        for started, _ in (one, four):
            _wait(started, kill=True)
        raise
    return dict(configs=configs, jax=jax_res, jax_grads=jax_grads,
                ranks=_results(*four), world_one=_results(*one)[0],
                edge=edge, edge_batches=edge_batches, jax_edge=jax_edge)


# ------------------------------------------------------------ the tests


def test_concat_shard_localize_round_trip():
    """concat_shards -> shard_graph_batch -> _localize gives back every
    per-shard batch field for field, on the port as on JAX."""
    batches, _ = _shard_batches()
    port = [GraphBatch(**_np(b)).to("cpu") for b in batches]
    cat = concat_shards(port)
    jcat = jax_concat(batches)
    for i, orig in enumerate(batches):
        seg = shard_graph_batch(cat, DPGroup(i, S, "gloo", "cpu"),
                                tile=TILE)
        back = _localize(seg, i, S)
        jback = jax_localize(_segment(jcat, i), i, S)
        for f in dataclasses.fields(GraphBatch):
            want = np.asarray(getattr(orig, f.name))
            got = getattr(back, f.name).numpy()
            assert np.array_equal(got, want), (i, f.name)
            assert np.array_equal(np.asarray(getattr(jback, f.name)),
                                  want), (i, f.name)
    # the numpy concat splits the same way, and uneven splits raise
    seg = shard_graph_batch(jax.tree_util.tree_map(np.asarray, jcat),
                            DPGroup(1, S, "gloo", "cpu"))
    assert all(np.array_equal(getattr(seg, f.name).numpy(),
                              np.asarray(getattr(cat, f.name))[
                                  len(getattr(seg, f.name)):
                                  2 * len(getattr(seg, f.name))])
               for f in dataclasses.fields(GraphBatch))
    with pytest.raises(ValueError, match="equal segments"):
        shard_graph_batch(cat, DPGroup(0, 3, "gloo", "cpu"))
    with pytest.raises(ValueError, match="multiple of the tile"):
        shard_graph_batch(cat, DPGroup(0, S, "gloo", "cpu"), tile=3 * TILE)


def test_tile_zero_is_refused():
    """Partitioned training needs the tile contract, on the port (before
    any collective) as on JAX."""
    cfg = PretrainConfig(model=ModelConfig(**dict(MODEL, tile=0)))
    dp = DPGroup(0, S, "gloo", "cpu")
    with pytest.raises(ValueError, match="tile-aligned"):
        partitioned_train_step(None, None, None, cfg, 0, LR, dp)
    with pytest.raises(ValueError, match="tile-aligned"):
        build_partitioned_pretrain_step(
            _jax_model("gin", "part"), jax_adam_torch(LR, WD),
            make_mesh(S, axis="part"), axis="part", tile=0)


def test_none_step_matches_jax(run):
    """aug 'none': the return_grads call against JAX's partitioned
    return_grads and its unsharded step (loss rtol 1e-5, gradients rtol
    2e-4 / atol 1e-6) with the state left as it was; then three Adam
    steps at the step-parity limits, the ranks bit-identical."""
    (jloss, jgrads), (uloss, ugrads) = run["jax_grads"]
    for r in run["ranks"]:
        rg = r["gin-none"]["rg"]
        assert rg["unchanged"] and rg["opt_empty"]
        for want_loss, want in ((jloss, jgrads), (uloss, ugrads)):
            np.testing.assert_allclose(rg["loss"], want_loss, rtol=1e-5)
            assert set(rg["grads"]) == set(want)
            for k, v in want.items():
                if k.endswith(ZERO_GRAD_SUFFIX):
                    for side in (rg["grads"][k], v):
                        assert np.abs(side).max() <= ZERO_GRAD_ATOL, k
                    continue
                np.testing.assert_allclose(rg["grads"][k], v, rtol=2e-4,
                                           atol=1e-6, err_msg=k)
    _steps_match(run, "gin-none")


def _steps_match(run, name):
    c = next(c for c in run["configs"] if c["name"] == name)
    port = ranks_identical(run["ranks"], name)
    assert port["collectives_per_step"] == PART_COLLECTIVES, port[
        "collectives_per_step"]
    steps_against_jax(name, port, run["jax"][name], c["init"], c["bf16"])


@pytest.mark.parametrize("name", ["gin-node", "gcn-node", "gin-pallas",
                                  "gin-drop", "gin-bf16"])
def test_node_steps_match_jax(run, name):
    """aug 'node' on JAX's views of each localized shard: three GIN steps,
    one GCN step, one GIN step with 'pallas' NT-Xent, at the step-parity
    limits; three GIN steps with dropout 0.1 on JAX's keep masks (the
    unchained trunk: its BatchNorm moments summed across the ranks in
    MaskedBatchNorm, one all-reduce each way as the chained trunk's, so
    the same PART_COLLECTIVES) and three in bf16 (BF16_LIMITS); the ranks
    bit-identical."""
    _steps_match(run, name)


@pytest.mark.parametrize("variant", ["gather", "halo", "tile"])
def test_edgepart_variant_matches_jax_and_single_rank(run, variant):
    """Each variant's forward (1e-5) and its gradients of h and both tables
    (1e-4; the tables' partials summed across the ranks) against JAX's
    variant on a 4-device mesh and the port's single-rank
    gine_aggregate; the all-reduces of its forward and backward."""
    packing = "tiled" if variant == "tile" else "plain"
    ranks = [r["edge"][variant] for r in run["ranks"]]
    got = [np.concatenate([r[k] for r in ranks]) for k in ("out", "dh")]
    got += [ranks[0]["dt1"], ranks[0]["dt2"]]
    partial_sums = [sum(r[k] for r in ranks)
                    for k in ("dt1_partial", "dt2_partial")]
    single = _port_single_rank(run["edge_batches"][packing],
                               run["edge"], packing)
    for want in (run["jax_edge"][variant], single):
        for i, (g, w) in enumerate(zip(got, want)):
            tol = 1e-5 if i == 0 else 1e-4
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=f"{variant} output {i}")
    for r in ranks:
        for i, k in enumerate(("dt1", "dt2")):
            assert np.array_equal(r[k], ranks[0][k])
            np.testing.assert_allclose(r[k], partial_sums[i], rtol=1e-6,
                                       atol=1e-6)
    n_local = EDGE_SPEC["n_nodes"] // S
    want_bytes = {"gather": S * n_local * EDGE_D * 4,
                  "halo": S * 2 * HALO * EDGE_D * 4, "tile": 0}[variant]
    for r in ranks:
        calls = 0 if variant == "tile" else 1
        assert r["collectives"] == (calls, calls), r["collectives"]
        assert r["reduced_bytes"] == (want_bytes, want_bytes)


def test_no_molecule_crosses_a_shard():
    """At tile 16 with 32 rows per rank every molecule sits on one rank
    (the tile variant's contract), and shard_ell_rows splits the ELL view
    into the ranks' rows."""
    graphs = [featurize_smiles(s) for s in EDGE_SMILES]
    batch = pack_batch(graphs, PadSpec(**EDGE_SPEC, tile=EDGE_TILE))
    node_graph, mask = np.asarray(batch.node_graph), np.asarray(
        batch.node_mask)
    per = batch.num_nodes // S
    for g in np.unique(node_graph[mask]):
        rows = np.flatnonzero(mask & (node_graph == g))
        assert rows.min() // per == rows.max() // per
    sh = shard_ell_rows(batch, S)
    jsh = jax_edgepart.shard_ell_rows(batch, S)
    for k, v in jsh.items():
        assert np.array_equal(np.asarray(sh[k]), v), k
    with pytest.raises(ValueError, match="not divisible"):
        shard_ell_rows(batch, 3)


def test_running_stats_mean_matches_jax_pmean_at_three_ranks():
    """The running statistics' mean where S is not a power of two: three
    ranks holding the same statistics (as after the summed moments), the
    port's sum-then-divide against JAX's pmean on a 3-device mesh, bit
    for bit."""

    class _Ranks3:
        """Three ranks that hold this rank's values: the sum in rank
        order."""
        world, rank = 3, 0

        @staticmethod
        def all_reduce_(x):
            x.copy_(x + x + x)
            return x

    model = build_model(PretrainConfig(model=ModelConfig(**MODEL)))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for b in model.buffers():
            if b.is_floating_point():
                b.copy_(torch.rand(b.shape, generator=gen) * 7 + 0.1)
    stats = [b.clone() for b in model.buffers() if b.is_floating_point()]
    mean_running_stats(model, _Ranks3())
    mesh = make_mesh(3, axis="part")
    pmean = jax.jit(shard_map(lambda x: jax.lax.pmean(x, "part"), mesh=mesh,
                              in_specs=P("part"), out_specs=P("part"),
                              check_vma=False))
    got = [b for b in model.buffers() if b.is_floating_point()]
    for before, after in zip(stats, got):
        want = np.asarray(pmean(np.tile(before.numpy()[None], (3, 1))))[0]
        assert np.array_equal(after.numpy(), want)


def test_world_one_is_the_one_card_step(run):
    """At world 1 the partitioned step (its collectives on a one-rank gloo
    group) and its return_grads give the one-card step's loss, gradients,
    Adam moments and state bit for bit, GIN and GCN."""
    got = run["world_one"]
    for c in ("gin", "gcn"):
        part, ref = got[c]["part"], got[c]["one"]
        assert part["rg"]["loss"] == ref["rg"]["loss"]
        assert part["rg"]["unchanged"] and ref["rg"]["unchanged"]
        for k, v in ref["rg"]["grads"].items():
            assert np.array_equal(part["rg"]["grads"][k], v), k
        assert part["losses"] == ref["losses"], c
        for key in ("grads0", "mu0", "nu0"):
            for k, v in ref[key].items():
                assert np.array_equal(part[key][k], v), (c, key, k)
        for s, st in enumerate(ref["states"]):
            for k, v in st.items():
                assert np.array_equal(part["states"][s][k], v), (s, k)
