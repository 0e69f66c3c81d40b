"""The PyTorch port's data-parallel pretraining against the JAX package, on
the CPU: ranks are processes of tests/torch_dp_worker.py on a gloo group
(spawned as their own processes, never forked from this one, which holds
JAX), each with a hard time limit.

- corpus_shard_range over tests/test_multihost.py's grid equal to JAX's;
- the port's 2- and 4-rank step against JAX's build_dp_pretrain_step on a
  2- and a 4-device CPU mesh: three steps, GIN and GCN, the closed-form
  NT-Xent and 'pallas' (the port's plain K2, JAX's kernel in interpreter
  mode), both sides given the same weights and the views JAX draws inside
  its step (fold_in(fold_in(rng, step), device), fed to the port through
  AUG_DELTA_FIELDS); the limits of tests/test_torch_port_pretrain.py's
  step parity for the loss, the step-0 gradients and Adam moments, every
  parameter and the BatchNorm stats; the ranks bit-identical to each
  other;
- at world 1, the DP step bit-identical to the one-card step on the same
  batch, views and state (collectives at world 1 add nothing);
- a 2-rank Pretrainer's split, steps per epoch, unit spec, unit stack and
  unit rows, and its batch-cache shard and cache orders, equal to what
  the JAX package's multi-process code computes for each process index
  (its helpers composed as pretrain.py:136-147, 158-181, 873-1000,
  1117-1130 compose them, with one device per process);
- a 2-rank `cli.pretrain --cpu --dist-*` run with a resume;
- `data_axis` read from a YAML, and a Pretrainer refusing data_axis
  without a process group (the port used to drop the key and train on
  one device).
"""

import dataclasses
import os
import socket
import subprocess
import sys
import time
from types import SimpleNamespace

import jax
import numpy as np
import optax
import pytest
import torch

from molclr_tpu.data.augment import paired_augment as jax_paired_augment
from molclr_tpu.data.loader import BatchIterator as JaxBatchIterator
from molclr_tpu.data.loader import featurize_many as jax_featurize_many
from molclr_tpu.data.loader import spec_for_graphs as jax_spec_for_graphs
from molclr_tpu.data.regroup import epoch_unit_orders as jax_unit_orders
from molclr_tpu.data.regroup import pack_unit_stack as jax_pack_unit_stack
from molclr_tpu.data.regroup import plan_units as jax_plan_units
from molclr_tpu.data.regroup import unit_spec_for as jax_unit_spec_for
from molclr_tpu.data.graphs import PadSpec as JaxPadSpec
from molclr_tpu.data.synthetic import synthetic_corpus
from molclr_tpu.models import MolCLRNet as JaxMolCLRNet
from molclr_tpu.parallel import build_dp_pretrain_step, make_mesh, \
    stack_batches
from molclr_tpu.parallel.multihost import corpus_shard_range as jax_csr
from molclr_tpu.train.optim import adam_torch as jax_adam_torch
from molclr_tpu.train.pretrain import Pretrainer as JaxPretrainer
from molclr_tpu.train.state import TrainState
from molclr_tpu_torch.data.graphs import GraphBatch
from molclr_tpu_torch.parallel import corpus_shard_range
from molclr_tpu_torch.train.checkpoints import state_dict_from_jax
from molclr_tpu_torch.train.config import PretrainConfig, pretrain_from_yaml
from molclr_tpu_torch.train.pretrain import Pretrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dp_worker.py")
SMALL = dict(num_layers=2, emb_dim=16, feat_dim=32, tile=32)
B, LR, WD = 12, 5e-4, 1e-5
RANK_TIMEOUT_S = 150


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path, mode: str, world: int, inp: dict) -> list[dict]:
    """`world` worker processes on one gloo group; their results. A rank
    that fails, or ranks that are not all done within RANK_TIMEOUT_S, fail
    the test (every rank is killed)."""
    inp_path = tmp_path / f"{mode}{world}.in.pt"
    out_dir = tmp_path / f"{mode}{world}"
    out_dir.mkdir()
    torch.save(inp, inp_path)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    cmds = [[sys.executable, WORKER, mode, str(inp_path), str(out_dir),
             str(r), str(world), str(port)] for r in range(world)]
    for r, log in enumerate(_spawn(cmds, ROOT, env, out_dir)):
        assert log is None, f"rank {r} failed:\n{log}"
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _spawn(cmds, cwd, env, log_dir) -> list:
    """Run the commands at once, each writing to its own log file; wait
    until all are done or RANK_TIMEOUT_S has passed, then kill what is
    left. Per command: None if it exited 0, else the end of its log."""
    logs = [open(os.path.join(log_dir, f"rank{r}.log"), "wb")
            for r in range(len(cmds))]
    procs = [subprocess.Popen(c, cwd=cwd, env=env, stdout=f,
                              stderr=subprocess.STDOUT)
             for c, f in zip(cmds, logs)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p, f in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    return [None if p.returncode == 0 else
            f"exit {p.returncode}: " + open(f.name, errors="replace")
            .read()[-4000:] for p, f in zip(procs, logs)]


def _np(batch) -> dict:
    return {f.name: np.asarray(getattr(batch, f.name))
            for f in dataclasses.fields(GraphBatch)}


def _deltas(views) -> tuple:
    return tuple(tuple(np.asarray(getattr(v, f)) for f in
                       ("atom_type", "chirality", "edge_mask", "nbr_mask"))
                 for v in views)


# --------------------------------------------------------------- shards


def test_corpus_shard_range_matches_jax():
    """The grid of tests/test_multihost.py: every process's slice."""
    for n in (0, 1, 7, 8, 100, 101, 1023):
        for count in (1, 2, 3, 4, 8):
            for p in range(count):
                assert corpus_shard_range(n, p, count) == jax_csr(n, p, count)


# ------------------------------------------------------ steps against JAX


def _jax_dp_run(world: int, gnn: str, impl: str, fused: bool,
                steps: int = 3):
    """JAX's build_dp_pretrain_step on a `world`-device CPU mesh (fused:
    the BN-chained Pallas layers in interpreter mode, else the unchained
    XLA layers with classic BatchNorm): the initial state, per step each
    device's batch and views, and after each step the loss and the
    state."""
    graphs, _ = jax_featurize_many(synthetic_corpus(80, seed=5))
    spec = jax_spec_for_graphs(graphs, B, tile=SMALL["tile"])
    batches = [b for b, _, _ in JaxBatchIterator(graphs, spec, shuffle=True,
                                                 drop_last=True, seed=0)]
    kw = dict(num_layers=SMALL["num_layers"], emb_dim=SMALL["emb_dim"],
              feat_dim=SMALL["feat_dim"], gnn_type=gnn, tile=SMALL["tile"],
              fused=fused)
    init = JaxMolCLRNet(**kw).init(jax.random.PRNGKey(0), batches[0],
                                   train=False)
    host = jax.tree_util.tree_map(np.asarray, init)
    tx = jax_adam_torch(LR, WD)
    state = TrainState(params=host["params"],
                       batch_stats=host["batch_stats"],
                       opt_state=tx.init(host["params"]), step=0)
    bw = spec.max_graph_bonds
    step_fn = build_dp_pretrain_step(
        JaxMolCLRNet(bn_axis_name="data", **kw), tx, make_mesh(world),
        aug="node", axis="data", tile=SMALL["tile"], bond_window=bw,
        ntxent_impl=impl, ntxent_interpret=True)
    rng = jax.random.PRNGKey(9)
    run = {"init": state_dict_from_jax(host["params"], host["batch_stats"]),
           "bond_window": bw, "steps": [], "jax": []}
    for s in range(steps):
        bs = [batches[(s * world + d) % len(batches)] for d in range(world)]
        views = [jax_paired_augment(
            bs[d], jax.random.split(jax.random.fold_in(
                jax.random.fold_in(rng, s), d), 3)[0], "node",
            tile=SMALL["tile"], bond_window=bw) for d in range(world)]
        run["steps"].append({"batches": [_np(b) for b in bs],
                             "views": [_deltas(v) for v in views]})
        state, loss = step_fn(state, stack_batches(bs), rng)
        host = jax.tree_util.tree_map(np.asarray, (state.params,
                                                   state.batch_stats))
        adam = [x for x in jax.tree_util.tree_leaves(
            state.opt_state,
            is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(x, optax.ScaleByAdamState)][0]
        run["jax"].append({
            "loss": float(loss), "state": state_dict_from_jax(*host),
            "mu": state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             adam.mu)),
            "nu": state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             adam.nu))})
    return run


def _compare_states(jstate, port, grads0, steps, tight):
    """tests/test_torch_port_pretrain.py's limits: every parameter within
    the Adam sign-flip envelope 2 steps lr, tight (5e-5 + 2e-4 |p|) on
    99.97 % of the elements whose step-0 gradient exceeds 1e-4 at step 1;
    running_var rtol 2e-3 / atol 1e-5, running_mean the envelope."""
    cap = 2.0 * steps * LR
    for k, v in jstate.items():
        v = np.asarray(v, np.float64)
        got = np.asarray(port[k], np.float64)
        if "running_" in k:
            atol = cap if k.endswith("running_mean") else 1e-5
            np.testing.assert_allclose(got, v, rtol=2e-3, atol=atol,
                                       err_msg=k)
            continue
        diff = np.abs(got - v)
        assert diff.max() <= cap, (k, diff.max())
        if tight:
            real = np.abs(grads0[k]) > 1e-4
            bad = diff[real] > 5e-5 + 2e-4 * np.abs(v[real])
            assert (float(bad.mean()) if bad.size else 0.0) <= 3e-4, k


# (world, JAX's fused layers, [(gnn, ntxent_impl)]): at 2 ranks every
# pair against JAX's unchained XLA layers; at 4 ranks GIN with 'pallas' and
# GCN with the closed form against its BN-chained Pallas layers (in
# interpreter mode, the costlier compile)
DP_CASES = [(2, False, [("gin", "xla"), ("gin", "pallas"), ("gcn", "xla"),
                        ("gcn", "pallas")]),
            (4, True, [("gin", "pallas"), ("gcn", "xla")])]


@pytest.mark.parametrize("world,fused,pairs", DP_CASES,
                         ids=["2ranks", "4ranks"])
def test_dp_steps_match_jax_dp_step(tmp_path, world, fused, pairs):
    """Three DP steps of `world` port ranks against JAX's DP step on a
    `world`-device mesh, for GIN and GCN with the closed form and
    'pallas'; the ranks bit-identical to each other."""
    configs = []
    for gnn, impl in pairs:
        run = _jax_dp_run(world, gnn, impl, fused)
        configs.append(dict(
            run, name=f"{gnn}-{impl}", impl=impl, aug="node",
            batch_size=B, lr=LR, weight_decay=WD,
            model=dict(SMALL, gnn_type=gnn)))
    ranks = _run_ranks(tmp_path, "step", world, {"configs": [
        {k: v for k, v in c.items() if k != "jax"} for c in configs]})
    for c in configs:
        got = [r[c["name"]] for r in ranks]
        for r in got[1:]:
            assert r["losses"] == got[0]["losses"], c["name"]
            for s in range(3):
                for k, v in got[0]["states"][s].items():
                    assert np.array_equal(r["states"][s][k], v), \
                        (c["name"], s, k)
        port = got[0]
        p0 = c["init"]
        for s, j in enumerate(c["jax"]):
            np.testing.assert_allclose(
                port["losses"][s], j["loss"], rtol=1e-5 if s == 0 else 1e-3,
                atol=0.0 if s == 0 else 2e-5,
                err_msg=f"{c['name']} loss at step {s}")
            if s == 0:
                for k in port["grads0"]:
                    # JAX's step-0 gradient from its first moment
                    jg = (j["mu"][k].numpy() / 0.1
                          - WD * np.asarray(p0[k]))
                    np.testing.assert_allclose(port["grads0"][k], jg,
                                               rtol=2e-4, atol=1e-5,
                                               err_msg=(c["name"], k))
                    np.testing.assert_allclose(port["mu0"][k],
                                               j["mu"][k].numpy(),
                                               rtol=2e-4, atol=5e-6,
                                               err_msg=(c["name"], k))
                    np.testing.assert_allclose(port["nu0"][k],
                                               j["nu"][k].numpy(),
                                               rtol=5e-4, atol=1e-10,
                                               err_msg=(c["name"], k))
            _compare_states({k: v.numpy() for k, v in j["state"].items()},
                            port["states"][s], port["grads0"], s + 1,
                            tight=s == 0)
    # per rank and step: 2 views x 2 layers of BatchNorm sums, forward and
    # backward, the pairs' gather each way, the mask's gather, one
    # gradient mean
    per_step = 2 * 2 * SMALL["num_layers"] + 2 + 1 + 1
    assert all(r["collectives"] == per_step * 3 * len(configs)
               for r in ranks)


def test_dp_step_at_world_one_is_the_one_card_step(tmp_path):
    """At world 1 the DP step (its collectives on a one-rank gloo group)
    gives the one-card step's loss, gradients and state bit for bit."""
    configs = []
    for gnn, impl in (("gin", "xla"), ("gcn", "pallas")):
        graphs, _ = jax_featurize_many(synthetic_corpus(40, seed=6))
        spec = jax_spec_for_graphs(graphs, B, tile=SMALL["tile"])
        batches = [b for b, _, _ in JaxBatchIterator(
            graphs, spec, shuffle=True, drop_last=True, seed=0)][:2]
        kw = dict(num_layers=SMALL["num_layers"], emb_dim=SMALL["emb_dim"],
                  feat_dim=SMALL["feat_dim"], gnn_type=gnn,
                  tile=SMALL["tile"], fused=True)
        init = jax.tree_util.tree_map(np.asarray, JaxMolCLRNet(**kw).init(
            jax.random.PRNGKey(1), batches[0], train=False))
        steps = [{"batches": [_np(b)], "views": [_deltas(jax_paired_augment(
            b, jax.random.PRNGKey(s), "node", tile=SMALL["tile"],
            bond_window=spec.max_graph_bonds))]}
            for s, b in enumerate(batches)]
        configs.append(dict(
            name=f"{gnn}-{impl}", impl=impl, aug="node", batch_size=B,
            lr=LR, weight_decay=WD, model=dict(SMALL, gnn_type=gnn),
            init=state_dict_from_jax(init["params"], init["batch_stats"]),
            bond_window=spec.max_graph_bonds, steps=steps))
    (got,) = _run_ranks(tmp_path, "world1", 1, {"configs": configs})
    for c in configs:
        dp, one = got[c["name"]]["dp"], got[c["name"]]["one"]
        assert dp["losses"] == one["losses"], c["name"]
        for part in ("grads0", "mu0", "nu0"):
            for k, v in one[part].items():
                assert np.array_equal(dp[part][k], v), (c["name"], part, k)
        for s in range(len(c["steps"])):
            for k, v in one["states"][s].items():
                assert np.array_equal(dp["states"][s][k], v), (c["name"], k)


# ------------------------------------------- the Pretrainer's DP host side


def _jax_plan(smiles, cfg_kw, model_kw, world):
    """What the JAX package's multi-process code computes for each process
    index p (one device per process): its split, steps per epoch (min
    over processes), the unit spec agreed by max, U_dev (min), T, the unit
    stack and the unit rows of epochs 0 and 1; and with the batch cache,
    S (min) and _dp_epoch_orders of epoch 1."""
    tile, md, seed = model_kw["tile"], cfg_kw["max_degree"], cfg_kw["seed"]
    graphs, _ = jax_featurize_many(smiles, max_degree=md)
    order = np.random.RandomState(seed).permutation(len(graphs))
    n_valid = int(len(graphs) * cfg_kw["valid_size"])
    spec = jax_spec_for_graphs(graphs, cfg_kw["batch_size"], md,
                               tile=tile)
    per = []
    for p in range(world):
        rt = jax_csr(len(order) - n_valid, p, world)
        rv = jax_csr(n_valid, p, world)
        train = [graphs[i] for i in order[n_valid:][rt.start: rt.stop]]
        valid = [graphs[i] for i in order[:n_valid][rv.start: rv.stop]]
        it = JaxBatchIterator(train, spec, shuffle=True, drop_last=True,
                              seed=seed, cache_packed=True)
        perm = np.random.RandomState(seed + 7 * p).permutation(len(train))
        local = jax_unit_spec_for(jax_plan_units(
            [train[i] for i in perm], tile), tile, md)
        per.append(dict(train=train, valid=valid, it=it, local=local,
                        steps=max(1, len(it))))
    s_dp = min(q["steps"] for q in per)
    uspec = JaxPadSpec(
        n_graphs=max(q["local"].n_graphs for q in per), n_nodes=tile,
        n_edges=max(q["local"].n_edges for q in per), max_degree=md,
        tile=tile,
        max_graph_bonds=max(q["local"].max_graph_bonds for q in per))
    for p, q in enumerate(per):
        q["stack"], _, units = jax_pack_unit_stack(
            q["train"], tile, md, seed=seed + 7 * p, uspec=uspec)
        q["u"] = len(units)
    u_dev = min(q["u"] for q in per)
    t = u_dev // s_dp
    for p, q in enumerate(per):
        q["orders"] = [jax_unit_orders(u_dev, t, seed + 104729 * (p + 1),
                                       e)[:s_dp] for e in (0, 1)]
        for _ in q["it"]:         # one pass fills the cache (epoch 0)
            pass
    s_cache = min(len(q["it"].cache) for q in per)
    for q in per:
        fake = SimpleNamespace(train_iter=q["it"], _dp_shard_size=s_cache,
                               mesh=SimpleNamespace(shape={"data": 1}),
                               cfg=SimpleNamespace(data_axis="data"))
        q["cache_orders"] = JaxPretrainer._dp_epoch_orders(fake)[0]
    return per, dict(s_dp=s_dp, uspec=uspec, u_dev=u_dev, t=t,
                     s_cache=s_cache)


def test_pretrainer_dp_plan_matches_jax_per_process(tmp_path):
    smiles = synthetic_corpus(150, seed=8)
    cfg_kw = dict(batch_size=10, epochs=2, warm_up=0, aug="node",
                  valid_size=0.1, seed=3, max_degree=6, device_cache_mb=64,
                  eval_every_epochs=100, save_every_epochs=100)
    per, agreed = _jax_plan(smiles, cfg_kw, SMALL, world=2)
    ranks = _run_ranks(tmp_path, "plan", 2, {
        "smiles": smiles, "cfg": cfg_kw, "model": dict(SMALL),
        "tmp": str(tmp_path)})
    for p, (got, q) in enumerate(zip(ranks, per)):
        assert got["train"] == [g.n_atoms for g in q["train"]]
        assert got["valid"] == [g.n_atoms for g in q["valid"]]
        assert got["steps_per_epoch"] == agreed["s_dp"]
        assert got["uspec"] == tuple(vars(agreed["uspec"]).values())
        assert (got["n_units"], got["units_per_batch"]) == (
            agreed["u_dev"], agreed["t"])
        for f, v in got["stack"].items():
            want = np.asarray(getattr(q["stack"], f))[: agreed["u_dev"]]
            assert np.array_equal(v.astype(want.dtype), want), (p, f)
        for e in (0, 1):
            assert np.array_equal(got["orders"][e], q["orders"][e]), (p, e)
        assert got["resident"] and got["shard_size"] == agreed["s_cache"]
        from molclr_tpu_torch.parallel import cache_orders

        assert np.array_equal(
            cache_orders(got["cache_orders"], got["shard_size"]),
            q["cache_orders"])


# ------------------------------------------------------------ CLI, config


def test_cli_pretrain_two_ranks_with_resume(tmp_path):
    """Two gloo ranks through cli.pretrain --cpu --dist-*: the same losses
    on both ranks, rank 0 alone writing; then both resume from its
    checkpoint and finish the schedule."""
    yaml = tmp_path / "dp.yaml"
    yaml.write_text(
        "batch_size: 16\nepochs: 3\nwarm_up: 1\ndata_axis: data\n"
        "model: {num_layers: 2, emb_dim: 16, feat_dim: 32, tile: 32}\n")
    ck = tmp_path / "ck"

    def run(extra):
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        cmds = [[sys.executable, "-m", "molclr_tpu_torch.cli.pretrain",
                 "--config", str(yaml), "--synthetic", "160", "--cpu",
                 "--data", str(tmp_path / "corpus.txt"), "--ckpt-dir",
                 str(ck), "--dist-coordinator", f"127.0.0.1:{port}",
                 "--dist-nproc", "2", "--dist-procid", str(r),
                 "--save-every", "1", *extra] for r in range(2)]
        failed = _spawn(cmds, str(tmp_path), env, tmp_path)
        assert failed == [None, None], failed
        logs = [(tmp_path / f"rank{r}.log").read_text(errors="replace")
                for r in range(2)]
        return [[ln.split("'train_loss': ")[1].split(",")[0]
                 for ln in log.splitlines() if ln.startswith("epoch ")
                 and "train_loss" in ln] for log in logs], logs

    first, _ = run(["--stop-after-epoch", "1"])
    assert first[0] == first[1] and len(first[0]) == 1
    saved = sorted(f for f in os.listdir(ck) if f.endswith(".pt"))
    assert len(saved) == 1, saved
    step = int(saved[0][len("step_"): -len(".pt")])
    assert sorted(os.listdir(ck)) == sorted(
        ["best.pth", "config.json", "metrics.jsonl", saved[0],
         f"step_{step}.train_meta.json"])
    second, logs = run(["--resume", "latest"])
    assert second[0] == second[1] and len(second[0]) == 2
    assert all(f"at step {step}, epoch 1" in log for log in logs)
    assert f"step_{3 * step}.pt" in os.listdir(ck)


def test_data_axis_is_read_and_needs_a_group(tmp_path):
    """A YAML's data_axis reaches PretrainConfig.data_axis (the port used
    to drop it and train on one device), and a Pretrainer refuses it
    without a process group, as a group without it."""
    yaml = tmp_path / "p.yaml"
    yaml.write_text("batch_size: 8\ndata_axis: data\n")
    cfg = pretrain_from_yaml(str(yaml))
    assert cfg.data_axis == "data"
    with pytest.raises(ValueError, match="DPGroup"):
        Pretrainer(cfg, "cpu")
    with pytest.raises(ValueError, match="DPGroup"):
        Pretrainer(PretrainConfig(), "cpu", dp=object())
