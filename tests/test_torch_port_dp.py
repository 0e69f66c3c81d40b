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
  parameter and the BatchNorm stats; at 2 ranks also GIN and GCN at
  drop_ratio 0.1 on JAX's keep masks (jax_dropout_masks; the port's
  unchained trunk, its BatchNorm moments summed across the ranks in
  MaskedBatchNorm) at the same limits, and GIN in bf16 against JAX's
  BN-chained Pallas layers at BF16_LIMITS; the ranks bit-identical to
  each other; the all-reduces per step;
- at world 1, the DP step bit-identical to the one-card step on the same
  batch, views and state (collectives at world 1 add nothing);
- a 2-rank Pretrainer's split, steps per epoch, unit spec, unit stack and
  unit rows, and its batch-cache shard and cache orders, equal to what
  the JAX package's multi-process code computes for each process index
  (its helpers composed as pretrain.py:136-147, 158-181, 873-1000,
  1117-1130 compose them, with one device per process); a 2-rank
  Pretrainer run at drop_ratio 0.1 whose ranks draw the keep masks of
  their own streams, different on each rank;
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
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

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
    return _wait(_start(cmds, cwd, env, log_dir))


def _start(cmds, cwd, env, log_dir):
    """Start the commands at once, each writing to its own log file; the
    handle _wait takes, with the deadline RANK_TIMEOUT_S from now."""
    logs = [open(os.path.join(log_dir, f"rank{r}.log"), "wb")
            for r in range(len(cmds))]
    procs = [subprocess.Popen(c, cwd=cwd, env=env, stdout=f,
                              stderr=subprocess.STDOUT)
             for c, f in zip(cmds, logs)]
    return procs, logs, time.monotonic() + RANK_TIMEOUT_S


def _wait(started, kill: bool = False) -> list:
    """Wait for _start's commands until its deadline (kill: not at all),
    then kill what is left. Per command: None if it exited 0, else the
    end of its log."""
    procs, logs, deadline = started
    try:
        for p in procs:
            if kill:
                break
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


def jax_dropout_masks(model, params, stats, mesh, axis: str):
    """JAX's dropout keep masks of its DP or partitioned step on `mesh`: a
    function (views, rng, step) -> per device [view i, view j] of [N, D]
    bool masks, one per layer; views per device (vi, vj). Under shard_map
    as the step runs, each device folds (step, device) into rng and splits
    it into (rng_aug, rng_di, rng_dj), and a train-mode apply of view i with
    rng_di (view j with rng_dj) draws its layers' masks in the step's
    order. The masks depend on the keys and the shapes alone: the capture
    applies params with every BatchNorm bias at 10, so that each Dropout's
    input is nonzero on every real row and its output nonzero exactly
    where kept (a padding row's input is zero in either package, so its
    mask moves nothing). Compiled once for all steps."""
    layers = model.num_layers
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: np.full_like(x, 10.0)
        if path[-1].key == "bias" and str(path[-2].key).startswith("bn_")
        else x, params)

    def local(params, stats, vi, vj, rng, step):
        one = lambda t: jax.tree_util.tree_map(lambda x: x[0], t)  # noqa
        r = jax.random.fold_in(jax.random.fold_in(rng, step),
                               jax.lax.axis_index(axis))
        _, rdi, rdj = jax.random.split(r, 3)
        out = []
        for v, key in ((one(vi), rdi), (one(vj), rdj)):
            _, upd = model.apply({"params": params, "batch_stats": stats},
                                 v, train=True, rngs={"dropout": key},
                                 mutable=["batch_stats", "intermediates"],
                                 capture_intermediates=True)
            trunk = upd["intermediates"]["trunk"]
            out.append(jnp.stack([trunk[f"Dropout_{i}"]["__call__"][0] != 0
                                  for i in range(layers)]))
        return jnp.stack(out)[None]

    a = P(axis)
    fn = jax.jit(shard_map(local, mesh=mesh,
                           in_specs=(P(), P(), a, a, P(), P()),
                           out_specs=a, check_vma=False))

    def masks(views, rng, step: int) -> list:
        got = np.asarray(fn(params, stats,
                            stack_batches([v[0] for v in views]),
                            stack_batches([v[1] for v in views]), rng,
                            jnp.int32(step)))
        return [[list(view) for view in dev] for dev in got]

    return masks


def _jax_dp_run(world: int, gnn: str, impl: str, fused: bool,
                drop: float = 0.0, bf16: bool = False, steps: int = 3):
    """JAX's build_dp_pretrain_step on a `world`-device CPU mesh (fused:
    the BN-chained Pallas layers in interpreter mode, else the unchained
    XLA layers with classic BatchNorm; drop: the model's dropout rate;
    bf16: bfloat16 activations): the initial state, per step each device's
    batch, views and (drop > 0) dropout keep masks, and after each step
    the loss and the state."""
    graphs, _ = jax_featurize_many(synthetic_corpus(80, seed=5))
    spec = jax_spec_for_graphs(graphs, B, tile=SMALL["tile"])
    batches = [b for b, _, _ in JaxBatchIterator(graphs, spec, shuffle=True,
                                                 drop_last=True, seed=0)]
    kw = dict(num_layers=SMALL["num_layers"], emb_dim=SMALL["emb_dim"],
              feat_dim=SMALL["feat_dim"], gnn_type=gnn, tile=SMALL["tile"],
              fused=fused, drop_ratio=drop,
              dtype=jnp.bfloat16 if bf16 else jnp.float32)
    init = JaxMolCLRNet(**kw).init(jax.random.PRNGKey(0), batches[0],
                                   train=False)
    host = jax.tree_util.tree_map(np.asarray, init)
    tx = jax_adam_torch(LR, WD)
    state = TrainState(params=host["params"],
                       batch_stats=host["batch_stats"],
                       opt_state=tx.init(host["params"]), step=0)
    bw = spec.max_graph_bonds
    model, mesh = JaxMolCLRNet(bn_axis_name="data", **kw), make_mesh(world)
    step_fn = build_dp_pretrain_step(
        model, tx, mesh, aug="node", axis="data", tile=SMALL["tile"],
        bond_window=bw, ntxent_impl=impl, ntxent_interpret=True)
    rng = jax.random.PRNGKey(9)
    if drop:
        masks = jax_dropout_masks(model, host["params"], host["batch_stats"],
                                  mesh, "data")
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
        if drop:
            run["steps"][-1]["masks"] = masks(views, rng, s)
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


# bf16 against JAX, BF16_LIMITS: the limits of the port's one-card bf16
# step checks (chip_smoke.py's STEP_* at bf16, a step on the card against
# the same step on the CPU) and of its bf16 comparisons with JAX
# (BF16_RTOL = 3e-2 in tests/test_torch_port_gcn_pretrain.py and
# test_torch_port_train_ops.py), applied as the f32 step parity applies its
# own (the two runs step on from their own states): one bf16 rounding that
# flips between the two implementations moves what follows by a bf16 ulp,
# 2^-8, and XLA on the CPU sums a bf16 broadcast's cotangent in bf16
# partials where PyTorch sums in f32 (ROADMAP.md queue 3), which the
# BatchNorm backward amplifies. So: the loss within one bf16 ulp (2^-8)
# relative at every step (the projections are bf16); each step-0
# gradient, first and second moment within STEP_GRAD_RTOL[bf16] = 0.15 of
# the model's largest; every parameter within Adam's sign-flip envelope at
# every step, and at step 0 within 5e-5 + 2e-4 |p| on all but
# max(1, ceil(STEP_FRAC_OFF[bf16] n)) of its n elements with a real
# gradient (above 1e-4 and STEP_GRAD_NOISE[bf16] = 2e-2 of the largest);
# the BatchNorm running stats within BF16_RTOL of max(1, max|jax|) at
# every step.
BF16_RTOL = 3e-2
BF16_LIMITS = dict(loss_rtol=2.0 ** -8, grad_rtol=0.15, frac_off=1e-2,
                   grad_noise=2e-2, bn_rtol=BF16_RTOL)


def adam_step_bound(t: int, b1: float = 0.9, b2: float = 0.999) -> float:
    """The largest |m_hat / sqrt(v_hat)| of Adam's t-th update over all
    gradient histories (chip_smoke.py's adam_step_bound): 1 at t = 1."""
    w = [(1 - b1) * b1 ** (t - i) / (1 - b1 ** t) for i in range(1, t + 1)]
    u = [(1 - b2) * b2 ** (t - i) / (1 - b2 ** t) for i in range(1, t + 1)]
    return sum(a * a / c for a, c in zip(w, u)) ** 0.5


def bf16_step_errors(s, port, j, p0, jstate) -> dict:
    """The quantities BF16_LIMITS holds at step s of a configuration, each
    as a share of its limit's scale: loss (relative), grads0 / mu0 / nu0
    (over the model's largest), envelope (over Adam's envelope after s + 1
    steps), off (step 0: elements off over those allowed), bn (over
    max(1, max|jax|))."""
    out = {"loss": abs(port["losses"][s] - j["loss"]) / abs(j["loss"])}
    g0 = port["grads0"]
    gtop = max(np.abs(v).max() for v in g0.values())
    if s == 0:
        grads = {k: j["mu"][k].numpy() / 0.1 - WD * np.asarray(p0[k])
                 for k in g0}
        for part, want in (("grads0", grads),
                           ("mu0", {k: v.numpy()
                                    for k, v in j["mu"].items()}),
                           ("nu0", {k: v.numpy()
                                    for k, v in j["nu"].items()})):
            top = max(np.abs(v).max() for v in want.values())
            out[part] = max(np.abs(port[part][k] - v).max() / top
                            for k, v in want.items())
    # each update moves an element by at most lr adam_step_bound(t), so two
    # runs whose gradients flip sign part by twice that per step (and the
    # f32 rounding of p)
    cap = 2.0 * LR * sum(adam_step_bound(t) for t in range(1, s + 2))
    off, env, bn = 0.0, 0.0, 0.0
    for k, v in jstate.items():
        v = np.asarray(v, np.float64)
        diff = np.abs(np.asarray(port["states"][s][k], np.float64) - v)
        if "running_" in k:
            bn = max(bn, diff.max() / max(1.0, np.abs(v).max()))
            continue
        env = max(env, diff.max() / (cap + 2.0 ** -22 * np.abs(v).max()))
        real = np.abs(g0[k]) > max(1e-4, BF16_LIMITS["grad_noise"] * gtop)
        bad = diff[real] > 5e-5 + 2e-4 * np.abs(v[real])
        if s == 0 and bad.size:
            allowed = np.ceil(BF16_LIMITS["frac_off"] * bad.size)
            off = max(off, bad.sum() / max(1.0, allowed))
    out.update(envelope=env, off=off, bn=bn)
    return out


def _bf16_step_agrees(name, s, port, j, p0, jstate) -> None:
    e, lim = bf16_step_errors(s, port, j, p0, jstate), BF16_LIMITS
    assert e["loss"] <= lim["loss_rtol"], (name, s, e)
    for part in ("grads0", "mu0", "nu0"):
        assert e.get(part, 0.0) <= lim["grad_rtol"], (name, s, part, e)
    assert e["envelope"] <= 1.0 and e["off"] <= 1.0, (name, s, e)
    assert e["bn"] <= lim["bn_rtol"], (name, s, e)


def steps_against_jax(name, port, jax_steps, p0, bf16=False):
    """A configuration's port steps (a rank's record) against JAX's: the
    loss, the step-0 gradients (from JAX's first moment) and Adam moments,
    the state after each step. f32: tests/test_torch_port_pretrain.py's
    step-parity limits (_compare_states). bf16: BF16_LIMITS."""
    for s, j in enumerate(jax_steps):
        jstate = {k: v.numpy() for k, v in j["state"].items()}
        if bf16:
            _bf16_step_agrees(name, s, port, j, p0, jstate)
            continue
        np.testing.assert_allclose(
            port["losses"][s], j["loss"], rtol=1e-5 if s == 0 else 1e-3,
            atol=0.0 if s == 0 else 2e-5, err_msg=f"{name} loss at step {s}")
        if s == 0:
            for k in port["grads0"]:
                # JAX's step-0 gradient from its first moment
                jg = j["mu"][k].numpy() / 0.1 - WD * np.asarray(p0[k])
                np.testing.assert_allclose(port["grads0"][k], jg,
                                           rtol=2e-4, atol=1e-5,
                                           err_msg=(name, k))
                np.testing.assert_allclose(port["mu0"][k],
                                           j["mu"][k].numpy(), rtol=2e-4,
                                           atol=5e-6, err_msg=(name, k))
                np.testing.assert_allclose(port["nu0"][k],
                                           j["nu"][k].numpy(), rtol=5e-4,
                                           atol=1e-10, err_msg=(name, k))
        _compare_states(jstate, port["states"][s], port["grads0"], s + 1,
                        tight=s == 0)


def ranks_identical(ranks, name):
    """The configuration's records of every rank, equal bit for bit (the
    losses and every state); rank 0's."""
    got = [r[name] for r in ranks]
    for r in got[1:]:
        assert r["losses"] == got[0]["losses"], name
        for s, st in enumerate(got[0]["states"]):
            for k, v in st.items():
                assert np.array_equal(r["states"][s][k], v), (name, s, k)
    return got[0]


# (world, [(gnn, ntxent_impl, JAX's fused layers, drop_ratio, bf16)]): at
# 2 ranks every pair against JAX's unchained XLA layers, GIN and GCN with
# dropout 0.1 on JAX's keep masks (the port's unchained trunk: K4f / K4b or
# K5f / K5b and the cross-rank BatchNorm between them) against the same,
# and GIN in bf16 against JAX's BN-chained Pallas layers (interpreter
# mode, the port's K1f / K1b path); at 4 ranks GIN with 'pallas' and GCN
# with the closed form against its BN-chained Pallas layers
DP_CASES = [(2, [("gin", "xla", False, 0.0, False),
                 ("gin", "pallas", False, 0.0, False),
                 ("gcn", "xla", False, 0.0, False),
                 ("gcn", "pallas", False, 0.0, False),
                 ("gin", "xla", False, 0.1, False),
                 ("gcn", "xla", False, 0.1, False),
                 ("gin", "xla", True, 0.0, True)]),
            (4, [("gin", "pallas", True, 0.0, False),
                 ("gcn", "xla", True, 0.0, False)])]


@pytest.mark.parametrize("world,cases", DP_CASES, ids=["2ranks", "4ranks"])
def test_dp_steps_match_jax_dp_step(tmp_path, world, cases):
    """Three DP steps of `world` port ranks against JAX's DP step on a
    `world`-device mesh, for GIN and GCN with the closed form and
    'pallas', with dropout 0.1 (JAX's masks) and in bf16; the ranks
    bit-identical to each other; the all-reduces per step."""
    configs = []
    for gnn, impl, fused, drop, bf16 in cases:
        run = _jax_dp_run(world, gnn, impl, fused, drop, bf16)
        configs.append(dict(
            run, name=f"{gnn}-{impl}-{drop}-{'bf16' if bf16 else 'f32'}",
            impl=impl, aug="node", batch_size=B, lr=LR, weight_decay=WD,
            bf16=bf16, model=dict(SMALL, gnn_type=gnn, drop_ratio=drop,
                                  bf16=bf16)))
    ranks = _run_ranks(tmp_path, "step", world, {"configs": [
        {k: v for k, v in c.items() if k != "jax"} for c in configs]})
    for c in configs:
        port = ranks_identical(ranks, c["name"])
        steps_against_jax(c["name"], port, c["jax"], c["init"], c["bf16"])
    # per rank and step: 2 views x 2 layers of BatchNorm sums, forward and
    # backward, the pairs' gather each way, the mask's gather, one
    # gradient mean; the unchained trunk (dropout) sums its moments in
    # MaskedBatchNorm, one all-reduce each way as the chained trunk's
    # coefficient mode, so its count is the same
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


@pytest.fixture(scope="module")
def plan_run(tmp_path_factory):
    """Two ranks of the `plan` mode (and its dropout run: one epoch at
    drop_ratio 0.1) with JAX's per-process plan of the same corpus."""
    tmp = tmp_path_factory.mktemp("plan")
    smiles = synthetic_corpus(150, seed=8)
    cfg_kw = dict(batch_size=10, epochs=2, warm_up=0, aug="node",
                  valid_size=0.1, seed=3, max_degree=6, device_cache_mb=64,
                  eval_every_epochs=100, save_every_epochs=100)
    drop_kw = dict(cfg_kw, epochs=1)
    ranks = _run_ranks(tmp, "plan", 2, {
        "smiles": smiles, "cfg": cfg_kw, "model": dict(SMALL),
        "drop_cfg": drop_kw, "drop_model": dict(SMALL, drop_ratio=0.1),
        "tmp": str(tmp)})
    return ranks, _jax_plan(smiles, cfg_kw, SMALL, world=2)


def test_pretrainer_dp_plan_matches_jax_per_process(plan_run):
    ranks, (per, agreed) = plan_run
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


def test_pretrainer_dp_dropout_masks_differ_by_rank(plan_run):
    """A 2-rank Pretrainer run with drop_ratio 0.1 (units path, eager on
    the CPU): each rank's train steps draw the keep masks of its own
    streams step_generator(seed, DROPOUT_STREAM, step, view, rank), and
    the two ranks' masks differ at every step and view (ranks that shared
    their masks would correlate their dropout, which JAX's per-device
    fold_in rules out)."""
    ranks, _ = plan_run
    drawn = [r["dropout"]["drawn"] for r in ranks]
    assert drawn[0].keys() == drawn[1].keys() and len(drawn[0]) >= 2
    for r in ranks:
        d = r["dropout"]
        for step, views in d["drawn"].items():
            for got, want in zip(views, d["stream"][step]):
                assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                    step
    for step in drawn[0]:
        for v0, v1 in zip(drawn[0][step], drawn[1][step]):
            for a, b in zip(v0, v1):
                n = min(a.shape[0], b.shape[0])
                assert not torch.equal(a[:n], b[:n]), step


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
