"""The port's seed ensembles and batched targets against the JAX FineTuner's
vmapped member program, on the CPU.

Member m = t * n_seeds + s trains on target column t from seed s. The
data side (labels, splits, per-column normalizers, the split stacks and
the frozen-composition orders) equals JAX's exactly; three member steps
match JAX's `_multi_train` from JAX's member states (carried over member
by member with `state_dict_from_jax`), one of them with dropout 0.3 given
JAX's masks; evaluate matches JAX's on the same state; a whole run's
per-column test metrics match JAX's vmapped run. Then the port's own
invariants, bit for bit with dropout 0.3: member (t, 0) is the one-seed
run on column t, one Adam over all members is M Adams, same-seed members
start equal across columns and diverge, frozen compositions upload the
train stack once; the CLI's CSV rows with --n-seeds; the single-group
Adam of quirk Q6.

Small sizes (tests/test_torch_port_finetune.py's SMALL: 2 layers, emb 16,
feat 32, tile 64), synthetic task CSVs; JAX runs its default CPU model
(the fused layers' plain reference). Tolerances: member steps as the
one-member steps of tests/test_torch_port_finetune.py (loss rtol 1e-5 at
step 0 and 1e-4 after, its `_compare` limits on the parameters and
BatchNorm stats); metrics of the same state within 1e-6; a whole run's
test metric within 5e-4 of JAX's, the bound JAX's own vmapped-against-
sequential test uses; the port's invariants exactly.
"""

import copy
import csv
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molclr_tpu.data import tasks as jax_tasks
from molclr_tpu.data.tasks import TaskSpec as JaxTaskSpec
from molclr_tpu.train import checkpoints as jax_ckpt
from molclr_tpu.train import finetune as jax_finetune
from molclr_tpu.train.config import FineTuneConfig as JaxFineTuneConfig
from molclr_tpu.train.config import ModelConfig as JaxModelConfig
from molclr_tpu.train.optim import two_group_adam as jax_two_group_adam
from molclr_tpu_torch.cli import finetune as port_cli
from molclr_tpu_torch.data import tasks as port_tasks
from molclr_tpu_torch.data.graphs import GraphBatch
from molclr_tpu_torch.data.tasks import TaskSpec
from molclr_tpu_torch.models import FineTuneNet
from molclr_tpu_torch.train import checkpoints as ckpt_lib
from molclr_tpu_torch.train import finetune as port_finetune
from molclr_tpu_torch.train.config import FineTuneConfig, ModelConfig
from molclr_tpu_torch.train.finetune import FineTuner, run_all_targets, \
    train_step
from molclr_tpu_torch.train.optim import two_group_adam
from test_torch_port_finetune import SMALL, _compare, _jax_state

CLINTOX = ["CT_TOX", "FDA_APPROVED"]
LOG = lambda *_: None  # noqa: E731


def _cfgs(tmp, drop=0.0, gnn="gin", **kw):
    """The same run as (JAX config, port config)."""
    base = dict(task_name="ClinTox", data_root=str(tmp / "data"),
                synthetic_fallback=True, synthetic_n=240, batch_size=16,
                epochs=2, ckpt_dir=str(tmp / "ck"))
    base.update(kw)
    return (JaxFineTuneConfig(model=JaxModelConfig(
                gnn_type=gnn, drop_ratio=drop, **SMALL), **base),
            FineTuneConfig(model=ModelConfig(
                gnn_type=gnn, drop_ratio=drop, **SMALL), **base))


def _pair(tmp, targets=CLINTOX, state=True, **kw):
    """A JAX FineTuner and the port's on the CPU, set up from the same
    config; the example batch JAX's caller draws before setup_state is
    the one the port's setup_state draws."""
    jcfg, pcfg = _cfgs(tmp, **kw)
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        jft = jax_finetune.FineTuner(jcfg, targets=targets).setup_data()
    port = FineTuner(pcfg, "cpu", targets=targets).setup_data()
    if state:
        jft.setup_state(next(iter(jft.iters["train"]))[0])
        port.setup_state()
    jft._build_steps()
    return jft, port


def _batch_fields(gb):
    return {f.name: np.asarray(getattr(gb, f.name))
            for f in dataclasses.fields(GraphBatch)}


def _assert_stacks_equal(port_host, jax_stack):
    gb, lab, mi, mm = port_host
    jb, jlab, jmi, jmm = jax.tree_util.tree_map(np.asarray, jax_stack)
    for name, v in _batch_fields(gb).items():
        assert np.array_equal(v, np.asarray(getattr(jb, name))), name
    for got, want in ((lab, jlab), (mi, jmi), (mm, jmm)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _load_jax_members(port, state):
    """JAX's stacked member state carried into the port's members."""
    for m, model in enumerate(port.models):
        member = jax.tree_util.tree_map(lambda x, m=m: x[m], state)
        got = ckpt_lib.transfer_state(_jax_state(member), model)
        assert got["skipped"] == []


def _member(state, m):
    return jax.tree_util.tree_map(lambda x: x[m], state)


def _syn2r(monkeypatch):
    """A two-column regression task with z-scored labels (JAX's
    TestBatchedTargets::test_regression_per_target_normalizers)."""
    args = ("Syn2R", "regression", "syn2r/syn2r.csv", ("prop_a", "prop_b"),
            "mse", "rmse")
    kw = dict(normalize_labels=True, add_hs=False)
    monkeypatch.setitem(jax_tasks.TASKS, "Syn2R", JaxTaskSpec(*args, **kw))
    monkeypatch.setitem(port_tasks.TASKS, "Syn2R", TaskSpec(*args, **kw))
    assert jax_finetune.TASKS is jax_tasks.TASKS
    assert port_finetune.TASKS is port_tasks.TASKS
    return ["prop_a", "prop_b"]


# ------------------------------------------------------------------- data


# the steps run between two _train_epoch_stack calls, as row slices: none;
# the benchmark harness's split of an epoch; that split with epoch 1 cut
# short, fewer steps than batches
STEPS = {None: None, "ahead": [(0, 1), (1, 3), (3, None)],
         "short": [(0, 1), (1, 3)]}


@pytest.mark.parametrize("task,repack,steps,motifs", [
    pytest.param("ClinTox", True, None, False, id="ClinTox-True"),
    pytest.param("ClinTox", False, None, False, id="ClinTox-False"),
    pytest.param("Syn2R", False, None, False, id="Syn2R-False"),
    pytest.param("ClinTox", True, "ahead", False, id="ClinTox-True-ahead"),
    pytest.param("ClinTox", True, "short", False, id="ClinTox-True-short"),
    pytest.param("ClinTox", True, "ahead", True, id="ClinTox-True-motifs"),
])
def test_data_and_stacks_equal_jax(tmp_path, monkeypatch, task, repack,
                                   steps, motifs):
    """Labels [n, T] (the qm9 scale aside), splits, per-column
    normalizers, the valid stack and two epochs' train stacks and orders
    (fresh compositions, or cached_epoch_order over frozen ones). With
    `steps`, the port's steps run between the epochs (so the next epoch's
    batches are packed between their launches, the rest at the boundary
    where an epoch is cut short) and three epochs' stacks and orders are
    held to JAX's; `motifs` adds the motif head's ids and mask."""
    targets = _syn2r(monkeypatch) if task == "Syn2R" else CLINTOX
    jft, port = _pair(tmp_path, targets, state=steps is not None,
                      task_name=task, repack_each_epoch=repack,
                      use_motifs=motifs)
    assert port.n_members == jft.n_members == 2
    assert port.labels.shape == (len(port.smiles), 2)
    assert np.array_equal(port.labels, jft.labels)
    assert np.array_equal(port.train_labels, jft.train_labels)
    assert port.split == jft.split
    if task == "Syn2R":
        assert [(n.mean, n.std) for n in port.normalizers] == \
            [(n.mean, n.std) for n in jft.normalizers]
        assert port.normalizers[0].mean != port.normalizers[1].mean
    else:
        assert port.normalizers is None and jft.normalizers is None
    valid = port._epoch_stack("valid")
    _assert_stacks_equal(
        (GraphBatch(**{k: v.numpy() for k, v in valid.batches.items()}),
         valid.labels.numpy(), valid.motif_ids.numpy(),
         valid.motif_mask.numpy()),
        jft._split_stack("valid"))
    epochs = 2 if steps is None else 3
    for epoch in range(epochs):
        p_stack, p_order = port._train_epoch_stack()
        j_stack, j_order = jft._train_epoch_stack()
        assert np.array_equal(p_order, j_order)
        got = {k: v.numpy() for k, v in p_stack.tensors().items()}
        jb, jlab, jmi, jmm = jax.tree_util.tree_map(np.asarray, j_stack)
        for name, v in _batch_fields(jb).items():
            assert got[name].dtype == v.dtype, name
            assert np.array_equal(got[name], v), name
        for name, want in (("labels", jlab), ("motif_ids", jmi),
                           ("motif_mask", jmm)):
            assert got[name].dtype == want.dtype
            assert np.array_equal(got[name], want), name
        if motifs:
            assert got["motif_mask"].any()
        if steps is None:
            continue
        cut = STEPS[steps] if epoch == 1 else STEPS["ahead"]
        ran = len(p_order) if epoch != 2 or steps == "ahead" else 3
        assert port.packed_ahead == (0 if epoch == 0 else ran)
        rows = torch.from_numpy(np.asarray(p_order, np.int64)[:, None])
        for lo, hi in cut:
            assert np.isfinite(port._run_steps(rows[lo:hi]).numpy()).all()
    if not repack:
        assert not np.array_equal(p_order, np.arange(len(p_order)))
    assert port.uploads["train"] == (epochs if repack else 1)


def test_rows_that_differ_raise_and_run_all_targets_loops(tmp_path):
    """Columns that keep different rows: the multi-target FineTuner
    raises JAX's ValueError, and run_all_targets logs JAX's line and runs
    the per-target loop."""
    jcfg, pcfg = _cfgs(tmp_path, epochs=1, synthetic_n=120)
    path = Path(pcfg.data_root) / port_tasks.TASKS["ClinTox"].data_path
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        port_finetune.resolve_task_csv(pcfg, port_tasks.TASKS["ClinTox"])
    rows = list(csv.reader(path.open()))
    col = rows[0].index("FDA_APPROVED")
    for r in rows[1:6]:
        r[col] = ""
    with path.open("w", newline="") as f:
        csv.writer(f).writerows(rows)
    errors = []
    for make in (lambda: jax_finetune.FineTuner(jcfg, targets=CLINTOX),
                 lambda: FineTuner(pcfg, "cpu", targets=CLINTOX)):
        with pytest.raises(ValueError) as e:
            make().setup_data()
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "different rows" in errors[0]
    lines = []
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path)
        results = run_all_targets(pcfg, "cpu", log=lines.append)
    assert "[ClinTox] target columns keep different rows; falling back " \
        "to the sequential per-target loop" in lines
    assert [r["target"] for r in results] == CLINTOX


# ------------------------------------------------------- steps and eval


def test_member_steps_and_evaluate_match_jax(tmp_path):
    """ClinTox, 2 seeds: M = 4 members. JAX's stacked member state carried
    into the port; three steps of the port's members against JAX's
    `_multi_train` over the same stack rows (drop_ratio 0), member by
    member; then evaluate on the same state."""
    jft, port = _pair(tmp_path, n_seeds=2)
    assert port.n_members == 4
    _load_jax_members(port, jft.state)
    j_stack, _ = jft._train_epoch_stack()
    p_stack, _ = port._train_epoch_stack()
    assert np.array_equal(p_stack.labels.numpy(), np.asarray(j_stack[1]))
    cfg = jft.cfg
    lr = max(cfg.init_lr, cfg.init_base_lr)
    state, grads0 = jft.state, None
    for step in range(3):
        state, jloss = jft._multi_train(
            state, j_stack, jnp.asarray([step], jnp.int32),
            jax.random.PRNGKey(17))
        loss = port._step(0, torch.tensor([step]))
        np.testing.assert_allclose(loss.numpy(), np.asarray(jloss)[0],
                                   rtol=1e-5 if step == 0 else 1e-4,
                                   err_msg=f"losses at step {step}")
        if step == 0:
            grads0 = [{k: p.grad.numpy().copy()
                       for k, p in model.named_parameters()}
                      for model in port.models]
        for m, model in enumerate(port.models):
            _compare(_jax_state(_member(state, m)), model, grads0[m],
                     step + 1, lr, tight=step == 0)
    for split in ("valid", "test"):
        got = port.evaluate(split)
        want = jft.evaluate(split, state=state)
        assert got["n"] == want["n"] > 0
        assert set(got) == set(want)
        for key in ("metric", "std"):
            assert abs(got[key] - want[key]) <= 1e-6, (key, got, want)
        np.testing.assert_allclose(got["per_member"], want["per_member"],
                                   rtol=0, atol=1e-6)
        for a, b in zip(got["per_target"], want["per_target"]):
            assert a["target"] == b["target"]
            np.testing.assert_allclose(
                [a["metric"], a["std"], *a["per_seed"]],
                [b["metric"], b["std"], *b["per_seed"]], rtol=0, atol=1e-6)


def _jax_member_masks(jft, state, item, rng):
    """JAX's dropout keep masks of each member at its step (the vmapped
    step folds member m's key split(rng, n_seeds)[m % n_seeds] with its
    step count): the Dropout outputs of a train-mode apply of the member
    with captured intermediates are non-zero exactly where kept."""
    batch = item[0]
    keys = jax.random.split(rng, jft.cfg.n_seeds)
    out = []
    for m in range(jft.n_members):
        member = _member(state, m)
        _, upd = jft.model.apply(
            {"params": member.params, "batch_stats": member.batch_stats},
            batch, train=True, mutable=["batch_stats", "intermediates"],
            capture_intermediates=True,
            rngs={"dropout": jax.random.fold_in(
                keys[m % jft.cfg.n_seeds], member.step)})
        trunk = upd["intermediates"]["trunk"]
        out.append([torch.from_numpy(np.asarray(
            trunk[f"Dropout_{i}"]["__call__"][0]) != 0)
            for i in range(SMALL["num_layers"])])
    return out


def test_dropout_member_step_matches_jax(tmp_path):
    """BBBP with 3 seeds (M = 3, one column), dropout 0.3: one member step
    fed JAX's per-member masks against `_multi_train`, then evaluate
    (per_seed) on the same state."""
    jft, port = _pair(tmp_path, targets=None, drop=0.3, task_name="BBBP",
                      n_seeds=3)
    _load_jax_members(port, jft.state)
    j_stack, _ = jft._train_epoch_stack()
    port._train_epoch_stack()
    rng = jax.random.PRNGKey(17)
    item = jax.tree_util.tree_map(lambda x: np.asarray(x)[0], j_stack)
    masks = _jax_member_masks(jft, jft.state, item, rng)
    state, jloss = jft._multi_train(jft.state, j_stack,
                                    jnp.asarray([0], jnp.int32), rng)
    batch, labels, motifs = port._take(port._stacks["train"],
                                       torch.tensor([0]))
    loss = train_step(port.models, port.opt, batch, labels, motifs, "ce",
                      seed_masks=masks, n_seeds=3)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss)[0],
                               rtol=1e-5)
    lr = max(jft.cfg.init_lr, jft.cfg.init_base_lr)
    for m, model in enumerate(port.models):
        grads0 = {k: p.grad.numpy() for k, p in model.named_parameters()}
        _compare(_jax_state(_member(state, m)), model, grads0, 1, lr,
                 tight=True)
    got, want = port.evaluate("valid"), jft.evaluate("valid", state=state)
    assert "per_target" not in got and set(got) == set(want)
    np.testing.assert_allclose(
        [got["metric"], got["std"], *got["per_seed"]],
        [want["metric"], want["std"], *want["per_seed"]], rtol=0, atol=1e-6)


def test_whole_run_matches_jax_vmapped(tmp_path):
    """ClinTox, both columns in one run (drop_ratio 0, 3 epochs) from JAX's
    initial member states: each column's test metric within 5e-4 of JAX's
    vmapped run, the same result schema; each member's best state
    dominates its final epoch on the validation split."""
    jft, port = _pair(tmp_path, epochs=3)
    _load_jax_members(port, jft.state)
    want = jft.train(log=LOG)
    got = port.train(log=LOG)
    assert [r["target"] for r in got["per_target"]] == CLINTOX
    assert set(got) == set(want) | {"history"}
    for a, b in zip(got["per_target"], want["per_target"]):
        assert set(a) == set(b)
        assert np.isfinite(b["test_metric"])
        np.testing.assert_allclose(a["test_metric"], b["test_metric"],
                                   rtol=5e-4, atol=5e-4)
    assert [set(r) for r in got["history"]] == \
        [set(r) | {"steps", "train_s", "packed_ahead"}
         for r in want["history"]]
    assert [r["packed_ahead"] for r in got["history"]] == [0.0, 1.0, 1.0]
    direction = port_finetune.METRIC_DIRECTION[port.task.metric]
    final = port.evaluate("valid", state=port.final_state)["per_member"]
    best = port.evaluate("valid", state=port.best_state)["per_member"]
    assert all(direction * b >= direction * f for b, f in zip(best, final))


# ------------------------------------------------- the port's invariants


def _tuner(tmp, targets=CLINTOX, **kw):
    _, pcfg = _cfgs(tmp, drop=0.3, **kw)
    return FineTuner(pcfg, "cpu", targets=targets).setup_data().setup_state()


def _state_equal(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k])
                                          for k in sa)


@pytest.mark.filterwarnings("ignore:task CSV")
def test_member_t0_equals_the_one_seed_run(tmp_path):
    """ClinTox 2 x 2 with dropout 0.3: after an epoch, member (t, 0) is
    bit for bit the one-seed run on column t (same losses, parameters and
    BatchNorm stats), and member (t, 1) is not."""
    ens = _tuner(tmp_path, n_seeds=2)
    losses = ens._train_epoch()
    assert losses.shape[1] == 4
    for t, target in enumerate(CLINTOX):
        one = _tuner(tmp_path, targets=[target])
        assert one.n_members == 1
        one_losses = one._train_epoch()
        assert np.array_equal(one_losses[:, 0], losses[:, 2 * t])
        assert _state_equal(one.model, ens.models[2 * t])
        assert not _state_equal(one.model, ens.models[2 * t + 1])


@pytest.mark.filterwarnings("ignore:task CSV")
def test_one_adam_over_members_equals_separate_adams(tmp_path):
    """Three steps of all members under one two-group Adam against each
    member under its own, from the same states with the same masks: bit
    for bit."""
    ft = _tuner(tmp_path, n_seeds=2)
    ft._train_epoch_stack()
    alone = [copy.deepcopy(model) for model in ft.models]
    opts = [two_group_adam(model, ft.cfg.init_lr, ft.cfg.init_base_lr,
                           ft.cfg.weight_decay) for model in alone]
    for step in range(3):
        batch, labels, motifs = ft._take(ft._stacks["train"],
                                         torch.tensor([step]))
        masks = ft.seed_masks(batch.num_nodes)
        together = train_step(ft.models, ft.opt, batch, labels, motifs,
                              "ce", masks, n_seeds=2)
        for m, (model, opt) in enumerate(zip(alone, opts)):
            t, s = divmod(m, 2)
            loss = train_step([model], opt, batch, labels[:, t], motifs,
                              "ce", [masks[s]])
            assert torch.equal(loss[0], together[m])
    for model, ref in zip(ft.models, alone):
        assert _state_equal(model, ref)


@pytest.mark.filterwarnings("ignore:task CSV")
def test_same_seed_members_start_equal_and_diverge(tmp_path):
    """m = t * S + s: members of one seed are equal across the columns at
    init, those of two seeds differ; training on different columns makes
    the same-seed members differ."""
    ft = _tuner(tmp_path, n_seeds=2)
    a, b, c, d = ft.models
    assert _state_equal(a, c) and _state_equal(b, d)
    assert not _state_equal(a, b)
    ft._train_epoch()
    assert not _state_equal(a, c) and not _state_equal(b, d)


@pytest.mark.filterwarnings("ignore:task CSV")
@pytest.mark.parametrize("repack", [True, False])
def test_train_stack_uploads(tmp_path, repack):
    """repack_each_epoch False uploads the train stack once and takes each
    epoch's order from cached_epoch_order (seeded by the iterator's epoch
    count: setup_state's example batch, the pass that fills the cache,
    then one per epoch); True refills the same buffers every epoch, in
    the iterator's order. Of each repacked stack's S rows, packed_ahead
    were packed during the previous epoch's steps and packed_late at the
    epoch boundary: all late at the first epoch and at a call with no
    steps before it, all ahead after an epoch that ran all its steps;
    both 0 without repacking."""
    ft = _tuner(tmp_path, repack_each_epoch=repack)
    orders, counts = [], []
    inner = ft._train_epoch_stack

    def recording():
        stack, order = inner()
        orders.append((stack, order))
        counts.append((ft.packed_ahead, ft.packed_late))
        return stack, order

    ft._train_epoch_stack = recording
    for _ in range(3):
        assert np.isfinite(ft._train_epoch()).all()
    stacks = {id(s) for s, _ in orders}
    assert len(stacks) == 1
    assert ft.uploads["train"] == (3 if repack else 1)
    n = len(ft.iters["train"])
    for e, (_, order) in enumerate(orders):
        want = (np.random.RandomState(ft.cfg.seed + 2 + e).permutation(n)
                if not repack else np.arange(n))
        assert np.array_equal(order, want)
    ft._train_epoch_stack()                   # after a whole epoch
    ft._train_epoch_stack()                   # with no steps before it
    assert counts == ([(0, n)] + [(n, 0)] * 3 + [(0, n)] if repack
                      else [(0, 0)] * 5)


# ---------------------------------------------------------- CLI, optimizer


def test_cli_n_seeds_writes_the_jax_csv_rows(tmp_path, monkeypatch):
    """`--n-seeds 2 --cpu` on synthetic ClinTox: one run over both
    columns; one CSV row per column in the JAX package's format (target,
    metric, std over the seeds, synthetic=true); RESULT lines with the
    std."""
    monkeypatch.chdir(tmp_path)
    Path("small.yaml").write_text(
        "batch_size: 16\nepochs: 1\nmodel:\n  num_layer: 2\n  emb_dim: 16\n"
        "  feat_dim: 32\n  tile: 64\n")
    out = []
    monkeypatch.setattr("builtins.print", lambda *a, **k: out.append(
        " ".join(map(str, a))))
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        assert port_cli.main(["--config", "small.yaml", "--task", "ClinTox",
                              "--allow-synthetic", "--n-seeds", "2",
                              "--cpu"]) == 0
    name = tmp_path / "experiments" / "scratch_ClinTox_finetune.csv"
    rows = list(csv.reader(name.open(newline="")))
    assert [r[0] for r in rows] == CLINTOX
    assert all(len(r) == 4 and r[3] == "synthetic=true" for r in rows)
    results = [{"target": r[0], "test_metric": float(r[1]),
                "test_std": float(r[2]), "synthetic": True} for r in rows]
    (tmp_path / "j").mkdir()
    monkeypatch.chdir(tmp_path / "j")
    jax_finetune._append_experiments_csv(JaxFineTuneConfig(
        task_name="ClinTox"), results)
    assert (tmp_path / "j" / "experiments" / name.name).read_text() == \
        name.read_text()
    assert sum(line.startswith("RESULT ClinTox/") and " +- " in line
               for line in out) == 2


def test_single_group_adam_matches_jax():
    """two_group_adam(quirk_q6_single_group=True): one group at the base
    LR, three steps of given gradients against JAX's within f32 rounding
    (rtol 1e-6, atol 1e-7: a few ulps of parameters of magnitude <= 1,
    1/1000 of one step's move); two groups put the head at its own LR."""
    net = FineTuneNet(task="classification", drop_ratio=0.3,
                      generator=torch.Generator().manual_seed(1), **SMALL)
    params, _ = jax_ckpt.import_torch_params(
        {k: v.numpy().copy() for k, v in net.state_dict().items()},
        num_layers=SMALL["num_layers"], gnn_type="gin")
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tx = jax_two_group_adam(params, 5e-4, 1e-4, 1e-6,
                            quirk_q6_single_group=True)
    opt = two_group_adam(net, 5e-4, 1e-4, 1e-6, quirk_q6_single_group=True)
    assert [g["lr"] for g in opt.param_groups] == [1e-4]
    opt_state = tx.init(params)
    rng = np.random.RandomState(3)
    for _ in range(3):
        grads = {k: torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
                 for k, p in net.named_parameters()}
        for k, p in net.named_parameters():
            p.grad = grads[k].clone()
        opt.step()
        jgrads, _ = jax_ckpt.import_torch_params(
            {k: v.numpy() for k, v in grads.items()},
            num_layers=SMALL["num_layers"], gnn_type="gin")
        jgrads = jax.tree_util.tree_map(jnp.asarray, jgrads)
        upd, opt_state = tx.update(jgrads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)
    want = ckpt_lib.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params))
    got = net.state_dict()
    for k, v in want.items():
        # p + update rounded in f32 on both sides: a few ulps of |p| <= 1
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    two = two_group_adam(net, 5e-4, 1e-4)
    assert [g["lr"] for g in two.param_groups] == [5e-4, 1e-4]
    head = {id(p) for p in two.param_groups[0]["params"]}
    assert head == {id(p) for p in net.pred_head.parameters()}
