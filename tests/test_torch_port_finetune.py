"""The PyTorch port's fine-tuning slice against the JAX package, on the CPU:
the host code (scaffolds and splits, BRICS fragments and the motif
vocabulary, metrics, the synthetic task CSV, the config reader) exactly
equal; FineTuneNet and MotifFineTuneNet in eval mode; three train steps
against the JAX FineTuner's own jitted `_train_step` with JAX's dropout
masks; evaluation; the motif table's encoding; and the CLI.

Small sizes (2 layers, emb 16, feat 32, tile 64: the synthetic BBBP
molecules with their hydrogens reach 45 atoms), f32 unless a test says
otherwise; JAX runs its fused layers in interpreter mode. Tolerances:
  * forwards 1e-5 * max(1, max|jax|) (sums in another order); bf16 3e-2;
  * train steps as tests/test_torch_port_pretrain.py: loss rtol 1e-5 at
    step 0 and 1e-4 after; parameters within Adam's sign-flip envelope 2
    * steps * lr (elements whose exact gradient is 0, such as the conv
    biases ahead of a BatchNorm, carry f32 noise that Adam scales to a
    whole step) and tight (5e-5 + 2e-4 |p|) on 99.97 % of the elements
    whose step-0 gradient exceeds 1e-4; BatchNorm running_var rtol 2e-3 /
    atol 1e-5, running_mean within the envelope (it inherits the conv-bias
    drift);
  * metrics of the same state within 1e-6 (the predictions agree to f32
    rounding and no pair of scores is closer than that).
"""

import csv
import dataclasses
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from molclr_tpu.data import motifs as jax_motifs
from molclr_tpu.data import splits as jax_splits
from molclr_tpu.data.synthetic import synthetic_corpus
from molclr_tpu.data.synthetic import write_task_csv as jax_write_task_csv
from molclr_tpu.data.tasks import TASKS as JAX_TASKS
from molclr_tpu.models import FineTuneNet as JaxFineTuneNet
from molclr_tpu.models import MotifFineTuneNet as JaxMotifFineTuneNet
from molclr_tpu.train import finetune as jax_finetune
from molclr_tpu.train import metrics as jax_metrics
from molclr_tpu.train.config import FineTuneConfig as JaxFineTuneConfig
from molclr_tpu.train.config import ModelConfig as JaxModelConfig
from molclr_tpu.train.config import finetune_from_yaml as jax_from_yaml
from molclr_tpu_torch.cli import finetune as port_cli
from molclr_tpu_torch.data import motifs, splits
from molclr_tpu_torch.data.graphs import GraphBatch
from molclr_tpu_torch.data.synthetic import write_task_csv
from molclr_tpu_torch.data.tasks import TASKS
from molclr_tpu_torch.models import FineTuneNet, MotifFineTuneNet
from molclr_tpu_torch.ops import fused_gcn, fused_layer
from molclr_tpu_torch.train import checkpoints as ckpt_lib
from molclr_tpu_torch.train import metrics
from molclr_tpu_torch.train.config import FineTuneConfig, ModelConfig, \
    finetune_from_yaml
from molclr_tpu_torch.train.finetune import FineTuner, train_step
from molclr_tpu_torch.train.orbax import OrbaxFormatError
from molclr_tpu_torch.train.optim import two_group_adam

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(num_layers=2, emb_dim=16, feat_dim=32, tile=64)


def assert_close(port, ref, rtol=1e-5):
    port = port.detach().float().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = float(np.abs(port - ref).max())
    lim = rtol * max(1.0, float(np.abs(ref).max()))
    assert err <= lim, (err, lim)


def _port_batch(bj) -> GraphBatch:
    return GraphBatch(**{f.name: np.asarray(getattr(bj, f.name))
                         for f in dataclasses.fields(GraphBatch)}).to("cpu")


def _molecules() -> list[str]:
    """The synthetic corpus and every parseable SMILES literal of
    tests/test_chem.py."""
    from molclr_tpu_torch.chem.smiles import parse_smiles

    text = (ROOT / "tests" / "test_chem.py").read_text()
    lits = sorted(set(re.findall(r'"([^"\s]+)"', text)))
    chem = [s for s in lits if parse_smiles(s, strict=False) is not None]
    assert len(chem) > 20
    return synthetic_corpus(300, seed=4) + chem


# ------------------------------------------------------------- host code


def test_scaffolds_and_splits_equal_jax():
    smiles = _molecules()
    keys = [splits.generate_scaffold(s) for s in smiles]
    assert keys == [jax_splits.generate_scaffold(s) for s in smiles]
    assert len(set(keys)) > 10
    for valid, test in ((0.1, 0.1), (0.2, 0.15)):
        assert splits.scaffold_split(smiles, valid, test) == \
            jax_splits.scaffold_split(smiles, valid, test)
        for seed in (0, 3):
            for quirk in (False, True):
                assert splits.random_split(len(smiles), valid, test, seed,
                                           quirk) == \
                    jax_splits.random_split(len(smiles), valid, test, seed,
                                            quirk)


def test_brics_fragments_and_motif_vocab_equal_jax():
    smiles = _molecules()
    keys = [motifs.mol_fragment_keys(s) for s in smiles]
    assert keys == [jax_motifs.mol_fragment_keys(s) for s in smiles]
    for cap in (12, 3):
        got = motifs.build_motif_vocab(smiles, max_motifs_per_mol=cap)
        want = jax_motifs.build_motif_vocab(smiles, max_motifs_per_mol=cap)
        assert got.smiles == want.smiles and got.size > 20
        assert np.array_equal(got.mol_motifs, want.mol_motifs)
        assert np.array_equal(got.mol_motif_mask, want.mol_motif_mask)


def test_metrics_and_normalizer_equal_jax():
    rng = np.random.RandomState(1)
    labels = rng.randint(0, 2, 200)
    scores = np.round(rng.rand(200), 2)           # with ties
    assert metrics.roc_auc(labels, scores) == \
        jax_metrics.roc_auc(labels, scores)
    assert np.isnan(metrics.roc_auc(np.ones(5), scores[:5]))
    y, p = rng.randn(50), rng.randn(50)
    assert metrics.rmse(y, p) == jax_metrics.rmse(y, p)
    assert metrics.mae(y, p) == jax_metrics.mae(y, p)
    assert metrics.METRIC_DIRECTION == jax_metrics.METRIC_DIRECTION
    for vals in (y, np.full(4, 2.5)):
        a, b = metrics.Normalizer(vals), jax_metrics.Normalizer(vals)
        assert (a.mean, a.std) == (b.mean, b.std)
        assert np.array_equal(a.denorm(a.norm(p)), b.denorm(b.norm(p)))


@pytest.mark.parametrize("task,pathologies", [("BBBP", False),
                                              ("Tox21", True),
                                              ("ESOL", False)])
def test_write_task_csv_equals_jax(tmp_path, task, pathologies):
    assert dataclasses.asdict(TASKS[task]) == \
        dataclasses.asdict(JAX_TASKS[task])
    write_task_csv(str(tmp_path / "p.csv"), TASKS[task], n=80, seed=2,
                   pathologies=pathologies)
    jax_write_task_csv(str(tmp_path / "j.csv"), JAX_TASKS[task], n=80,
                       seed=2, pathologies=pathologies)
    assert (tmp_path / "p.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()


def test_finetune_from_yaml_equals_jax():
    path = str(ROOT / "configs" / "finetune.yaml")
    got, want = finetune_from_yaml(path), jax_from_yaml(path)
    for f in dataclasses.fields(FineTuneConfig):
        if f.name != "model":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    for f in dataclasses.fields(ModelConfig):
        assert getattr(got.model, f.name) == getattr(want.model, f.name)
    assert got.model.drop_ratio == 0.3 and got.batch_size == 32
    # the defaults of the two FineTuneConfigs agree too
    for f in dataclasses.fields(FineTuneConfig):
        if f.name != "model":
            assert f.default == getattr(JaxFineTuneConfig(), f.name), f.name


# ----------------------------------------------------------------- models


def _batch(n=20, seed=3, add_hs=True):
    from molclr_tpu.data.graphs import pack_batch as jax_pack
    from molclr_tpu.data.loader import featurize_many as jax_featurize
    from molclr_tpu.data.loader import spec_for_graphs as jax_spec

    graphs, _ = jax_featurize(synthetic_corpus(n, seed=seed), add_hs=add_hs,
                              prefer_native=False)
    bj = jax_pack(graphs, jax_spec(graphs, n, tile=64, sizing="max"))
    return bj, _port_batch(bj)


@pytest.mark.parametrize("gnn,task,motif,dtype", [
    ("gin", "classification", False, "float32"),
    ("gcn", "regression", False, "float32"),
    ("gin", "regression", True, "float32"),
    ("gcn", "classification", True, "float32"),
    ("gin", "classification", False, "bfloat16")])
def test_finetune_nets_eval_forward_match_jax(gnn, task, motif, dtype):
    """Eval forward at drop_ratio 0.3 (the unchained trunk) with the JAX
    model's weights and BatchNorm stats carried by state_dict_from_jax."""
    bj, bp = _batch()
    jdt = {"float32": jax.numpy.float32, "bfloat16": jax.numpy.bfloat16}
    kw = dict(task=task, gnn_type=gnn, drop_ratio=0.3, **SMALL)
    g = bp.num_graphs
    rng = np.random.RandomState(4)
    mi = rng.randint(0, 9, (g, 3)).astype(np.int32)
    mm = rng.rand(g, 3) < 0.6
    if motif:
        jnet = JaxMotifFineTuneNet(num_motifs=9, dtype=jdt[dtype], fused=True,
                                   **kw)
        args = (bj, mi, mm)
    else:
        jnet = JaxFineTuneNet(dtype=jdt[dtype], fused=True, **kw)
        args = (bj,)
    variables = jnet.init(jax.random.PRNGKey(5), *args, train=False)
    # a train-mode pass moves the running stats off their initial values
    _, upd = jnet.apply(variables, *args, train=True, mutable=["batch_stats"],
                        rngs={"dropout": jax.random.PRNGKey(6)})
    variables = {"params": variables["params"], **upd}
    jh, jpred = jnet.apply(variables, *args, train=False)
    tdt = getattr(torch, dtype)
    cls = MotifFineTuneNet if motif else FineTuneNet
    net = cls(**({"num_motifs": 9} if motif else {}), dtype=tdt, **kw)
    got = ckpt_lib.transfer_state(ckpt_lib.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, variables["batch_stats"])), net)
    assert got["skipped"] == [] and got["copied"] == len(
        [k for k in net.state_dict() if "num_batches" not in k])
    net.eval()
    seen = []
    for conv in net.gnns:
        conv.register_forward_hook(lambda m, i, o: seen.append(i[0].dtype))
    with torch.no_grad():
        targs = (bp,) + ((torch.from_numpy(mi.astype(np.int64)),
                          torch.from_numpy(mm)) if motif else ())
        h, pred = net(*targs)
    # layers after the first take the f32 that the first BatchNorm gives
    # (JAX promotes bf16 x f32 scale to f32), so a bf16 run runs layer 0
    # in bf16 and the rest in f32, as the JAX model does
    assert seen == [tdt] + [torch.float32] * (SMALL["num_layers"] - 1)
    rtol = 1e-5 if dtype == "float32" else 3e-2
    assert h.dtype == (torch.float32 if motif else tdt)
    assert pred.shape == (g, 2 if task == "classification" else 1)
    assert_close(h, jh, rtol)
    assert_close(pred, jpred, rtol)


# ------------------------------------------------------------ train steps


def _jax_tuner(tmp, gnn, use_motifs):
    cfg = JaxFineTuneConfig(
        task_name="BBBP", data_root=str(tmp), synthetic_fallback=True,
        synthetic_n=120, batch_size=16, epochs=1, ckpt_dir=str(tmp / "ck"),
        use_motifs=use_motifs, model=JaxModelConfig(
            gnn_type=gnn, drop_ratio=0.3, fused=True, **SMALL))
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        ft = jax_finetune.FineTuner(cfg).setup_data()
    ft.setup_state(next(iter(ft.iters["train"]))[0])
    ft._build_steps()
    return ft


def _port_model(ft_jax):
    m = ft_jax.cfg.model
    kw = dict(task="classification", gnn_type=m.gnn_type,
              drop_ratio=m.drop_ratio, **SMALL)
    if ft_jax.cfg.use_motifs:
        net = MotifFineTuneNet(num_motifs=ft_jax.motif_vocab.size, **kw)
    else:
        net = FineTuneNet(**kw)
    got = ckpt_lib.transfer_state(_jax_state(ft_jax.state), net)
    assert got["skipped"] == []
    return net


def _jax_state(state):
    return ckpt_lib.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params),
        jax.tree_util.tree_map(np.asarray, state.batch_stats))


def _dropout_masks(ft, state, item, rng):
    """JAX's dropout keep masks of one train step (rng folded with the
    step, as `_train_step` folds it): the Dropout outputs of a train-mode
    apply with captured intermediates are non-zero exactly where kept (and
    where an input is 0 the mask changes nothing)."""
    batch, _, mi, mm = item
    args = (batch,) + ((mi, mm) if ft.cfg.use_motifs else ())
    _, upd = ft.model.apply(
        {"params": state.params, "batch_stats": state.batch_stats}, *args,
        train=True, rngs={"dropout": jax.random.fold_in(rng, state.step)},
        mutable=["batch_stats", "intermediates"], capture_intermediates=True)
    trunk = upd["intermediates"]["trunk"]
    return [torch.from_numpy(np.asarray(
        trunk[f"Dropout_{i}"]["__call__"][0]) != 0)
        for i in range(SMALL["num_layers"])]


@pytest.mark.parametrize("gnn,use_motifs", [("gin", False), ("gcn", False),
                                            ("gin", True)])
def test_train_steps_match_jax_finetuner(tmp_path, gnn, use_motifs):
    """Three steps of the port's train_step against the JAX FineTuner's
    jitted _train_step (two-group Adam, BatchNorm stats, dropout 0.3 with
    JAX's masks), then the validation metric of the same state."""
    ft = _jax_tuner(tmp_path, gnn, use_motifs)
    items = ft._epoch_items("train")
    assert len(items) >= 3
    net = _port_model(ft)
    cfg = ft.cfg
    opt = two_group_adam(net, cfg.init_lr, cfg.init_base_lr,
                         cfg.weight_decay)
    heads = {id(p) for p in opt.param_groups[0]["params"]}
    head_names = sorted(k for k, p in net.named_parameters()
                        if id(p) in heads)
    assert head_names and all(k.startswith(("pred_head", "motif_"))
                              for k in head_names)
    state = ft.state
    rng = jax.random.PRNGKey(17)
    grads0 = None
    for step in range(3):
        item = items[step]
        masks = _dropout_masks(ft, state, item, rng)
        motifs_j = (item[2], item[3]) if use_motifs else ()
        state, jloss = ft._train_step(state, item[0], motifs_j, item[1],
                                      rng)
        motifs_t = ((torch.from_numpy(item[2].astype(np.int64)),
                     torch.from_numpy(item[3])) if use_motifs else ())
        loss = train_step([net], opt, _port_batch(item[0]),
                          torch.from_numpy(item[1]), motifs_t, "ce",
                          seed_masks=[masks])[0]
        np.testing.assert_allclose(float(loss), float(jloss),
                                   rtol=1e-5 if step == 0 else 1e-4,
                                   err_msg=f"loss at step {step}")
        if step == 0:
            grads0 = {k: p.grad.numpy().copy()
                      for k, p in net.named_parameters()}
        _compare(_jax_state(state), net, grads0, step + 1,
                 max(cfg.init_lr, cfg.init_base_lr), tight=step == 0)
    # the same state gives the same validation metric
    ft.state = state
    port = FineTuner(_port_cfg(ft.cfg), "cpu").setup_data()
    port.models = [_port_model(ft)]
    got, want = port.evaluate("valid"), ft.evaluate("valid")
    assert got["n"] == want["n"] > 0
    assert abs(got["metric"] - want["metric"]) <= 1e-6, (got, want)


def _port_cfg(jcfg) -> FineTuneConfig:
    m = jcfg.model
    return FineTuneConfig(
        task_name=jcfg.task_name, data_root=jcfg.data_root,
        synthetic_fallback=True, synthetic_n=jcfg.synthetic_n,
        batch_size=jcfg.batch_size, epochs=jcfg.epochs,
        ckpt_dir=jcfg.ckpt_dir, use_motifs=jcfg.use_motifs,
        model=ModelConfig(gnn_type=m.gnn_type, drop_ratio=m.drop_ratio,
                          **SMALL))


def _compare(jstate, model, grads0, steps, lr, tight):
    cap = 2.0 * steps * lr
    port = {k: v.detach().numpy() for k, v in model.state_dict().items()}
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


def test_motif_table_encoding_matches_jax(tmp_path):
    """The motif table the port encodes with its FineTuneNet (eval mode,
    'max' packing) against the JAX package's encode_motif_vocab with the
    same trunk and feat_lin."""
    ft = _jax_tuner(tmp_path, "gin", True)
    vocab = ft.motif_vocab
    kw = ft._model_kwargs()
    plain = JaxFineTuneNet(**kw)
    dummy = next(iter(ft.iters["train"]))[0]
    pv = plain.init(jax.random.PRNGKey(0), dummy, train=False)
    from molclr_tpu.train.checkpoints import transfer_params

    params = {k: v for k, v in ft.state.params.items()
              if not k.startswith("motif_")}
    variables = {"params": transfer_params(params, pv["params"]),
                 "batch_stats": ft.state.batch_stats}
    want = jax_motifs.encode_motif_vocab(vocab, plain, variables,
                                         feat_dim=SMALL["feat_dim"],
                                         tile=SMALL["tile"])
    net = FineTuneNet(task="classification", drop_ratio=0.3, **SMALL)
    ckpt_lib.transfer_state(ckpt_lib.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, variables["batch_stats"])), net)
    port_vocab = motifs.MotifVocab(vocab.smiles, vocab.mol_motifs,
                                   vocab.mol_motif_mask)
    got = motifs.encode_motif_vocab(port_vocab, net, SMALL["feat_dim"],
                                    tile=SMALL["tile"])
    assert got.shape == (vocab.size, SMALL["feat_dim"])
    assert_close(got, want)
    assert net.training                       # its mode is given back


# ------------------------------------------------------------------- CLI


def test_cli_finetune_cpu_runs_and_writes_the_jax_csv_row(tmp_path,
                                                          monkeypatch):
    """The CLI on the CPU (plain versions) on a tiny config in a temporary
    working directory: RESULT lines, metrics.jsonl, and an experiments CSV
    row in the JAX package's format; a warm start from the port's own
    step_<n>.pt; no kernel launch."""
    monkeypatch.chdir(tmp_path)
    Path("small.yaml").write_text(
        "batch_size: 16\nepochs: 2\nmodel:\n  num_layer: 2\n  emb_dim: 16\n"
        "  feat_dim: 32\n  tile: 64\n")
    src = FineTuneNet(task="classification", drop_ratio=0.3,
                      generator=torch.Generator().manual_seed(3), **SMALL)
    ckpt = ckpt_lib.save_checkpoint("pre", 7, {"model": src.state_dict()})
    launches = (fused_layer.fused_gine_layer.launches,
                fused_gcn.fused_gcn_layer.launches)
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        assert port_cli.main(["--config", "small.yaml", "--allow-synthetic",
                              "--pretrained", "pre", "--cpu"]) == 0
    assert launches == (fused_layer.fused_gine_layer.launches,
                        fused_gcn.fused_gcn_layer.launches)
    name = "pre_BBBP_finetune.csv"       # named after --pretrained
    with open(tmp_path / "experiments" / name, newline="") as f:
        rows = list(csv.reader(f))
    assert len(rows) == 1 and rows[0][0] == "p_np"
    assert rows[0][2] == "synthetic=true" and 0 <= float(rows[0][1]) <= 1
    monkeypatch.chdir(tmp_path / "pre")
    jax_finetune._append_experiments_csv(
        JaxFineTuneConfig(pretrained="pre"),
        [{"target": "p_np", "test_metric": float(rows[0][1]),
          "synthetic": True}])
    assert (tmp_path / "pre" / "experiments" / name).read_text() == \
        (tmp_path / "experiments" / name).read_text()
    recs = (tmp_path / "runs" / "finetune" / "BBBP_p_np" /
            "metrics.jsonl").read_text().splitlines()
    assert len(recs) == 3                       # two epochs and the test
    assert ckpt_lib.resolve_pretrained(str(tmp_path / "pre")) == ckpt


def test_cli_finetune_without_cpu_raises_when_no_gpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["--allow-synthetic", "--epochs", "1"])
    assert not (tmp_path / "experiments").exists()


def test_warm_start_sources(tmp_path):
    """A reference .pth and a step_<n>.pt load; a step_<n> directory that
    is not an Orbax checkpoint (no _METADATA) raises naming it (Orbax
    checkpoints themselves load: tests/test_torch_port_orbax.py); a seed
    ensemble is no longer refused."""
    net = FineTuneNet(task="regression", **SMALL)
    torch.save(net.state_dict(), tmp_path / "m.pth")
    got = ckpt_lib.load_pretrained_state(str(tmp_path / "m.pth"))
    assert torch.equal(got["feat_lin.weight"], net.feat_lin.weight)
    (tmp_path / "orbax" / "step_3").mkdir(parents=True)
    path = ckpt_lib.resolve_pretrained(str(tmp_path / "orbax"))
    assert path == str(tmp_path / "orbax" / "step_3")
    with pytest.raises(OrbaxFormatError, match="_METADATA.*Orbax"):
        ckpt_lib.load_pretrained_state(path)
    with pytest.raises(FileNotFoundError):
        ckpt_lib.load_pretrained_state(str(tmp_path / "missing.pth"))
    assert FineTuner(FineTuneConfig(n_seeds=3), "cpu").n_members == 3


def test_finetuner_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FineTuner(FineTuneConfig())
    assert FineTuner(FineTuneConfig(), "cpu").device.type == "cpu"
