"""The PyTorch port's pretraining slice against the JAX package, on the CPU:
the optimizer and schedule, the epoch iterator, the config reader, three
contrastive train steps (GIN and GCN) against the JAX Pretrainer's own
jitted step, one step each of subgraph and mix augmentation, dropout and
concat_views, the BFS horizon, and the port's Pretrainer / CLI
(checkpoint, resume, device choice).

Small sizes (tile 32, D 32, 3 layers, feat 64), f32. The step parity
feeds both sides the same JAX-drawn views (the four AUG_DELTA_FIELDS) and
starts them from the same weights (state_dict_from_jax); its tolerances
follow tests/test_torch_step_parity.py: loss rtol 1e-5 at step 0 and 1e-3
after, step-0 gradients rtol 2e-4 / atol 1e-5, Adam moments after the
first update rtol 2e-4 (mu) and 5e-4 (nu), parameters within the Adam
sign-flip envelope 2 * steps * lr everywhere and tight (5e-5 + 2e-4 |p|)
on 99.97 % of the elements whose step-0 gradient exceeds 1e-4, BN
running_var rtol 2e-3 / atol 1e-5 (running_mean inherits the conv-bias
drift and gets the envelope)."""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from molclr_tpu.data.augment import paired_augment as jax_paired_augment
from molclr_tpu.data.graphs import concat_views as jax_concat_views
from molclr_tpu.data.loader import BatchIterator as JaxBatchIterator
from molclr_tpu.data.loader import featurize_many as jax_featurize_many
from molclr_tpu.data.loader import spec_for_graphs as jax_spec_for_graphs
from molclr_tpu.data.synthetic import synthetic_corpus
from molclr_tpu.train import optim as jax_optim
from molclr_tpu.train.config import ModelConfig as JaxModelConfig
from molclr_tpu.train.config import PretrainConfig as JaxPretrainConfig
from molclr_tpu.train.config import pretrain_from_yaml as jax_from_yaml
from molclr_tpu.train.pretrain import Pretrainer as JaxPretrainer
from molclr_tpu_torch.cli import pretrain as port_cli
from molclr_tpu_torch.data.augment import AUG_DELTA_FIELDS, apply_view_delta
from molclr_tpu_torch.data.graphs import GraphBatch
from molclr_tpu_torch.data.loader import BatchIterator, featurize_many, \
    spec_for_graphs
from molclr_tpu_torch.ops import fused_gcn, fused_layer
from molclr_tpu_torch.train import optim
from molclr_tpu_torch.train.checkpoints import latest_checkpoint, \
    state_dict_from_jax, transfer_state
from molclr_tpu_torch.train.config import ModelConfig, PretrainConfig, \
    pretrain_from_yaml
from molclr_tpu_torch.train.pretrain import Pretrainer, build_model, \
    step_generator, train_step

SMALL = dict(num_layers=3, emb_dim=32, feat_dim=64, tile=32)


def _port_batch(bj) -> GraphBatch:
    """A JAX GraphBatch as the port's, on the CPU."""
    return GraphBatch(**{f.name: np.asarray(getattr(bj, f.name))
                         for f in dataclasses.fields(GraphBatch)}).to("cpu")


# ------------------------------------------------------- optimizer, data


def test_warmup_then_cosine_matches_jax():
    for args in ((5e-4, 7, 10, 3), (1e-3, 1, 4, 0), (5e-4, 5, 3, 5)):
        ref = jax_optim.warmup_then_cosine(*args)
        got = optim.warmup_then_cosine(*args)
        for step in (0, 1, 6, 7, 20, 21, 34, 60, 69, 70, 500):
            np.testing.assert_allclose(got(step), float(ref(step)),
                                       rtol=1e-6, atol=1e-12)


def test_adam_step_matches_optax_adam_torch():
    """One torch.optim.Adam step (set_lr) against the JAX package's
    adam_torch chain with weight decay: the moments match to f32 rounding
    and the update to its rtol 2e-4 (eps sits in another place)."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(50).astype(np.float32)
    g = (rng.randn(50) * 1e-2).astype(np.float32)
    tx = jax_optim.adam_torch(5e-4, 1e-5)
    state = tx.init(p0)
    upd, state = tx.update(g, state, p0)
    p = torch.tensor(p0, requires_grad=True)
    opt = optim.adam_torch([p], 1e-5)
    optim.set_lr(opt, 5e-4)
    p.grad = torch.tensor(g)
    opt.step()
    adam = [s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(),
                               np.asarray(adam.mu), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(opt.state[p]["exp_avg_sq"].numpy(),
                               np.asarray(adam.nu), rtol=1e-6, atol=1e-15)
    np.testing.assert_allclose(p.detach().numpy() - p0, np.asarray(upd),
                               rtol=2e-4, atol=1e-9)


@pytest.mark.parametrize("cache", [False, True])
def test_batch_iterator_matches_jax_for_two_epochs(cache):
    smiles = synthetic_corpus(50, seed=6)
    gj, _ = jax_featurize_many(smiles, prefer_native=False)
    gp, _ = featurize_many(smiles)
    spec_j = jax_spec_for_graphs(gj, 12, tile=32)
    spec_p = spec_for_graphs(gp, 12, tile=32)
    for drop_last, shuffle in ((True, True), (False, False)):
        it_j = JaxBatchIterator(gj, spec_j, shuffle=shuffle,
                                drop_last=drop_last, seed=3,
                                cache_packed=cache)
        it_p = BatchIterator(gp, spec_p, shuffle=shuffle,
                             drop_last=drop_last, seed=3, cache_packed=cache)
        assert len(it_j) == len(it_p)
        for _ in range(2):
            got = list(it_p)
            want = list(it_j)
            assert len(got) == len(want)
            for (bp, _, ip), (bj, _, ij) in zip(got, want):
                assert np.array_equal(ip, ij)
                for f in dataclasses.fields(GraphBatch):
                    assert np.array_equal(getattr(bp, f.name),
                                          np.asarray(getattr(bj, f.name)))
        assert (it_p.cache is None) == (it_j.cache is None)


def test_pretrain_from_yaml_matches_jax():
    path = str(Path(__file__).resolve().parents[1] / "configs" /
               "pretrain.yaml")
    got, want = pretrain_from_yaml(path), jax_from_yaml(path)
    for f in dataclasses.fields(PretrainConfig):
        if f.name != "model":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    # the port's ModelConfig is the JAX package's with Graphormer's
    # widths beside it, at their defaults (the YAML names no Graphormer)
    shared = {f.name for f in dataclasses.fields(want.model)}
    for f in dataclasses.fields(ModelConfig):
        if f.name in shared:
            assert getattr(got.model, f.name) == getattr(want.model, f.name)
        else:
            assert f.name in ("num_heads", "ffn_dim", "max_hops"), f.name
            assert getattr(got.model, f.name) == f.default


# -------------------------------------------------------- step parity


def _adam_moments(opt_state):
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    return (state_dict_from_jax(jax.tree_util.tree_map(np.asarray, adam.mu)),
            state_dict_from_jax(jax.tree_util.tree_map(np.asarray, adam.nu)))


def _compare_states(jstate, model, grads0, steps, lr, tight):
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


def _port_views(bp, vj):
    """JAX's two views as the port's: the base batch with their
    AUG_DELTA_FIELDS."""
    return tuple(apply_view_delta(bp, tuple(
        torch.from_numpy(np.asarray(getattr(v, f)).astype(
            np.int64 if f in ("atom_type", "chirality") else bool))
        for f in AUG_DELTA_FIELDS)) for v in vj)


def _dropout_masks(pre, state, views, rng, concat):
    """JAX's dropout keep masks of one train step: `_train_step` folds the
    step into rng and splits it into (rng_aug, rng_di, rng_dj); the
    Dropout outputs of a train-mode apply with the view's stream are
    non-zero exactly where kept (where an input is 0 the mask changes
    nothing). Per view a list of [N, D] masks, or one list for the joint
    batch of concat_views."""
    _, rng_di, rng_dj = jax.random.split(
        jax.random.fold_in(rng, state.step), 3)
    runs = ([(jax_concat_views(*views), rng_di)] if concat
            else list(zip(views, (rng_di, rng_dj))))
    masks = []
    for batch, r in runs:
        _, upd = pre.model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            batch, train=True, rngs={"dropout": r},
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=True)
        trunk = upd["intermediates"]["trunk"]
        masks.append([torch.from_numpy(np.asarray(
            trunk[f"Dropout_{i}"]["__call__"][0]) != 0)
            for i in range(SMALL["num_layers"])])
    return masks


def _run_steps_against_jax(tmp_path, steps, gnn="gin", aug="node",
                           drop=0.0, concat=False):
    """`steps` steps of the port's train_step against the JAX Pretrainer's
    jitted _train_step (fused layers in interpreter mode), both given the
    same JAX-drawn views (and JAX's dropout masks), from the same weights:
    the loss, the step-0 gradients and Adam moments, the parameters and
    BatchNorm stats after every step. Returns the JAX Pretrainer."""
    smiles = synthetic_corpus(44, seed=23)
    model_kw = dict(SMALL, gnn_type=gnn, drop_ratio=drop)
    cfg_j = JaxPretrainConfig(
        batch_size=20, epochs=3, warm_up=0, init_lr=5e-4, weight_decay=1e-5,
        aug=aug, valid_size=0.05, seed=0, featurize_processes=0,
        steps_per_dispatch=1, device_cache_mb=0, concat_views=concat,
        ckpt_dir=str(tmp_path / "jax"),
        model=JaxModelConfig(fused=True, **model_kw))
    pre = JaxPretrainer(cfg_j).setup_data(smiles)
    batches = [b for b, _, _ in pre.train_iter]
    assert len(batches) == 2
    pre.setup_state(batches[0])
    pre._build_steps()
    state = pre.state
    bw = pre.spec.max_graph_bonds

    cfg_p = PretrainConfig(batch_size=20, epochs=3, warm_up=0,
                           init_lr=5e-4, weight_decay=1e-5, aug=aug,
                           concat_views=concat,
                           model=ModelConfig(**model_kw))
    model = build_model(cfg_p)
    got = transfer_state(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params),
        jax.tree_util.tree_map(np.asarray, state.batch_stats)), model)
    assert got["skipped"] == []
    opt = optim.adam_torch(model.parameters(), cfg_p.weight_decay)
    schedule = optim.warmup_then_cosine(cfg_p.init_lr, len(batches),
                                        cfg_p.epochs, cfg_p.warm_up)
    grads0 = None
    for step in range(steps):
        bj = batches[step % 2]
        rng = jax.random.fold_in(jax.random.PRNGKey(9), step)
        vj = jax_paired_augment(bj, rng, aug, tile=32, bond_window=bw,
                                max_waves=pre._max_waves)
        masks = (_dropout_masks(pre, state, vj, rng, concat) if drop
                 else None)
        p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
        state, jloss = pre._train_step(state, bj, rng, vj)
        bp = _port_batch(bj)
        loss = train_step(model, opt, bp, cfg_p, step, schedule(step),
                          views=_port_views(bp, vj), bond_window=bw,
                          dropout_masks=masks)
        np.testing.assert_allclose(
            float(loss), float(jloss), rtol=1e-5 if step == 0 else 1e-3,
            atol=0.0 if step == 0 else 2e-5, err_msg=f"loss at step {step}")
        if step == 0:
            mu, nu = _adam_moments(state.opt_state)
            grads0 = {k: p.grad.numpy().copy()
                      for k, p in model.named_parameters()}
            for k, p in model.named_parameters():
                # JAX's step-0 gradient from its first moment:
                # mu = (1 - b1) (g + wd p)
                jg = mu[k].numpy() / 0.1 - cfg_p.weight_decay * p0[k].numpy()
                np.testing.assert_allclose(grads0[k], jg, rtol=2e-4,
                                           atol=1e-5, err_msg=k)
                np.testing.assert_allclose(
                    opt.state[p]["exp_avg"].numpy(), mu[k].numpy(),
                    rtol=2e-4, atol=5e-6, err_msg=k)
                np.testing.assert_allclose(
                    opt.state[p]["exp_avg_sq"].numpy(), nu[k].numpy(),
                    rtol=5e-4, atol=1e-10, err_msg=k)
        jstate = state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, state.params),
            jax.tree_util.tree_map(np.asarray, state.batch_stats))
        _compare_states(jstate, model, grads0, steps=step + 1,
                        lr=cfg_p.init_lr, tight=step == 0)
    assert int(state.step) == steps
    return pre


@pytest.mark.parametrize("gnn", ["gin", "gcn"])
def test_train_step_matches_jax_pretrainer(tmp_path, gnn):
    """Three steps of the port's train_step against the JAX Pretrainer's
    jitted _train_step, both given the same JAX-drawn node-augmented
    views: GIN (K1 layers) and GCN (K3 layers)."""
    bwd = (fused_layer.fused_gine_bn_layer_bwd if gnn == "gin"
           else fused_gcn.fused_gcn_bn_layer_bwd)
    launches = bwd.launches
    _run_steps_against_jax(tmp_path, 3, gnn=gnn)
    # the CPU path runs the plain backward, not the kernel
    assert bwd.launches == launches


@pytest.mark.parametrize("variant", [
    dict(aug="subgraph"), dict(aug="mix"), dict(aug="mix", gnn="gcn"),
    dict(drop=0.1), dict(drop=0.1, gnn="gcn"), dict(concat=True)])
def test_one_train_step_of_each_option_matches_jax(tmp_path, variant):
    """One step of each other pretraining option against the JAX
    Pretrainer, with the limits of the three-step test: subgraph and mix
    augmentation (JAX's views, drawn within the Pretrainer's corpus-derived
    horizon; mix featurizes with hydrogens), dropout 0.1 (JAX's masks, one
    stream per view) and concat_views (both views in one forward)."""
    _run_steps_against_jax(tmp_path, 1, **variant)


def test_pretrainer_derives_the_bfs_horizon_as_jax(tmp_path):
    """max_waves 0 derives max atoms - 1 from the corpus, as the JAX
    Pretrainer does; an explicit value wins."""
    smiles = ["C" * 60, "CCO", "c1ccccc1"] * 10
    model = dict(SMALL, tile=64)
    for max_waves, want in ((0, 59), (17, 17)):
        kw = dict(batch_size=8, epochs=1, aug="subgraph", valid_size=0.1,
                  max_waves=max_waves, ckpt_dir=str(tmp_path))
        ref = JaxPretrainer(JaxPretrainConfig(
            featurize_processes=0, model=JaxModelConfig(**model), **kw)
        ).setup_data(smiles)
        got = Pretrainer(PretrainConfig(model=ModelConfig(**model), **kw),
                         "cpu").setup_data(smiles)
        assert got.max_waves == ref._max_waves == want


def test_train_step_draws_per_step_and_runs_bf16():
    """Without views, the step draws its augmentation from
    step_generator(seed, 0, step): two models from the same weights take
    identical steps. In bf16 the step is finite and the f32 parameters
    move."""
    smiles = synthetic_corpus(20, seed=2)
    gp, _ = featurize_many(smiles)
    spec = spec_for_graphs(gp, 20, tile=32)
    batch = BatchIterator(gp, spec, shuffle=False).__iter__().__next__()[0]
    batch = batch.to("cpu")
    cfg = PretrainConfig(batch_size=20, model=ModelConfig(**SMALL))
    runs = []
    for _ in range(2):
        model = build_model(cfg, torch.Generator().manual_seed(1))
        opt = optim.adam_torch(model.parameters(), cfg.weight_decay)
        loss = train_step(model, opt, batch, cfg, 4, 5e-4,
                          bond_window=spec.max_graph_bonds)
        runs.append((loss, model.state_dict()))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])
    g1 = step_generator(0, 0, 4)
    g2 = step_generator(0, 0, 5)
    assert not torch.equal(torch.randint(0, 9, (20,), generator=g1),
                           torch.randint(0, 9, (20,), generator=g2))
    cfg.model.bf16 = True
    model = build_model(cfg, torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = optim.adam_torch(model.parameters(), cfg.weight_decay)
    loss = train_step(model, opt, batch, cfg, 0, 5e-4,
                      bond_window=spec.max_graph_bonds)
    assert torch.isfinite(loss)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert not torch.equal(before["gnns.0.mlp.0.weight"],
                           model.gnns[0].mlp[0].weight)


# ----------------------------------------------------- Pretrainer, CLI


def test_pretrainer_saves_and_resumes(tmp_path):
    """A tiny run on the CPU stops after epoch 1 of 3 with a full-state
    checkpoint; a resumed run continues the step count, the schedule and
    the data stream, and ends where an uninterrupted run ends (without the
    packed-batch cache, whose epoch-0 compositions a resumed run cannot
    see, as in the JAX package)."""
    smiles = synthetic_corpus(60, seed=8)

    def cfg(d, **kw):
        return PretrainConfig(batch_size=16, epochs=3, warm_up=1,
                              valid_size=0.1, ckpt_dir=str(tmp_path / d),
                              save_every_epochs=5, pack_cache_max_mols=0,
                              model=ModelConfig(**SMALL), **kw)

    full = Pretrainer(cfg("full"), "cpu").setup_data(smiles).setup_state()
    hist_full = full.train(log=lambda *_: None)
    first = Pretrainer(cfg("cut", stop_after_epochs=1), "cpu")
    first.setup_data(smiles).setup_state()
    hist = first.train(log=lambda *_: None)
    assert len(hist) == 1 and first.step == first.steps_per_epoch
    path = latest_checkpoint(str(tmp_path / "cut"))
    assert path.endswith(f"step_{first.step}.pt")
    second = Pretrainer(cfg("cut", resume_from=path), "cpu")
    second.setup_data(smiles).setup_state()
    assert second.step == first.step and second._start_epoch == 1
    hist2 = second.train(log=lambda *_: None)
    assert [h["epoch"] for h in hist2] == [1, 2]
    assert hist2[-1]["step"] == hist_full[-1]["step"]
    assert hist2[0]["lr"] == hist_full[1]["lr"]
    for a, b in zip(hist2, hist_full[1:]):
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   rtol=1e-5)
    recs = [json.loads(line) for line in
            (tmp_path / "cut" / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in recs] == [0, 1, 2]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["valid_loss"])
               for r in recs)
    assert (tmp_path / "cut" / "best.pth").exists()
    # a reference .pth resumes weights only
    third = Pretrainer(cfg("pth", resume_from=str(tmp_path / "cut" /
                                                  "best.pth")), "cpu")
    third.setup_data(smiles).setup_state()
    assert third.step == 0
    assert torch.equal(third.model.gnns[0].mlp[0].weight.detach(), torch.load(
        tmp_path / "cut" / "best.pth")["gnns.0.mlp.0.weight"])


def test_cli_pretrain_without_cpu_raises_when_no_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["--synthetic", "20", "--data",
                       str(tmp_path / "c.txt"), "--ckpt-dir",
                       str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()


def test_cli_pretrain_cpu_runs_and_resumes(tmp_path):
    yaml_path = tmp_path / "small.yaml"
    yaml_path.write_text("batch_size: 16\nepochs: 2\nwarm_up: 1\nmodel:\n"
                         "  num_layer: 2\n  emb_dim: 16\n  feat_dim: 32\n"
                         "  tile: 32\n")
    base = ["--config", str(yaml_path), "--synthetic", "50", "--data",
            str(tmp_path / "c.txt"), "--ckpt-dir", str(tmp_path / "ck"),
            "--cpu"]
    assert port_cli.main(base + ["--stop-after-epoch", "1"]) == 0
    assert port_cli.main(base + ["--resume", "latest"]) == 0
    recs = [json.loads(line) for line in
            (tmp_path / "ck" / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in recs] == [0, 1]
    assert recs[1]["step"] == 2 * recs[0]["step"]
