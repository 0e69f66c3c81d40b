"""The PyTorch port's one-card dispatch machinery against the JAX package,
on the CPU: the tile-unit regroup (data/regroup.py), augmentation keys
drawn ahead and precomputed views (data/augment.py), the fused Adam
(train/optim.py), and the Pretrainer's units, frozen-cache and host paths,
resume, the adam_impl stamp and the resident eval stack.

Small sizes (2 layers, emb 16, feat 32, tile 32 or 64, 60-96 synthetic
molecules), f32. Host-side planning, packing, orders and views are held
bit-equal to the JAX package's (tolerance 0). The Pretrainer's units path
runs aug 'none' from JAX's weights and is held to the loss limits of
tests/test_torch_port_pretrain.py::test_train_step_matches_jax_pretrainer
(rtol 1e-5 at the first step, 1e-3 / atol 2e-5 after). The fused Adam is
held to JAX's adam_torch_fused at rtol 1e-6 (both are f32 elementwise
updates, rounded per operation) and to the chain Adam at the limits of
test_adam_step_matches_optax_adam_torch. The port's own paths (units,
frozen cache, host with and without prefetch, resumed) are held to each
other exactly: on the CPU they run the same operations on the same
batches and keys."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molclr_tpu.data import augment as jax_augment
from molclr_tpu.data import regroup as jax_regroup
from molclr_tpu.data.loader import featurize_many as jax_featurize_many
from molclr_tpu.data.synthetic import synthetic_corpus
from molclr_tpu.train import optim as jax_optim
from molclr_tpu.train.config import ModelConfig as JaxModelConfig
from molclr_tpu.train.config import PretrainConfig as JaxPretrainConfig
from molclr_tpu.train.pretrain import Pretrainer as JaxPretrainer
from molclr_tpu_torch.cli import pretrain as port_cli
from molclr_tpu_torch.data import augment, regroup
from molclr_tpu_torch.data.graphs import GraphBatch, concat_shards
from molclr_tpu_torch.data.loader import featurize_many, prefetch_iter
from molclr_tpu_torch.train import optim
from molclr_tpu_torch.train.checkpoints import latest_checkpoint, \
    state_dict_from_jax, transfer_state
from molclr_tpu_torch.train.config import ModelConfig, PretrainConfig, \
    pretrain_from_yaml
from molclr_tpu_torch.train.pretrain import TRAIN_STREAM, Pretrainer, \
    step_generator

SMALL = dict(num_layers=2, emb_dim=16, feat_dim=32)
FIELDS = [f.name for f in dataclasses.fields(GraphBatch)]


def _graphs(n=96, seed=5, add_hs=False):
    smiles = synthetic_corpus(n, seed=seed)
    gj, _ = jax_featurize_many(smiles, add_hs=add_hs, prefer_native=False)
    gp, _ = featurize_many(smiles, add_hs=add_hs)
    return gj, gp


# ------------------------------------------------------------ regroup


@pytest.mark.parametrize("tile", [32, 64])
def test_unit_plan_stack_and_orders_equal_jax(tile):
    gj, gp = _graphs()
    groups_j = jax_regroup.plan_units(gj, tile)
    groups_p = regroup.plan_units(gp, tile)
    assert ([[g.n_atoms for g in gr] for gr in groups_p]
            == [[g.n_atoms for g in gr] for gr in groups_j])
    spec_j = jax_regroup.unit_spec_for(groups_j, tile)
    spec_p = regroup.unit_spec_for(groups_p, tile)
    assert dataclasses.asdict(spec_p) == dataclasses.asdict(spec_j)
    stack_j, uspec_j, units_j = jax_regroup.pack_unit_stack(gj, tile, seed=3)
    stack_p, uspec_p, units_p = regroup.pack_unit_stack(gp, tile, seed=3)
    assert dataclasses.asdict(uspec_p) == dataclasses.asdict(uspec_j)
    assert len(units_p) == len(units_j)
    for f in FIELDS:
        assert np.array_equal(getattr(stack_p, f),
                              np.asarray(getattr(stack_j, f))), f
    wire = JaxPretrainer._wire_dtypes(uspec_j)
    assert regroup.wire_dtypes(uspec_p) == wire
    u = len(units_p)
    for narrow in (None, wire):
        assert (regroup.unit_stack_bytes(uspec_p, u, narrow)
                == jax_regroup.unit_stack_bytes(uspec_j, u, narrow))
        dev = regroup.upload_stack(stack_p, "cpu", narrow)
        assert (sum(t.numel() * t.element_size() for t in dev.values())
                == regroup.unit_stack_bytes(uspec_p, u, narrow))
    for n, t, seed, epoch in ((u, 5, 0, 0), (u, 5, 0, 3), (100, 8, 7, 1),
                              (37, 37, 2, 9)):
        assert np.array_equal(
            regroup.epoch_unit_orders(n, t, seed, epoch),
            jax_regroup.epoch_unit_orders(n, t, seed, epoch))


def test_wire_dtypes_refuse_specs_beyond_int16():
    from molclr_tpu_torch.data.graphs import PadSpec

    assert regroup.wire_dtypes(PadSpec(4, 1 << 15, 64, tile=256)) is None
    assert regroup.wire_dtypes(PadSpec(4, 256, 1 << 16, tile=256)) is None
    assert regroup.wire_dtypes(PadSpec(4, 256, 64, tile=256)) is not None


@pytest.mark.parametrize("narrow", [False, True])
def test_concat_units_equals_jax_and_concat_shards(narrow):
    """T unit rows regrouped on the device: equal to JAX's concat_units
    of the same stack (wide or narrow) and to the port's concat_shards of
    the same units, field for field, int64 / bool; the sentinel bond of
    every unit maps to T * B_t."""
    gj, gp = _graphs()
    stack_j, uspec, units_j = jax_regroup.pack_unit_stack(gj, 32, seed=3)
    stack_p, _, units_p = regroup.pack_unit_stack(gp, 32, seed=3)
    wire = JaxPretrainer._wire_dtypes(uspec) if narrow else None
    if narrow:
        stack_j = {f: np.asarray(getattr(stack_j, f)).astype(d)
                   for f, d in wire.items()}
    dev = regroup.upload_stack(stack_p, "cpu", wire)
    idx = np.random.RandomState(0).permutation(len(units_p))[:6]
    got = regroup.concat_units(dev, torch.from_numpy(idx.astype(np.int64)))
    want_j = jax_regroup.concat_units(stack_j, jnp.asarray(idx, jnp.int32))
    want_p = concat_shards([units_p[i].to("cpu") for i in idx])
    bmax = uspec.n_bonds
    for f in FIELDS:
        x = getattr(got, f)
        assert x.dtype == (torch.bool if f.endswith("mask") else torch.int64)
        assert torch.equal(x, getattr(want_p, f)), f
        assert np.array_equal(x.numpy(), np.asarray(getattr(want_j, f))), f
    # every unit has padding slots: the sentinel is the concatenated one
    assert int((got.nbr_bond == 6 * bmax).sum()) > 0
    assert int(got.nbr_bond.max()) == 6 * bmax


# ------------------------------------------------ keys ahead, deltas


def _unit_batches(add_hs, tile=64, steps=3):
    _, gp = _graphs(add_hs=add_hs)
    stack, uspec, units = regroup.pack_unit_stack(gp, tile, seed=1)
    dev = regroup.upload_stack(stack, "cpu", regroup.wire_dtypes(uspec))
    rows = torch.from_numpy(regroup.epoch_unit_orders(len(units), 4, 0, 0)
                            [:steps].astype(np.int64))
    return dev, rows, uspec


@pytest.mark.parametrize("kind", ["node", "subgraph", "mix"])
def test_precomputed_deltas_bit_identical_to_inline(kind):
    """A window of steps' keys drawn with each step's step_generator,
    flattened into one int64 row per step and unflattened, gives through
    precompute_deltas_for the views that paired_augment draws inline from
    the same generators, bit for bit (mix on molecules with hydrogens)."""
    dev, rows, uspec = _unit_batches(add_hs=kind == "mix")
    kw = dict(tile=64, bond_window=uspec.max_graph_bonds, max_waves=12)
    n, g = 4 * 64, 4 * uspec.n_graphs

    def batch(i):
        return regroup.concat_units(dev, rows[i])

    window = torch.stack([augment.flatten_keys(augment.draw_paired_keys(
        kind, n, g, step_generator(0, TRAIN_STREAM, 5 + i)))
        for i in range(len(rows))])
    deltas = augment.precompute_deltas_for(
        batch, lambda i: augment.unflatten_keys(kind, window[i], n, g),
        len(rows), kind, **kw)
    for i in range(len(rows)):
        inline = augment.paired_augment(
            batch(i), step_generator(0, TRAIN_STREAM, 5 + i), kind, **kw)
        for v, view in enumerate(inline):
            for f, d in zip(augment.AUG_DELTA_FIELDS, deltas[v]):
                assert torch.equal(d[i], getattr(view, f)), (i, v, f)
            full = augment.apply_view_delta(batch(i),
                                            tuple(d[i] for d in deltas[v]))
            assert torch.equal(full.nbr_mask, view.nbr_mask)
    shared = augment.precompute_paired_deltas(
        batch(0), lambda i: augment.unflatten_keys(kind, window[i], n, g),
        2, kind, **kw)
    assert torch.equal(shared[1][0][0], deltas[1][0][0])


@pytest.mark.parametrize("kind", ["node", "subgraph"])
def test_precomputed_deltas_equal_jax_given_its_keys(kind):
    """Given the keys JAX's precompute_deltas_for draws for each step (step
    i: split(fold_in(rng, i), 3)), the port's deltas equal JAX's."""
    gj, gp = _graphs()
    stack_j, uspec, _ = jax_regroup.pack_unit_stack(gj, 32, seed=3)
    stack_p, _, _ = regroup.pack_unit_stack(gp, 32, seed=3)
    dev = regroup.upload_stack(stack_p, "cpu")
    orders = regroup.epoch_unit_orders(stack_p.atom_type.shape[0], 5, 0, 1)
    bw, n = uspec.max_graph_bonds, 5 * 32
    rng = jax.random.PRNGKey(4)

    def rng_for_step(i):
        return jax.random.split(jax.random.fold_in(rng, i), 3)[0]

    want = jax_augment.precompute_deltas_for(
        lambda i: jax_regroup.concat_units(stack_j, jnp.asarray(orders)[i]),
        rng_for_step, 3, kind, tile=32, bond_window=bw, max_waves=9)

    def keys(i):
        r_i, r_j, r_start = jax.random.split(rng_for_step(i), 3)
        if kind == "node":
            out = []
            for r in (r_i, r_j):
                r_n, r_b = jax.random.split(r)
                out.append((torch.from_numpy(np.array(
                    jax_augment._rand_keys(r_n, n))), torch.from_numpy(
                    np.array(jax_augment._hash_salts(r_b)))))
            return tuple(out)
        return (torch.from_numpy(np.array(jax_augment._rand_keys(r_start,
                                                                  n))),
                tuple(torch.from_numpy(np.array(jax_augment._rand_keys(
                    jax.random.split(r)[1], n))) for r in (r_i, r_j)))

    got = augment.precompute_deltas_for(
        lambda i: regroup.concat_units(dev, torch.from_numpy(
            orders[i].astype(np.int64))),
        keys, 3, kind, tile=32, bond_window=bw, max_waves=9)
    for v in range(2):
        for f, a, b in zip(augment.AUG_DELTA_FIELDS, got[v], want[v]):
            assert np.array_equal(a.numpy(), np.asarray(b)), (v, f)


def test_prefetch_iter_keeps_order_raises_and_stops_when_abandoned():
    """The prefetch thread yields the items in order, raises the worker's
    exception in the consumer, and stops (within its put timeout) when the
    consumer abandons an endless iterator."""
    import itertools
    import threading

    assert list(prefetch_iter(iter(range(7)), 2)) == list(range(7))

    def failing():
        yield 1
        raise KeyError("boom")

    with pytest.raises(KeyError, match="boom"):
        list(prefetch_iter(failing(), 2))
    before = threading.active_count()
    it = prefetch_iter(itertools.count(), 2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    assert threading.active_count() == before + 1
    it.close()
    for _ in range(40):
        if threading.active_count() == before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() == before


# ---------------------------------------------------------- fused Adam


@pytest.mark.parametrize("wd", [0.0, 1e-5])
def test_fused_adam_matches_jax_adam_torch_fused(wd):
    """Five steps of FusedAdam against JAX's adam_torch_fused on the same
    gradients: parameters and moments within rtol 1e-6; the parameters
    live in the flat buffer as views, their gradients too."""
    rng = np.random.RandomState(1)
    shapes = [(7, 3), (5,), (4, 2, 2)]
    p0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    params = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in p0]
    opt = optim.FusedAdam(params, wd)
    optim.set_lr(opt, 5e-4)
    tx = jax_optim.adam_torch_fused(5e-4, wd)
    jp = [jnp.asarray(x) for x in p0]
    state = tx.init(jp)
    for step in range(5):
        g = [(rng.randn(*s) * 10.0 ** -step).astype(np.float32)
             for s in shapes]
        opt.zero_grad()
        for p, x in zip(params, g):
            p.grad.add_(torch.from_numpy(x))
        opt.step()
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = [a + b for a, b in zip(jp, upd)]
        for p, want in zip(params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(opt.mu.numpy(), np.asarray(state.mu),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(opt.nu.numpy(), np.asarray(state.nu),
                                   rtol=1e-6, atol=1e-15)
        assert int(opt.count) == int(state.count) == step + 1
    assert params[1].data_ptr() == opt.flat.data_ptr() + 21 * 4
    assert params[2].grad.data_ptr() == opt.grad.data_ptr() + 26 * 4


def test_fused_adam_matches_chain_adam():
    """One step of FusedAdam against the port's chain Adam (torch.optim.Adam)
    with weight decay, at the limits of test_adam_step_matches_optax_adam_
    torch: moments rtol 1e-6, update rtol 2e-4 (eps sits elsewhere); its
    state_dict reloads in place."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(50).astype(np.float32)
    g = (rng.randn(50) * 1e-2).astype(np.float32)
    pf = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    pc = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    fused = optim.make_adam("fused", [pf], 1e-5)
    chain = optim.make_adam("chain", [pc], 1e-5)
    for opt, p in ((fused, pf), (chain, pc)):
        opt.zero_grad()
        optim.set_lr(opt, 5e-4)
        if p.grad is None:
            p.grad = torch.from_numpy(g.copy())
        else:
            p.grad.copy_(torch.from_numpy(g))
        opt.step()
    np.testing.assert_allclose(fused.mu.numpy(),
                               chain.state[pc]["exp_avg"].numpy(),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(fused.nu.numpy(),
                               chain.state[pc]["exp_avg_sq"].numpy(),
                               rtol=1e-6, atol=1e-15)
    np.testing.assert_allclose(pf.detach().numpy() - p0,
                               pc.detach().numpy() - p0, rtol=2e-4, atol=1e-9)
    saved = fused.state_dict()
    fused.step()
    mu = fused.mu
    fused.load_state_dict(saved)
    assert fused.mu is mu and torch.equal(mu, saved["mu"])
    assert int(fused.count) == 1


# ------------------------------------------------------ the Pretrainer


def _cfgs(tmp_path, tag, epochs=3, **kw):
    shared = dict(batch_size=16, epochs=epochs, warm_up=1, aug="none",
                  valid_size=0.1, seed=0, eval_every_epochs=100,
                  save_every_epochs=100, device_cache_mb=512,
                  steps_per_dispatch=1)
    shared.update(kw)
    jax_cfg = JaxPretrainConfig(
        featurize_processes=0, ckpt_dir=str(tmp_path / f"j{tag}"),
        model=JaxModelConfig(tile=32, **SMALL), **shared)
    port_cfg = PretrainConfig(ckpt_dir=str(tmp_path / f"p{tag}"),
                              model=ModelConfig(tile=32, **SMALL), **shared)
    return jax_cfg, port_cfg


def test_pretrainer_units_path_matches_jax(tmp_path):
    """The JAX package's default one-card path (device_cache_mb > 0,
    fresh_compositions, tile > 0), steps_per_dispatch 1, aug 'none', from
    JAX's weights: the same unit plan (U, T), the same orders every epoch,
    and per-step losses within the step-parity limits."""
    smiles = synthetic_corpus(80, seed=9)
    cfg_j, cfg_p = _cfgs(tmp_path, "u", epochs=2)
    ref = JaxPretrainer(cfg_j).setup_data(smiles)
    ref.setup_state(next(iter(ref.train_iter))[0])
    ref._build_steps()
    inner, seen = ref._multi_step_units, []

    def recording(state, stack, idxs, rng):
        state, loss = inner(state, stack, idxs, rng)
        seen.append((np.asarray(idxs), np.asarray(loss)))
        return state, loss

    ref._multi_step_units = recording
    params = jax.tree_util.tree_map(np.asarray, ref.state.params)
    stats = jax.tree_util.tree_map(np.asarray, ref.state.batch_stats)
    ref.train(log=lambda *_: None)

    pre = Pretrainer(cfg_p, "cpu").setup_data(smiles).setup_state()
    assert transfer_state(state_dict_from_jax(params, stats),
                          pre.model)["skipped"] == []
    hist = pre.train(log=lambda *_: None)
    assert pre._units and ref._unit_stack is not None
    assert (pre._n_units, pre._units_per_batch) == (ref._n_units,
                                                    ref._units_per_batch)
    s = pre.steps_per_epoch
    assert [h["steps"] for h in hist] == [s, s] and len(seen) == 2 * s
    for epoch in range(2):
        orders = regroup.epoch_unit_orders(pre._n_units,
                                           pre._units_per_batch, 0, epoch)
        for i in range(s):
            assert np.array_equal(seen[epoch * s + i][0][0], orders[i])
    want = np.concatenate([loss for _, loss in seen])
    got = np.concatenate(pre.epoch_losses)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=0.0)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3, atol=2e-5)


def _losses(pre) -> list[float]:
    return np.concatenate(pre.epoch_losses).tolist()


def _port_run(tmp_path, tag, smiles, **kw):
    cfg = PretrainConfig(
        batch_size=16, epochs=kw.pop("epochs", 3), warm_up=1,
        valid_size=kw.pop("valid_size", 0.1), seed=0, eval_every_epochs=kw.pop("eval_every_epochs", 100),
        save_every_epochs=kw.pop("save_every_epochs", 100),
        ckpt_dir=str(tmp_path / tag), model=ModelConfig(tile=32, **SMALL),
        **kw)
    pre = Pretrainer(cfg, "cpu").setup_data(smiles).setup_state()
    hist = pre.train(log=lambda *_: None)
    return pre, hist


def test_frozen_cache_and_prefetch_give_the_host_paths_losses(tmp_path):
    """The host path with the prefetch thread, and the frozen resident
    batch cache (fresh_compositions False: uploaded after epoch 0, its
    batches taken in the iterator's order), give the eager host path's
    per-step losses exactly, node augmentation included."""
    smiles = synthetic_corpus(60, seed=8)
    base, _ = _port_run(tmp_path, "host", smiles, device_cache_mb=0,
                        prefetch=0)
    assert base._stack is None
    pre, _ = _port_run(tmp_path, "prefetch", smiles, device_cache_mb=0,
                       prefetch=2)
    assert _losses(pre) == _losses(base)
    frozen, _ = _port_run(tmp_path, "frozen", smiles,
                          fresh_compositions=False)
    assert frozen._stack is not None and not frozen._units
    assert frozen._units_per_batch == 1
    assert _losses(frozen) == _losses(base)


@pytest.mark.parametrize("replan", [0, 2])
def test_resume_continues_the_unit_stream(tmp_path, replan):
    """A run stopped after epoch 1 of 4 and resumed draws the same units
    and orders (replanned at epoch 2 when replan_units_every = 2) and
    takes the uninterrupted run's steps exactly; a replan changes the
    stream."""
    smiles = synthetic_corpus(60, seed=8)
    kw = dict(epochs=4, aug="node", replan_units_every=replan)
    full, _ = _port_run(tmp_path, "full", smiles, **kw)
    assert full._units
    _port_run(tmp_path, "cut", smiles, stop_after_epochs=2, **kw)
    path = latest_checkpoint(str(tmp_path / "cut"))
    second, hist = _port_run(tmp_path, "cut", smiles, resume_from=path, **kw)
    assert [h["epoch"] for h in hist] == [2, 3]
    n = len(_losses(second))
    assert _losses(second) == _losses(full)[-n:]
    assert second._units_plan_epoch == (2 if replan else 0)
    if replan:
        plain, _ = _port_run(tmp_path, "plain", smiles, epochs=4, aug="node")
        assert _losses(plain)[:n] == _losses(full)[:n]
        assert _losses(plain)[-n:] != _losses(full)[-n:]


def test_resume_refuses_another_adam_impl(tmp_path):
    smiles = synthetic_corpus(60, seed=8)
    _port_run(tmp_path, "f", smiles, epochs=2, save_every_epochs=1,
              adam_impl="fused")
    path = latest_checkpoint(str(tmp_path / "f"))
    stamp = json.loads(open(path.replace(".pt", ".train_meta.json")).read())
    assert stamp == {"adam_impl": "fused"}
    cfg = PretrainConfig(batch_size=16, epochs=3, valid_size=0.1,
                         resume_from=path, ckpt_dir=str(tmp_path / "c"),
                         model=ModelConfig(tile=32, **SMALL))
    with pytest.raises(ValueError, match="adam_impl='fused'"):
        Pretrainer(cfg, "cpu").setup_data(smiles).setup_state()
    cfg.adam_impl = "fused"
    pre = Pretrainer(cfg, "cpu").setup_data(smiles).setup_state()
    assert int(pre.opt.count) == pre.step > 0


def test_resident_eval_stack_gives_the_streamed_loss(tmp_path):
    """Validation streams its batches on the first pass, then uploads them
    once; the resident pass gives the streamed loss bit for bit."""
    smiles = synthetic_corpus(96, seed=8)
    pre, _ = _port_run(tmp_path, "v", smiles, epochs=1, valid_size=0.35,
                       aug="node")
    assert pre._eval_stack is None
    streamed = pre.validate(3)
    assert pre._eval_stack is not None
    assert len(pre.valid_iter) > 1
    assert pre.validate(3) == streamed
    assert pre.validate(4) != streamed


def test_fused_adam_pretrainer_tracks_chain(tmp_path):
    """The units path with adam_impl 'fused' against 'chain': the same
    first loss, and the later ones within the step-parity limits."""
    smiles = synthetic_corpus(60, seed=8)
    chain, _ = _port_run(tmp_path, "chain", smiles, epochs=2, aug="node")
    fused, _ = _port_run(tmp_path, "fused", smiles, epochs=2, aug="node",
                         adam_impl="fused")
    assert _losses(fused)[0] == _losses(chain)[0]
    np.testing.assert_allclose(_losses(fused), _losses(chain),
                               rtol=1e-3, atol=2e-5)


def test_graph_steps_follow_steps_per_dispatch():
    """Steps per CUDA graph: none on the CPU, at 1 or on the host path
    (device_cache_mb 0); one under 'auto' and k at k on the card; dropout (which a graph cannot capture) runs
    eager under 'auto' with a note and raises when k > 1 asks for it."""
    def steps(device, k, drop=0.0, cache_mb=2048):
        cfg = PretrainConfig(steps_per_dispatch=k, device_cache_mb=cache_mb,
                             model=ModelConfig(drop_ratio=drop))
        pre = Pretrainer(cfg, device)
        return pre._resolve_graph_steps(), pre._graph_note

    assert steps("cpu", 0) == (0, "")
    assert steps("cuda", 1) == (0, "")
    assert steps("cuda", 0, cache_mb=0) == (0, "")
    assert steps("cuda", 0) == (1, "")
    assert steps("cuda", 3) == (3, "")
    got, note = steps("cuda", 0, drop=0.1)
    assert got == 0 and "dropout" in note
    with pytest.raises(ValueError, match="steps_per_dispatch=3"):
        steps("cuda", 3, drop=0.1)


def test_cli_dispatch_flags_reach_the_config(tmp_path):
    """The one-card dispatch flags of the JAX CLI set their config fields;
    the YAML takes them as top-level keys; --profile-dir writes a
    trace."""
    yaml_path = tmp_path / "small.yaml"
    yaml_path.write_text("batch_size: 16\nepochs: 1\nwarm_up: 1\n"
                         "adam_impl: fused\nprefetch: 0\n"
                         "aug_precompute: false\nmodel:\n  num_layer: 2\n"
                         "  emb_dim: 16\n  feat_dim: 32\n  tile: 32\n")
    cfg = pretrain_from_yaml(str(yaml_path))
    assert (cfg.adam_impl, cfg.prefetch, cfg.aug_precompute) == ("fused", 0,
                                                                 False)
    ck = tmp_path / "ck"
    assert port_cli.main([
        "--config", str(yaml_path), "--synthetic", "40", "--data",
        str(tmp_path / "c.txt"), "--ckpt-dir", str(ck), "--cpu",
        "--steps-per-dispatch", "2", "--device-cache-mb", "64",
        "--pack-cache-max-mols", "1000", "--narrow-cache", "off",
        "--replan-units-every", "3", "--profile-dir",
        str(tmp_path / "prof")]) == 0
    got = json.loads((ck / "config.json").read_text())
    assert (got["steps_per_dispatch"], got["device_cache_mb"],
            got["pack_cache_max_mols"], got["narrow_cache"],
            got["replan_units_every"], got["adam_impl"]) == (
        2, 64, 1000, "off", 3, "fused")
    assert (tmp_path / "prof" / "trace.json").exists()
