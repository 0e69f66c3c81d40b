"""One rank of the PyTorch port's data-parallel tests
(tests/test_torch_port_dp.py), run as its own process: it imports torch
and the port only, never JAX.

    python tests/torch_dp_worker.py MODE IN OUT RANK WORLD PORT

joins a gloo group of WORLD ranks on 127.0.0.1:PORT (the CPU), reads its
inputs from the torch.save file IN and writes its results to
OUT/rank<RANK>.pt. Modes:
  step   the configurations of IN["configs"]: each starts a model from the
         given state dict and takes three DP train steps on this rank's
         batches and JAX-drawn views (and with dropout JAX's keep masks);
         it records the loss, the state dict, the step-0 gradients and
         Adam moments.
  world1 (WORLD 1) the DP step against the one-card step on the same
         batch, views and state, two steps of each configuration: loss,
         state dict and gradients, bit for bit.
  plan   a Pretrainer on IN["smiles"] under data_axis: this rank's split,
         its steps per epoch, the unit spec, units and their stack, and
         the unit rows of epochs 0 and 1; then, with fresh_compositions
         off, the batch-cache shard size and the cache orders of epoch 1
         after one host epoch; then a run of IN["drop_cfg"] (dropout >
         0): the keep masks its steps drew, and the masks of this rank's
         generator streams for the same steps.
  part   (tests/test_torch_port_partition.py) the node-row-sharded step:
         each configuration of IN["configs"] concatenates its per-shard
         batches (concat_shards), takes this rank's segment
         (shard_graph_batch) and runs partitioned_train_step from the
         given state on JAX-drawn views of the localized shard (or none)
         and, with dropout, JAX's keep masks:
         optionally a return_grads call first (its loss, gradients and
         whether the state stayed as it was), then its steps' losses,
         states, step-0 gradients and Adam moments, and the all-reduces
         per step. Then IN["edge"]: each edgepart variant's forward and
         backward on this rank's rows (out, dh, the tables' partial
         gradients and their sums across the ranks, the all-reduces and
         bytes of the forward and backward).
  part1  (WORLD 1) the partitioned step against the one-card step on the
         same batch, views and state, two steps of each configuration,
         and the return_grads call against the one-card gradients.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from molclr_tpu_torch.data.augment import AUG_DELTA_FIELDS, \
    apply_view_delta  # noqa: E402
from molclr_tpu_torch.data.graphs import GraphBatch, \
    concat_shards  # noqa: E402
from molclr_tpu_torch.parallel import build_sharded_layer, \
    destroy_distributed, init_distributed, localize_shard, \
    partitioned_train_step, shard_ell_rows, shard_graph_batch  # noqa: E402
from molclr_tpu_torch.train import optim  # noqa: E402
from molclr_tpu_torch.train.checkpoints import transfer_state  # noqa: E402
from molclr_tpu_torch.train.config import ModelConfig, \
    PretrainConfig  # noqa: E402
from molclr_tpu_torch.train.pretrain import Pretrainer, build_model, \
    forward_backward, train_step  # noqa: E402


def port_views(bp: GraphBatch, deltas):
    """The two views of a base batch from JAX's AUG_DELTA_FIELDS."""
    return tuple(apply_view_delta(bp, tuple(
        torch.from_numpy(np.asarray(a).astype(
            np.int64 if f in ("atom_type", "chirality") else bool))
        for f, a in zip(AUG_DELTA_FIELDS, d))) for d in deltas)


def port_masks(masks):
    """JAX's keep masks of one rank and step as train_step takes them
    (None without dropout)."""
    if masks is None:
        return None
    return [[torch.from_numpy(np.asarray(m)) for m in view]
            for view in masks]


def state_np(model) -> dict:
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def _setup(c: dict, dp):
    cfg = PretrainConfig(batch_size=c["batch_size"], warm_up=0,
                         init_lr=c["lr"], weight_decay=c["weight_decay"],
                         aug=c["aug"], ntxent_impl=c["impl"],
                         data_axis="data" if dp is not None else "",
                         model=ModelConfig(**c["model"]))
    model = build_model(cfg, dp=dp)
    got = transfer_state(c["init"], model)
    assert got["skipped"] == [], got["skipped"]
    return cfg, model, optim.adam_torch(model.parameters(), cfg.weight_decay)


def _record(out: dict, model, opt, s: int, loss) -> None:
    out["losses"].append(float(loss))
    out["states"].append(state_np(model))
    if s == 0:
        out["grads0"] = {k: p.grad.numpy().copy()
                         for k, p in model.named_parameters()}
        out["mu0"] = {k: opt.state[p]["exp_avg"].numpy().copy()
                      for k, p in model.named_parameters()}
        out["nu0"] = {k: opt.state[p]["exp_avg_sq"].numpy().copy()
                      for k, p in model.named_parameters()}


def run_steps(c: dict, rank: int, dp) -> dict:
    cfg, model, opt = _setup(c, dp)
    out = {"losses": [], "states": []}
    for s, step in enumerate(c["steps"]):
        bp = GraphBatch(**step["batches"][rank]).to("cpu")
        masks = step.get("masks")
        loss = train_step(model, opt, bp, cfg, s, cfg.init_lr,
                          views=port_views(bp, step["views"][rank]),
                          dropout_masks=port_masks(
                              None if masks is None else masks[rank]),
                          bond_window=c["bond_window"], dp=dp)
        _record(out, model, opt, s, loss)
    return out


def run_partitioned(c: dict, rank: int, dp, one_card: bool = False) -> dict:
    """The configuration's partitioned steps on this rank's segment of the
    concatenated shards (one_card: the one-card train_step on the whole
    concatenated batch, with the views of the same steps)."""
    cfg, model, opt = _setup(c, None if one_card else dp)
    cat = concat_shards([GraphBatch(**b).to("cpu") for b in c["shards"]])
    shard = shard_graph_batch(cat, dp, device="cpu", tile=cfg.model.tile)
    local = cat if one_card else localize_shard(shard, dp)
    views = [None if v is None else port_views(local, v[rank])
             for v in c["views"]]
    masks = [port_masks(None if m is None else m[rank])
             for m in c.get("masks", [None] * len(views))]
    kw = dict(bond_window=c["bond_window"])
    out = {"losses": [], "states": []}
    if c.get("return_grads"):
        before = state_np(model)
        if one_card:
            loss = forward_backward(model, opt, local, cfg, 0,
                                    views=views[0], dropout_masks=masks[0],
                                    **kw)
            grads = {k: p.grad for k, p in model.named_parameters()}
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in before.items()})
        else:
            loss, grads = partitioned_train_step(
                model, opt, shard, cfg, 0, cfg.init_lr, dp, views=views[0],
                dropout_masks=masks[0], return_grads=True, **kw)
        after = state_np(model)
        out["rg"] = dict(loss=float(loss), grads={
            k: g.numpy().copy() for k, g in grads.items()},
            unchanged=all(np.array_equal(v, after[k])
                          for k, v in before.items()),
            opt_empty=len(opt.state) == 0)
    c0 = dp.collectives
    for s, (v, m) in enumerate(zip(views, masks)):
        if one_card:
            loss = train_step(model, opt, local, cfg, s, cfg.init_lr,
                              views=v, dropout_masks=m, **kw)
        else:
            loss = partitioned_train_step(model, opt, shard, cfg, s,
                                          cfg.init_lr, dp, views=v,
                                          dropout_masks=m, **kw)
        _record(out, model, opt, s, loss)
    out["collectives_per_step"] = (dp.collectives - c0) / len(views)
    return out


def run_edgepart(e: dict, rank: int, dp) -> dict:
    """Each variant's forward and backward on this rank's rows of e's
    batches, h and cotangent."""
    out = {}
    for variant, packing in (("gather", "plain"), ("halo", "plain"),
                             ("tile", "tiled")):
        batch = GraphBatch(**e[packing]).to("cpu")
        sh = {k: v[rank] for k, v in shard_ell_rows(batch,
                                                    dp.world).items()}
        rows = slice(rank * sh["nbr"].shape[0],
                     (rank + 1) * sh["nbr"].shape[0])
        h = torch.from_numpy(e[f"h_{packing}"][rows]).requires_grad_()
        t1, t2 = (torch.from_numpy(e[k]).requires_grad_()
                  for k in ("t1", "t2"))
        layer = build_sharded_layer(dp, variant, halo=e["halo"],
                                    tile=e["tile"])
        c0, b0 = dp.collectives, dp.reduced_bytes
        o = layer(h, t1, t2, sh["nbr"], sh["nbr_bond_type"],
                  sh["nbr_bond_dir"], sh["nbr_mask"])
        c1, b1 = dp.collectives, dp.reduced_bytes
        o.backward(torch.from_numpy(e[f"cot_{packing}"][rows]))
        c2, b2 = dp.collectives, dp.reduced_bytes
        rec = dict(out=o.detach().numpy().copy(),
                   dh=h.grad.numpy().copy(),
                   dt1_partial=t1.grad.numpy().copy(),
                   dt2_partial=t2.grad.numpy().copy(),
                   collectives=(c1 - c0, c2 - c1),
                   reduced_bytes=(b1 - b0, b2 - b1))
        # the caller's sum of the tables' partial gradients
        rec["dt1"] = dp.all_reduce_(t1.grad.clone()).numpy()
        rec["dt2"] = dp.all_reduce_(t2.grad.clone()).numpy()
        out[variant] = rec
    return out


def plan(inp: dict, rank: int, dp) -> dict:
    out = {}
    for fresh in (True, False):
        cfg = PretrainConfig(**inp["cfg"], fresh_compositions=fresh,
                             data_axis="data",
                             ckpt_dir=os.path.join(inp["tmp"],
                                                   f"r{rank}{fresh}"),
                             model=ModelConfig(**inp["model"]))
        pre = Pretrainer(cfg, "cpu", dp=dp).setup_data(inp["smiles"])
        pre.setup_state()
        if fresh:
            pre._activate_units(lambda *a: None)
            out.update(
                train=[g.n_atoms for g in pre.train_iter.graphs],
                valid=[g.n_atoms for g in pre.valid_iter.graphs],
                steps_per_epoch=pre.steps_per_epoch,
                uspec=tuple(vars(pre.unit_spec).values()),
                n_units=pre._n_units, units_per_batch=pre._units_per_batch,
                stack={k: v.cpu().numpy() for k, v in pre._stack.items()},
                orders=[pre._unit_orders(e) for e in (0, 1)])
        else:
            pre._host_epoch(0, lambda *a: None)
            pre._maybe_upload_cache(lambda *a: None)
            out.update(shard_size=pre._dp_shard_size,
                       cache_orders=pre.train_iter.cached_epoch_order(),
                       resident=pre._stack is not None)
    if "drop_cfg" in inp:
        out["dropout"] = dropout_draws(inp, rank, dp)
    return out


def dropout_draws(inp: dict, rank: int, dp) -> dict:
    """A Pretrainer run of IN["drop_cfg"] (drop_ratio > 0) under data_axis:
    {step: [view i, view j] keep masks} that its train steps drew (every
    draw_keep call, recorded with the step count), and the same from this
    rank's streams step_generator(seed, DROPOUT_STREAM, step, view,
    rank)."""
    from molclr_tpu_torch.models import nets
    from molclr_tpu_torch.train.pretrain import DROPOUT_STREAM, \
        step_generator

    cfg = PretrainConfig(**inp["drop_cfg"], data_axis="data",
                         ckpt_dir=os.path.join(inp["tmp"], f"d{rank}"),
                         model=ModelConfig(**inp["drop_model"]))
    pre = Pretrainer(cfg, "cpu", dp=dp).setup_data(inp["smiles"])
    pre.setup_state()
    drawn, draw = [], nets.draw_keep

    def recorded(*args, **kw):
        keep = draw(*args, **kw)
        drawn.append((pre.step, keep.clone()))
        return keep

    nets.draw_keep = recorded
    try:
        pre.train(log=lambda *a: None)
    finally:
        nets.draw_keep = draw
    layers = cfg.model.num_layers
    out = {"drawn": {}, "stream": {}}
    for step in sorted({s for s, _ in drawn}):
        masks = [m for s, m in drawn if s == step]
        assert len(masks) == 2 * layers, len(masks)
        out["drawn"][step] = [masks[:layers], masks[layers:]]
        n = masks[0].shape[0]
        out["stream"][step] = [pre.model.keep_masks(n, step_generator(
            cfg.seed, DROPOUT_STREAM, step, view, rank)) for view in (0, 1)]
    return out


def main() -> None:
    mode, inp_path, out_dir = sys.argv[1:4]
    rank, world, port = (int(x) for x in sys.argv[4:7])
    torch.manual_seed(0)
    dp = init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo",
                          timeout_s=120, log=lambda *a: None)
    inp = torch.load(inp_path, weights_only=False)
    try:
        if mode == "step":
            out = {c["name"]: run_steps(c, rank, dp) for c in inp["configs"]}
            out["collectives"] = dp.collectives
        elif mode == "world1":
            out = {}
            for c in inp["configs"]:
                out[c["name"]] = {"dp": run_steps(c, rank, dp),
                                  "one": run_steps(c, rank, None)}
        elif mode == "plan":
            out = plan(inp, rank, dp)
        elif mode == "part":
            out = {c["name"]: run_partitioned(c, rank, dp)
                   for c in inp["configs"]}
            out["edge"] = run_edgepart(inp["edge"], rank, dp)
        elif mode == "part1":
            out = {c["name"]: {"part": run_partitioned(c, rank, dp),
                               "one": run_partitioned(c, rank, dp, True)}
                   for c in inp["configs"]}
        else:
            raise ValueError(f"unknown mode {mode!r}")
    finally:
        destroy_distributed()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
