"""One rank of the PyTorch port's data-parallel tests
(tests/test_torch_port_dp.py), run as its own process: it imports torch
and the port only, never JAX.

    python tests/torch_dp_worker.py MODE IN OUT RANK WORLD PORT

joins a gloo group of WORLD ranks on 127.0.0.1:PORT (the CPU), reads its
inputs from the torch.save file IN and writes its results to
OUT/rank<RANK>.pt. Modes:
  step   the configurations of IN["configs"]: each starts a model from the
         given state dict and takes three DP train steps on this rank's
         batches and JAX-drawn views; it records the loss, the state
         dict, the step-0 gradients and Adam moments.
  world1 (WORLD 1) the DP step against the one-card step on the same
         batch, views and state, two steps of each configuration: loss,
         state dict and gradients, bit for bit.
  plan   a Pretrainer on IN["smiles"] under data_axis: this rank's split,
         its steps per epoch, the unit spec, units and their stack, and
         the unit rows of epochs 0 and 1; then, with fresh_compositions
         off, the batch-cache shard size and the cache orders of epoch 1
         after one host epoch.
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
from molclr_tpu_torch.data.graphs import GraphBatch  # noqa: E402
from molclr_tpu_torch.parallel import destroy_distributed, \
    init_distributed  # noqa: E402
from molclr_tpu_torch.train import optim  # noqa: E402
from molclr_tpu_torch.train.checkpoints import transfer_state  # noqa: E402
from molclr_tpu_torch.train.config import ModelConfig, \
    PretrainConfig  # noqa: E402
from molclr_tpu_torch.train.pretrain import Pretrainer, build_model, \
    train_step  # noqa: E402


def port_views(bp: GraphBatch, deltas):
    """The two views of a base batch from JAX's AUG_DELTA_FIELDS."""
    return tuple(apply_view_delta(bp, tuple(
        torch.from_numpy(np.asarray(a).astype(
            np.int64 if f in ("atom_type", "chirality") else bool))
        for f, a in zip(AUG_DELTA_FIELDS, d))) for d in deltas)


def state_np(model) -> dict:
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def run_steps(c: dict, rank: int, dp) -> dict:
    cfg = PretrainConfig(batch_size=c["batch_size"], warm_up=0,
                         init_lr=c["lr"], weight_decay=c["weight_decay"],
                         aug=c["aug"], ntxent_impl=c["impl"],
                         data_axis="data" if dp is not None else "",
                         model=ModelConfig(**c["model"]))
    model = build_model(cfg, dp=dp)
    got = transfer_state(c["init"], model)
    assert got["skipped"] == [], got["skipped"]
    opt = optim.adam_torch(model.parameters(), cfg.weight_decay)
    out = {"losses": [], "states": []}
    for s, step in enumerate(c["steps"]):
        bp = GraphBatch(**step["batches"][rank]).to("cpu")
        loss = train_step(model, opt, bp, cfg, s, cfg.init_lr,
                          views=port_views(bp, step["views"][rank]),
                          bond_window=c["bond_window"], dp=dp)
        out["losses"].append(float(loss))
        out["states"].append(state_np(model))
        if s == 0:
            out["grads0"] = {k: p.grad.numpy().copy()
                             for k, p in model.named_parameters()}
            out["mu0"] = {k: opt.state[p]["exp_avg"].numpy().copy()
                          for k, p in model.named_parameters()}
            out["nu0"] = {k: opt.state[p]["exp_avg_sq"].numpy().copy()
                          for k, p in model.named_parameters()}
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
        else:
            raise ValueError(f"unknown mode {mode!r}")
    finally:
        destroy_distributed()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
