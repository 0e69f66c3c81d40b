"""MolCLR contrastive pretraining (ref molclr.py:33-177) on one card.

Port of molclr_tpu/train/pretrain.py: `train_step` / `eval_step` (its
`loss_fn`, `train_step` and `eval_step`) and a `Pretrainer` on the host
streaming path, for GIN and GCN (normalize_gcn too), every augmentation
kind (node, subgraph, mix, none), dropout (drop_ratio > 0: the unchained
trunk) and concat_views. Per step, two views are drawn by paired_augment
(the BFS kinds within the corpus-derived horizon `max_waves`); both run
through the model in train mode one after the other, so view j's BatchNorm
sees the running stats view i updated, or with concat_views as one batch
in one forward; the loss is the masked NT-Xent of (zi, zj) in f32 with
pair_mask = graph_mask; gradients flow through the kernels' backward
passes; and Adam with torch semantics steps on the epoch-granular warm-up
+ cosine schedule.

Augmentation draws come from CPU torch.Generators seeded from (cfg.seed,
step) (`step_generator`), so a resumed run redraws the same stream and a
run on the card sees the same views as one on the CPU; dropout draws its
masks on the model's device from generators seeded from (cfg.seed, step,
view), one stream per view as JAX's rng_di / rng_dj. Not ported yet: the
JAX Pretrainer's TPU dispatch machinery (scan folding, precomputed
augmentation, device-resident caches and tile-unit regrouping, the narrow
wire format, the prefetch thread, the on-disk corpus), data parallelism,
TensorBoard and profiling.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from molclr_tpu_torch.data.augment import paired_augment
from molclr_tpu_torch.data.graphs import concat_views
from molclr_tpu_torch.data.loader import (
    BatchIterator,
    featurize_many,
    read_pretrain_smiles,
    spec_for_graphs,
)
from molclr_tpu_torch.losses import nt_xent_loss, resolve_ntxent
from molclr_tpu_torch.models import MolCLRNet
from molclr_tpu_torch.train import checkpoints as ckpt_lib
from molclr_tpu_torch.train.config import PretrainConfig, to_dict
from molclr_tpu_torch.train.logging_util import MetricWriter
from molclr_tpu_torch.train.optim import adam_torch, set_lr, \
    warmup_then_cosine

# stream ids of step_generator
TRAIN_STREAM, VALID_STREAM, DROPOUT_STREAM = 0, 1, 2


def step_generator(seed: int, *ids: int, device="cpu") -> torch.Generator:
    """A torch.Generator on `device` seeded from (seed, *ids): the
    augmentation draws of one train step (TRAIN_STREAM, step) or one
    validation batch (VALID_STREAM, epoch, i) on the CPU, the dropout
    masks of one view of a train step (DROPOUT_STREAM, step, view) on the
    model's device."""
    words = np.random.SeedSequence([seed, *ids]).generate_state(2)
    return torch.Generator(device=device).manual_seed(
        (int(words[0]) << 31) ^ int(words[1]))


def build_model(cfg: PretrainConfig, generator: torch.Generator | None = None
                ) -> MolCLRNet:
    m = cfg.model
    return MolCLRNet(num_layers=m.num_layers, emb_dim=m.emb_dim,
                     feat_dim=m.feat_dim, gnn_type=m.gnn_type, pool=m.pool,
                     drop_ratio=m.drop_ratio, normalize_gcn=m.normalize_gcn,
                     dtype=torch.bfloat16 if m.bf16 else torch.float32,
                     tile=m.tile, generator=generator)


def _loss(loss_fn, cfg, zi, zj, batch):
    return loss_fn(zi.float(), zj.float(), cfg.temperature,
                   cfg.use_cosine_similarity, pair_mask=batch.graph_mask)


def _dropout_kw(model, cfg, step: int, view: int, masks) -> dict:
    """The dropout inputs of one forward: the given keep masks, or (with
    drop_ratio > 0) a generator on the model's device for (cfg.seed,
    step, view); nothing at drop_ratio 0."""
    if masks is not None:
        return dict(dropout_masks=masks)
    if model.drop_ratio == 0.0:
        return {}
    dev = next(model.parameters()).device
    return dict(generator=step_generator(cfg.seed, DROPOUT_STREAM, step,
                                         view, device=dev))


def train_step(model, opt, batch, cfg: PretrainConfig, step: int, lr: float,
               views=None, bond_window: int = 0, max_waves: int = 0,
               dropout_masks=None) -> torch.Tensor:
    """One optimizer step on one base batch; returns the loss (a 0-d
    tensor on the batch's device, not synchronized). views = (vi, vj)
    replaces the augmentation draw (as the JAX train_step's `views`);
    dropout_masks replaces the dropout draw: per view a list of bool keep
    masks [N, emb_dim], one per layer (with concat_views, one list for the
    joint batch, [2N, emb_dim]). The LR is the schedule at the step count
    before the update."""
    if views is None:
        views = paired_augment(batch, step_generator(cfg.seed, TRAIN_STREAM,
                                                     step),
                               cfg.aug, tile=cfg.model.tile,
                               bond_window=bond_window, max_waves=max_waves)
    vi, vj = views
    masks = dropout_masks or (None, None)
    model.train()
    if cfg.concat_views:
        _, z = model(concat_views(vi, vj),
                     **_dropout_kw(model, cfg, step, 0, masks[0]))
        g = batch.num_graphs
        zi, zj = z[:g], z[g:]
    else:
        _, zi = model(vi, **_dropout_kw(model, cfg, step, 0, masks[0]))
        _, zj = model(vj, **_dropout_kw(model, cfg, step, 1, masks[1]))
    loss = _loss(resolve_ntxent(cfg.ntxent_impl), cfg, zi, zj, batch)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    set_lr(opt, lr)
    opt.step()
    return loss.detach()


@torch.no_grad()
def eval_step(model, batch, cfg: PretrainConfig, generator: torch.Generator,
              bond_window: int = 0, max_waves: int = 0) -> torch.Tensor:
    """Validation loss of one batch: both views in eval mode, one after the
    other whatever concat_views says, the closed form NT-Xent (as the JAX
    eval_step)."""
    vi, vj = paired_augment(batch, generator, cfg.aug, tile=cfg.model.tile,
                            bond_window=bond_window, max_waves=max_waves)
    model.eval()
    _, zi = model(vi)
    _, zj = model(vj)
    return _loss(nt_xent_loss, cfg, zi, zj, batch)


class Pretrainer:
    """setup_data -> setup_state -> train, on `device` (a CUDA device unless
    the caller asks for the CPU)."""

    def __init__(self, cfg: PretrainConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.step = 0
        self._start_epoch = 0

    # ---- data ----
    def setup_data(self, smiles: list[str] | None = None):
        """Featurize and split the corpus: an explicit `smiles` list, or the
        SMILES text file cfg.data_path."""
        cfg = self.cfg
        if smiles is None:
            smiles = read_pretrain_smiles(cfg.data_path)
        graphs, _ = featurize_many(smiles, add_hs=(cfg.aug == "mix"),
                                   max_degree=cfg.max_degree)
        order = np.random.RandomState(cfg.seed).permutation(len(graphs))
        n_valid = int(len(graphs) * cfg.valid_size)
        valid_ids, train_ids = order[:n_valid], order[n_valid:]
        train = [graphs[i] for i in train_ids]
        valid = [graphs[i] for i in valid_ids]
        self.spec = spec_for_graphs(graphs, cfg.batch_size, cfg.max_degree,
                                    cfg.pad_slack, cfg.pad_quantile,
                                    tile=cfg.model.tile,
                                    sizing=cfg.pad_sizing)
        self._mean_real_nodes = (float(np.mean([g.n_atoms for g in train]))
                                 * cfg.batch_size if train else 0.0)
        self._mean_real_edges = (float(np.mean(
            [g.edge_src.shape[0] for g in train])) * cfg.batch_size
            if train else 0.0)
        # BFS horizon of subgraph / mix: max atoms - 1 bounds every graph's
        # eccentricity, so the wave sweep never under-removes (capped at
        # 2000 so that the wave key (max_waves + 1) * 2^20 stays in int32)
        max_atoms = max((g.n_atoms for g in graphs), default=2)
        self.max_waves = (cfg.max_waves if cfg.max_waves > 0
                          else max(1, min(max_atoms - 1, 2000)))
        self.train_iter = BatchIterator(
            train, self.spec, shuffle=True, drop_last=True, seed=cfg.seed,
            cache_packed=0 < len(train) <= cfg.pack_cache_max_mols)
        self.valid_iter = BatchIterator(
            valid, self.spec, shuffle=False, drop_last=False, seed=cfg.seed,
            cache_packed=0 < len(valid) <= cfg.pack_cache_max_mols)
        return self

    # ---- model / optimizer ----
    def setup_state(self):
        cfg = self.cfg
        self.model = build_model(
            cfg, torch.Generator().manual_seed(cfg.seed)).to(self.device)
        self.opt = adam_torch(self.model.parameters(), cfg.weight_decay)
        self.steps_per_epoch = max(1, len(self.train_iter))
        self.schedule = warmup_then_cosine(cfg.init_lr, self.steps_per_epoch,
                                           cfg.epochs, cfg.warm_up)
        if cfg.resume_from:
            self._resume(cfg.resume_from)
        return self

    def _resume(self, path: str) -> None:
        """A reference .pth (weights only: optimizer, step and schedule
        start from zero) or a full-state step_<step>.pt (the run continues
        its optimizer moments, step count, LR schedule and data stream)."""
        if path.endswith(".pth"):
            got = ckpt_lib.transfer_state(
                ckpt_lib.load_torch_state_dict(path), self.model)
            if got["copied"] == 0:
                raise ValueError(f"{path}: no tensor matches the model")
            return
        full = ckpt_lib.load_checkpoint(path)
        self.model.load_state_dict(full["model"])
        self.opt.load_state_dict(full["optimizer"])
        self.step = int(full["step"])
        self._start_epoch = int(full["epoch"]) + 1
        self.train_iter.set_epoch(self._start_epoch)
        self.valid_iter.set_epoch(self._start_epoch)

    # ---- loops ----
    def validate(self, epoch: int) -> float:
        losses = [eval_step(self.model, batch.to(self.device), self.cfg,
                            step_generator(self.cfg.seed, VALID_STREAM,
                                           epoch, i),
                            self.spec.max_graph_bonds, self.max_waves)
                  for i, (batch, _, _) in enumerate(self.valid_iter)]
        return (float(np.float32(np.mean([float(x) for x in losses])))
                if losses else float("nan"))

    def _save_best(self) -> None:
        path = os.path.join(self.cfg.ckpt_dir, "best.pth")
        torch.save({k: v.cpu() for k, v in self.model.state_dict().items()},
                   path)

    def train(self, log=print) -> list[dict]:
        cfg = self.cfg
        os.makedirs(cfg.ckpt_dir, exist_ok=True)
        with open(os.path.join(cfg.ckpt_dir, "config.json"), "w") as f:
            json.dump(to_dict(cfg), f, indent=2, default=str)
        writer = MetricWriter(cfg.ckpt_dir)
        best_val = float("inf")
        history = []
        # message edges per step = 2 views x layers x (real directed edges
        # + self-loops), bench.py's metric
        edges_per_step = 2 * cfg.model.num_layers * (
            self._mean_real_edges + self._mean_real_nodes)
        try:
            for epoch in range(self._start_epoch, cfg.epochs):
                t0 = time.perf_counter()
                losses = []
                for batch, _, _ in self.train_iter:
                    loss = train_step(self.model, self.opt,
                                      batch.to(self.device), cfg, self.step,
                                      self.schedule(self.step),
                                      bond_window=self.spec.max_graph_bonds,
                                      max_waves=self.max_waves)
                    self.step += 1
                    losses.append(loss)
                    if self.step % cfg.log_every_steps == 0:
                        log(f"epoch {epoch} step {self.step} loss "
                            f"{float(loss):.4f} lr "
                            f"{self.schedule(self.step):.6f}")
                losses = [float(x) for x in losses]   # synchronizes
                epoch_s = time.perf_counter() - t0
                record = {"epoch": epoch,
                          "train_loss": (float(np.mean(losses)) if losses
                                         else float("nan")),
                          "time_s": round(epoch_s, 2), "steps": len(losses),
                          "step": self.step,
                          "lr": self.schedule(self.step),
                          "edges_per_sec": round(edges_per_step * len(losses)
                                                 / max(epoch_s, 1e-9))}
                if (epoch + 1) % cfg.eval_every_epochs == 0:
                    val = self.validate(epoch)
                    record["valid_loss"] = val
                    if val < best_val:
                        best_val = val
                        self._save_best()
                stopping = (cfg.stop_after_epochs
                            and epoch + 1 >= cfg.stop_after_epochs
                            and epoch + 1 < cfg.epochs)
                if (epoch + 1) % cfg.save_every_epochs == 0 or stopping:
                    ckpt_lib.save_checkpoint(cfg.ckpt_dir, self.step, {
                        "model": self.model.state_dict(),
                        "optimizer": self.opt.state_dict(),
                        "step": self.step, "epoch": epoch})
                history.append(record)
                writer.record(record)
                log(f"epoch {epoch}: {record}")
                if stopping:
                    log(f"stop_after_epochs={cfg.stop_after_epochs}: "
                        f"stopping at epoch {epoch} (schedule set for "
                        f"{cfg.epochs} epochs; resume continues it)")
                    break
        finally:
            writer.close()
        return history
