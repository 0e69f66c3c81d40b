"""MoleculeNet fine-tuning (ref finetune.py:61-395) on one card.

Port of molclr_tpu/train/finetune.py: `resolve_task_csv`, `SharedTaskData`,
`FineTuner`, `run_all_targets` and `_append_experiments_csv`, with the JAX
package's behaviour: scaffold / random splits, qm7 / qm9 label z-scoring
(a Normalizer per target column) and the qm9 unit scale, CE / MSE / L1
losses, ROC-AUC / RMSE / MAE with metric-gated best-state selection per
member and a final test pass on the best states, warm start by partial
transfer, and the motif head with its vocabulary encoded by the plain
network.

Members. A FineTuner trains M = T x S members side by side: the T target
columns of `targets` (a multi-target task whose columns keep the same
rows, cfg.batch_targets) times cfg.n_seeds seeds; member m = t * S + s
trains on column t from seed cfg.seed + s. This is the JAX package's
vmapped member axis. Here each member is its own module, so the kernel
wrappers, `transfer_state` and `state_dict_from_jax` serve unchanged; a
step runs every member on one shared batch (M launches of each layer
kernel where the JAX package launches one with a member grid axis), and
one two-group Adam over all members' parameters steps them as M Adams
would (Adam is elementwise). Dropout: seed s draws its keep masks once per
step from a generator seeded cfg.seed + 17 + s and hands them to its T
members, as the JAX package gives the members of a seed one stream.

Resident split stacks. Each split is one stack of packed batches on the
device (the batches, labels [G] or [G, T], motif ids and mask, zeros
without motifs), as the JAX package's `_split_stack`; a step takes its
batch through a device index (`concat_units`), so nothing is uploaded per
step. repack_each_epoch re-draws the train compositions on the host every
epoch and refills the same device buffers; False uploads the train stack
once and takes `cached_epoch_order` every epoch.

On the card, every step after GRAPH_WARMUP_STEPS eager ones is one replay
of a CUDA graph of the M members' step, and every evaluate one replay over
the split's stack followed by one readback (train/graphed.py); a capture
that fails raises. FineTuner(graphed=False) keeps the card eager; the CPU
always runs eager. Best states stay on the device.
"""

from __future__ import annotations

import copy
import csv
import os
import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from molclr_tpu_torch.cli.embed import resolve_device
from molclr_tpu_torch.data.loader import (
    BatchIterator,
    featurize_many,
    spec_for_graphs,
)
from molclr_tpu_torch.data.motifs import build_motif_vocab, \
    encode_motif_vocab, mol_fragment_keys
from molclr_tpu_torch.data.regroup import concat_units, stack_batches, \
    upload_stack
from molclr_tpu_torch.data.splits import generate_scaffold, random_split, \
    scaffold_split
from molclr_tpu_torch.data.tasks import TASKS, TaskSpec, qm9_label_scale
from molclr_tpu_torch.models import FineTuneNet, MotifFineTuneNet
from molclr_tpu_torch.train import checkpoints as ckpt_lib
from molclr_tpu_torch.train.config import FineTuneConfig
from molclr_tpu_torch.train.graphed import GRAPH_WARMUP_STEPS, GraphedSteps
from molclr_tpu_torch.train.logging_util import MetricWriter
from molclr_tpu_torch.train.metrics import METRIC_DIRECTION, METRICS, \
    Normalizer
from molclr_tpu_torch.train.optim import two_group_adam

def resolve_task_csv(cfg: FineTuneConfig, spec: TaskSpec) -> tuple[str, bool]:
    """Locate the task CSV under data_root. When absent, raise, or (iff
    cfg.synthetic_fallback) fabricate a synthetic stand-in with a warning.
    Returns (path, synthetic): synthetic=True must reach every reported
    result. A CSV with a `_synthetic` column (written by write_task_csv)
    counts as synthetic even when it was already on disk."""
    path = os.path.join(cfg.data_root, spec.data_path)
    if not os.path.exists(path):
        if not cfg.synthetic_fallback:
            raise FileNotFoundError(
                f"task CSV not found: {path!r} (task {spec.name!r}, "
                f"data_root {cfg.data_root!r}). Place the MoleculeNet CSV "
                f"there, or pass --allow-synthetic / set "
                f"cfg.synthetic_fallback=True to train on a fabricated "
                f"synthetic stand-in (results will be stamped "
                f"synthetic=true).")
        from molclr_tpu_torch.data.synthetic import write_task_csv

        warnings.warn(
            f"task CSV {path!r} missing; fabricating a SYNTHETIC stand-in "
            f"({cfg.synthetic_n} rows). Metrics from this run do NOT "
            f"reflect the real {spec.name} task.", stacklevel=2)
        write_task_csv(path, spec, n=cfg.synthetic_n, seed=cfg.seed)
        return path, True
    try:
        with open(path, newline="") as f:
            header = next(csv.reader(f), [])
        if "_synthetic" in header:
            return path, True
    except OSError:
        pass
    return path, False


class SharedTaskData:
    """One task's CSV read once with all label columns, every parseable
    molecule featurized once, and scaffold / BRICS keys computed once
    (lazily), shared by the FineTuners of its target columns."""

    def __init__(self, cfg: FineTuneConfig, task: TaskSpec):
        self.cfg, self.task = cfg, task
        csv_path, self.synthetic = resolve_task_csv(cfg, task)
        smiles_rows: list[str] = []
        raw: dict[str, list] = {t: [] for t in task.targets}
        with open(csv_path, newline="") as f:
            for row in csv.DictReader(f):
                smiles_rows.append(row["smiles"])
                for t in task.targets:
                    raw[t].append(row.get(t, ""))
        graphs, kept = featurize_many(smiles_rows, add_hs=task.add_hs,
                                      max_degree=cfg.max_degree)
        self.graphs = graphs
        self.smiles = [smiles_rows[i] for i in kept]
        self.raw = {t: [raw[t][i] for i in kept] for t in task.targets}
        self._scaffold_keys = None
        self._fragment_keys = None

    def select(self, target: str):
        """(row ids, float labels) of the rows with a non-empty label for
        `target` (ref dataset_test.py:94-111)."""
        vals = self.raw[target]
        ids = [i for i, v in enumerate(vals) if v not in ("", None)]
        if self.task.task == "classification":
            labels = np.array([int(float(vals[i])) for i in ids],
                              dtype=np.float64)
        else:
            labels = np.array([float(vals[i]) for i in ids],
                              dtype=np.float64)
        return ids, labels

    def scaffold_keys(self) -> list[str]:
        if self._scaffold_keys is None:
            self._scaffold_keys = [generate_scaffold(s) for s in self.smiles]
        return self._scaffold_keys

    def fragment_keys(self) -> list[list[str]]:
        if self._fragment_keys is None:
            self._fragment_keys = [mol_fragment_keys(s) for s in self.smiles]
        return self._fragment_keys


def compute_loss(pred: torch.Tensor, labels: torch.Tensor,
                 graph_mask: torch.Tensor, loss: str) -> torch.Tensor:
    """The masked mean over real graphs of the task's loss: 'ce' on the
    two logits (labels as class ids), 'mse' or 'l1' on pred[:, 0]."""
    w = graph_mask.float()
    if loss == "ce":
        per = torch.nn.functional.cross_entropy(pred, labels.long(),
                                                reduction="none")
    elif loss == "mse":
        per = (pred[:, 0] - labels) ** 2
    else:
        per = (pred[:, 0] - labels).abs()
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


def train_step(models, opt, batch, labels, motifs, loss: str,
               seed_masks=None, n_seeds: int = 1) -> torch.Tensor:
    """One optimizer step of the members on one packed batch (on their
    device); returns their losses [M] (not synchronized). Member m = t *
    n_seeds + s takes labels[:, t] of labels [G, T] (or labels [G]) and
    the dropout keep masks seed_masks[s], one bool [N, emb_dim] per layer
    (None at drop_ratio 0); motifs is () or (motif_ids, motif_mask). One
    backward of the members' summed losses gives each its own gradients,
    and `opt` steps all of them."""
    losses = []
    for m, model in enumerate(models):
        t, s = divmod(m, n_seeds)
        model.train()
        _, pred = model(batch, *motifs, dropout_masks=(
            None if seed_masks is None else seed_masks[s]))
        lab = labels[:, t] if labels.dim() == 2 else labels
        losses.append(compute_loss(pred.float(), lab, batch.graph_mask,
                                   loss))
    losses = torch.stack(losses)
    opt.zero_grad(set_to_none=True)
    losses.sum().backward()
    opt.step()
    return losses.detach()


@torch.no_grad()
def predict(models, batch, motifs) -> torch.Tensor:
    """The members' eval-mode predictions [M, G, out_dim] in f32."""
    out = []
    for model in models:
        model.eval()
        out.append(model(batch, *motifs)[1].float())
    return torch.stack(out)


@dataclass
class SplitStack:
    """One split's packed batches on the device, [S, ...] each: the
    GraphBatch fields (int32 / bool, `upload_stack`), the labels [S, G] or
    [S, G, T] (f32), the motif ids [S, G, C] (int32) and mask (bool)."""

    batches: dict[str, torch.Tensor]
    labels: torch.Tensor
    motif_ids: torch.Tensor
    motif_mask: torch.Tensor

    def tensors(self) -> dict[str, torch.Tensor]:
        return dict(self.batches, labels=self.labels,
                    motif_ids=self.motif_ids, motif_mask=self.motif_mask)

    def to(self, device) -> SplitStack:
        return SplitStack({k: v.to(device) for k, v in self.batches.items()},
                          self.labels.to(device), self.motif_ids.to(device),
                          self.motif_mask.to(device))

    def fill_(self, other: SplitStack) -> None:
        """Copy `other`, of the same shapes, into these buffers."""
        dst = self.tensors()
        for k, v in other.tensors().items():
            if dst[k].shape != v.shape:
                raise ValueError(f"stack field {k}: {tuple(v.shape)} does "
                                 f"not fit {tuple(dst[k].shape)}")
            dst[k].copy_(v)


class FineTuner:
    """setup_data -> setup_state -> train for one target column (`target`)
    or, with `targets`, for all the listed columns at once (they must keep
    the same rows), each with cfg.n_seeds seeds, on `device` (the first
    CUDA device unless the caller names one, such as the CPU). `graphed`
    replays steps and evaluations as CUDA graphs on the card."""

    def __init__(self, cfg: FineTuneConfig, device=None,
                 target: str | None = None,
                 targets: list[str] | None = None, graphed: bool = True):
        self.cfg = cfg
        self.device = (torch.device(device) if device is not None
                       else resolve_device(cpu=False))
        self.task = TASKS[cfg.task_name]
        if targets is not None and len(targets) > 1:
            self.targets = list(targets)
        else:
            self.targets = [target or (targets[0] if targets
                                       else self.task.targets[0])]
        self.target = (self.targets[0] if len(self.targets) == 1
                       else f"multi{len(self.targets)}")
        self.n_targets = len(self.targets)
        self.n_members = self.n_targets * cfg.n_seeds
        self.graphed = graphed and self.device.type == "cuda"
        self.models: list = []
        self.motif_vocab = None
        self.normalizer: Normalizer | None = None
        self.normalizers: list[Normalizer] | None = None
        self._stacks: dict[str, SplitStack] = {}
        self._host_stacks: dict[str, tuple] = {}
        # host -> device transfers of each split's stack
        self.uploads = {"train": 0, "valid": 0, "test": 0}
        self._train_graph = None
        self._eval_graphs: dict[str, GraphedSteps] = {}
        self._eager_steps = 0

    @property
    def model(self):
        """The first member: the model of a one-member run."""
        return self.models[0]

    def _model_kwargs(self) -> dict:
        m = self.cfg.model
        return dict(task=self.task.task, num_layers=m.num_layers,
                    emb_dim=m.emb_dim, feat_dim=m.feat_dim,
                    gnn_type=m.gnn_type, pool=m.pool,
                    drop_ratio=m.drop_ratio, pred_n_layer=m.pred_n_layer,
                    pred_act=m.pred_act, normalize_gcn=m.normalize_gcn,
                    dtype=torch.bfloat16 if m.bf16 else torch.float32,
                    tile=m.tile)

    # ---- data ----
    def setup_data(self, shared: SharedTaskData | None = None):
        """Featurize (or reuse `shared`), split and index the task data."""
        cfg, task = self.cfg, self.task
        if shared is None:
            shared = SharedTaskData(cfg, task)
        self.shared = shared
        ids, labels = shared.select(self.targets[0])
        if self.n_targets > 1:
            # one run over all columns: their rows (so the splits and the
            # packed batches) must coincide
            cols = [labels]
            for t in self.targets[1:]:
                ids_t, lab_t = shared.select(t)
                if list(ids_t) != list(ids):
                    raise ValueError(
                        f"target {t!r} keeps different rows than "
                        f"{self.targets[0]!r}; use the sequential "
                        f"per-target loop (cfg.batch_targets=False)")
                cols.append(lab_t)
            labels = np.stack(cols, axis=1)              # [n, T]
            if cfg.task_name == "qm9":
                labels = labels * np.array(
                    [qm9_label_scale(t) for t in self.targets])[None, :]
        elif cfg.task_name == "qm9":
            labels = labels * qm9_label_scale(self.targets[0])
        smiles = [shared.smiles[i] for i in ids]
        graphs = [shared.graphs[i] for i in ids]
        self.smiles, self.labels = smiles, labels

        if cfg.splitting == "scaffold":
            sk = shared.scaffold_keys()
            tr, va, te = scaffold_split(smiles, cfg.valid_size,
                                        cfg.test_size,
                                        keys=[sk[i] for i in ids])
        else:
            tr, va, te = random_split(len(smiles), cfg.valid_size,
                                      cfg.test_size, seed=cfg.seed)
        self.split = (tr, va, te)
        if task.normalize_labels:
            if self.n_targets > 1:
                # z-scored per column, as T one-column runs would
                self.normalizers = [Normalizer(labels[tr, t])
                                    for t in range(self.n_targets)]
                labels = np.stack([n.norm(labels[:, t]) for t, n in
                                   enumerate(self.normalizers)], axis=1)
            else:
                self.normalizer = Normalizer(labels[tr])
                labels = self.normalizer.norm(labels)
        self.train_labels = labels

        if cfg.use_motifs:
            # vocabulary over the entire dataset (ref finetune.py:125)
            fk = shared.fragment_keys()
            self.motif_vocab = build_motif_vocab(
                smiles, max_motifs_per_mol=cfg.max_motifs_per_mol,
                fragment_keys=[fk[i] for i in ids])

        self.spec = spec_for_graphs(graphs, cfg.batch_size, cfg.max_degree,
                                    tile=cfg.model.tile)
        # valid/test batches follow the scaffold order, where the
        # statistical 'total' bound does not hold: worst-case capacity
        self.eval_spec = spec_for_graphs(graphs, cfg.batch_size,
                                         cfg.max_degree,
                                         tile=cfg.model.tile, sizing="max")
        lab = labels.astype(np.float32)
        self.iters, self.split_motifs = {}, {}
        for name, split_ids, shuffle, drop in [
                ("train", tr, True, True), ("valid", va, False, False),
                ("test", te, False, False)]:
            self.iters[name] = BatchIterator(
                [graphs[i] for i in split_ids],
                self.spec if shuffle else self.eval_spec,
                labels=lab[split_ids], shuffle=shuffle, drop_last=drop,
                seed=cfg.seed,
                cache_packed=not (shuffle and cfg.repack_each_epoch))
            if cfg.use_motifs:
                self.split_motifs[name] = (
                    self.motif_vocab.mol_motifs[split_ids],
                    self.motif_vocab.mol_motif_mask[split_ids])
        return self

    def _batch_motifs(self, split: str, idx):
        """Padded [n_graphs, C] motif ids / mask of a packed batch."""
        ids_arr, mask_arr = self.split_motifs[split]
        g = self.spec.n_graphs
        c = ids_arr.shape[1]
        mi = np.zeros((g, c), np.int32)
        mm = np.zeros((g, c), bool)
        mi[: len(idx)] = ids_arr[idx]
        mm[: len(idx)] = mask_arr[idx]
        return mi, mm

    # ---- resident split stacks ----
    def _epoch_items(self, split: str) -> list[tuple]:
        """One pass of the split's iterator as (batch, labels [G] or
        [G, T], motif ids, motif mask) on the host; motif ids and mask are
        zeros [G, 1] without motifs."""
        out = []
        g = self.spec.n_graphs
        for batch, lab, idx in self.iters[split]:
            labp = (np.zeros((g, self.n_targets), np.float32)
                    if self.n_targets > 1 else np.zeros(g, np.float32))
            if lab is not None:
                labp[: len(lab)] = lab
            if self.cfg.use_motifs:
                mi, mm = self._batch_motifs(split, idx)
            else:
                mi = np.zeros((g, 1), np.int32)
                mm = np.zeros((g, 1), bool)
            out.append((batch, labp, mi, mm))
        return out

    @staticmethod
    def _stack_items(items) -> tuple:
        """The items stacked on the host: (a GraphBatch of [S, ...] numpy
        arrays, labels, motif ids, motif mask)."""
        batches, labs, mis, mms = zip(*items)
        return (stack_batches(batches), np.stack(labs), np.stack(mis),
                np.stack(mms))

    def _upload(self, split: str, host: tuple) -> SplitStack:
        """The host stack on the device: a new SplitStack, or the split's
        existing one refilled in place (its buffers are the ones a
        captured graph reads)."""
        gb, lab, mi, mm = host
        fresh = SplitStack(upload_stack(gb, "cpu"), torch.from_numpy(lab),
                           torch.from_numpy(mi), torch.from_numpy(mm))
        if split in self._stacks:
            self._stacks[split].fill_(fresh)
        else:
            self._stacks[split] = fresh.to(self.device)
        self._host_stacks[split] = (gb.graph_mask, lab)
        self.uploads[split] += 1
        return self._stacks[split]

    def _split_stack(self, split: str) -> SplitStack:
        """The split's device stack, built from one pass of its iterator
        on first use (the packed-batch cache of valid / test, and of train
        under repack_each_epoch False)."""
        if split not in self._stacks:
            self._upload(split, self._stack_items(self._epoch_items(split)))
        return self._stacks[split]

    def _train_epoch_stack(self) -> tuple[SplitStack, np.ndarray]:
        """(stack, order) of one training epoch. repack_each_epoch packs
        fresh compositions on the host and refills the device stack;
        otherwise the compositions are frozen after epoch 0 and only the
        order changes."""
        if self.cfg.repack_each_epoch:
            items = self._epoch_items("train")
            return (self._upload("train", self._stack_items(items)),
                    np.arange(len(items)))
        stack = self._split_stack("train")
        return stack, self.iters["train"].cached_epoch_order()

    def _take(self, stack: SplitStack, idx: torch.Tensor) -> tuple:
        """(batch, labels, motifs) of the stack's row idx ([1] int64 on
        the device)."""
        batch = concat_units(stack.batches, idx)
        labels = torch.index_select(stack.labels, 0, idx)[0]
        motifs = ()
        if self.cfg.use_motifs:
            motifs = (torch.index_select(stack.motif_ids, 0, idx)[0].long(),
                      torch.index_select(stack.motif_mask, 0, idx)[0])
        return batch, labels, motifs

    # ---- members / optimizer ----
    def setup_state(self):
        """The members on the device: seed s's model from cfg.seed + s,
        warm-started from cfg.pretrained (loaded once), its motif table
        encoded by the plain network (once with a warm start, whose trunk
        every seed shares; else once per seed), copied to each target
        column; the two-group Adam over all of them (capturable on the
        card) and the seeds' dropout generators."""
        cfg = self.cfg
        # the JAX package initializes from an example train batch, which
        # advances the train shuffle stream by one epoch: draw it likewise
        # so that both packages see the same batches
        next(iter(self.iters["train"]))
        pretrained = None
        if cfg.pretrained:
            path = ckpt_lib.resolve_pretrained(cfg.pretrained)
            pretrained = (path, ckpt_lib.load_pretrained_state(path))
        seeds, table = [], None
        for s in range(cfg.n_seeds):
            gen = torch.Generator().manual_seed(cfg.seed + s)
            if cfg.use_motifs:
                model = MotifFineTuneNet(
                    num_motifs=max(1, self.motif_vocab.size), generator=gen,
                    **self._model_kwargs())
            else:
                model = FineTuneNet(generator=gen, **self._model_kwargs())
            if pretrained is not None:
                got = ckpt_lib.transfer_state(pretrained[1], model)
                if got["copied"] == 0:
                    raise ValueError(f"{pretrained[0]}: no tensor matches "
                                     f"the model")
            model.to(self.device)
            if cfg.use_motifs and self.motif_vocab.size > 0:
                if table is None or pretrained is None:
                    table = self._encode_motifs(model)
                with torch.no_grad():
                    model.motif_embedding.weight.copy_(
                        torch.from_numpy(table))
            seeds.append(model)
        self.models = [seeds[s] if t == 0 else copy.deepcopy(seeds[s])
                       for t in range(self.n_targets)
                       for s in range(cfg.n_seeds)]
        self.opt = two_group_adam(self.models, cfg.init_lr,
                                  cfg.init_base_lr, cfg.weight_decay,
                                  capturable=self.device.type == "cuda")
        self.dropout_gens = [
            torch.Generator(device=self.device).manual_seed(
                cfg.seed + 17 + s) for s in range(cfg.n_seeds)]
        return self

    def _encode_motifs(self, model) -> np.ndarray:
        """Seed the motif table with the plain network's features of each
        fragment (ref finetune.py:144-161): a FineTuneNet that shares
        `model`'s trunk and feat_lin (the heads' motif-specific shapes do
        not transfer), in eval mode on the device."""
        # the JAX package draws an example batch here too
        next(iter(self.iters["train"]))
        plain = FineTuneNet(**self._model_kwargs())
        ckpt_lib.transfer_state(model.state_dict(), plain)
        plain.to(self.device)
        m = self.cfg.model
        return encode_motif_vocab(self.motif_vocab, plain, m.feat_dim,
                                  max_degree=self.cfg.max_degree,
                                  tile=m.tile)

    def member_states(self) -> list[dict[str, torch.Tensor]]:
        """Device copies of each member's parameters and BatchNorm stats."""
        return [{k: v.detach().clone() for k, v in
                 model.state_dict().items()} for model in self.models]

    def load_member_states(self, states) -> None:
        """Copy member states into the members in place (a captured graph
        keeps reading their tensors)."""
        for model, state in zip(self.models, states, strict=True):
            model.load_state_dict(state)

    # ---- steps ----
    def seed_masks(self, n: int):
        """Each seed's dropout keep masks for one step on a batch of n
        nodes, drawn from its generator; None at drop_ratio 0."""
        if self.cfg.model.drop_ratio == 0.0:
            return None
        seeds = self.models[: self.cfg.n_seeds]
        return [model.keep_masks(n, gen)
                for model, gen in zip(seeds, self.dropout_gens)]

    def _step(self, j: int, idx: torch.Tensor) -> torch.Tensor:
        """One step of every member on the train stack's row idx ([1]
        int64 on the device); the body of the train graph (j unused)."""
        batch, labels, motifs = self._take(self._stacks["train"], idx)
        return train_step(self.models, self.opt, batch, labels, motifs,
                          self.task.loss, self.seed_masks(batch.num_nodes),
                          self.cfg.n_seeds)

    def _train_epoch(self) -> np.ndarray:
        """One epoch over the train stack; returns the losses [S, M]. Only
        the order vector is uploaded, and the losses are read back once."""
        _, order = self._train_epoch_stack()
        rows = torch.from_numpy(np.asarray(order, np.int64)[:, None]).to(
            self.device)
        return self._run_steps(rows).cpu().numpy()

    def _run_steps(self, rows: torch.Tensor) -> torch.Tensor:
        """The steps of rows ([S, 1] train-stack rows on the device):
        eager ones, or on the card after GRAPH_WARMUP_STEPS eager steps
        replays of the step's graph; returns the losses [S, M] on the
        device."""
        out = torch.empty(rows.shape[0], self.n_members, device=self.device)
        for i in range(rows.shape[0]):
            if self.graphed and self._eager_steps >= GRAPH_WARMUP_STEPS:
                if self._train_graph is None:
                    self._train_graph = GraphedSteps(
                        self._step, 1, [((1,), torch.long)], self.device,
                        out=(self.n_members,), generators=(
                            self.dropout_gens
                            if self.cfg.model.drop_ratio > 0 else ()))
                out[i].copy_(self._train_graph.run(rows[i: i + 1])[0])
            else:
                out[i].copy_(self._step(0, rows[i]))
                self._eager_steps += 1
        return out

    def _predict_split(self, split: str) -> torch.Tensor:
        """The members' predictions over the split's stack [S, M, G,
        out_dim]."""
        stack = self._stacks[split]
        rows = torch.arange(stack.labels.shape[0], device=self.device)
        preds = []
        for b in range(rows.shape[0]):
            batch, _, motifs = self._take(stack, rows[b: b + 1])
            preds.append(predict(self.models, batch, motifs))
        return torch.stack(preds)

    def predictions(self, split: str) -> np.ndarray:
        """_predict_split on the host: on the card one replay of the
        split's graph (captured after one eager pass at its first call)."""
        self._split_stack(split)
        if not self.graphed:
            return self._predict_split(split).cpu().numpy()
        graph = self._eval_graphs.get(split)
        if graph is None:
            warm = self._predict_split(split)
            graph = self._eval_graphs[split] = GraphedSteps(
                lambda j: self._predict_split(split), 1, [], self.device,
                out=warm.shape)
        return graph.run()[0].cpu().numpy()

    # ---- eval ----
    def _scores(self, pred: np.ndarray, normalizer=None) -> np.ndarray:
        if self.task.task == "classification":
            if self.cfg.score_mode == "logit1":   # quirk Q7 compatibility
                return pred[:, 1]
            e = np.exp(pred - pred.max(axis=1, keepdims=True))
            return (e / e.sum(axis=1, keepdims=True))[:, 1]
        out = pred[:, 0]
        if normalizer is not None:
            out = normalizer.denorm(out)
        return out

    def _metric_of(self, pred: np.ndarray, lab: np.ndarray,
                   normalizer=None) -> float:
        scores = self._scores(pred, normalizer)
        if self.task.task == "regression" and normalizer is not None:
            lab = normalizer.denorm(lab)
        return METRICS[self.task.metric](lab, scores)

    def _member_normalizer(self, m: int):
        if self.n_targets > 1:
            return (self.normalizers[m // self.cfg.n_seeds]
                    if self.normalizers is not None else None)
        return self.normalizer

    def evaluate(self, split: str, state=None) -> dict:
        """The task metric of the members on `split` (after loading
        `state`, member states, when given), as the JAX package reports
        it: with more than one member also per_member, and per_seed (one
        column) or per_target (metric, std and per_seed of each column)
        and std (over seeds; for several columns the mean of theirs)."""
        if state is not None:
            self.load_member_states(state)
        preds = self.predictions(split)         # [S, M, G, out]
        masks, labels = self._host_stacks[split]
        out = {"name": self.task.metric, "n": int(masks.sum())}
        if self.n_members == 1:
            out["metric"] = self._metric_of(preds[:, 0][masks],
                                            labels[masks], self.normalizer)
            out["loss"] = out["metric"]
            return out
        n_seeds = self.cfg.n_seeds

        def member_lab(m):
            if self.n_targets > 1:
                return labels[..., m // n_seeds][masks]
            return labels[masks]
        per_member = [self._metric_of(preds[:, m][masks], member_lab(m),
                                      self._member_normalizer(m))
                      for m in range(self.n_members)]
        out["per_member"] = per_member
        if self.n_targets == 1:
            out["per_seed"] = per_member
        else:
            pm = np.asarray(per_member).reshape(self.n_targets, n_seeds)
            out["per_target"] = [
                {"target": t, "metric": float(row.mean()),
                 "std": float(row.std()), "per_seed": row.tolist()}
                for t, row in zip(self.targets, pm)]
        out["metric"] = float(np.mean(per_member))
        # the std over seeds; for several columns the mean of the columns'
        # (not a flat std over targets x seeds, which would mix the
        # spread between columns into the seeds' noise)
        if self.n_targets > 1:
            out["std"] = float(np.mean([pt["std"]
                                        for pt in out["per_target"]]))
        else:
            out["std"] = float(np.std(per_member))
        # gate on the task metric (finetune.py:228-243)
        out["loss"] = out["metric"]
        return out

    # ---- loop ----
    def _keep_best(self, improved: np.ndarray, best_state):
        """The best states after an epoch: the members that improved copy
        their state on the device; the first gating epoch copies every
        member's (those that did not improve keep it, as the JAX
        package's first masked select does)."""
        if best_state is None:
            return self.member_states()
        for m in np.flatnonzero(improved):
            state = self.models[m].state_dict()
            for k, v in best_state[m].items():
                v.copy_(state[k])
        return best_state

    def train(self, log=print) -> dict:
        cfg = self.cfg
        run_dir = os.path.join(cfg.ckpt_dir, f"{cfg.task_name}_{self.target}")
        writer = MetricWriter(run_dir, tensorboard=cfg.tensorboard)
        direction = METRIC_DIRECTION[self.task.metric]
        best = np.full(self.n_members, -np.inf)
        best_state = None
        history = []
        try:
            for epoch in range(cfg.epochs):
                t0 = time.perf_counter()
                losses = self._train_epoch()           # [S, M]
                train_s = time.perf_counter() - t0
                val = self.evaluate("valid")
                scores = direction * np.asarray(
                    val.get("per_member", [val["metric"]]))
                improved = scores > best           # NaN scores never gate
                best = np.where(improved, scores, best)
                if improved.any():
                    best_state = self._keep_best(improved, best_state)
                record = {"epoch": epoch,
                          "train_loss": (float(losses.mean()) if losses.size
                                         else float("nan")),
                          f"valid_{val['name']}": val["metric"],
                          "time_s": round(time.perf_counter() - t0, 2),
                          "steps": losses.shape[0],
                          "train_s": train_s}
                if "std" in val:
                    record[f"valid_{val['name']}_std"] = val["std"]
                if "per_target" in val:
                    record[f"valid_{val['name']}_per_target"] = [
                        round(pt["metric"], 4) for pt in val["per_target"]]
                history.append(record)
                writer.record(record)
                writer.scalars(epoch, train_loss=record["train_loss"],
                               **{f"valid_{val['name']}": val["metric"]})
                log(f"[{cfg.task_name}/{self.target}] {record}")
            self.final_state = self.member_states()
            # every validation metric NaN: the final states
            self.best_state = best_state or self.final_state
            test = self.evaluate("test", state=self.best_state)
            writer.record({"test_" + test["name"]: test["metric"],
                           **({"test_" + test["name"] + "_std": test["std"],
                               "test_per_seed": test["per_seed"]}
                              if "per_seed" in test else {})})
        finally:
            writer.close()
        members = (f"{cfg.n_seeds} seeds" if self.n_targets == 1
                   else f"{self.n_targets} targets x {cfg.n_seeds} seeds")
        log(f"[{cfg.task_name}/{self.target}] test {test['name']} = "
            f"{test['metric']:.4f}"
            + (f" +- {test['std']:.4f} ({members})" if "std" in test
               else ""))
        synthetic = bool(getattr(self.shared, "synthetic", False))
        out = {"target": self.target, "test_metric": test["metric"],
               "metric_name": test["name"], "history": history,
               "synthetic": synthetic}
        if "per_seed" in test:
            out["test_std"] = test["std"]
            out["test_per_seed"] = test["per_seed"]
        if "per_target" in test:
            # test_std only where there is a seed ensemble: the CSV rows
            # of one seed keep the reference's format
            out["per_target"] = [
                {"target": pt["target"], "test_metric": pt["metric"],
                 "metric_name": test["name"], "synthetic": synthetic,
                 **({"test_std": pt["std"],
                     "test_per_seed": pt["per_seed"]}
                    if cfg.n_seeds > 1 else {})}
                for pt in test["per_target"]]
        return out


def run_all_targets(cfg: FineTuneConfig, device=None,
                    log=print) -> list[dict]:
    """Train every target column of the task, sharing featurization,
    scaffold and BRICS work across them, and append the results to the
    experiments CSV. With cfg.batch_targets and columns that keep the same
    rows, all columns train in one run (members = targets x seeds); else
    one run per column, as the reference does (finetune.py:495-506)."""
    task = TASKS[cfg.task_name]
    shared = SharedTaskData(cfg, task)
    if cfg.batch_targets and len(task.targets) > 1:
        row_sets = [shared.select(t)[0] for t in task.targets]
        if all(r == row_sets[0] for r in row_sets[1:]):
            ft = FineTuner(cfg, device, targets=list(task.targets))
            ft.setup_data(shared=shared).setup_state()
            out = ft.train(log=log)
            results = out.get("per_target") or [out]
            _append_experiments_csv(cfg, results)
            return results
        log(f"[{cfg.task_name}] target columns keep different rows; "
            f"falling back to the sequential per-target loop")
    results = []
    for target in task.targets:
        ft = FineTuner(cfg, device, target=target).setup_data(shared=shared)
        ft.setup_state()
        results.append(ft.train(log=log))
    _append_experiments_csv(cfg, results)
    return results


def _append_experiments_csv(cfg: FineTuneConfig, results: list[dict]):
    """Append per-target results to experiments/<ckpt>_<task>_finetune.csv
    under the current directory, reference-style (finetune.py:501-506:
    pandas to_csv append, no header or index; csv quoting for target names
    with commas)."""
    os.makedirs("experiments", exist_ok=True)
    out = os.path.join(
        "experiments",
        f"{os.path.basename(cfg.pretrained) or 'scratch'}_"
        f"{cfg.task_name}_finetune.csv")
    with open(out, "a", newline="") as f:
        w = csv.writer(f)
        for r in results:
            row = [r["target"], r["test_metric"]]
            if "test_std" in r:
                row.append(r["test_std"])
            if r.get("synthetic"):
                row.append("synthetic=true")
            w.writerow(row)
