"""MoleculeNet fine-tuning (ref finetune.py:61-395) on one card.

Port of molclr_tpu/train/finetune.py: `resolve_task_csv`, `SharedTaskData`,
`FineTuner`, `run_all_targets` and `_append_experiments_csv`, with the JAX
package's behaviour: scaffold / random splits, one model per target column,
qm7 / qm9 label z-scoring (Normalizer) and the qm9 unit scale, CE / MSE /
L1 losses, ROC-AUC / RMSE / MAE with metric-gated best-state selection and
a final test pass on the best state, warm start by partial transfer, and
the motif head with its vocabulary encoded by the plain network.

One member per run: the JAX package's scanned, vmapped epoch program
becomes a plain Python loop over batches, and its device-resident best
state a device copy of the state dict taken when validation improves. Not
ported: the seed ensemble (n_seeds > 1 raises NotImplementedError) and the
vmapped multi-target program; a multi-target task runs the per-target
loop, which the JAX package holds that program equal to.
Dropout draws from a torch.Generator on the card seeded from cfg.seed.
"""

from __future__ import annotations

import csv
import os
import time
import warnings

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
from molclr_tpu_torch.data.splits import generate_scaffold, random_split, \
    scaffold_split
from molclr_tpu_torch.data.tasks import TASKS, TaskSpec, qm9_label_scale
from molclr_tpu_torch.models import FineTuneNet, MotifFineTuneNet
from molclr_tpu_torch.train import checkpoints as ckpt_lib
from molclr_tpu_torch.train.config import FineTuneConfig
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


def train_step(model, opt, batch, labels, motifs, loss: str,
               dropout_masks=None, generator=None) -> torch.Tensor:
    """One optimizer step on one packed batch (on the model's device);
    returns the loss (a 0-d tensor, not synchronized). motifs is () or
    (motif_ids, motif_mask); the dropout keep masks come from
    `dropout_masks` (one per layer) or `generator`."""
    model.train()
    _, pred = model(batch, *motifs, dropout_masks=dropout_masks,
                    generator=generator)
    value = compute_loss(pred.float(), labels, batch.graph_mask, loss)
    opt.zero_grad(set_to_none=True)
    value.backward()
    opt.step()
    return value.detach()


@torch.no_grad()
def predict(model, batch, motifs) -> torch.Tensor:
    """Eval-mode predictions [G, out_dim] in f32."""
    model.eval()
    return model(batch, *motifs)[1].float()


class FineTuner:
    """setup_data -> setup_state -> train for one target column, on
    `device` (the first CUDA device unless the caller names one, such as
    the CPU)."""

    def __init__(self, cfg: FineTuneConfig, device=None,
                 target: str | None = None):
        if cfg.n_seeds > 1:
            raise NotImplementedError(
                "n_seeds > 1 (the JAX package's vmapped seed ensemble) is "
                "not ported")
        self.cfg = cfg
        self.device = (torch.device(device) if device is not None
                       else resolve_device(cpu=False))
        self.task = TASKS[cfg.task_name]
        self.target = target or self.task.targets[0]
        self.model = None
        self.motif_vocab = None
        self.normalizer: Normalizer | None = None

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
        ids, labels = shared.select(self.target)
        if cfg.task_name == "qm9":
            labels = labels * qm9_label_scale(self.target)
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
                seed=cfg.seed, cache_packed=not shuffle)
            if cfg.use_motifs:
                self.split_motifs[name] = (
                    self.motif_vocab.mol_motifs[split_ids],
                    self.motif_vocab.mol_motif_mask[split_ids])
        self._eval_items = {}
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

    def _device_item(self, split: str, batch, lab, idx):
        """(batch, labels [G], motifs) on the device."""
        labp = np.zeros(self.spec.n_graphs, np.float32)
        if lab is not None:
            labp[: len(lab)] = lab
        motifs = ()
        if self.cfg.use_motifs:
            mi, mm = self._batch_motifs(split, idx)
            motifs = (torch.from_numpy(mi.astype(np.int64)).to(self.device),
                      torch.from_numpy(mm).to(self.device))
        return (batch.to(self.device), torch.from_numpy(labp).to(self.device),
                motifs)

    # ---- model / optimizer ----
    def setup_state(self):
        """The model from cfg.seed, warm-started from cfg.pretrained, with
        the motif table encoded by the plain network, on the device; the
        two-group Adam."""
        cfg = self.cfg
        # the JAX package initializes from an example train batch, which
        # advances the train shuffle stream by one epoch: draw it likewise
        # so that both packages see the same batches
        next(iter(self.iters["train"]))
        gen = torch.Generator().manual_seed(cfg.seed)
        if cfg.use_motifs:
            self.model = MotifFineTuneNet(
                num_motifs=max(1, self.motif_vocab.size), generator=gen,
                **self._model_kwargs())
        else:
            self.model = FineTuneNet(generator=gen, **self._model_kwargs())
        if cfg.pretrained:
            path = ckpt_lib.resolve_pretrained(cfg.pretrained)
            got = ckpt_lib.transfer_state(
                ckpt_lib.load_pretrained_state(path), self.model)
            if got["copied"] == 0:
                raise ValueError(f"{path}: no tensor matches the model")
        self.model.to(self.device)
        if cfg.use_motifs and self.motif_vocab.size > 0:
            table = self._encode_motifs()
            with torch.no_grad():
                self.model.motif_embedding.weight.copy_(
                    torch.from_numpy(table))
        self.opt = two_group_adam(self.model, cfg.init_lr, cfg.init_base_lr,
                                  cfg.weight_decay)
        self.dropout_gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 17)
        return self

    def _encode_motifs(self) -> np.ndarray:
        """Seed the motif table with the plain network's features of each
        fragment (ref finetune.py:144-161): a FineTuneNet that shares the
        trunk and feat_lin (the heads' motif-specific shapes do not
        transfer), in eval mode on the device."""
        # the JAX package draws an example batch here too
        next(iter(self.iters["train"]))
        plain = FineTuneNet(**self._model_kwargs())
        ckpt_lib.transfer_state(self.model.state_dict(), plain)
        plain.to(self.device)
        m = self.cfg.model
        return encode_motif_vocab(self.motif_vocab, plain, m.feat_dim,
                                  max_degree=self.cfg.max_degree,
                                  tile=m.tile)

    # ---- eval ----
    def _scores(self, pred: np.ndarray) -> np.ndarray:
        if self.task.task == "classification":
            if self.cfg.score_mode == "logit1":   # quirk Q7 compatibility
                return pred[:, 1]
            e = np.exp(pred - pred.max(axis=1, keepdims=True))
            return (e / e.sum(axis=1, keepdims=True))[:, 1]
        out = pred[:, 0]
        if self.normalizer is not None:
            out = self.normalizer.denorm(out)
        return out

    def _metric_of(self, pred: np.ndarray, lab: np.ndarray) -> float:
        scores = self._scores(pred)
        if self.task.task == "regression" and self.normalizer is not None:
            lab = self.normalizer.denorm(lab)
        return METRICS[self.task.metric](lab, scores)

    def evaluate(self, split: str) -> dict:
        """The task metric of the current model on `split` (its batches
        stay on the device after the first call)."""
        if split not in self._eval_items:
            self._eval_items[split] = [self._device_item(split, *item)
                                       for item in self.iters[split]]
        preds, labels = [], []
        for batch, lab, motifs in self._eval_items[split]:
            pred = predict(self.model, batch, motifs)
            keep = batch.graph_mask
            preds.append(pred[keep])
            labels.append(lab[keep])
        pred = torch.cat(preds).cpu().numpy() if preds else np.zeros((0, 2))
        lab = torch.cat(labels).cpu().numpy() if labels else np.zeros(0)
        metric = self._metric_of(pred, lab)
        # gate on the task metric (finetune.py:228-243)
        return {"name": self.task.metric, "n": len(lab), "metric": metric,
                "loss": metric}

    # ---- loop ----
    def _train_items(self):
        # batch compositions re-drawn every epoch (reference DataLoader)
        for item in self.iters["train"]:
            yield self._device_item("train", *item)

    def train(self, log=print) -> dict:
        cfg = self.cfg
        run_dir = os.path.join(cfg.ckpt_dir, f"{cfg.task_name}_{self.target}")
        writer = MetricWriter(run_dir)
        direction = METRIC_DIRECTION[self.task.metric]
        best, best_state = -np.inf, None
        history = []
        try:
            for epoch in range(cfg.epochs):
                t0 = time.perf_counter()
                losses = []
                for batch, lab, motifs in self._train_items():
                    losses.append(train_step(
                        self.model, self.opt, batch, lab, motifs,
                        self.task.loss, generator=self.dropout_gen))
                losses = [float(x) for x in losses]   # synchronizes
                train_s = time.perf_counter() - t0
                val = self.evaluate("valid")
                score = direction * val["metric"]
                if score > best:             # NaN scores never gate
                    best = score
                    best_state = {k: v.detach().clone() for k, v in
                                  self.model.state_dict().items()}
                record = {"epoch": epoch,
                          "train_loss": (float(np.mean(losses)) if losses
                                         else float("nan")),
                          f"valid_{val['name']}": val["metric"],
                          "time_s": round(time.perf_counter() - t0, 2),
                          "steps": len(losses),
                          "train_s": train_s}
                history.append(record)
                writer.record(record)
                log(f"[{cfg.task_name}/{self.target}] {record}")
            if best_state is not None:    # else every metric was NaN
                self.model.load_state_dict(best_state)
            self.best_state = best_state
            test = self.evaluate("test")
            writer.record({"test_" + test["name"]: test["metric"]})
        finally:
            writer.close()
        log(f"[{cfg.task_name}/{self.target}] test {test['name']} = "
            f"{test['metric']:.4f}")
        return {"target": self.target, "test_metric": test["metric"],
                "metric_name": test["name"], "history": history,
                "synthetic": bool(getattr(self.shared, "synthetic", False))}


def run_all_targets(cfg: FineTuneConfig, device=None,
                    log=print) -> list[dict]:
    """Train one model per target column, as the reference does
    (finetune.py:495-506), sharing featurization, scaffold and BRICS work
    across the columns, and append the results to the experiments CSV."""
    task = TASKS[cfg.task_name]
    shared = SharedTaskData(cfg, task)
    if len(task.targets) > 1:
        log(f"[{cfg.task_name}] the vmapped multi-target program is not "
            f"ported; running the per-target loop")
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
