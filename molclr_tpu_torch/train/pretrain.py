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
view), one stream per view as JAX's rng_di / rng_dj (in a CUDA graph, from
generators registered with it and reseeded so before each replay).

The Pretrainer takes the JAX Pretrainer's one-card paths
(molclr_tpu/train/pretrain.py), in its order of preference:
  units     (fresh_compositions, tile > 0, device_cache_mb > 0, the
            default) the train split packed once into tile-units and
            uploaded, narrow where the unit spec allows
            (`_upload_units`); every epoch draws fresh compositions
            (`epoch_unit_orders`) and each step regroups T units on the
            device (`concat_units`); `replan_units_every` re-plans the
            units;
  resident  (fresh_compositions False, or no units) after the first host
            epoch, the cached batches uploaded once (`_maybe_upload_cache`)
            and taken in the iterator's order;
  host      (device_cache_mb 0, or over budget) batches packed in the
            prefetch thread into pinned memory and copied on a side
            stream; from an on-disk corpus above pack_cache_max_mols,
            each batch packed by one native call straight from the
            memory maps and narrowed to the wire dtypes on the host, then
            widened on the card (`_stream_batches`, JAX's
            `_native_superbatches`).
The corpus is a SMILES list or text file, featurized at the start, or an
on-disk corpus (data/corpus.py, cfg.data_path a directory that
cli.featurize built), memory-mapped: its split, spec and unit plan come
from its vectorized counts, and its tile-units are packed from the maps.
On the resident paths each window of KEY_WINDOW steps draws its
augmentation keys on the host and uploads them once; on the card the
steps are replayed as CUDA graphs (train/graphed.py, steps_per_dispatch)
after GRAPH_WARMUP_STEPS eager ones; every step augments inline from its
key row (aug_precompute is read for the JAX package's YAML and changes
nothing here). Validation batches are uploaded once
after the first pass. With tile 0 (the ELL trunk) there are no tile-units:
the first epoch takes the host path and the later ones the resident
cached batches, as in the JAX Pretrainer. TensorBoard scalars (cfg.tensorboard)
carry the JAX Pretrainer's tags at its steps.

Data parallelism (cfg.data_axis, the JAX Pretrainer's data_axis paths) runs
one rank per process (parallel/, `dp`: a DPGroup from init_distributed),
as the JAX package's multi-process runs do with one device per process:
each rank keeps its corpus_shard_range slice of the seeded split
(`_process_shard`), the steps per epoch are the fewest any rank has (the
schedule counts optimizer steps), and a step sums the BatchNorm moments
across the ranks, gathers both views' projections before the loss and
averages the gradients before Adam (parallel/dp.py). The three DP paths:
units (each rank packs its own tile-units, seed + 7 rank, with a unit
spec agreed by max, keeps the fewest units any rank has and draws its
orders from seed + 104729 (rank + 1)); resident (each rank keeps the
fewest cached batches any rank has, in its iterator's order); host (each
rank trains the agreed number of its own batches per epoch). Augmentation
and dropout streams add the rank to their seeds. Each decision that one
rank could take alone (a stack over budget, a plan that fails) is agreed
across the ranks, so that none waits in a collective its peers skip. Only
rank 0 writes config.json, metrics, TensorBoard and checkpoints; every
rank validates its own split and resumes. On the card the DP step is
replayed as a CUDA graph on NCCL (its collectives captured); on gloo it
runs eager.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from molclr_tpu_torch import native
from molclr_tpu_torch.data.augment import (
    draw_paired_keys,
    flatten_keys,
    paired_augment,
    paired_augment_keys,
    unflatten_keys,
)
from molclr_tpu_torch.data.corpus import CorpusSubset, DiskCorpus, \
    is_disk_corpus
from molclr_tpu_torch.data.graphs import concat_views
from molclr_tpu_torch.data.loader import (
    BatchIterator,
    device_batches,
    featurize_many,
    prefetch_iter,
    read_pretrain_smiles,
    ready,
    spec_for_graphs,
)
from molclr_tpu_torch.data.regroup import (
    concat_units,
    epoch_unit_orders,
    pack_units,
    plan_corpus_units,
    plan_unit_groups,
    stack_batches,
    unit_stack_bytes,
    upload_stack,
    wire_dtypes,
)
from molclr_tpu_torch.losses import nt_xent_loss, resolve_ntxent
from molclr_tpu_torch.models import MolCLRNet
from molclr_tpu_torch.parallel import dp as dp_lib
from molclr_tpu_torch.parallel.multihost import corpus_shard_range
from molclr_tpu_torch.train import checkpoints as ckpt_lib
from molclr_tpu_torch.train.config import PretrainConfig, to_dict
from molclr_tpu_torch.train.graphed import GRAPH_WARMUP_STEPS, GraphedSteps
from molclr_tpu_torch.train.logging_util import MetricWriter, NullWriter
from molclr_tpu_torch.train.optim import load_optimizer_state, make_adam, \
    set_lr, warmup_then_cosine
from molclr_tpu_torch.train.spans import span

# stream ids of step_generator
TRAIN_STREAM, VALID_STREAM, DROPOUT_STREAM = 0, 1, 2
# resident steps whose augmentation keys are drawn and uploaded at once
KEY_WINDOW = 64
# steps that profile_dir traces, from the first step after the first
# capture (or after GRAPH_WARMUP_STEPS steps where nothing is captured)
PROFILE_STEPS = 8


def step_seed(seed: int, *ids: int) -> int:
    """The seed of step_generator(seed, *ids)."""
    words = np.random.SeedSequence([seed, *ids]).generate_state(2)
    return (int(words[0]) << 31) ^ int(words[1])


def step_generator(seed: int, *ids: int, device="cpu") -> torch.Generator:
    """A torch.Generator on `device` seeded from (seed, *ids): the
    augmentation draws of one train step (TRAIN_STREAM, step) or one
    validation batch (VALID_STREAM, epoch, i) on the CPU, the dropout
    masks of one view of a train step (DROPOUT_STREAM, step, view) on the
    model's device."""
    return torch.Generator(device=device).manual_seed(step_seed(seed, *ids))


def build_model(cfg: PretrainConfig, generator: torch.Generator | None = None,
                dp=None) -> MolCLRNet:
    """The pretraining network of cfg.model; dp (a DPGroup) makes its
    BatchNorm layers sum their moments across the ranks."""
    m = cfg.model
    return MolCLRNet(num_layers=m.num_layers, emb_dim=m.emb_dim,
                     feat_dim=m.feat_dim, gnn_type=m.gnn_type, pool=m.pool,
                     drop_ratio=m.drop_ratio, normalize_gcn=m.normalize_gcn,
                     dtype=torch.bfloat16 if m.bf16 else torch.float32,
                     tile=m.tile, generator=generator, dp=dp)


def _loss(loss_fn, cfg, zi, zj, batch, dp=None):
    return loss_fn(zi.float(), zj.float(), cfg.temperature,
                   cfg.use_cosine_similarity, pair_mask=batch.graph_mask,
                   dp=dp)


def _dropout_kw(model, cfg, step: int, view: int, masks,
                generators, stream=()) -> dict:
    """The dropout inputs of one forward: the given keep masks, or (with
    drop_ratio > 0) the view's generator of `generators`, or else a
    generator on the model's device for (cfg.seed, step, view, *stream);
    nothing at drop_ratio 0."""
    if masks is not None:
        return dict(dropout_masks=masks)
    if model.drop_ratio == 0.0:
        return {}
    if generators is not None:
        return dict(generator=generators[view])
    dev = next(model.parameters()).device
    return dict(generator=step_generator(cfg.seed, DROPOUT_STREAM, step,
                                         view, *stream, device=dev))


def forward_backward(model, opt, batch, cfg: PretrainConfig, step: int,
                     views=None, bond_window: int = 0, max_waves: int = 0,
                     dropout_masks=None, keys=None, dropout_generators=None,
                     dp=None, stream=()) -> torch.Tensor:
    """train_step up to the update: both views through the model in train
    mode (its BatchNorm running stats updated), the loss, the gradients
    into the parameters' .grad (averaged over the ranks under dp). Returns
    the loss with its graph; the arguments are train_step's."""
    if views is None:
        with span("step.views"):
            if keys is None:
                keys = draw_paired_keys(
                    cfg.aug, batch.num_nodes, batch.num_graphs,
                    step_generator(cfg.seed, TRAIN_STREAM, step, *stream))
            views = paired_augment_keys(batch, keys, cfg.aug,
                                        tile=cfg.model.tile,
                                        bond_window=bond_window,
                                        max_waves=max_waves)
    vi, vj = views
    masks = dropout_masks or (None, None)
    gens = dropout_generators
    model.train()
    with span("step.encode"):
        if cfg.concat_views:
            _, z = model(concat_views(vi, vj), **_dropout_kw(
                model, cfg, step, 0, masks[0], gens, stream))
            g = batch.num_graphs
            zi, zj = z[:g], z[g:]
        else:
            _, zi = model(vi, **_dropout_kw(model, cfg, step, 0, masks[0],
                                            gens, stream))
            _, zj = model(vj, **_dropout_kw(model, cfg, step, 1, masks[1],
                                            gens, stream))
    world = 1 if dp is None else dp.world
    with span("step.loss"):
        loss = _loss(resolve_ntxent(cfg.ntxent_impl, world), cfg, zi, zj,
                     batch, dp)
    with span("step.backward"):
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if dp is not None:
            dp_lib.mean_grads(model.parameters(), dp)
    return loss


def train_step(model, opt, batch, cfg: PretrainConfig, step: int,
               lr: float | None, views=None, bond_window: int = 0,
               max_waves: int = 0, dropout_masks=None, keys=None,
               dropout_generators=None, dp=None, stream=()) -> torch.Tensor:
    """One optimizer step on one base batch; returns the loss (a 0-d
    tensor on the batch's device, not synchronized). views = (vi, vj)
    replaces the augmentation draw (as the JAX train_step's `views`), keys
    (draw_paired_keys' structure, on any device) replaces only the draw
    from step_generator(cfg.seed, TRAIN_STREAM, step); dropout_masks
    replaces the dropout draw: per view a list of bool keep masks [N,
    emb_dim], one per layer (with concat_views, one list for the joint
    batch, [2N, emb_dim]); dropout_generators (one per view, seeded as
    step_generator(cfg.seed, DROPOUT_STREAM, step, view)) replace the
    generators the step would make. The LR is the schedule at the step
    count before the update; None leaves the optimizer's LR as it is (a
    CUDA graph's step reads the LR tensor that set_lr fills before each
    replay). Under data parallelism dp (a DPGroup; the model built with
    it) the loss is the global one over every rank's pairs and the
    gradients are averaged over the ranks before the update; `stream`
    (the rank) extends the seeds of the step's generators.
    """
    loss = forward_backward(model, opt, batch, cfg, step, views=views,
                            bond_window=bond_window, max_waves=max_waves,
                            dropout_masks=dropout_masks, keys=keys,
                            dropout_generators=dropout_generators, dp=dp,
                            stream=stream)
    with span("step.adam"):
        if lr is not None:
            set_lr(opt, lr)
        opt.step()
    return loss.detach()


@torch.no_grad()
def eval_step(model, batch, cfg: PretrainConfig, generator: torch.Generator,
              bond_window: int = 0, max_waves: int = 0) -> torch.Tensor:
    """Validation loss of one batch: both views in eval mode, one after the
    other whatever concat_views says, the closed form NT-Xent (as the JAX
    eval_step)."""
    with span("step.views"):
        vi, vj = paired_augment(batch, generator, cfg.aug,
                                tile=cfg.model.tile, bond_window=bond_window,
                                max_waves=max_waves)
    model.eval()
    with span("step.encode"):
        _, zi = model(vi)
        _, zj = model(vj)
    with span("step.loss"):
        return _loss(nt_xent_loss, cfg, zi, zj, batch)


class Pretrainer:
    """setup_data -> setup_state -> train, on `device` (a CUDA device unless
    the caller asks for the CPU). After train, `epoch_losses` holds each
    epoch's step losses (f32) and, where steps were replayed, `graphed`
    the GraphedSteps that replayed them. prefer_native=False featurizes a
    SMILES corpus with the Python chem layer (in cfg.featurize_processes
    processes) and packs with the Python packer. cfg.data_axis trains
    data-parallel over the ranks of `dp` (parallel.init_distributed's
    DPGroup, on this rank's device), which it requires."""

    def __init__(self, cfg: PretrainConfig, device,
                 prefer_native: bool = True, dp=None):
        if bool(cfg.data_axis) != (dp is not None):
            raise ValueError(
                "data_axis trains data-parallel and needs the rank's "
                "DPGroup (parallel.init_distributed), and a DPGroup needs "
                f"data_axis (data_axis={cfg.data_axis!r}, dp={dp})")
        self.cfg = cfg
        self.device = torch.device(device)
        self.prefer_native = prefer_native
        self.dp = dp
        # the rank, appended to the seeds of the augmentation and dropout
        # streams (JAX folds the device index into the step's key)
        self._stream = () if dp is None else (dp.rank,)
        self.is_main = dp is None or dp.rank == 0
        # DP: the fewest cached batches any rank has (the resident path)
        self._dp_shard_size = 0
        self.step = 0
        self._start_epoch = 0
        # the device stack of the resident paths: tile-units (_units) or
        # the cached batches, each step taking _units_per_batch rows
        self._stack = None
        self._units = False
        self._units_per_batch = 0
        self._n_units = 0
        self.unit_spec = None
        self._unit_stack_mb = 0.0
        self._units_plan_epoch = 0
        self._eval_stack = None
        self._device_cache_used_mb = 0.0
        self.graphed = None
        self._graph_gens = []
        self._eager_resident_steps = 0
        # profile_dir: the step from which a pending profiler may start
        self._profile_from = None
        self._profiler = None
        self._profiled_steps = 0
        self.epoch_losses: list[np.ndarray] = []

    # ---- data ----
    def setup_data(self, smiles: list[str] | None = None):
        """Split the corpus: an explicit `smiles` list or the SMILES text
        file cfg.data_path, featurized here; or the on-disk corpus that
        cfg.data_path names, memory-mapped (molecules above max_degree
        left out, as featurize_many leaves them out of a text file, so
        that both give the same split of the same molecules)."""
        cfg = self.cfg
        if smiles is None and is_disk_corpus(cfg.data_path):
            if not self.prefer_native:
                raise ValueError(
                    f"{cfg.data_path} is an on-disk corpus, which only the "
                    f"native packer reads; drop --no-native")
            corpus = DiskCorpus(cfg.data_path)
            if bool(corpus.meta.get("add_hs")) != (cfg.aug == "mix"):
                raise ValueError(
                    f"corpus {cfg.data_path} was built with add_hs="
                    f"{corpus.meta.get('add_hs')} but aug={cfg.aug!r} "
                    f"needs add_hs={cfg.aug == 'mix'}; rebuild with "
                    f"cli.featurize --add-hs accordingly")
            keep = np.flatnonzero(
                np.asarray(corpus.max_degrees) <= cfg.max_degree)
            order = keep[np.random.RandomState(cfg.seed).permutation(
                len(keep))]
            n_valid = int(len(order) * cfg.valid_size)
            train_ids, valid_ids = self._process_shard(order[n_valid:],
                                                       order[:n_valid])
            train = CorpusSubset(corpus, train_ids)
            valid = CorpusSubset(corpus, valid_ids)
            sized = CorpusSubset(corpus, keep)
            atoms = train.atom_counts
            edges = train.edge_counts
            max_atoms = int(sized.atom_counts.max()) if len(keep) else 2
        else:
            if smiles is None:
                smiles = read_pretrain_smiles(cfg.data_path)
            graphs, _ = featurize_many(smiles, add_hs=(cfg.aug == "mix"),
                                       max_degree=cfg.max_degree,
                                       processes=cfg.featurize_processes,
                                       prefer_native=self.prefer_native)
            order = np.random.RandomState(cfg.seed).permutation(len(graphs))
            n_valid = int(len(graphs) * cfg.valid_size)
            train_ids, valid_ids = self._process_shard(order[n_valid:],
                                                       order[:n_valid])
            train = [graphs[i] for i in train_ids]
            valid = [graphs[i] for i in valid_ids]
            sized = graphs
            atoms = np.array([g.n_atoms for g in train])
            edges = np.array([g.edge_src.shape[0] for g in train])
            max_atoms = max((g.n_atoms for g in graphs), default=2)
        self.spec = spec_for_graphs(sized, cfg.batch_size, cfg.max_degree,
                                    cfg.pad_slack, cfg.pad_quantile,
                                    tile=cfg.model.tile,
                                    sizing=cfg.pad_sizing)
        self._mean_real_nodes = (float(atoms.mean()) * cfg.batch_size
                                 if len(train) else 0.0)
        self._mean_real_edges = (float(edges.mean()) * cfg.batch_size
                                 if len(train) else 0.0)
        # BFS horizon of subgraph / mix: max atoms - 1 bounds every graph's
        # eccentricity, so the wave sweep never under-removes (capped at
        # 2000 so that the wave key (max_waves + 1) * 2^20 stays in int32)
        self.max_waves = (cfg.max_waves if cfg.max_waves > 0
                          else max(1, min(max_atoms - 1, 2000)))
        self.train_iter = BatchIterator(
            train, self.spec, shuffle=True, drop_last=True, seed=cfg.seed,
            cache_packed=0 < len(train) <= cfg.pack_cache_max_mols,
            prefer_native=self.prefer_native)
        self.valid_iter = BatchIterator(
            valid, self.spec, shuffle=False, drop_last=False, seed=cfg.seed,
            cache_packed=0 < len(valid) <= cfg.pack_cache_max_mols,
            prefer_native=self.prefer_native)
        return self

    def _process_shard(self, train_ids, valid_ids):
        """Data parallelism: every rank draws the same seeded split and
        keeps its contiguous corpus_shard_range slice of each part (the
        JAX Pretrainer's _process_shard); one card: both as they are."""
        if self.dp is None:
            return train_ids, valid_ids
        rank, world = self.dp.rank, self.dp.world
        rt = corpus_shard_range(len(train_ids), rank, world)
        rv = corpus_shard_range(len(valid_ids), rank, world)
        return (train_ids[rt.start: rt.stop], valid_ids[rv.start: rv.stop])

    def _agree_ints(self, vals, op: str) -> tuple[int, ...]:
        """Host integers every rank must take alike, agreed by `op` ('max'
        or 'min') across the ranks; one card: as they are."""
        if self.dp is None:
            return tuple(int(v) for v in vals)
        return dp_lib.agree_ints(vals, self.dp, op=op)

    def _agree(self, ok: bool) -> bool:
        """A choice every rank must take alike (a stack uploaded or not):
        true where it holds on every rank; one card: as it is."""
        return bool(self._agree_ints((int(ok),), "min")[0])

    # ---- model / optimizer ----
    def _resolve_graph_steps(self) -> int:
        """Steps per CUDA graph on the resident paths (0: eager; always on
        the CPU, where device_cache_mb 0 leaves only the host path, and on
        gloo, whose collectives stage through the host and cannot be
        captured)."""
        cfg = self.cfg
        k = cfg.steps_per_dispatch
        if self.device.type != "cuda" or k == 1 or not cfg.device_cache_mb:
            return 0
        if self.dp is not None and self.dp.backend != "nccl":
            return 0
        return max(1, k)

    def setup_state(self):
        cfg = self.cfg
        self.model = build_model(
            cfg, torch.Generator().manual_seed(cfg.seed),
            self.dp).to(self.device)
        self.graph_steps = self._resolve_graph_steps()
        # capturable on the card whatever the path, so that the host path,
        # eager steps and graph replays round Adam alike
        self.opt = make_adam(cfg.adam_impl, self.model.parameters(),
                             cfg.weight_decay,
                             capturable=self.device.type == "cuda")
        # one optimizer step takes one batch of every rank: the schedule
        # counts optimizer steps, and every rank bakes the same one (the
        # fewest batches any rank has)
        (self.steps_per_epoch,) = self._agree_ints(
            (max(1, len(self.train_iter)),), "min")
        self.schedule = warmup_then_cosine(cfg.init_lr, self.steps_per_epoch,
                                           cfg.epochs, cfg.warm_up)
        if cfg.resume_from:
            self._resume(cfg.resume_from)
        return self

    def _resume(self, path: str) -> None:
        """A reference .pth or an Orbax step directory of the JAX package
        (weights only: optimizer, step and schedule start from zero) or a
        full-state step_<step>.pt (the run continues its optimizer
        moments, step count, LR schedule and data stream). A
        step_<step>.pt written with another adam_impl is refused before
        anything loads (one without a stamp predates 'fused': 'chain')."""
        if path.endswith(".pth") or os.path.isdir(path):
            got = ckpt_lib.transfer_state(
                ckpt_lib.load_pretrained_state(path), self.model)
            if got["copied"] == 0:
                raise ValueError(f"{path}: no tensor matches the model")
            return
        saved_impl = "chain"
        meta = ckpt_lib.train_meta_path(path)
        if os.path.exists(meta):
            with open(meta) as f:
                saved_impl = json.load(f).get("adam_impl", "chain")
        if saved_impl != self.cfg.adam_impl:
            raise ValueError(
                f"checkpoint {path} was written with adam_impl="
                f"{saved_impl!r} but this run has adam_impl="
                f"{self.cfg.adam_impl!r}; their optimizer states differ: "
                f"set adam_impl={saved_impl!r} to resume")
        full = ckpt_lib.load_checkpoint(path)
        self.model.load_state_dict(full["model"])
        load_optimizer_state(self.opt, full["optimizer"])
        self.step = int(full["step"])
        self._start_epoch = int(full["epoch"]) + 1
        self.train_iter.set_epoch(self._start_epoch)
        self.valid_iter.set_epoch(self._start_epoch)

    # ---- device stacks ----
    def _upload_units(self, log, plan_seed: int | None = None) -> bool:
        """Pack the train split into tile-units and upload the [U, ...]
        stack, narrow unless narrow_cache is 'off' or the unit spec
        exceeds the narrow dtypes. T = U // steps_per_epoch units per step
        keep the schedule's steps per epoch. The units are planned, then
        checked against the budget, then packed: a split of an on-disk
        corpus from its counts and by the native packer from the memory
        maps. plan_seed replaces cfg.seed as the molecule shuffle (a
        replan); a replan that fails any check leaves the old stack in
        place, its budget counted as released for the check.

        Under data parallelism (the JAX Pretrainer's _maybe_upload_units_dp
        in a multi-process run, one device per process) each rank plans
        its own split seeded with seed + 7 rank; the ranks agree the unit
        spec by max and U by min (the remainder units are dropped), and
        every choice, so all ranks take the path or none does. On one card
        every agreement is the value itself. Returns True when the units
        path is active."""
        cfg = self.cfg
        graphs = self.train_iter.graphs
        rank = 0 if self.dp is None else self.dp.rank
        seed = cfg.seed + 7 * rank if plan_seed is None else plan_seed
        replan_mb = self._unit_stack_mb if self._units else 0.0
        s_epoch = self.steps_per_epoch
        corpus = isinstance(graphs, CorpusSubset)
        groups = None
        if len(graphs) <= cfg.pack_cache_max_mols:
            plan = plan_corpus_units if corpus else plan_unit_groups
            try:
                groups, local = plan(graphs, cfg.model.tile, cfg.max_degree,
                                     seed=seed)
            except ValueError as e:
                log(f"fresh-compositions unit packing unavailable ({e}); "
                    f"falling back to the frozen batch cache")
        if not self._agree(groups is not None):
            return False
        g_t, e_t, mb = self._agree_ints(
            (local.n_graphs, local.n_edges, local.max_graph_bonds), "max")
        uspec = dataclasses.replace(local, n_graphs=g_t, n_edges=e_t,
                                    max_graph_bonds=mb)
        (u,) = self._agree_ints((len(groups),), "min")
        dropped = len(groups) - u
        t = u // s_epoch
        if t < 1:
            log(f"{u} tile-units < {s_epoch} steps/epoch; falling back to "
                f"the frozen batch cache")
            return False
        narrow = None if cfg.narrow_cache == "off" else wire_dtypes(uspec)
        total_mb = unit_stack_bytes(uspec, u, narrow) / 2**20
        if not self._agree(self._device_cache_used_mb - replan_mb + total_mb
                           <= cfg.device_cache_mb):
            log(f"tile-unit stack {total_mb:.0f} MB "
                f"({'narrow' if narrow else 'full-width'}) exceeds "
                f"device_cache_mb={cfg.device_cache_mb}"
                + (" on this rank or another" if self.dp else "")
                + "; staying host-side")
            return False
        if corpus:
            t0 = time.perf_counter()
            stack = native.pack_unit_stack_indexed(
                graphs.corpus, groups[:u], uspec, narrow=narrow)
            log(f"packed {u} units from the memory-mapped corpus in "
                f"{time.perf_counter() - t0:.1f} s ({total_mb:.1f} MB, "
                f"{unit_stack_bytes(uspec, u) / 2**20:.1f} MB full width)")
            atoms, edges = graphs.atom_counts, graphs.edge_counts
        else:
            stack, _ = pack_units(groups[:u], uspec, self.prefer_native)
            atoms = np.array([g.n_atoms for g in graphs])
            edges = np.array([g.edge_src.shape[0] for g in graphs])
        if self._units:
            # a replan: release the old stack, and the graph reading it
            self._device_cache_used_mb -= replan_mb
            self._stack = self.graphed = None
        self._stack = upload_stack(stack, self.device, narrow)
        self._units = True
        self.unit_spec = uspec
        self._unit_stack_mb = total_mb
        self._n_units, self._units_per_batch = u, t
        self._device_cache_used_mb += total_mb
        # throughput accounting: a step holds T of the split's units
        self._mean_real_edges = int(edges.sum()) * t / len(groups)
        self._mean_real_nodes = int(atoms.sum()) * t / len(groups)
        log(("" if self.dp is None else f"rank {rank}: ")
            + f"uploaded {u}-unit stack ({total_mb:.1f} MB"
            + (", narrow" if narrow else "")
            + f", {t} units x {cfg.model.tile} nodes per step, {s_epoch} "
            f"steps/epoch"
            + (f", {dropped} remainder units dropped" if dropped else "")
            + "); epochs re-draw batch compositions on-device")
        return True

    def _maybe_upload_cache(self, log) -> None:
        """After a full host epoch: the tile-unit stack where fresh
        compositions allow it, else the cached batches as a [S, ...] stack
        within device_cache_mb (under data parallelism the fewest batches
        any rank has, if every rank's fit)."""
        cfg = self.cfg
        cache = self.train_iter.cache
        if (self._stack is not None or not cfg.device_cache_mb
                or not self._agree(bool(cache))):
            return
        if (cfg.fresh_compositions and cfg.model.tile > 0
                and self._upload_units(log)):
            return
        batches = [gb for gb, _, _ in cache]
        dropped = 0
        if self.dp is not None:
            batches, self._dp_shard_size, dropped = \
                dp_lib.shard_batch_cache(batches, self.dp)
        stack = stack_batches(batches)
        total_mb = sum(v.nbytes for v in vars(stack).values()) / 2**20
        if not self._agree(self._device_cache_used_mb + total_mb
                           <= cfg.device_cache_mb):
            log(f"packed-batch cache {total_mb:.0f} MB exceeds "
                f"device_cache_mb={cfg.device_cache_mb}"
                + (" on this rank or another" if self.dp else "")
                + "; staying host-side")
            return
        if dropped:
            log(f"rank {self.dp.rank}: {dropped} remainder batches dropped "
                f"at device granularity")
        self._stack = upload_stack(stack, self.device)
        self._units, self._units_per_batch = False, 1
        self._device_cache_used_mb += total_mb
        log(f"uploaded {len(batches)}-batch cache ({total_mb:.1f} MB) to the "
            f"device; epochs are now transfer-free")

    def _maybe_upload_eval(self) -> None:
        cache = self.valid_iter.cache
        if not cache or not self.cfg.device_cache_mb:
            return
        stack = stack_batches([gb for gb, _, _ in cache])
        total_mb = sum(v.nbytes for v in vars(stack).values()) / 2**20
        if self._device_cache_used_mb + total_mb <= self.cfg.device_cache_mb:
            self._device_cache_used_mb += total_mb
            self._eval_stack = upload_stack(stack, self.device)

    # ---- loops ----
    def validate(self, epoch: int) -> float:
        """The mean validation loss, from the device-resident eval stack once
        a first pass has filled the iterator's cache (the same batches and
        keys, so the same bits)."""
        with span("pretrain.validate"):
            losses = [eval_step(self.model, batch, self.cfg,
                                step_generator(self.cfg.seed, VALID_STREAM,
                                               epoch, i),
                                self.spec.max_graph_bonds, self.max_waves)
                      for i, batch in enumerate(self._valid_batches())]
            if self._eval_stack is None:
                self._maybe_upload_eval()
            return (float(np.float32(np.mean([float(x) for x in losses])))
                    if losses else float("nan"))

    def _valid_batches(self):
        """The validation batches on the device: rows of the eval stack,
        or the iterator's batches uploaded one by one."""
        if self._eval_stack is not None:
            rows = torch.arange(self._eval_stack["graph_mask"].shape[0],
                                device=self.device)
            for i in range(rows.shape[0]):
                with span("step.take"):
                    batch = concat_units(self._eval_stack, rows[i: i + 1])
                yield batch
        else:
            for b, _, _ in self.valid_iter:
                with span("step.take"):
                    batch = b.to(self.device)
                yield batch

    def _save_best(self) -> None:
        path = os.path.join(self.cfg.ckpt_dir, "best.pth")
        torch.save({k: v.cpu() for k, v in self.model.state_dict().items()},
                   path)

    def _advance(self, n: int, losses: torch.Tensor, epoch: int,
                 log) -> None:
        """Count n steps just taken (losses: theirs) and log where a
        multiple of log_every_steps was passed."""
        every = self.cfg.log_every_steps
        before, self.step = self.step, self.step + n
        if self.step // every > before // every:
            log(f"epoch {epoch} step {self.step} loss "
                f"{float(losses[-1]):.4f} lr {self.schedule(self.step):.6f}")

    def _profile_steps(self, n: int, log) -> None:
        """After n steps (outside any range): start a pending profiler
        once past the warm-up, or stop it after its PROFILE_STEPS."""
        if self._profiler is not None:
            self._profiled_steps += n
            if self._profiled_steps >= PROFILE_STEPS:
                self._stop_profiler(log)
        elif self._profile_from is not None and self._steady():
            self._profile_from = None
            self._start_profiler(log)

    def _stream_batches(self):
        """The host batches of one epoch of the host path: from an on-disk
        corpus whose train split is not cached (above pack_cache_max_mols),
        one native call per batch straight from the memory maps, in the
        shuffle stream of BatchIterator.__iter__ (its epoch counter
        advances the same way, so that a resume draws the same batches),
        each batch narrowed to the wire dtypes here, in the prefetch
        thread; else the iterator's packed batches."""
        it = self.train_iter
        if it.cache_packed or not isinstance(it.graphs, CorpusSubset):
            for gb, _, _ in it:
                yield gb
            return
        sub, b = it.graphs, it.batch_size
        rng = np.random.RandomState(it.seed + it._epoch)
        it.set_epoch(it._epoch + 1)
        order = rng.permutation(len(sub))
        stop = len(sub) - len(sub) % b        # drop_last
        ids = sub.ids[order[:stop]].reshape(-1, b)
        wire = wire_dtypes(self.spec)
        packer = native.IndexedPacker(sub.corpus, self.spec)
        for row in ids:
            fields_ = vars(packer.batch(row))
            if wire is not None:
                fields_ = {k: v.astype(wire[k]) for k, v in fields_.items()}
            yield fields_

    def _host_epoch(self, epoch: int, log) -> list[float]:
        """One epoch of the host path. Under data parallelism every rank
        trains the agreed steps per epoch on its own batches and only
        drains the rest (so that its iterator's cache fills)."""
        cfg = self.cfg
        buf = torch.empty(len(self.train_iter), device=self.device)
        batches = device_batches(self._stream_batches(), self.device)
        if cfg.prefetch:
            batches = prefetch_iter(batches, cfg.prefetch)
        n = 0
        for batch, event in batches:
            if self.dp is not None and n == self.steps_per_epoch:
                continue
            loss = train_step(self.model, self.opt, ready(batch, event), cfg,
                              self.step, self.schedule(self.step),
                              bond_window=self.spec.max_graph_bonds,
                              max_waves=self.max_waves, dp=self.dp,
                              stream=self._stream)
            buf[n].copy_(loss)
            n += 1
            self._advance(1, buf[:n], epoch, log)
            self._profile_steps(1, log)
        return buf[:n].tolist()

    def _batch_size(self) -> tuple[int, int]:
        """(nodes, graphs) of a resident step's batch."""
        t = self._units_per_batch
        return (t * self._stack["atom_type"].shape[1],
                t * self._stack["graph_mask"].shape[1])

    def _key_window(self, start: int, n: int) -> torch.Tensor:
        """The augmentation keys of steps start .. start + n - 1, one flat
        row each (step_generator(seed, TRAIN_STREAM, step)), uploaded to
        the device at once (from pinned memory on the card)."""
        cfg = self.cfg
        nodes, graphs = self._batch_size()
        with span("pretrain.keys"):
            rows = torch.stack([flatten_keys(draw_paired_keys(
                cfg.aug, nodes, graphs,
                step_generator(cfg.seed, TRAIN_STREAM, start + j,
                               *self._stream)))
                for j in range(n)])
            if self.device.type == "cuda":
                rows = rows.pin_memory()
            return rows.to(self.device, non_blocking=True)

    def _resident_step(self, idx_row, key_row, lr: float | None,
                       dropout_generators=None) -> torch.Tensor:
        """One step on T rows of the device stack, its views from its key
        row."""
        cfg = self.cfg
        with span("step.take"):
            batch = concat_units(self._stack, idx_row)
            keys = unflatten_keys(cfg.aug, key_row, batch.num_nodes,
                                  batch.num_graphs)
        return train_step(self.model, self.opt, batch, cfg, self.step, lr,
                          keys=keys, bond_window=self.spec.max_graph_bonds,
                          max_waves=self.max_waves,
                          dropout_generators=dropout_generators, dp=self.dp,
                          stream=self._stream)

    def _graph_body(self, j: int, idx_row, key_row) -> torch.Tensor:
        """Step j of a graph: with dropout, its views' masks come from the
        graph's generators of step j, which _resident_epoch reseeds before
        each replay."""
        return self._resident_step(idx_row, key_row, None,
                                   self._graph_gens[j] if self._graph_gens
                                   else None)

    def _new_graph(self, k: int, units: int, key_len: int) -> GraphedSteps:
        """The GraphedSteps of k resident steps, with (under dropout) two
        generators per step on the card, one per view."""
        self._graph_gens = []
        if self.cfg.model.drop_ratio > 0:
            self._graph_gens = [tuple(torch.Generator(device=self.device)
                                      for _ in range(2)) for _ in range(k)]
        return GraphedSteps(self._graph_body, k,
                            [((units,), torch.long),
                             ((key_len,), torch.long)], self.device,
                            generators=[g for pair in self._graph_gens
                                        for g in pair])

    def _reseed_graph_gens(self) -> None:
        """Seed step j's generators as step_generator(cfg.seed,
        DROPOUT_STREAM, self.step + j, view): the streams that eager steps
        draw from."""
        for j, pair in enumerate(self._graph_gens):
            for view, gen in enumerate(pair):
                gen.manual_seed(step_seed(self.cfg.seed, DROPOUT_STREAM,
                                          self.step + j, view, *self._stream))

    def _resident_epoch(self, epoch: int, orders: np.ndarray,
                        log) -> list[float]:
        """One epoch over the device stack, orders [S, T] its rows per step:
        windows of KEY_WINDOW steps (a multiple of the graph's steps), each
        drawing its keys at once; graphed steps after the warm-up, else
        eager steps. Only the [S, T] orders and the keys are uploaded."""
        s = orders.shape[0]
        idx = torch.from_numpy(orders.astype(np.int64)).to(self.device)
        buf = torch.empty(s, device=self.device)
        k = self.graph_steps
        window = -(-KEY_WINDOW // k) * k if k else KEY_WINDOW
        for lo in range(0, s, window):
            w = min(window, s - lo)
            keys = self._key_window(self.step, w)
            j = 0
            while j < w:
                at = lo + j
                replay = (k and j + k <= w and self._eager_resident_steps
                          >= GRAPH_WARMUP_STEPS)
                n = k if replay else 1
                with span("pretrain.dispatch"):
                    if replay:
                        if self.graphed is None:
                            self.graphed = self._new_graph(k, idx.shape[1],
                                                           keys.shape[1])
                        set_lr(self.opt, self.schedule(self.step))
                        self._reseed_graph_gens()
                        buf[at: at + k].copy_(self.graphed.run(
                            idx[at: at + k], keys[j: j + k]))
                    else:
                        with span("pretrain.eager_step"):
                            loss = self._resident_step(
                                idx[at], keys[j], self.schedule(self.step))
                        buf[at].copy_(loss)
                        self._eager_resident_steps += 1
                    self._advance(n, buf[at: at + n], epoch, log)
                self._profile_steps(n, log)
                j += n
        return buf.tolist()

    def _unit_orders(self, epoch: int) -> np.ndarray:
        """The [S, T] unit rows of one epoch: the one-card stream, or under
        data parallelism the rank's (seed + 104729 (rank + 1))."""
        cfg = self.cfg
        if self.dp is not None:
            return dp_lib.unit_orders(self._n_units, self._units_per_batch,
                                      cfg.seed, self.dp.rank, epoch,
                                      self.steps_per_epoch)
        return epoch_unit_orders(self._n_units, self._units_per_batch,
                                 cfg.seed, epoch)[: self.steps_per_epoch]

    def _activate_units(self, log) -> None:
        """The tile-unit stack up front (no host epoch first). A resumed
        run of a replanning config packs once, with the seed of the last
        replan at or before its first epoch, so that its compositions are
        the uninterrupted run's."""
        cfg = self.cfg
        if (self._stack is not None or not cfg.fresh_compositions
                or cfg.model.tile <= 0 or not cfg.device_cache_mb):
            return
        n = cfg.replan_units_every
        if self.dp is not None:
            if n:
                log("replan_units_every is not implemented for the DP units "
                    "path (as in the JAX package); training on the epoch-0 "
                    "unit plan (compositions still re-draw per epoch)")
            self._upload_units(log)
            return
        last = (self._start_epoch // n) * n if n else 0
        if last > 0:
            if self._upload_units(log, plan_seed=cfg.seed + 7919 * last):
                self._units_plan_epoch = last
        else:
            self._upload_units(log)

    def _maybe_replan(self, epoch: int, log) -> None:
        n = self.cfg.replan_units_every
        if (self._units and n and epoch > 0 and epoch % n == 0
                and self.dp is None
                and self._units_plan_epoch != epoch):
            if self._upload_units(log,
                                  plan_seed=self.cfg.seed + 7919 * epoch):
                self._units_plan_epoch = epoch

    def _steady(self) -> bool:
        """Past the warm-up: on a resident path that replays, its graph
        captured; elsewhere (the host path, eager steps) GRAPH_WARMUP_STEPS
        steps of this run taken."""
        if self.graph_steps and self._stack is not None:
            return self.graphed is not None and self.graphed.captures > 0
        return self.step >= self._profile_from

    def _start_profiler(self, log) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=acts)
        self._profiler.start()
        log(f"profiler: tracing from step {self.step}")

    def _stop_profiler(self, log) -> None:
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._profiler = self._profiler, None
        prof.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        log(f"profiler trace of {self._profiled_steps} steps written to "
            f"{path}")

    def train(self, log=print) -> list[dict]:
        cfg = self.cfg
        if self.is_main:
            # data parallelism: rank 0 writes for all (the ranks hold the
            # same parameters)
            os.makedirs(cfg.ckpt_dir, exist_ok=True)
            with open(os.path.join(cfg.ckpt_dir, "config.json"), "w") as f:
                json.dump(to_dict(cfg), f, indent=2, default=str)
            writer = MetricWriter(cfg.ckpt_dir, tensorboard=cfg.tensorboard)
        else:
            writer = NullWriter()
        best_val = float("inf")
        history = []
        self._activate_units(log)
        if cfg.profile_dir:
            self._profile_from = self.step + GRAPH_WARMUP_STEPS
        try:
            for epoch in range(self._start_epoch, cfg.epochs):
                t0 = time.perf_counter()
                self._maybe_replan(epoch, log)
                if self._stack is None:
                    losses = self._host_epoch(epoch, log)
                    self._maybe_upload_cache(log)
                elif self._units:
                    losses = self._resident_epoch(epoch, self._unit_orders(
                        epoch), log)
                else:
                    order = self.train_iter.cached_epoch_order()
                    if self.dp is not None:
                        order = dp_lib.cache_orders(order,
                                                    self._dp_shard_size)
                    losses = self._resident_epoch(epoch, order[:, None], log)
                self._stop_profiler(log)
                self.epoch_losses.append(np.asarray(losses, np.float32))
                epoch_s = time.perf_counter() - t0
                # message edges per step = 2 views x layers x (real
                # directed edges + self-loops), bench.py's metric
                edges_per_step = 2 * cfg.model.num_layers * (
                    self._mean_real_edges + self._mean_real_nodes)
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
                    if val < best_val and self.is_main:
                        best_val = val
                        self._save_best()
                stopping = (cfg.stop_after_epochs
                            and epoch + 1 >= cfg.stop_after_epochs
                            and epoch + 1 < cfg.epochs)
                if ((epoch + 1) % cfg.save_every_epochs == 0
                        or stopping) and self.is_main:
                    path = ckpt_lib.save_checkpoint(cfg.ckpt_dir, self.step, {
                        "model": self.model.state_dict(),
                        "optimizer": self.opt.state_dict(),
                        "step": self.step, "epoch": epoch})
                    with open(ckpt_lib.train_meta_path(path), "w") as f:
                        json.dump({"adam_impl": cfg.adam_impl}, f)
                history.append(record)
                writer.record(record)
                writer.scalars(self.step, train_loss=record["train_loss"],
                               cosine_lr_decay=record["lr"],
                               validation_loss=record.get("valid_loss",
                                                          float("nan")),
                               edges_per_sec=record["edges_per_sec"])
                log(f"epoch {epoch}: {record}")
                if stopping:
                    log(f"stop_after_epochs={cfg.stop_after_epochs}: "
                        f"stopping at epoch {epoch} (schedule set for "
                        f"{cfg.epochs} epochs; resume continues it)")
                    break
        finally:
            self._stop_profiler(log)
            if self._profile_from is not None:
                self._profile_from = None
                log("profiler: no step after the warm-up; no trace written")
            writer.close()
        return history
