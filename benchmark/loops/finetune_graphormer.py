"""The Graphormer fine-tuning cell: Graphormer-base trained by the
FineTuner on a MoleculeNet classification task, driven epoch by epoch
through the calls `FineTuner.train` makes (the train epoch over the
resident split stack with its pair tables, graphed steps; evaluate(
"valid"); the best-state keep), without its final test pass and files.
The helpers of loops/finetune.py serve unchanged.

Set-up, each phase timed on standard error: the task CSV generated from
the seed, featurized with hydrogens; the scaffold keys (the FineTuner's
own, computed here first to time them apart); each molecule's distances
and path bonds computed (on the card), the split and the pad specs; the
member built with weights drawn from the seed; epoch 0, whose first
three steps are read for the comparison (their batches with the pair
tables and labels, the program's dropout keep masks re-drawn from a
generator in the dropout generator's state, the first gradient from
Adam's state, the weights after the third, and the predictions of the
first VALID_CHECKED validation batches there), then its other steps, its
validation and keep, so that the window's first epoch is packed between
launches as every later one is. The window: whole epochs from epoch 1
until `seconds` have passed; a traced run profiles its last epoch's
boundary and first PROFILED_STEPS steps (never in its first epoch) and
then EAGER_STEPS eager steps for the program's `graphormer.*` ranges.
Then the plain reference (reference/graphormer.py) follows the first
three steps from the same weights with the same keep masks and predicts
the checked validation batches.
"""

from __future__ import annotations

import gc
import math
import os
import time

import numpy as np
import torch
from torch import nn

from benchmark import roofline
from benchmark import roofline_graphormer as rg
from benchmark import trace as tracelib
from benchmark.loops.finetune import _epoch, _stack_rows, _validate, \
    batch_check, readings, split_check, valid_check
from benchmark.loops.pretrain import CHECKED_STEPS, MARK, _sync, \
    adam_gradient, device_info, gc_watch, phase, program_seed
from benchmark.reference import graphormer as rgraph
from benchmark.traffic import molgen
from molclr_tpu_torch.data.tasks import TASKS
from molclr_tpu_torch.train.config import FineTuneConfig, ModelConfig
from molclr_tpu_torch.train.finetune import FineTuner, SharedTaskData
from molclr_tpu_torch.train.metrics import METRIC_DIRECTION

MASK_SALT = 17                 # the dropout stream: cfg.seed + 17
VALID_CHECKED = 4              # validation batches held to the reference
EAGER_STEPS = 2                # eager steps profiled after the window
PROFILED_STEPS = 24            # steps of the last window epoch profiled
EAGER_MARK = "bench.graphormer_eager_steps"
RANGES = ("graphormer.bias", "graphormer.attn", "graphormer.ffn")
OTHER = "(no graphormer range)"
TOKEN = rgraph.GRAPH_TOKEN_TYPE


def make_config(ctx) -> FineTuneConfig:
    c, tr = ctx.config, ctx.traffic
    model = ModelConfig(gnn_type="graphormer",
                        num_layers=c["num_hidden_layers"],
                        emb_dim=c["embedding_dim"],
                        ffn_dim=c["ffn_embedding_dim"],
                        num_heads=c["num_attention_heads"],
                        max_hops=c["multi_hop_max_dist"],
                        drop_ratio=c["dropout"], tile=c["tile"])
    return FineTuneConfig(
        task_name=tr["task"], data_root=ctx.tmp,
        batch_size=tr["batch_size"], epochs=tr["epochs"],
        init_lr=tr["init_lr"], init_base_lr=tr["init_base_lr"],
        weight_decay=tr["weight_decay"], model=model,
        valid_size=tr["valid_size"], test_size=tr["test_size"],
        splitting=tr["splitting"], seed=program_seed(ctx.seed),
        ckpt_dir=ctx.tmp, n_seeds=tr["n_seeds"], batch_targets=True)


def make_weights(model: nn.Module, seed: int, device) -> dict:
    """{name: f32 tensor on device}, one uniform draw from the seed:
    LayerNorm scales 1 +- 0.1 and shifts +- 0.1; the attention bias's
    tables (spatial, bond type and direction, the graph token's distance)
    +- 1 and the hop matrices +- 1 / sqrt(heads), so that the bias moves
    the scores as a trained model's does; every other weight and bias at
    Graphormer's init scale, standard deviation 0.02."""
    norms = {f"{m}.{p}" for m, mod in model.named_modules()
             if isinstance(mod, nn.LayerNorm) for p in ("weight", "bias")}
    named = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    total = sum(int(np.prod(s)) for _, s in named)
    word = int(np.random.SeedSequence([int(seed), 97, 1])
               .generate_state(1, np.uint64)[0] >> 1)
    gen = torch.Generator(device=device).manual_seed(word)
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0,
                                                      generator=gen)
    out, off = {}, 0
    for name, shape in named:
        n = int(np.prod(shape))
        mid, half = 0.0, 0.02 * math.sqrt(3.0)
        if name in norms:
            mid, half = (1.0 if name.endswith("weight") else 0.0), 0.1
        elif name.startswith(("spatial_", "edge_type_", "edge_dir_",
                              "graph_token_distance")):
            half = 1.0
        elif name == "edge_hop_weight":
            half = 1.0 / math.sqrt(shape[-1])
        out[name] = (flat[off: off + n] * half + mid).reshape(shape)
        off += n
    return out


def without_tokens(b: dict) -> dict:
    """A packed batch dict without its graph-token rows (the molecules as
    the generator wrote them, for the checks of loops/finetune.py)."""
    keep = b["atom_type"] != TOKEN
    new = torch.cumsum(keep.long(), 0) - 1
    out = dict(b)
    for k in ("atom_type", "chirality", "node_graph", "node_mask"):
        out[k] = b[k][keep]
    out["src"], out["dst"] = new[b["src"]], new[b["dst"]]
    out["graph_n_nodes"] = b["graph_n_nodes"] - b["graph_mask"].long()
    return out


def pair_check(batches: list, pairs: list, hops: int, tile: int) -> int:
    """Pairs of the checked batches' molecules whose spatial row or path
    bonds in the program's tile tables differ from the reference's own
    distances and path rule."""
    bad = 0
    for b, (spatial, path) in zip(batches, pairs):
        for mol in rgraph.molecules(b):
            if mol is None:
                continue
            n = mol["atom_type"].shape[0]
            dist, types, dirs, real = rgraph.shortest_paths(
                n, mol["bonds"], hops)
            t, a = divmod(int(mol["rows"][0]) + 1, tile)
            sp = spatial[t, a: a + n, a: a + n].long()
            pa = path[t, a: a + n, a: a + n].long()
            want_sp = torch.where(dist >= rgraph.UNREACHABLE,
                                  rgraph.UNREACHABLE + 1, dist + 1)
            want_pa = torch.where(real, 1 + 3 * types + dirs, 0)
            bad += int((sp != want_sp).sum()) \
                + int((pa != want_pa).any(-1).sum())
    return bad


def _counts(stack) -> list:
    """Per stack row (real rows, pairs the molecules need, molecules)."""
    b = stack.batches
    n = b["graph_n_nodes"].long()
    return list(zip(b["node_mask"].bool().sum(1).tolist(),
                    (n * n).sum(1).tolist(),
                    b["graph_mask"].bool().sum(1).tolist()))


def _flops(cfg, counts, backward: bool) -> float:
    m = cfg.model
    return sum(rg.step_flops(r, p, g, d=m.emb_dim, f=m.ffn_dim,
                             layers=m.num_layers, out=2, backward=backward)
               for r, p, g in counts)


def run(ctx, control: bool = False) -> dict:
    dev, tr = ctx.device, ctx.traffic
    cfg = make_config(ctx)
    m = cfg.model
    task = TASKS[tr["task"]]
    phase(ctx, "imports")
    gen = molgen.write_task_csv(
        os.path.join(ctx.tmp, task.data_path), tr["molecules_total"],
        ctx.seed, tr["molecules"], list(task.targets),
        tr["positive_rates"])
    phase(ctx, "generate")
    shared = SharedTaskData(cfg, task)
    phase(ctx, "featurize")
    if len(shared.graphs) != tr["molecules_total"]:
        raise RuntimeError(f"{len(shared.graphs)} of "
                           f"{tr['molecules_total']} molecules featurized")
    shared.scaffold_keys()
    phase(ctx, "scaffold keys")
    ft = FineTuner(cfg, dev, targets=list(task.targets))
    ft.setup_data(shared=shared)
    phase(ctx, "pair tables, split and specs")
    ft.setup_state()
    split, program_smiles = tuple(list(p) for p in ft.split), list(ft.smiles)
    phase(ctx, "state")
    w = make_weights(ft.model, ctx.seed, dev)
    with torch.no_grad():
        for name, p in ft.model.named_parameters():
            p.copy_(w[name])
    p0 = {k: v.cpu() for k, v in w.items()}
    del w

    # epoch 0: the checked steps, the validation predictions there, the
    # rest of the epoch, its validation and keep (set-up)
    stack, order = ft._train_epoch_stack()
    rows = torch.from_numpy(np.asarray(order, np.int64)[:, None]).to(dev)
    masks = torch.Generator(device=dev).manual_seed(cfg.seed + MASK_SALT)
    batches, labels, pairs, keeps = [], [], [], []
    for s in range(CHECKED_STEPS):
        b, lab, inputs = ft._take(stack, rows[s])
        batches.append(_stack_rows(stack, [int(rows[s])])[0])
        labels.append(lab.detach().cpu())
        pairs.append(tuple(x.cpu() for x in inputs))
        keeps.append(ft.model.keep_masks(b.num_nodes, masks))
    losses = ft._run_steps(rows[:1]).cpu().numpy().tolist()
    params = list(ft.model.named_parameters())
    first = {n: adam_gradient(ft.opt, p) for n, p in params}
    losses += ft._run_steps(rows[1:CHECKED_STEPS]).cpu().numpy().tolist()
    after = {n: p.detach().cpu().clone() for n, p in params}
    preds = torch.from_numpy(ft.predictions("valid"))[:VALID_CHECKED]
    vstack = ft._stacks["valid"]
    valid = _stack_rows(vstack, range(vstack.labels.shape[0]))
    valid_labels = list(vstack.labels.detach().cpu())
    phase(ctx, "checked steps and validation graph")
    out = {"attempted": 0, "failed": 0, "e2e": {}, "layer": {}}
    keep = {"best": np.full(ft.n_members, -np.inf), "state": None}
    if not control:
        t_ep = time.perf_counter()
        ft._run_steps(rows[CHECKED_STEPS:])
        direction = METRIC_DIRECTION[task.metric]
        _validate(ft, direction, keep)
        phase(ctx, "epoch 0 and its validation")
        epoch_s = time.perf_counter() - t_ep
        out["e2e"]["setup_s"] = time.perf_counter() - ctx.t0
        _window(ctx, ft, cfg, direction, keep, epoch_s, out)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del ft, stack, vstack, params, keep
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    bare = [without_tokens(b) for b in batches]
    mismatch = batch_check(bare, labels, cfg.batch_size, gen, split[0])
    split_bad = split_check(split, program_smiles, gen, cfg.valid_size,
                            cfg.test_size)
    valid_bad = valid_check([without_tokens(b) for b in valid], valid_labels,
                            gen, split[1])
    pair_bad = pair_check(batches, pairs, m.max_hops, m.tile)
    kw = dict(layers=m.num_layers, heads=m.num_heads, hops=m.max_hops,
              tile=m.tile, drop=m.drop_ratio, head_lr=cfg.init_lr,
              base_lr=cfg.init_base_lr, wd=cfg.weight_decay, device=dev)
    checked = valid[:VALID_CHECKED]

    def reference(**extra):
        args = dict(kw, **extra)
        r = rgraph.finetune_steps(p0, batches, labels, keeps, **args)
        r["losses"] = [[x] for x in r["losses"]]
        r["preds"] = rgraph.predict(
            r["params"], checked, layers=m.num_layers, heads=m.num_heads,
            hops=m.max_hops, device=dev,
            tf32=args.get("tf32", False))[:, None]
        return r

    ref = reference()
    mask = torch.stack([b["graph_mask"] for b in checked])
    prog = {"losses": losses[:CHECKED_STEPS], "first_grad": first,
            "params": after, "preds": preds}
    nums = readings(prog, ref, p0, mask)
    lim = ctx.limits
    out["checks"] = [
        ("batch_mismatch", float(mismatch), lim["batch_mismatch"]),
        ("split_mismatch", float(split_bad), lim["split_mismatch"]),
        ("valid_mismatch", float(valid_bad), lim["valid_mismatch"]),
        ("pair_mismatch", float(pair_bad), lim["pair_mismatch"]),
        ("loss0_gap", nums["loss0_gap"], lim["loss0_gap"]),
        ("loss_gap", nums["loss_gap"], lim["loss_gap"]),
        ("grad_norm_gap", nums["grad_norm_gap"], lim["grad_norm_gap"]),
        ("update_norm_gap", nums["update_norm_gap"], lim["update_norm_gap"]),
        ("valid_pred_gap", nums["valid_pred_gap"], lim["valid_pred_gap"]),
    ]
    out["device"] = device_info(dev, peak, out.pop("trace_device", {}))
    out["worst_leaf"] = {"grad": nums["grad_at"], "update": nums["update_at"]}
    if control:
        out["diag"] = {"program_losses": prog["losses"],
                       "reference_losses": ref["losses"]}
        out["control"] = readings(prog, reference(tf32=True), p0, mask)
        out["faults"] = {
            "half": readings(prog, reference(half=True), p0, mask),
            "frozen": readings(prog, reference(head_lr=0.0, base_lr=0.0),
                               p0, mask)}
    return out


def _window(ctx, ft, cfg, direction, keep, epoch_s, out) -> None:
    dev = ctx.device
    val_flops = _flops(cfg, _counts(ft._stacks["valid"]), False)
    mols = steps = bad = 0
    flops = timed_s = 0.0
    pairs_real = pairs_computed = 0
    summary = None
    watch = gc_watch(ctx.log)
    t_start = time.perf_counter()
    while True:
        t_ep, cpu_ep = time.perf_counter(), time.process_time()
        last = ctx.trace and steps > 0 and (
            t_ep - t_start + epoch_s >= ctx.seconds)
        if last:
            summary = _profiled(ctx, ft, direction, keep)
            losses, order = summary.pop("epoch")
        else:
            losses, order = _epoch(ft)
            _validate(ft, direction, keep)
        bad += int((~np.isfinite(losses)).any(1).sum())
        mols += int(ft._host_stacks["train"][0][order].sum())
        pairs_real += ft.counters["pairs_real"]
        pairs_computed += ft.counters["pairs_computed"]
        if ctx.trace and not last:
            _sync(dev)
            timed_s += time.perf_counter() - t_ep
            counts = _counts(ft._stacks["train"])
            flops += _flops(cfg, [counts[r] for r in order], True) \
                + val_flops
        steps += len(order)
        epoch_s = time.perf_counter() - t_ep
        ctx.log(f"window: epoch {epoch_s:.4f} s, {len(order)} steps, "
                f"process CPU {time.process_time() - cpu_ep:.4f} s")
        if last or (not ctx.trace
                    and time.perf_counter() - t_start >= ctx.seconds):
            break
    _sync(dev)
    window_s = time.perf_counter() - t_start
    gc.callbacks.remove(watch)
    out["attempted"], out["failed"] = steps, bad
    out["e2e"]["finetune_mol_per_s"] = mols / window_s
    out["pairs"] = {"pairs_real": pairs_real,
                    "pairs_computed": pairs_computed}
    if ctx.trace:
        eager = _eager_ranges(ctx, ft)
        out["layer"] = {
            "kind": "finetune_graphormer", "model_flops": flops,
            "window_s": timed_s, "peak_flops": roofline.PEAK_F32,
            "profiled_window_s": summary["window_s"],
            "busy_s": summary["busy_s"], **out["pairs"], **eager}
        out["trace_device"] = {"busy_s": summary["busy_s"],
                               "window_s": summary["window_s"]}
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"],
                            "eager_range_ms_per_step": {
                                k: 1e3 * v / EAGER_STEPS
                                for k, v in eager["range_device_s"].items()}}


def _profiled(ctx, ft, direction, keep) -> dict:
    """The last window epoch as _epoch runs it, its boundary (the refill
    of the train stack) and first PROFILED_STEPS steps under
    torch.profiler (a whole epoch's replays are some hundred thousand
    device events, whose processing would stall the run for minutes);
    then its other steps, its validation and keep."""
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = ctx.device
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(dev)
    with profile(activities=acts) as prof:
        torch.ones(1, device=dev).add_(1)
        _sync(dev)
        with record_function(MARK):
            with record_function("FineTuner._train_epoch_stack"):
                _, order = ft._train_epoch_stack()
            rows = torch.from_numpy(np.asarray(order, np.int64)[:, None]).to(
                dev)
            with record_function("FineTuner._run_steps"):
                head = ft._run_steps(rows[:PROFILED_STEPS])
            _sync(dev)
    summary = tracelib.summarize(prof, MARK)
    losses = torch.cat([head, ft._run_steps(rows[PROFILED_STEPS:])])
    _validate(ft, direction, keep)
    summary["epoch"] = (losses.cpu().numpy(), np.asarray(order))
    return summary


def range_device_s(events, marker: str, names=RANGES) -> dict:
    """Device seconds of the operations launched under each range of
    `names` inside the range `marker`, and of the others (OTHER): an
    operation belongs to the innermost such range, on the thread of the
    runtime call that launched it (the same correlation id), around the
    call's time; a backward's ranges and launches are on autograd's
    thread."""
    cuda = torch.autograd.DeviceType.CUDA
    mark = next(e for e in events if e.name == marker
                and e.device_type != cuda)
    lo, hi = mark.time_range.start, mark.time_range.end
    ranges = [(e.time_range.start, e.time_range.end, e.thread, e.name)
              for e in events if e.device_type != cuda and e.name in names
              and lo <= e.time_range.start and e.time_range.end <= hi]
    launch = {e.id: (e.time_range.start, e.thread) for e in events
              if e.device_type != cuda and e.name.startswith("cu")}
    out = dict.fromkeys(names + (OTHER,), 0.0)
    for e in events:
        if e.device_type != cuda or getattr(e, "is_user_annotation", False) \
                or e.id not in launch:
            continue
        t, thread = launch[e.id]
        if not lo <= t <= hi:
            continue
        inside = [(b - a, n) for a, b, th, n in ranges
                  if th == thread and a <= t <= b]
        out[min(inside)[1] if inside else OTHER] += (
            e.time_range.end - e.time_range.start) * 1e-6
    return out


def _eager_ranges(ctx, ft) -> dict:
    """EAGER_STEPS eager steps on the current train stack's first rows
    under torch.profiler (after one unprofiled eager step): the device
    seconds under each `graphormer.*` range, and the attention's least
    time on those batches."""
    from torch.profiler import ProfilerActivity, profile, record_function

    dev, m = ctx.device, ft.cfg.model
    rows = torch.arange(EAGER_STEPS + 1, device=dev)[:, None]
    graphed, ft.graphed = ft.graphed, False
    try:
        ft._run_steps(rows[:1])
        _sync(dev)
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            torch.ones(1, device=dev).add_(1)
            _sync(dev)
            with record_function(EAGER_MARK):
                ft._run_steps(rows[1:])
                _sync(dev)
    finally:
        ft.graphed = graphed
    dev_s = range_device_s(prof.events(), EAGER_MARK)
    counts = _counts(ft._stacks["train"])[1: EAGER_STEPS + 1]
    bound = sum(m.num_layers * (
        rg.attention_bound_s(r, p, m.emb_dim, m.num_heads, False)
        + rg.attention_bound_s(r, p, m.emb_dim, m.num_heads, True))
        for r, p, _ in counts)
    return {"eager_steps": EAGER_STEPS, "range_device_s": dev_s,
            "attn_device_s": dev_s["graphormer.attn"],
            "bias_device_s": dev_s["graphormer.bias"],
            "attn_bound_s": bound}
