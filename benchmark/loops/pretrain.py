"""Pretraining cells: MolCLR contrastive pretraining on the Pretrainer's
default path (tile-unit stack resident on the card, fresh compositions
per epoch, keys drawn a window ahead, every step after the warm-up a CUDA
graph replay), driven epoch by epoch through the calls that
`Pretrainer.train` makes, each epoch with its validation and without its
checkpoint writes.

Set-up: the corpus generated from the seed and featurized, the state
built, the benchmark's weights loaded, the unit stack uploaded, epoch 0
(its first three steps read for the comparison: the batches they took,
the first gradient from Adam's state, the weights after the third) and
two validation passes (the first fills the resident eval stack, the
second warms its path). The window: whole epochs from epoch 1 until
`seconds` have passed. Then the reference follows the first three steps
from the same weights.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from benchmark import compare, roofline, weights
from benchmark import trace as tracelib
from benchmark.reference import data as rdata
from benchmark.reference import molecule
from benchmark.reference import steps as rsteps
from benchmark.traffic import molgen
from molclr_tpu_torch.data.regroup import concat_units
from molclr_tpu_torch.train.config import ModelConfig, PretrainConfig
from molclr_tpu_torch.train.pretrain import Pretrainer

B1 = 0.9
CHECKED_STEPS = 3
# train steps of the last window epoch that the traced run profiles
PROFILED_STEPS = 16
MARK = "bench.profiled_subwindow"
ATOMS = 7                      # the heavy-atom column of a signature


def program_seed(seed: int) -> int:
    """The seed handed to the program (its numpy streams take < 2^32)."""
    return int(seed) % (2**31 - 1)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def phase(ctx, name: str) -> None:
    """Log the seconds since the process started at the end of a set-up
    phase."""
    _sync(ctx.device)
    ctx.log(f"set-up: {name} done at {time.perf_counter() - ctx.t0:.2f} s")


def make_config(ctx) -> PretrainConfig:
    c, tr = ctx.config, ctx.traffic
    model = ModelConfig(gnn_type=c["model_type"], num_layers=c["num_layer"],
                        emb_dim=c["emb_dim"], feat_dim=c["feat_dim"],
                        drop_ratio=c["drop_ratio"], pool=c["pool"],
                        tile=c["tile"])
    return PretrainConfig(
        batch_size=tr["batch_size"], epochs=tr["epochs"],
        warm_up=tr["warm_up"], init_lr=tr["init_lr"],
        weight_decay=tr["weight_decay"], temperature=tr["temperature"],
        use_cosine_similarity=True, ntxent_impl=tr["ntxent_impl"],
        aug=tr["aug"], valid_size=tr["valid_size"], model=model,
        seed=program_seed(ctx.seed), ckpt_dir=ctx.tmp,
        log_every_steps=1 << 30)


def adam_gradient(opt, p) -> torch.Tensor:
    """The gradient (plus weight decay) that Adam took in its first step,
    from its first moment: exp_avg = (1 - b1) g; nought where it holds no
    state for p (a step that never reached the optimizer)."""
    st = opt.state.get(p, {})
    if "exp_avg" not in st:
        return torch.zeros_like(p, device="cpu")
    return (st["exp_avg"] / (1 - B1)).cpu()


def device_info(dev, peak: int, traced: dict) -> dict:
    """The result line's `device`: the card, the run's peak memory, and
    with --trace 1 the profiled sub-window's busy and wall seconds."""
    return {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1, "memory_peak_bytes": int(peak), **traced}


def cpu_batch(gb) -> dict:
    return {f: getattr(gb, f).detach().cpu() for f in rdata.FIELDS}


def view_counts(v: dict) -> dict:
    """n, n_real, nnz_adj, nnz_cnt of one view (reference/data.py layout),
    as the layer kernels see its adjacency and edge counts."""
    e = v["edge_mask"]
    n = v["atom_type"].shape[0]
    n_real = int(v["node_mask"].sum())
    dst = v["dst"][e]
    hit = torch.zeros(n, 8, dtype=torch.bool)
    hit[dst, v["bond_type"][e]] = True
    hit[dst, 5 + v["bond_dir"][e]] = True
    hit[v["node_mask"], rdata.SELF_LOOP_BOND_TYPE] = True
    hit[v["node_mask"], 5] = True
    return {"n": n, "n_real": n_real, "nnz_adj": n_real + int(e.sum()),
            "nnz_cnt": int(hit.sum())}


def unit_stats(stack: dict, aug: str) -> dict:
    """Per tile-unit real atoms, real molecules, directed bonds and the
    directed bonds node augmentation deletes (floor(M / 4) per molecule);
    the bonds subgraph removal deletes depend on the draw and are left in
    (the step's aggregation FLOPs then count them: an upper bound)."""
    gm = stack["graph_mask"].bool()
    nb = stack["graph_n_bonds"].long()
    dropped = (2 * torch.floor(0.25 * nb.float()).long() * gm
               if aug == "node" else torch.zeros_like(nb))
    return {k: v.cpu().numpy() for k, v in {
        "atoms": stack["node_mask"].bool().sum(1),
        "graphs": gm.sum(1),
        "edges": stack["edge_mask"].bool().sum(1),
        "dropped": dropped.sum(1)}.items()}


def step_flops(c: dict, atoms, edges, graphs, backward: bool) -> float:
    """Model FLOPs of both views of one batch through the encoder, the
    projection and NT-Xent (edge counts: every real atom's self-loop and
    bond-type / direction entries bounded by 2 per atom plus 2 per
    directed bond)."""
    d, f = c["emb_dim"], c["feat_dim"]
    d2 = 2 * d
    nnz_adj = atoms + edges
    nnz_cnt = 2 * atoms + 2 * edges
    per_view = (c["num_layer"] * roofline.layer_flops(
        c["model_type"], atoms, nnz_adj, nnz_cnt, d, d2, False)
        + roofline.head_flops(graphs, d, f, "project", False))
    fwd = 2 * per_view + roofline.ntxent_flops(graphs, f // 2, False)
    if not backward:
        return fwd
    bwd = (2 * (c["num_layer"] * roofline.layer_flops(
        c["model_type"], atoms, nnz_adj, nnz_cnt, d, d2, True)
        + roofline.head_flops(graphs, d, f, "project", True))
        + roofline.ntxent_flops(graphs, f // 2, True))
    return fwd + bwd


def view_bound_s(c: dict, k: dict, backward: bool) -> float:
    """The layer kernels' least time over one view's num_layer layers."""
    d, s = c["emb_dim"], c["tile"]
    args = (k["n"], s, k["n_real"], k["nnz_adj"], k["nnz_cnt"], d)
    if c["model_type"] == "gin":
        t = roofline.gine_bn_fwd_s(*args, 2 * d)
        if backward:
            t += roofline.gine_bn_bwd_s(*args, 2 * d)
    else:
        t = roofline.gcn_bn_fwd_s(*args)
        if backward:
            t += roofline.gcn_bn_bwd_s(*args)
    return c["num_layer"] * t


def _expected_batch_check(c, tr, cfg, sig, smiles, batches, tile, g_t,
                          steps_epoch):
    """Molecule slots of the checked steps that differ from the molecule
    the reference's own split and unit plan put there (read from its
    SMILES by reference/molecule.py: each atom's type and chirality in
    order, each bond's ends, type and direction; no hydrogens), plus
    molecule slots the plan leaves empty but the batch fills (or the
    reverse)."""
    n = sig.shape[0]
    train, _ = rdata.split_ids(n, cfg.seed, cfg.valid_size)
    groups = rdata.unit_groups(sig[train, ATOMS], tile, cfg.seed)
    per_step = len(groups) // steps_epoch
    orders = rdata.epoch_orders(len(groups), per_step, cfg.seed, 0,
                                len(batches))
    bad = 0
    for b, row in zip(batches, orders):
        g_total = b["graph_mask"].shape[0]
        if g_total != per_step * g_t:
            return g_total
        want = [None] * g_total
        for i, u in enumerate(row):
            for j, mol in enumerate(groups[u]):
                want[i * g_t + j] = molecule.expected(smiles[train[mol]],
                                                      hydrogens=False)
        got = molecule.batch_molecules(b, g_total)
        for w, m, real in zip(want, got, b["graph_mask"].tolist()):
            bad += int((w is not None) != real or (real and m != w))
    return bad


def run(ctx, control: bool = False) -> dict:
    """One run of a pretraining cell (control=True: set-up, the checked
    steps and the comparison, the reference in TF32 beside it, no
    window)."""
    dev, c, tr = ctx.device, ctx.config, ctx.traffic
    cfg = make_config(ctx)
    phase(ctx, "imports")
    smiles, sig, _ = molgen.generate(c["pretrain_corpus_molecules"],
                                     ctx.seed, tr["molecules"])
    phase(ctx, "generate")
    pt = Pretrainer(cfg, dev).setup_data(smiles)
    phase(ctx, "featurize")
    pt.setup_state()
    named = [(n, tuple(p.shape)) for n, p in pt.model.named_parameters()]
    w0 = weights.make(named, ctx.seed, 0, dev)
    weights.load_into(pt.model, w0)
    p0 = {k: v.detach().cpu() for k, v in w0.items()}
    del w0
    buf0 = {k: v.detach().cpu().clone()
            for k, v in pt.model.named_buffers()}
    phase(ctx, "state")
    pt._activate_units(ctx.log)
    phase(ctx, "pack and upload the unit stack")
    if not pt._units:
        raise RuntimeError("the tile-unit path did not activate")
    stack = pt._stack
    tile, g_t = stack["atom_type"].shape[1], stack["graph_mask"].shape[1]
    steps_epoch = pt.steps_per_epoch

    # epoch 0: the checked steps, then the rest and validation (set-up)
    orders = pt._unit_orders(0)
    batches = [cpu_batch(concat_units(stack, torch.as_tensor(
        orders[s], dtype=torch.long, device=dev)))
        for s in range(CHECKED_STEPS)]
    losses = pt._resident_epoch(0, orders[:1], ctx.log)
    named_p = list(pt.model.named_parameters())
    first = {n: adam_gradient(pt.opt, p) for n, p in named_p}
    losses += pt._resident_epoch(0, orders[1:CHECKED_STEPS], ctx.log)
    after = {n: p.detach().cpu().clone() for n, p in named_p}
    phase(ctx, "checked steps")
    out = {"attempted": 0, "failed": 0, "e2e": {}, "layer": {}}
    if not control:
        t_ep = time.perf_counter()
        pt._resident_epoch(0, orders[CHECKED_STEPS:], ctx.log)
        phase(ctx, "epoch 0")
        pt.validate(0)
        pt.validate(0)
        phase(ctx, "validation")
        epoch_s = time.perf_counter() - t_ep
        out["e2e"]["setup_s"] = time.perf_counter() - ctx.t0
        _window(ctx, pt, c, cfg, stack, epoch_s, out)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    max_waves = pt.max_waves
    del pt, stack, named_p
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference follows the checked steps
    mismatch = _expected_batch_check(c, tr, cfg, sig, smiles, batches, tile,
                                     g_t, steps_epoch)
    keys = [rdata.draw_keys(cfg.aug, b["atom_type"].shape[0],
                            rdata.step_generator(cfg.seed,
                                                 rdata.TRAIN_STREAM, s))
            for s, b in enumerate(batches)]
    ref_max_waves = max(1, min(int(sig[:, ATOMS].max()) - 1, 2000))
    kw = dict(kind=cfg.aug, max_waves=ref_max_waves, gnn=c["model_type"],
              layers=c["num_layer"], temperature=cfg.temperature,
              lr=cfg.init_lr, wd=cfg.weight_decay, device=dev)
    ref = rsteps.pretrain_steps(p0, buf0, batches, keys, **kw)
    prog = {"losses": losses[:CHECKED_STEPS], "first_grad": first,
            "params": after}
    nums = readings(prog, ref, p0)
    lim = ctx.limits
    out["checks"] = [
        ("batch_mismatch", float(mismatch), lim["batch_mismatch"]),
        ("horizon_gap", float(abs(max_waves - ref_max_waves)),
         lim["horizon_gap"]),
        ("loss0_gap", nums["loss0_gap"], lim["loss0_gap"]),
        ("loss_gap", nums["loss_gap"], lim["loss_gap"]),
        ("grad_norm_gap", nums["grad_norm_gap"], lim["grad_norm_gap"]),
        ("update_norm_gap", nums["update_norm_gap"], lim["update_norm_gap"]),
    ]
    out["device"] = device_info(dev, peak, out.pop("trace_device", {}))
    out["worst_leaf"] = {"grad": nums["grad_at"], "update": nums["update_at"]}
    if control:
        out["diag"] = {"program_losses": prog["losses"],
                       "reference_losses": ref["losses"]}
        out["control"] = readings(rsteps.pretrain_steps(
            p0, buf0, batches, keys, tf32=True, **kw), ref, p0)
        out["faults"] = {
            "half": readings(rsteps.pretrain_steps(
                p0, buf0, batches, keys, half=True, **kw), ref, p0),
            "frozen": readings(rsteps.pretrain_steps(
                p0, buf0, batches, keys, **dict(kw, lr=0.0)), ref, p0)}
        f64 = rsteps.pretrain_steps(p0, buf0, batches, keys,
                                    dtype=torch.float64, **kw)
        out["f64"] = {"program": readings(prog, f64, p0),
                      "reference": readings(ref, f64, p0)}
    return out


def readings(prog: dict, ref: dict, p0: dict) -> dict:
    """The numbers compared: the relative loss gap of the first step and
    the widest of the checked steps (later steps carry Adam's rounding
    noise: an element whose gradient is near nought takes a whole step of
    either sign); the worst leaf's gap of first-gradient norms; the worst
    leaf's gap of the norms of the change over the checked steps, over the
    leaves whose reference gradient is not nought to rounding."""
    grad_gap, grad_at = compare.leaf_norm_gap(prog["first_grad"],
                                              ref["first_grad"])
    moved = compare.moved(ref["first_grad"])
    dp = {k: prog["params"][k] - p0[k] for k in moved}
    dr = {k: ref["params"][k] - p0[k] for k in moved}
    upd_gap, upd_at = compare.leaf_norm_gap(dp, dr)
    return {"loss0_gap": compare.rel_gap(prog["losses"][:1],
                                         ref["losses"][:1]),
            "loss_gap": compare.rel_gap(prog["losses"], ref["losses"]),
            "grad_norm_gap": grad_gap, "grad_at": grad_at,
            "update_norm_gap": upd_gap, "update_at": upd_at,
            "left_out": sorted(set(ref["first_grad"]) - set(moved))}


def _window(ctx, pt, c, cfg, stack, epoch_s, out) -> None:
    """Whole epochs until ctx.seconds have passed: pretrain_mol_per_s. With
    ctx.trace the last epoch's last PROFILED_STEPS steps and its
    validation run under torch.profiler, and the per-layer readings are
    gathered."""
    dev = ctx.device
    us = unit_stats(stack, cfg.aug)
    ev = pt._eval_stack
    val = {"atoms": int(ev["node_mask"].sum()),
           "graphs": int(ev["graph_mask"].sum()),
           "edges": int(ev["edge_mask"].sum())}
    val_flops = step_flops(c, val["atoms"], val["edges"], val["graphs"],
                           False)
    mols = steps = bad = 0
    flops = 0.0
    epoch = 1
    summary = None
    watch = gc_watch(ctx.log)
    log_slow_calls(ctx.log, pt, "_key_window")
    if pt.graphed is not None:
        log_slow_calls(ctx.log, pt.graphed, "run")
    t_start = time.perf_counter()
    while True:
        t_ep, cpu_ep = time.perf_counter(), time.process_time()
        orders = pt._unit_orders(epoch)
        last = ctx.trace and (t_ep - t_start + epoch_s >= ctx.seconds)
        if last:
            split = max(0, len(orders) - PROFILED_STEPS)
            losses = pt._resident_epoch(epoch, orders[:split], ctx.log)
            step0 = pt.step
            losses += _profiled(ctx, pt, epoch, orders[split:], out)
            summary = out.pop("summary")
            summary["bound_s"] = _profiled_bound(ctx, c, cfg, stack,
                                                 orders[split:], step0,
                                                 pt, epoch)
            t_val = time.perf_counter()
        else:
            losses = pt._resident_epoch(epoch, orders, ctx.log)
            t_val = time.perf_counter()
            pt.validate(epoch)
        bad += sum(1 for x in losses if not math.isfinite(x))
        a, e, g, dr = (us[k][orders].sum(1) for k in
                       ("atoms", "edges", "graphs", "dropped"))
        flops += sum(step_flops(c, int(a[i]), int(e[i] - dr[i]), int(g[i]),
                                True) for i in range(len(orders)))
        flops += val_flops
        mols += int(g.sum())
        steps += len(orders)
        epoch_s = time.perf_counter() - t_ep
        ctx.log(f"window: epoch {epoch} {epoch_s:.4f} s (steps "
                f"{t_val - t_ep:.4f} s, validation "
                f"{t_ep + epoch_s - t_val:.4f} s, process CPU "
                f"{time.process_time() - cpu_ep:.4f} s)")
        epoch += 1
        if last or (not ctx.trace
                    and time.perf_counter() - t_start >= ctx.seconds):
            break
    _sync(dev)
    window_s = time.perf_counter() - t_start
    gc.callbacks.remove(watch)
    out["attempted"], out["failed"] = steps, bad
    out["e2e"]["pretrain_mol_per_s"] = mols / window_s
    if ctx.trace:
        out["layer"] = {
            "kind": "pretrain", "model_flops": flops, "window_s": window_s,
            "peak_flops": roofline.PEAK_F32,
            "profiled_window_s": summary["window_s"],
            "busy_s": summary["busy_s"], "bound_s": summary["bound_s"],
            "port_kernel_s": summary["port_kernel_s"],
            "port_launches": summary["port_launches"]}
        out["trace_device"] = {"busy_s": summary["busy_s"],
                               "window_s": summary["window_s"]}
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}


def gc_watch(log):
    """Log each garbage collection that takes 50 ms or more (a host stall
    inside the window would otherwise go unexplained); returns the
    callback, for gc.callbacks.remove."""
    began = {}

    def watch(phase, info):
        if phase == "start":
            began["t"] = time.perf_counter()
        elif "t" in began:
            took = time.perf_counter() - began.pop("t")
            if took >= 0.05:
                log(f"window: garbage collection of generation "
                    f"{info['generation']} took {took:.4f} s")

    gc.callbacks.append(watch)
    return watch


def log_slow_calls(log, obj, name: str, slow_s: float = 0.25) -> None:
    """Log each call of obj's method `name` that takes slow_s or more, so
    that a stall inside the window is placed: the host's key draws and
    their pinned upload (Pretrainer._key_window), or a replay call that
    blocks while the card is behind (GraphedSteps.run)."""
    fn = getattr(obj, name)

    def timed(*a, **k):
        t = time.perf_counter()
        out = fn(*a, **k)
        took = time.perf_counter() - t
        if took >= slow_s:
            log(f"window: {type(obj).__name__}.{name} took {took:.4f} s")
        return out

    setattr(obj, name, timed)


def _profiled(ctx, pt, epoch, orders, out) -> list:
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = ctx.device
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(dev)
    with profile(activities=acts) as prof:
        # the tracer can miss the first kernels launched as it starts
        torch.ones(1, device=dev).add_(1)
        _sync(dev)
        with record_function(MARK):
            with record_function("Pretrainer._resident_epoch"):
                losses = pt._resident_epoch(epoch, orders, ctx.log)
            with record_function("Pretrainer.validate"):
                pt.validate(epoch)
            _sync(dev)
    out["summary"] = tracelib.summarize(prof, MARK)
    return losses


def _profiled_bound(ctx, c, cfg, stack, orders, step0, pt, epoch) -> float:
    """The layer kernels' least time over the profiled steps (both views,
    forward and backward) and the validation pass (both views, forward),
    from each view's own counts."""
    dev = ctx.device
    total = 0.0
    for j, row in enumerate(orders):
        b = cpu_batch(concat_units(stack, torch.as_tensor(
            row, dtype=torch.long, device=dev)))
        keys = rdata.draw_keys(cfg.aug, b["atom_type"].shape[0],
                               rdata.step_generator(cfg.seed,
                                                    rdata.TRAIN_STREAM,
                                                    step0 + j))
        for v in rdata.paired_views(b, cfg.aug, keys, pt.max_waves):
            total += view_bound_s(c, view_counts(v), True)
    ev = pt._eval_stack
    for i in range(ev["graph_mask"].shape[0]):
        b = cpu_batch(concat_units(ev, torch.tensor([i], device=dev)))
        gen = rdata.step_generator(cfg.seed, rdata.VALID_STREAM, epoch, i)
        keys = rdata.draw_keys(cfg.aug, b["atom_type"].shape[0], gen)
        for v in rdata.paired_views(b, cfg.aug, keys, pt.max_waves):
            total += view_bound_s(c, view_counts(v), False)
    return total
