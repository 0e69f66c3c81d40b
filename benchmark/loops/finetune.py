"""Fine-tuning cells: a MoleculeNet task's ensemble of M = targets x seeds
members trained in lockstep by the FineTuner, driven epoch by epoch
through the calls `FineTuner.train` makes (the train epoch over the
resident split stack, graphed steps; evaluate("valid"); the best-state
keep), without its final test pass and files.

Set-up: the task CSV generated from the seed into the run's scratch
directory, featurized with hydrogens and split by scaffold; the members
built with the benchmark's weights (one draw per seed, shared by that
seed's targets); epoch 0, whose first three steps are read for the
comparison (the batches and labels they took, the first gradient from
Adam's state, the weights after the third and the validation predictions
there, whose pass also captures the evaluation graph), then its
validation and keep. The window: whole epochs from epoch 1 until
`seconds` have passed. Then the reference follows the first three steps
and predicts the validation split.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import os
import time

import numpy as np
import torch

from benchmark import compare, roofline, weights
from benchmark import trace as tracelib
from benchmark.loops.pretrain import (
    CHECKED_STEPS,
    MARK,
    adam_gradient,
    _sync,
    phase,
    cpu_batch,
    device_info,
    gc_watch,
    program_seed,
    view_counts,
)
from benchmark.reference import molecule
from benchmark.reference import steps as rsteps
from benchmark.traffic import molgen
from molclr_tpu_torch.data.regroup import concat_units
from molclr_tpu_torch.data.tasks import TASKS
from molclr_tpu_torch.train.config import FineTuneConfig, ModelConfig
from molclr_tpu_torch.train.finetune import FineTuner, SharedTaskData
from molclr_tpu_torch.train.metrics import METRIC_DIRECTION

MASK_SALT = 17                  # seed s's dropout stream: cfg.seed + 17 + s


def make_config(ctx) -> FineTuneConfig:
    c, tr = ctx.config, ctx.traffic
    f = c["finetune"]
    model = ModelConfig(gnn_type=c["model_type"], num_layers=c["num_layer"],
                        emb_dim=c["emb_dim"], feat_dim=c["feat_dim"],
                        drop_ratio=f["drop_ratio"], pool=c["pool"],
                        pred_n_layer=f["pred_n_layer"],
                        pred_act=f["pred_act"], tile=c["tile"])
    return FineTuneConfig(
        task_name=tr["task"], data_root=ctx.tmp,
        batch_size=tr["batch_size"], epochs=tr["epochs"],
        init_lr=tr["init_lr"], init_base_lr=tr["init_base_lr"],
        weight_decay=tr["weight_decay"], model=model,
        valid_size=tr["valid_size"], test_size=tr["test_size"],
        splitting=tr["splitting"], seed=program_seed(ctx.seed),
        ckpt_dir=ctx.tmp, n_seeds=tr["n_seeds"], batch_targets=True)


def _flat(members: list) -> dict:
    return {f"m{m}.{k}": v for m, d in enumerate(members)
            for k, v in d.items()}


def _molecules(smiles, labels, ids) -> collections.Counter:
    """(molecule as reference/molecule.py reads its SMILES, with its
    hydrogens, labels) of the molecules `ids`, counted."""
    return collections.Counter(
        (molecule.expected(smiles[i], hydrogens=True),
         tuple(labels[i].tolist())) for i in ids)


def _held(batches, labels) -> collections.Counter:
    """(molecule, labels) of every real molecule slot of the batches,
    counted."""
    held = collections.Counter()
    for b, lab in zip(batches, labels):
        g_total = b["graph_mask"].shape[0]
        lab = lab.reshape(g_total, -1).long().numpy()
        for i, m in enumerate(molecule.batch_molecules(b, g_total)):
            if b["graph_mask"][i]:
                held[(m, tuple(lab[i].tolist()))] += 1
    return held


def batch_check(batches, labels, batch_size, gen, train) -> int:
    """Molecule slots of the checked steps that hold no molecule of the
    train split left over by the slots before (atoms, bonds, hydrogens
    and every label column together), plus steps whose real molecules are
    not batch_size."""
    bad = sum(abs(int(b["graph_mask"].sum()) - batch_size) for b in batches)
    held = _held(batches, labels)
    return bad + sum((held - _molecules(gen["smiles"], gen["labels"],
                                        train)).values())


def split_check(split, program_smiles, gen, valid_size, test_size) -> int:
    """Faults of the program's scaffold split against the generator's
    record: molecules the program keeps other than the task's, in order;
    molecules in no split or in two; a train or train-and-valid part past
    the split's cutoffs; and scaffold-key groups (a finer partition than
    Murcko scaffolds, molgen.generate) that lie in more than one split,
    each a scaffold shared across splits."""
    n = len(gen["smiles"])
    bad = sum(a != b for a, b in zip(program_smiles, gen["smiles"]))
    bad += abs(len(program_smiles) - n)
    where = np.full(n, -1)
    for part, ids in enumerate(split):
        for i in ids:
            bad += int(where[i] != -1)
            where[i] = part
    bad += int((where == -1).sum())
    tr, va, _ = split
    bad += int(len(tr) > (1.0 - valid_size - test_size) * n)
    bad += int(len(tr) + len(va) > (1.0 - test_size) * n)
    parts = {}
    for i, k in enumerate(gen["scaffold_keys"]):
        parts.setdefault(k, set()).add(int(where[i]))
    return bad + sum(len(p) > 1 for p in parts.values())


def valid_check(valid, valid_labels, gen, valid_ids) -> int:
    """Molecule slots of the validation batches beyond, or short of, the
    validation split's molecules with their labels, each once."""
    held = _held(valid, valid_labels)
    want = _molecules(gen["smiles"], gen["labels"], valid_ids)
    return sum((held - want).values()) + sum((want - held).values())


def step_flops(c: dict, k: dict, graphs: int, members: int,
               backward: bool) -> float:
    """Model FLOPs of the members on one batch (counts k of view_counts):
    the trunk's layers, feat_lin and the prediction head."""
    d, f = c["emb_dim"], c["feat_dim"]
    per = (c["num_layer"] * roofline.layer_flops(
        "gin", k["n_real"], k["nnz_adj"], k["nnz_cnt"], d, 2 * d, False)
        + roofline.head_flops(graphs, d, f, "predict", False))
    if backward:
        per += (c["num_layer"] * roofline.layer_flops(
            "gin", k["n_real"], k["nnz_adj"], k["nnz_cnt"], d, 2 * d, True)
            + roofline.head_flops(graphs, d, f, "predict", True))
    return members * per


def batch_bound_s(c: dict, k: dict, members: int, backward: bool) -> float:
    """The member-axis layer kernels' least time on one batch."""
    d, s = c["emb_dim"], c["tile"]
    args = (k["n"], s, k["n_real"], k["nnz_adj"], k["nnz_cnt"], d, 2 * d,
            members)
    t = roofline.gine_members_s(*args, backward=False)
    if backward:
        t += roofline.gine_members_s(*args, backward=True)
    return c["num_layer"] * t


def _stack_rows(stack, rows) -> list:
    """Rows of a split stack as reference batches on the CPU."""
    dev = stack.labels.device
    return [cpu_batch(concat_units(stack.batches,
                                   torch.as_tensor([r], device=dev)))
            for r in rows]


def row_stats(stack) -> dict:
    """Per stack row real atoms, directed bonds and molecules, with the
    FLOP counts' edge-count entries bounded by 2 per atom and 2 per
    directed bond."""
    b = stack.batches
    atoms = b["node_mask"].bool().sum(1).cpu().numpy()
    edges = b["edge_mask"].bool().sum(1).cpu().numpy()
    graphs = b["graph_mask"].bool().sum(1).cpu().numpy()
    return [({"n_real": int(a), "nnz_adj": int(a + e),
              "nnz_cnt": int(2 * a + 2 * e)}, int(g))
            for a, e, g in zip(atoms, edges, graphs)]


def run(ctx, control: bool = False) -> dict:
    dev, c, tr = ctx.device, ctx.config, ctx.traffic
    if c["model_type"] != "gin":
        raise ValueError("the fine-tuning reference covers the GIN trunk")
    cfg = make_config(ctx)
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
    ft = FineTuner(cfg, dev, targets=list(task.targets))
    ft.setup_data(shared=shared).setup_state()
    split, program_smiles = tuple(list(p) for p in ft.split), list(ft.smiles)
    phase(ctx, "split and state")
    n_seeds, members = cfg.n_seeds, ft.n_members
    named = [(n, tuple(p.shape)) for n, p in ft.models[0].named_parameters()]
    seed_w = [weights.make(named, ctx.seed, 1 + s, dev)
              for s in range(n_seeds)]
    for m, model in enumerate(ft.models):
        weights.load_into(model, seed_w[m % n_seeds])
    p0 = [{k: v.cpu() for k, v in seed_w[m % n_seeds].items()}
          for m in range(members)]
    del seed_w
    buf0 = [{k: v.detach().cpu().clone() for k, v in model.named_buffers()}
            for model in ft.models]

    # epoch 0: the checked steps, the validation predictions there, the
    # rest of the epoch, its validation and keep (set-up)
    stack, order = ft._train_epoch_stack()
    rows = torch.from_numpy(np.asarray(order, np.int64)[:, None]).to(dev)
    batches, labels = [], []
    for s in range(CHECKED_STEPS):
        b, lab, _ = ft._take(stack, rows[s])
        batches.append(cpu_batch(b))
        labels.append(lab.detach().cpu())
    losses = ft._run_steps(rows[:1]).cpu().numpy().tolist()
    params = [list(model.named_parameters()) for model in ft.models]
    first = _flat([{n: adam_gradient(ft.opt, p)
                    for n, p in mp} for mp in params])
    losses += ft._run_steps(rows[1:CHECKED_STEPS]).cpu().numpy().tolist()
    after = _flat([{n: p.detach().cpu().clone() for n, p in mp}
                   for mp in params])
    preds = torch.from_numpy(ft.predictions("valid"))
    vstack = ft._stacks["valid"]
    valid = _stack_rows(vstack, range(vstack.labels.shape[0]))
    valid_labels = list(vstack.labels.detach().cpu())
    phase(ctx, "checked steps and validation graph")
    out = {"attempted": 0, "failed": 0, "e2e": {}, "layer": {}}
    keep = {"best": np.full(members, -np.inf), "state": None}
    if not control:
        t_ep = time.perf_counter()
        ft._run_steps(rows[CHECKED_STEPS:])
        direction = METRIC_DIRECTION[task.metric]
        _validate(ft, direction, keep)
        phase(ctx, "epoch 0 and its validation")
        epoch_s = time.perf_counter() - t_ep
        out["e2e"]["setup_s"] = time.perf_counter() - ctx.t0
        _window(ctx, ft, c, direction, keep, epoch_s, out)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del ft, stack, vstack, params, keep
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    mismatch = batch_check(batches, labels, cfg.batch_size, gen, split[0])
    split_bad = split_check(split, program_smiles, gen, cfg.valid_size,
                            cfg.test_size)
    valid_bad = valid_check(valid, valid_labels, gen, split[1])
    kw = dict(mask_seeds=[cfg.seed + MASK_SALT + s for s in range(n_seeds)],
              n_seeds=n_seeds, layers=c["num_layer"], d=c["emb_dim"],
              drop=c["finetune"]["drop_ratio"], head_lr=cfg.init_lr,
              base_lr=cfg.init_base_lr, wd=cfg.weight_decay,
              pred_layers=c["finetune"]["pred_n_layer"], valid=valid,
              device=dev)
    ref = rsteps.finetune_steps(p0, buf0, batches, labels, **kw)
    mask = torch.stack([b["graph_mask"] for b in valid])
    prog = {"losses": losses[:CHECKED_STEPS], "first_grad": first,
            "params": after, "preds": preds}
    nums = readings(prog, ref, _flat(p0), mask)
    lim = ctx.limits
    out["checks"] = [
        ("batch_mismatch", float(mismatch), lim["batch_mismatch"]),
        ("split_mismatch", float(split_bad), lim["split_mismatch"]),
        ("valid_mismatch", float(valid_bad), lim["valid_mismatch"]),
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

        def read(**extra):
            r = rsteps.finetune_steps(p0, buf0, batches, labels,
                                      **dict(kw, **extra))
            r["first_grad"], r["params"] = (_flat(r["first_grad"]),
                                            _flat(r["params"]))
            return readings(r, ref, _flat(p0), mask)

        out["control"] = read(tf32=True)
        out["faults"] = {"half": read(half=True),
                         "frozen": read(head_lr=0.0, base_lr=0.0)}
    return out


def readings(prog: dict, ref: dict, p0: dict, mask) -> dict:
    """As the pretraining cells' readings over every member's leaves, the
    first step's member losses apart, and the widest gap of the members'
    validation predictions over the real molecules, as a share of the
    largest reference prediction."""
    ref_grad = _flat(ref["first_grad"]) if isinstance(
        ref["first_grad"], list) else ref["first_grad"]
    ref_params = _flat(ref["params"]) if isinstance(
        ref["params"], list) else ref["params"]
    grad_gap, grad_at = compare.leaf_norm_gap(prog["first_grad"], ref_grad)
    moved = compare.moved(ref_grad)
    upd_gap, upd_at = compare.leaf_norm_gap(
        {k: prog["params"][k] - p0[k] for k in moved},
        {k: ref_params[k] - p0[k] for k in moved})
    real = mask[:, None, :, None].expand_as(ref["preds"])
    pl, rl = prog["losses"], ref["losses"]
    return {"loss0_gap": compare.rel_gap(pl[0], rl[0]),
            "loss_gap": compare.rel_gap(sum(pl, []), sum(rl, [])),
            "grad_norm_gap": grad_gap, "grad_at": grad_at,
            "update_norm_gap": upd_gap, "update_at": upd_at,
            "valid_pred_gap": compare.max_rel_diff(prog["preds"][real],
                                                   ref["preds"][real])}


def _validate(ft, direction, keep, span=contextlib.nullcontext) -> None:
    """evaluate("valid") and the best-state keep, as train() runs them."""
    with span("FineTuner.evaluate"):
        val = ft.evaluate("valid")
    scores = direction * np.asarray(val.get("per_member", [val["metric"]]))
    improved = scores > keep["best"]
    keep["best"] = np.where(improved, scores, keep["best"])
    if improved.any():
        with span("FineTuner._keep_best"):
            keep["state"] = ft._keep_best(improved, keep["state"])


def _epoch(ft, span=contextlib.nullcontext):
    """One train epoch as FineTuner._train_epoch runs it; returns (losses
    [S, M], the epoch's stack rows). span(name) brackets each call."""
    with span("FineTuner._train_epoch_stack"):
        _, order = ft._train_epoch_stack()
    with span("FineTuner._run_steps"):
        rows = torch.from_numpy(np.asarray(order, np.int64)[:, None]).to(
            ft.device)
        losses = ft._run_steps(rows).cpu().numpy()
    return losses, np.asarray(order)


def _window(ctx, ft, c, direction, keep, epoch_s, out) -> None:
    dev = ctx.device
    m_count = ft.n_members
    val_flops = sum(step_flops(c, k, g, m_count, False)
                    for k, g in row_stats(ft._stacks["valid"]))
    mols = steps = bad = 0
    flops, valid_s = 0.0, []
    summary = None
    watch = gc_watch(ctx.log)
    t_start = time.perf_counter()
    while True:
        t_ep, cpu_ep = time.perf_counter(), time.process_time()
        last = ctx.trace and (t_ep - t_start + epoch_s >= ctx.seconds)
        if last:
            summary = _profiled(ctx, ft, direction, keep)
            losses, order = summary.pop("epoch")
        else:
            losses, order = _epoch(ft)
            t_v = time.perf_counter()
            _validate(ft, direction, keep)
            if ctx.trace:
                _sync(dev)
                valid_s.append(time.perf_counter() - t_v)
        bad += int((~np.isfinite(losses)).any(1).sum())
        gm = ft._host_stacks["train"][0]
        mols += m_count * int(gm[order].sum())
        if ctx.trace:
            stats = row_stats(ft._stacks["train"])
            flops += sum(step_flops(c, *stats[r], m_count, True)
                         for r in order) + val_flops
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
    if ctx.trace:
        bound = summary.pop("bound_s")
        out["layer"] = {
            "kind": "finetune", "model_flops": flops, "window_s": window_s,
            "peak_flops": roofline.PEAK_F32, "valid_s": valid_s,
            "profiled_window_s": summary["window_s"],
            "busy_s": summary["busy_s"], "bound_s": bound,
            "port_kernel_s": summary["port_kernel_s"],
            "port_launches": summary["port_launches"]}
        out["trace_device"] = {"busy_s": summary["busy_s"],
                               "window_s": summary["window_s"]}
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}


def _profiled(ctx, ft, direction, keep) -> dict:
    """The last window epoch (its steps, validation and keep) under
    torch.profiler; the layer kernels' least time over its launches."""
    from torch.profiler import ProfilerActivity, profile, record_function

    dev, c = ctx.device, ctx.config
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(dev)
    with profile(activities=acts) as prof:
        torch.ones(1, device=dev).add_(1)
        _sync(dev)
        with record_function(MARK):
            epoch = _epoch(ft, record_function)
            _validate(ft, direction, keep, record_function)
            _sync(dev)
    summary = tracelib.summarize(prof, MARK)
    m_count = ft.n_members
    bound = sum(batch_bound_s(c, view_counts(b), m_count, True)
                for b in _stack_rows(ft._stacks["train"], epoch[1]))
    vstack = ft._stacks["valid"]
    bound += sum(batch_bound_s(c, view_counts(b), m_count, False)
                 for b in _stack_rows(vstack, range(vstack.labels.shape[0])))
    summary["bound_s"] = bound
    summary["epoch"] = epoch
    return summary

