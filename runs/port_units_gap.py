"""Where the card-against-CPU gap of one pretraining step comes from, on the
units-path batches of a data-parallel Pretrainer and on phase 5's batch:
the kernels against the CPU, and a second witness, the plain versions on
the card, against the CPU and against the kernels.

    python3 runs/port_units_gap.py [--seeds 0 1 2] [--orders 4]
        [--cases f32 bf16 f32_dropout] [--out FILE]
                                        (repository root, one card)

Batches: for each seed, the first --orders units-path batches of a world-1
NCCL Pretrainer (chip_smoke.py's full-width GIN config, data_axis 'data',
that seed, on phase 7's 4,096-molecule corpus; seed 0's first batch is the
one phase 18 (a) holds its world-1 steps on), and phase 5's pretraining
batch. Per batch and case (f32 and bf16 through the BN-chained layers,
f32 at drop_ratio 0.1 through the unchained ones on one seeded set of keep
masks), three one-card steps from the same seeded state with the same
augmentation keys (the cfg's seed): on the card through the kernels, on
the card through the kernels' plain versions (the K1f / K1b / K4f / K4b
wrappers bound to fused_layer's *_plain functions, no launch), and on the
CPU. Each pair is compared as chip_smoke.state_agreement compares a card
step with the CPU's (the second of the pair the reference): the loss gap,
the largest share of a tensor's real-gradient elements off after Adam and
the tensors past STEP_FRAC_OFF, the largest gradient difference over the
largest gradient. Relu branches: for each layer call (2 views x 5 layers)
the elements of mid [N, 2 D] on real nodes whose relu branch (mid > 0)
differs between the pair, and the projection head's pre-relu [G, 512]
likewise (recomputed in f32 from each side's molecule features with the
starting weights), with the largest |pre-relu| among the flips. Prints
one JSON line per (batch, case) and writes them all to --out."""

import argparse
import json
import math
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from molclr_tpu_torch.data.synthetic import \
    write_pretrain_corpus  # noqa: E402
from molclr_tpu_torch.ops import fused_layer as FL  # noqa: E402
from molclr_tpu_torch.parallel import destroy_distributed, \
    init_distributed  # noqa: E402
from molclr_tpu_torch.train.pretrain import train_step  # noqa: E402

# (wrapper name, its plain version, the index of mid in its results)
WRAPPERS = (("fused_gine_bn_layer_fwd", "fused_gine_bn_layer_fwd_plain", 3),
            ("fused_gine_bn_layer_bwd", "fused_gine_bn_layer_bwd_plain", None),
            ("fused_gine_layer_fwd", "fused_gine_layer_fwd_plain", 2),
            ("fused_gine_layer_bwd", "fused_gine_layer_bwd_plain", None))
KERNELS = {name: getattr(FL, name) for name, _, _ in WRAPPERS}
# the cases: (name, pretrain_cfg keywords)
CASES = (("f32", {}), ("bf16", dict(bf16=True)),
         ("f32_dropout", dict(drop_ratio=0.1)))


def bind(plain: bool, mids: list) -> None:
    """The K1f / K1b / K4f / K4b wrappers through the kernels or (plain)
    their plain versions, each forward's mid appended to mids."""
    for name, plain_name, at in WRAPPERS:
        fn = getattr(FL, plain_name) if plain else KERNELS[name]
        if at is not None:
            def fn(*args, residuals, f=fn, at=at):
                out = (f(*args) if plain
                       else f(*args, residuals=residuals))
                if out[at] is not None:
                    mids.append(out[at].detach().float().cpu())
                return out
        setattr(FL, name, fn)


def init_model(cfg):
    """The seeded state every step starts from, on the CPU."""
    return cs.build_model(cfg, torch.Generator().manual_seed(cs.SEED + 2))


def one_step(where: str, cfg, batch, bw, waves, dev, masks) -> dict:
    """One step from the seeded state on `where` ('kernels', 'plain' on the
    card, 'cpu') with the keep masks `masks` (None without dropout): the
    model (on the CPU after the step), the loss, each layer call's mid and
    each view's molecule features h [G, feat_dim]."""
    d = torch.device("cpu") if where == "cpu" else dev
    mids, pooled = [], []
    bind(where == "plain", mids)
    model = init_model(cfg).to(d)
    hook = model.register_forward_hook(
        lambda m, i, o: pooled.append(o[0].detach().float().cpu()))
    opt = cs.optim.adam_torch(model.parameters(), cfg.weight_decay)
    cs.reset_counts()
    loss = train_step(model, opt, batch.to(d), cfg, 0, cfg.init_lr,
                      bond_window=bw, max_waves=waves, dropout_masks=masks
                      and [[m.to(d) for m in v] for v in masks])
    if d.type == "cuda":
        torch.cuda.synchronize()
    launches = {k: c for k, c in cs.read_counts().items() if c}
    hook.remove()
    bind(False, [])
    return dict(model=model.cpu(), loss=loss.item(), mids=mids,
                pooled=pooled, launches=launches)


def flips(a: dict, b: dict, batch, model) -> dict:
    """Relu branches that differ between two steps' records."""
    real = batch.node_mask.cpu().bool()
    out = {"mid": [], "head": []}
    for ma, mb in zip(a["mids"], b["mids"]):
        fa, fb = ma[real] > 0, mb[real] > 0
        diff = fa != fb
        n = int(diff.sum())
        top = max(ma[real][diff].abs().max().item(),
                  mb[real][diff].abs().max().item()) if n else 0.0
        out["mid"].append([n, top])
    lin = model.out_lin[0]
    w, bias = lin.weight.detach().float(), lin.bias.detach().float()
    gmask = batch.graph_mask.cpu().bool()
    for ha, hb in zip(a["pooled"], b["pooled"]):
        # the projection head's first linear layer on each side's h, with
        # the step's starting weights on both
        za, zb = (ha @ w.T + bias)[gmask], (hb @ w.T + bias)[gmask]
        diff = (za > 0) != (zb > 0)
        n = int(diff.sum())
        top = max(za[diff].abs().max().item(),
                  zb[diff].abs().max().item()) if n else 0.0
        out["head"].append([n, top])
    return out


def compare(a: dict, b: dict, cfg, dt, batch) -> dict:
    """a's state after the step against b's (the reference), as
    state_agreement holds a card step against the CPU's."""
    detail = {}
    ok = []
    cs.check = lambda good, msg: ok.append(good) or None
    worst, top, stat, gworst = cs.state_agreement(
        a["model"], b["model"], 0, cfg.init_lr, "gap", dt, detail=detail)
    loss_gap = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    over = {k: v for k, v in detail.items()
            if v[1] > max(1, math.ceil(cs.STEP_FRAC_OFF[dt] * v[2]))}
    return dict(loss=[a["loss"], b["loss"]], loss_gap=loss_gap,
                loss_over_limit=loss_gap > cs.STEP_LOSS_RTOL[dt],
                fraction_off=worst, grad_off=gworst, max_param_diff=top,
                running_stats_over_limit=stat, all_checks_pass=all(ok),
                tensors_over_frac_off=over,
                relu_flips=flips(a, b, batch, init_model(cfg)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--orders", type=int, default=4)
    ap.add_argument("--cases", nargs="+", default=[c for c, _ in CASES],
                    choices=[c for c, _ in CASES])
    ap.add_argument("--out", type=Path,
                    default=Path("chiprun_out/port_units_gap.jsonl"))
    args = ap.parse_args()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    check = cs.check
    tmp = tempfile.mkdtemp()
    corpus = os.path.join(tmp, "pretrain.txt")
    write_pretrain_corpus(corpus, 4096, seed=0)
    smiles = cs.read_pretrain_smiles(corpus)
    dp = init_distributed(backend="nccl", log=lambda *a: None)
    batches = []
    for seed in args.seeds:
        pre = cs.Pretrainer(cs.pretrain_cfg(data_axis="data", seed=seed),
                            dev, dp=dp)
        pre.setup_data(smiles).setup_state()
        pre._activate_units(lambda *a: None)
        for i, row in enumerate(pre._unit_orders(1)[:args.orders]):
            batches.append((f"units seed {seed} batch {i}", seed, cs.on_cpu(
                cs.concat_units(pre._stack, torch.as_tensor(row, device=dev))),
                pre.spec.max_graph_bonds, pre.max_waves))
        del pre
    destroy_distributed()
    phase5, spec = cs.pretrain_batch()
    batches.append(("phase5", 0, phase5.to("cpu"), spec.max_graph_bonds, 0))
    rows = []
    for name, seed, batch, bw, waves in batches:
        for case, kw in CASES:
            if case not in args.cases:
                continue
            cfg = cs.pretrain_cfg(seed=seed, **kw)
            dt = torch.bfloat16 if cfg.model.bf16 else torch.float32
            masks = None
            if cfg.model.drop_ratio > 0:
                gen = torch.Generator().manual_seed(cs.SEED + 6)
                masks = [init_model(cfg).keep_masks(batch.num_nodes, gen)
                         for _ in (0, 1)]
            runs = {w: one_step(w, cfg, batch, bw, waves, dev, masks)
                    for w in ("kernels", "plain", "cpu")}
            row = dict(batch=name, case=case,
                       tiles=batch.nbr.shape[0] // cs.TILE,
                       launches={w: r["launches"] for w, r in runs.items()})
            for a, b in (("kernels", "cpu"), ("plain", "cpu"),
                         ("kernels", "plain")):
                row[f"{a}_vs_{b}"] = compare(runs[a], runs[b], cfg, dt,
                                             batch)
            cs.check = check
            print(json.dumps(row), flush=True)
            rows.append(row)
    card = cs.card_line()
    print(card)
    args.out.write_text("".join(json.dumps(r) + "\n" for r in rows)
                        + json.dumps(dict(card=card)) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
