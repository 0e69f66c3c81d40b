"""Smoke run of the PyTorch / CUDA port (molclr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

  1. build    compile every csrc/*.cu kernel library from the checkout's
              sources (one nvcc per source, in parallel) into build/kernels/.
  2. kernels  for each hand-written kernel of the serving path (K1f
              fused_gine_bn_layer, K3f fused_gcn_bn_layer): run it and its
              plain PyTorch version on the card on the same inputs, taken
              from a real packed batch at full width (256 molecules, tile
              256, D 300), in f32 and bf16 with relu_in False and True;
              compare out and the moment sums, check that two kernel runs
              are bit-identical, and time the kernel, the plain version and
              a cuBLAS matmul chain computing the same function.
  3. slice    the serving path end to end: 1,024 synthetic SMILES through
              `molclr_tpu_torch.cli.embed.main` for a GIN and a GCN
              5 x 300 / 512 encoder with seeded random weights (and once
              with --projection). Every kernel launch count is set to 0
              just before each run and read just after it; the embeddings
              are compared with the same CLI run on the CPU (plain path).
  4. training kernels, at the pretraining shape (a 512-molecule batch
              packed as the Pretrainer packs it: T = 22 tiles of 256,
              D = 300): K1f with its residuals and K1b against their plain
              versions in f32 and bf16, relu_in False and True; K2f and K2b
              at 2B = 1,024 and 4,096 (D = 256) with and without dead pairs.
              Two runs bit-identical; kernel, plain and library times.
  5. step     the pretraining step at full width (GIN 5 x 300 / 512, B =
              512, node augmentation, f32, ntxent 'auto'): 3 steps on the
              card, each also run on the CPU's plain path from the card's
              state with the same CPU-drawn augmentation keys (losses,
              parameters and BatchNorm stats agree); launch counts per step
              (K1f 10, K1b 10, K2f 0, K2b 0); two identical card steps
              bit-identical; one step with ntxent 'pallas' (K2f and K2b
              once each, the loss of the closed form).
  6. speed    the step's time on the card in f32 and bf16 (median of CUDA
              event times over 25 steps after 5 warm-up steps), as
              message-edges/s (bench.py's metric) and molecules/s, the
              host's time to queue a step, and a torch.profiler breakdown
              of the device time by kernel.
  7. cli      `molclr_tpu_torch.cli.pretrain` on 4,096 synthetic molecules,
              B = 512: two epochs of a three-epoch schedule, then
              `--resume latest` for the third; metrics.jsonl records, K1b
              launches = 10 per training step, the step count and LR
              schedule continue.
  8. fine-tune kernels, at the fine-tuning shape (a batch of 32 molecules
              of the synthetic BBBP stand-in with their hydrogens, packed
              as the FineTuner packs a training batch: T = 4 tiles of 256,
              D = 300): K4f (with residuals), K4b, K5f and K5b against
              their plain versions in f32 and bf16; two runs
              bit-identical; kernel, plain and library times.
  9. fine-tune steps: the FineTuner at the reference fine-tune model (5 x
              300 / 512, drop 0.3, batch 32, pred head 2 x softplus, f32),
              GIN, GCN and GIN with the motif head: 3 steps on the card,
              each also run on the CPU from the card's state with the same
              dropout masks (losses, parameters, BatchNorm stats agree);
              launches per step K4f 5, K4b 5 (GIN) or K5f 5, K5b 5 (GCN);
              the eval forward of one validation batch ('max' sizing) and
              the motif table, card against the CPU from the same state;
              then the step's time (median of CUDA-event times over 25
              steps), molecules/s, the host's time to queue a step, an
              eval batch's time and a profile of the GIN step.
 10. fine-tune cli: `molclr_tpu_torch.cli.finetune --allow-synthetic` for
              2 epochs in a temporary working directory: GIN warm-started
              from phase 7's step_<n>.pt, then --model gcn, then --motifs;
              every RESULT metric finite, every row stamped synthetic.

It prints one JSON line listing the kernels, the card's name and power
limit, and as its last line {"ok": true, "device": {...}}. It needs one
CUDA card and imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from molclr_tpu_torch.cli import embed
from molclr_tpu_torch.cli import finetune as finetune_cli
from molclr_tpu_torch.cli import pretrain as pretrain_cli
from molclr_tpu_torch.data.featurize import NUM_BOND_DIRS, NUM_BOND_TYPES
from molclr_tpu_torch.data.graphs import pack_batch
from molclr_tpu_torch.data.loader import featurize_many, spec_for_graphs
from molclr_tpu_torch.data.motifs import encode_motif_vocab
from molclr_tpu_torch.data.synthetic import synthetic_corpus
from molclr_tpu_torch.models import FineTuneNet, MolCLRNet
from molclr_tpu_torch.ops import _build, ntxent
from molclr_tpu_torch.data.tasks import TASKS
from molclr_tpu_torch.ops.fused_gcn import (
    fused_gcn_bn_layer,
    fused_gcn_bn_layer_plain,
    fused_gcn_layer,
    fused_gcn_layer_bwd,
    fused_gcn_layer_bwd_plain,
    fused_gcn_layer_fwd,
    fused_gcn_layer_plain,
)
from molclr_tpu_torch.ops.fused_layer import (
    CNT_PAD,
    adj_diag_mask,
    fused_gine_bn_layer,
    fused_gine_bn_layer_bwd,
    fused_gine_bn_layer_bwd_plain,
    fused_gine_bn_layer_fwd,
    fused_gine_bn_layer_fwd_plain,
    fused_gine_bn_layer_plain,
    fused_gine_layer,
    fused_gine_layer_bwd,
    fused_gine_layer_bwd_plain,
    fused_gine_layer_fwd,
    fused_gine_layer_fwd_plain,
    pack_cnt,
)
from molclr_tpu_torch.ops.scatter_free import _counts
from molclr_tpu_torch.ops.tile_dense import build_tile_adjacency
from molclr_tpu_torch.train import finetune as ft_lib
from molclr_tpu_torch.train import optim
from molclr_tpu_torch.train.checkpoints import latest_checkpoint, \
    transfer_state
from molclr_tpu_torch.train.config import FineTuneConfig, ModelConfig, \
    PretrainConfig
from molclr_tpu_torch.train.pretrain import build_model, train_step

SEED = 0
TILE, EMB, FEAT, LAYERS, BATCH, N_MOLS = 256, 300, 512, 5, 256, 1024

# H100 SXM published peaks (dense, at the 700 W limit): HBM bytes/s and
# FLOP/s by operand type (f32 without tensor cores; TF32 is switched off).
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

# Kernel vs plain version on the card, max |kernel - plain| over
# max |plain|: f32 differs only in summation order (~1e-6 seen), bf16 may
# flip one rounding of an intermediate (one bf16 ulp is 2^-8 ~ 4e-3).
KERNEL_RTOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# Embedding on the card (kernels) vs on the CPU (plain path), both f32,
# through 5 layers with BatchNorm: max |gpu - cpu| <= RTOL * max(1, |cpu|).
SLICE_RTOL = 1e-4

KERNELS = {
    "fused_gine_bn_layer": dict(
        fn=fused_gine_bn_layer, source="molclr_tpu_torch/csrc/fused_gine_bn.cu",
        replaces="molclr_tpu/ops/fused_layer.py:232", model="gin"),
    "fused_gcn_bn_layer": dict(
        fn=fused_gcn_bn_layer, source="molclr_tpu_torch/csrc/fused_gcn_bn.cu",
        replaces="molclr_tpu/ops/fused_gcn.py:146", model="gcn"),
}
# the kernels of the training path (K1f is also on it, counted in
# fused_gine_bn_layer.launches)
TRAIN_KERNELS = {
    "fused_gine_bn_layer_bwd": dict(
        fn=fused_gine_bn_layer_bwd,
        source="molclr_tpu_torch/csrc/fused_gine_bn.cu",
        replaces="molclr_tpu/ops/fused_layer.py:271"),
    "ntxent_fwd": dict(fn=ntxent.ntxent_fwd,
                       source="molclr_tpu_torch/csrc/ntxent.cu",
                       replaces="molclr_tpu/ops/pallas_ntxent.py:43"),
    "ntxent_bwd": dict(fn=ntxent.ntxent_bwd,
                       source="molclr_tpu_torch/csrc/ntxent.cu",
                       replaces="molclr_tpu/ops/pallas_ntxent.py:86"),
}
# the kernels of the fine-tuning path (the unchained layers)
FT_KERNELS = {
    "fused_gine_layer": dict(
        fn=fused_gine_layer, source="molclr_tpu_torch/csrc/fused_gine_bn.cu",
        replaces="molclr_tpu/ops/fused_layer.py:59", model="gin"),
    "fused_gine_layer_bwd": dict(
        fn=fused_gine_layer_bwd,
        source="molclr_tpu_torch/csrc/fused_gine_bn.cu",
        replaces="molclr_tpu/ops/fused_layer.py:81", model="gin"),
    "fused_gcn_layer": dict(
        fn=fused_gcn_layer, source="molclr_tpu_torch/csrc/fused_gcn_bn.cu",
        replaces="molclr_tpu/ops/fused_gcn.py:45", model="gcn"),
    "fused_gcn_layer_bwd": dict(
        fn=fused_gcn_layer_bwd, source="molclr_tpu_torch/csrc/fused_gcn_bn.cu",
        replaces="molclr_tpu/ops/fused_gcn.py:54", model="gcn"),
}
ALL_FNS = {**{k: v["fn"] for k, v in KERNELS.items()},
           **{k: v["fn"] for k, v in TRAIN_KERNELS.items()},
           **{k: v["fn"] for k, v in FT_KERNELS.items()}}

# the pretraining main path: bench.py's batch and model (B = 512, the
# Pretrainer's 'total' sizing), 3 steps on the card and the CPU
P_BATCH, P_STEPS, SPEED_STEPS, WARM_STEPS = 512, 3, 25, 5
# K1b against its plain version: the same reasons as KERNEL_RTOL; weight
# gradients are sums over the 5,632 rows of a batch
BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# K2f / K2b against their plain versions (f32): row statistics and dreps
# summed in another order
NTX_RTOL = 1e-4
# card against CPU on each of 3 full-width steps from the same state (f32):
# loss rtol 1e-4; parameters within Adam's sign-flip envelope 2 lr times
# adam_step_bound (elements whose true gradient is ~0 may flip a whole
# lr-sized step), and within 5e-5 + 2e-4 |p| on 99.97 % of the elements
# whose gradient exceeds 1e-4; BatchNorm running stats rtol 2e-3 / atol
# 1e-5
STEP_LOSS_RTOL = 1e-4
# the kernels' NT-Xent against the closed form on one step (f32)
PALLAS_LOSS_RTOL = 1e-5

# the fine-tuning main path: configs/finetune.yaml's model and batch on the
# synthetic BBBP stand-in (write_task_csv's 2,000 molecules, seed 0), 3
# steps on the card and the CPU; kernels against their plain versions with
# KERNEL_RTOL, card steps against the CPU with STEP_LOSS_RTOL and the
# parameter and BatchNorm limits of phase 5
FT_BATCH, FT_MOLS, FT_STEPS = 32, 2000, 3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, loops: int = 5, reps: int = 20) -> float:
    """Median over `loops` of the mean device time of `reps` back-to-back
    calls (CUDA events; warm L2, as a layer finds its input just written)."""
    for _ in range(3):
        fn()
    means = []
    for _ in range(loops):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        means.append(e0.elapsed_time(e1) / reps)
    return statistics.median(means)


# ---------------------------------------------------------------- phase 2


def real_batch(dev):
    """The first embed batch of the slice's corpus, packed as the CLI packs
    it (tile-aligned, sizing='max'), on the card."""
    graphs, _ = featurize_many(synthetic_corpus(BATCH, seed=7))
    spec = spec_for_graphs(graphs, BATCH, tile=TILE, sizing="max")
    return pack_batch(graphs, spec).to(dev)


def layer_inputs(batch, dt, gen):
    """adj / cnt of a real packed batch in dtype dt, and seeded random
    features, BatchNorm coefficients and weights at full width."""
    dev = batch.nbr.device
    adj = build_tile_adjacency(batch.nbr, batch.nbr_mask, TILE, dtype=dt)
    w = batch.nbr_mask.to(dt)
    cnt = pack_cnt(_counts(batch.nbr_bond_type, w, NUM_BOND_TYPES),
                   _counts(batch.nbr_bond_dir, w, NUM_BOND_DIRS)).contiguous()
    n, d = batch.nbr.shape[0], EMB

    def u(*shape, bound):
        x = torch.rand(*shape, generator=gen) * 2 - 1
        return (x * bound).to(dev)

    h = torch.randn(n, d, generator=gen).to(dev, dt)
    a = (torch.rand(d, generator=gen) + 0.5).to(dev)
    b = u(d, bound=0.2)
    etab = u(CNT_PAD, d, bound=0.1).to(dt)
    etab[NUM_BOND_TYPES + NUM_BOND_DIRS:] = 0
    gine = dict(etab=etab,
                w1=u(d, 2 * d, bound=d ** -0.5).to(dt),
                b1=u(2 * d, bound=d ** -0.5),
                w2=u(2 * d, d, bound=(2 * d) ** -0.5).to(dt),
                b2=u(d, bound=(2 * d) ** -0.5))
    col = u(CNT_PAD, 1, bound=0.5)
    col[NUM_BOND_TYPES + NUM_BOND_DIRS:] = 0
    gcn = dict(etab=col.expand(CNT_PAD, d).contiguous().to(dt),
               w=u(d, d, bound=(3.0 / d) ** 0.5).to(dt), bias=u(d, bound=0.1))
    return dict(h=h, a=a, b=b, adj=adj, cnt=cnt), gine, gcn


def gine_args(x, p):
    return (x["h"], x["a"], x["b"], x["adj"], x["cnt"], p["etab"], p["w1"],
            p["b1"], p["w2"], p["b2"])


def gcn_args(x, p):
    return (x["h"], x["a"], x["b"], x["adj"], x["cnt"], p["etab"], p["w"],
            p["bias"])


def moments(out, mask):
    of = out.float() * mask
    return torch.stack([of.sum(0), (of * out.float()).sum(0)])


def gine_library(h, a, b, adj, cnt, etab, w1, b1, w2, b2, relu_in):
    """The K1f function as a chain of cuBLAS calls in the activation dtype
    (yardstick only; the port never calls it)."""
    t, s, _ = adj.shape
    n, d = h.shape
    y = torch.addcmul(b, h.float(), a)
    y = (y.relu_() if relu_in else y).to(h.dtype)
    agg = torch.bmm(adj, y.view(t, s, d)).view(n, d)
    agg = torch.addmm(agg, cnt, etab)
    mid = torch.addmm(b1.to(h.dtype), agg, w1).relu_()
    out = torch.addmm(b2.to(h.dtype), mid, w2)
    return out, moments(out, adj_diag_mask(adj))


def gcn_library(x, a, b, adj, cnt, etab, w, bias, relu_in):
    """The K3f function as a chain of cuBLAS calls in the activation dtype
    (yardstick only; the port never calls it)."""
    t, s, _ = adj.shape
    n, d = x.shape
    y = torch.addcmul(b, x.float(), a)
    y = (y.relu_() if relu_in else y).to(x.dtype)
    xw = torch.mm(y, w)
    out = torch.bmm(adj, xw.view(t, s, d)).view(n, d)
    out = torch.addmm(out, cnt, etab).add_(bias.to(x.dtype))
    return out, moments(out, adj_diag_mask(adj))


def bound_ms(name, x, p, dt):
    """Least time on an H100 for this call's work: max of the bytes every
    input read once and every output written once over HBM bandwidth, and
    the operations these inputs need over the dtype's peak. The sparse
    products count their nonzeros (adjacency and edge counts); the dense
    products count real node rows only (padded rows' results are never
    read). Returns (ms, 'bytes' | 'operations')."""
    adj, cnt = x["adj"], x["cnt"]
    t, s, _ = adj.shape
    n, d = x["h"].shape
    es = x["h"].element_size()
    n_real = int(adj_diag_mask(adj).sum())
    nnz = int((adj != 0).sum()) + int((cnt != 0).sum())
    ops = 2 * nnz * d
    act = 2 * n * d + t * s * s + n * CNT_PAD + CNT_PAD * d     # h, out, A, cnt, etab
    f32 = 2 * d + 2 * d                                         # a, b, sums
    if name == "fused_gine_bn_layer":
        d2 = p["w1"].shape[1]
        ops += 2 * 2 * n_real * d * d2
        act += 2 * d * d2
        f32 += d2 + d
    else:
        ops += 2 * n_real * d * d
        act += d * d
        f32 += d
    t_bytes = (act * es + f32 * 4) / HBM_BPS
    t_ops = ops / PEAK_FLOPS[dt]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_phase(dev) -> dict:
    batch = real_batch(dev)
    gen = torch.Generator().manual_seed(SEED)
    plain = {"fused_gine_bn_layer": fused_gine_bn_layer_plain,
             "fused_gcn_bn_layer": fused_gcn_bn_layer_plain}
    library = {"fused_gine_bn_layer": gine_library,
               "fused_gcn_bn_layer": gcn_library}
    results = {name: {"max_abs_err": 0.0, "cases": []} for name in KERNELS}
    for dt in (torch.float32, torch.bfloat16):
        x, pg, pc = layer_inputs(batch, dt, gen)
        t, s, _ = x["adj"].shape
        for relu_in in (False, True):
            for name, spec in KERNELS.items():
                args = (gine_args(x, pg) if name == "fused_gine_bn_layer"
                        else gcn_args(x, pc))
                kern = spec["fn"]
                out, sums = kern(*args, relu_in)
                out2, sums2 = kern(*args, relu_in)
                ref_out, ref_sums = plain[name](*args, relu_in)
                torch.cuda.synchronize()
                check(out.shape == ref_out.shape and out.dtype == dt,
                      f"{name}: out {tuple(out.shape)} {out.dtype}")
                check(bool(torch.isfinite(out.float()).all()),
                      f"{name}: non-finite output")
                err_out = (out.float() - ref_out.float()).abs().max().item()
                err_sums = (sums - ref_sums).abs().max().item()
                lim_out = KERNEL_RTOL[dt] * ref_out.float().abs().max().item()
                lim_sums = KERNEL_RTOL[dt] * ref_sums.abs().max().item()
                bitwise = torch.equal(out, out2) and torch.equal(sums, sums2)
                lib_out, _ = library[name](*args, relu_in)
                err_lib = (lib_out.float() - ref_out.float()).abs().max().item()
                case = dict(
                    dtype=str(dt).replace("torch.", ""), relu_in=relu_in,
                    tiles=t, tile=s, d=x["h"].shape[1],
                    err_out=err_out, lim_out=lim_out, err_sums=err_sums,
                    lim_sums=lim_sums, bit_identical=bitwise,
                    library_err_out=err_lib,
                    ms=time_ms(lambda: kern(*args, relu_in)),
                    plain_ms=time_ms(lambda: plain[name](*args, relu_in)),
                    library_ms=time_ms(lambda: library[name](*args, relu_in)))
                case["bound_ms"], case["bound_by"] = bound_ms(name, x, (
                    pg if name == "fused_gine_bn_layer" else pc), dt)
                print(f"kernel {name} {json.dumps(case)}", flush=True)
                check(err_out <= lim_out, f"{name} {case['dtype']} relu_in="
                      f"{relu_in}: out error {err_out} > {lim_out}")
                check(err_sums <= lim_sums, f"{name} {case['dtype']} relu_in="
                      f"{relu_in}: sums error {err_sums} > {lim_sums}")
                check(bitwise, f"{name}: two runs differ")
                r = results[name]
                r["max_abs_err"] = max(r["max_abs_err"], err_out)
                r["cases"].append(case)
    return results


# ---------------------------------------------------------------- phase 3


def packed_batches(graphs, dev):
    """The corpus in embed batches, packed as the CLI packs them, on dev."""
    spec = spec_for_graphs(graphs, BATCH, tile=TILE, sizing="max")
    return [pack_batch(graphs[lo:lo + BATCH], spec).to(dev)
            for lo in range(0, len(graphs), BATCH)]


def write_checkpoint(model_type: str, graphs, path: str, dev) -> None:
    """A seeded random encoder at full width whose BatchNorm running stats
    come from 10 train-mode forwards on the card (so eval-mode BatchNorm is
    not the identity), saved as a reference-schema .pth."""
    model = MolCLRNet(num_layers=LAYERS, emb_dim=EMB, feat_dim=FEAT,
                      gnn_type=model_type, tile=TILE,
                      generator=torch.Generator().manual_seed(SEED + 1))
    model = model.to(dev).train()
    batches = packed_batches(graphs, dev)
    with torch.no_grad():
        for i in range(10):
            model(batches[i % len(batches)])
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)


def forward_throughput(model_type: str, graphs, ckpt: str, dev) -> dict:
    """Device-side serving rate: the model forward over the corpus's
    pre-packed batches already on the card (no featurization)."""
    model = MolCLRNet(num_layers=LAYERS, emb_dim=EMB, feat_dim=FEAT,
                      gnn_type=model_type, tile=TILE)
    transfer_state(torch.load(ckpt, weights_only=True), model)
    model = model.to(dev).eval()
    batches = packed_batches(graphs, dev)
    messages = sum(int(b.nbr_mask.sum()) for b in batches) * LAYERS
    with torch.no_grad():
        for b in batches:
            model(b)
        torch.cuda.synchronize()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            for b in batches:
                model(b)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / reps
    return dict(forward_s=sec, forward_mol_per_s=len(graphs) / sec,
                forward_message_edges_per_s=messages / sec,
                message_edges_per_pass=messages)


def reset_counts() -> None:
    for fn in ALL_FNS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in ALL_FNS.items()}


def embed_run(argv) -> tuple[dict, float]:
    """One embed CLI run with every kernel count set to 0 just before it;
    returns the counts read just after it and the wall seconds."""
    reset_counts()
    t0 = time.perf_counter()
    rc = embed.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    check(rc == 0, f"embed {argv} returned {rc}")
    return read_counts(), sec


def slice_phase(dev, tmp: str, card: str) -> dict:
    smiles = synthetic_corpus(N_MOLS, seed=SEED)
    corpus = os.path.join(tmp, "corpus.txt")
    with open(corpus, "w") as f:
        f.write("\n".join(smiles) + "\n")
    graphs, _ = featurize_many(smiles)
    graphs = [g for g in graphs if g.n_atoms <= TILE]
    n_batches = -(-len(graphs) // BATCH)
    report = {}
    for model_type, projection in (("gin", False), ("gcn", False),
                                   ("gin", True)):
        tag = model_type + ("_projection" if projection else "")
        ckpt = os.path.join(tmp, f"{model_type}.pth")
        if not os.path.exists(ckpt):
            write_checkpoint(model_type, graphs, ckpt, dev)
        base = ["--checkpoint", ckpt, "--model", model_type, "--layers",
                str(LAYERS), "--emb-dim", str(EMB), "--feat-dim", str(FEAT),
                "--batch-size", str(BATCH), "--tile", str(TILE)]
        base += ["--projection"] if projection else []
        out_gpu = os.path.join(tmp, f"{tag}_gpu.npy")
        out_cpu = os.path.join(tmp, f"{tag}_cpu.npy")
        counts, sec = embed_run([corpus, out_gpu, *base])
        # the main path's launches: this model's kernel once per layer and
        # batch, the other kernel never
        for name in ALL_FNS:
            want = (LAYERS * n_batches if KERNELS.get(name, {}).get("model")
                    == model_type else 0)
            check(counts[name] == want, f"{tag}: {name} launched "
                  f"{counts[name]} times, expected {want}")
        embed_run([corpus, out_cpu, *base, "--cpu"])
        emb, ref = np.load(out_gpu), np.load(out_cpu)
        width = FEAT // 2 if projection else FEAT
        check(emb.shape == (len(graphs), width),
              f"{tag}: embeddings {emb.shape}, expected "
              f"{(len(graphs), width)}")
        check(bool(np.isfinite(emb).all()), f"{tag}: non-finite embeddings")
        err = float(np.abs(emb - ref).max())
        lim = SLICE_RTOL * max(1.0, float(np.abs(ref).max()))
        side = [open(os.path.join(tmp, f"{tag}_{w}.smiles.txt")).read()
                for w in ("gpu", "cpu")]
        check(side[0] == side[1], f"{tag}: sidecars differ")
        row = dict(card=card, shape=list(emb.shape), batches=n_batches,
                   launches=counts, max_abs_err_vs_cpu=err, limit=lim,
                   cli_s=sec, cli_mol_per_s=len(graphs) / sec)
        if not projection:
            row.update(forward_throughput(model_type, graphs, ckpt, dev))
        report[tag] = row
        print(f"slice {tag} {json.dumps(row)}", flush=True)
        check(err <= lim, f"{tag}: |gpu - cpu| {err} > {lim}")
    return report


# ---------------------------------------------------------------- phase 4


def pretrain_batch():
    """The first training batch of the pretraining path on the host: 512
    molecules of synthetic_corpus(512, seed=7) packed as the Pretrainer
    packs them (tile 256, 'total' sizing with the capped slack 1.05)."""
    graphs, _ = featurize_many(synthetic_corpus(P_BATCH, seed=7))
    spec = spec_for_graphs(graphs, P_BATCH, slack=1.05, tile=TILE)
    return pack_batch(graphs, spec), spec


def rel_err(got, want) -> tuple[float, float]:
    """(max |got - want|, max |want|) in f32."""
    g, w = got.float(), want.float()
    return (g - w).abs().max().item(), w.abs().max().item()


def gine_bwd_library(g, dsums, h, a, b, adj, cnt, agg, mid, out, w1, w2,
                     relu_in):
    """The K1b function as a chain of cuBLAS calls in the activation dtype
    (yardstick only; the port never calls it)."""
    t, s, _ = adj.shape
    n, d = g.shape
    dt = g.dtype
    gt = torch.addcmul(dsums[0], out.float(), dsums[1], value=2.0)
    gt = gt.mul_(adj_diag_mask(adj)).add_(g.float())
    gtc = gt.to(dt)
    dmid = torch.mm(gtc, w2.t()).mul_(mid > 0)
    dagg = torch.mm(dmid, w1.t())
    dx = torch.bmm(adj, dagg.view(t, s, d)).view(n, d).float()
    hf = h.float()
    if relu_in:
        dx = dx.mul_(torch.addcmul(b, hf, a) > 0)
    return ((dx * a).to(dt), (dx * hf).sum(0), dx.sum(0), torch.mm(agg.t(), dmid),
            dmid.float().sum(0), torch.mm(mid.t(), gtc), gt.sum(0),
            torch.mm(cnt.t(), dagg))


def k1b_bound_ms(x, p, dt):
    """Least time for K1b's work at these inputs: the four dense products
    over the real rows, A @ daggc and cnt^T daggc by their nonzeros; bytes:
    g, out, h, agg, dh [N, D], mid [N, 2D], A, cnt, W1, W2 in the activation
    type, the f32 vectors and weight gradients."""
    adj, cnt = x["adj"], x["cnt"]
    t, s, _ = adj.shape
    n, d = x["h"].shape
    d2 = p["w1"].shape[1]
    n_real = int(adj_diag_mask(adj).sum())
    ops = (4 * 2 * n_real * d * d2 + 2 * int((adj != 0).sum()) * d
           + 2 * int((cnt != 0).sum()) * d)
    act = 5 * n * d + n * d2 + t * s * s + n * CNT_PAD + 2 * d * d2
    f32 = 7 * d + d2 + 2 * d * d2 + CNT_PAD * d
    t_bytes = (act * x["h"].element_size() + f32 * 4) / HBM_BPS
    t_ops = ops / PEAK_FLOPS[dt]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def training_layer_phase(batch, dev) -> dict:
    """K1f with residuals and K1b at the pretraining shape."""
    gen = torch.Generator().manual_seed(SEED + 3)
    res = {"fwd": {"max_abs_err": 0.0, "cases": []},
           "bwd": {"max_abs_err": 0.0, "cases": []}}
    for dt in (torch.float32, torch.bfloat16):
        x, pg, _ = layer_inputs(batch, dt, gen)
        args = gine_args(x, pg)
        n, d = x["h"].shape
        g = (0.1 * torch.randn(n, d, generator=gen)).to(dev, dt)
        dsums = (1e-3 * torch.randn(2, d, generator=gen)).to(dev)
        for relu_in in (False, True):
            tag = dict(dtype=str(dt).replace("torch.", ""), relu_in=relu_in,
                       tiles=x["adj"].shape[0], d=d)
            fwd = fused_gine_bn_layer_fwd(*args, relu_in, residuals=True)
            fwd2 = fused_gine_bn_layer_fwd(*args, relu_in, residuals=True)
            ref = fused_gine_bn_layer_fwd_plain(*args, relu_in)
            torch.cuda.synchronize()
            case = dict(tag, bit_identical=all(
                torch.equal(u, v) for u, v in zip(fwd, fwd2)))
            for name, u, v in zip(("out", "sums", "agg", "mid"), fwd, ref):
                err, top = rel_err(u, v)
                case[f"err_{name}"], case[f"lim_{name}"] = \
                    err, KERNEL_RTOL[dt] * top
            case.update(
                ms=time_ms(lambda: fused_gine_bn_layer_fwd(
                    *args, relu_in, residuals=True)),
                plain_ms=time_ms(lambda: fused_gine_bn_layer_fwd_plain(
                    *args, relu_in)),
                library_ms=time_ms(lambda: gine_library(*args, relu_in)))
            case["bound_ms"], case["bound_by"] = bound_ms(
                "fused_gine_bn_layer", x, pg, dt)
            print(f"kernel k1f_residuals {json.dumps(case)}", flush=True)
            for name in ("out", "sums", "agg", "mid"):
                check(case[f"err_{name}"] <= case[f"lim_{name}"],
                      f"K1f residuals {tag}: {name} error "
                      f"{case[f'err_{name}']} > {case[f'lim_{name}']}")
            check(case["bit_identical"], f"K1f residuals {tag}: runs differ")
            res["fwd"]["max_abs_err"] = max(res["fwd"]["max_abs_err"],
                                            case["err_out"])
            res["fwd"]["cases"].append(case)

            out, _, agg, mid = fwd
            bargs = (g, dsums, x["h"], x["a"], x["b"], x["adj"], x["cnt"],
                     agg, mid, out, pg["w1"], pg["w2"], relu_in)
            got = fused_gine_bn_layer_bwd(*bargs)
            again = fused_gine_bn_layer_bwd(*bargs)
            want = fused_gine_bn_layer_bwd_plain(*bargs)
            torch.cuda.synchronize()
            case = dict(tag, bit_identical=all(
                torch.equal(u, v) for u, v in zip(got, again)))
            names = ("dh", "da", "db", "dw1", "db1", "dw2", "db2", "detab")
            for name, u, v in zip(names, got, want):
                err, top = rel_err(u, v)
                case[f"err_{name}"], case[f"lim_{name}"] = \
                    err, BWD_RTOL[dt] * top
            lib = gine_bwd_library(*bargs)
            case["library_err_dh"] = rel_err(lib[0], want[0])[0]
            case.update(
                ms=time_ms(lambda: fused_gine_bn_layer_bwd(*bargs)),
                plain_ms=time_ms(lambda: fused_gine_bn_layer_bwd_plain(
                    *bargs)),
                library_ms=time_ms(lambda: gine_bwd_library(*bargs)))
            case["bound_ms"], case["bound_by"] = k1b_bound_ms(x, pg, dt)
            print(f"kernel k1b {json.dumps(case)}", flush=True)
            for name in names:
                check(case[f"err_{name}"] <= case[f"lim_{name}"],
                      f"K1b {tag}: {name} error {case[f'err_{name}']} > "
                      f"{case[f'lim_{name}']}")
            check(case["bit_identical"], f"K1b {tag}: runs differ")
            res["bwd"]["max_abs_err"] = max(res["bwd"]["max_abs_err"],
                                            case["err_dh"])
            res["bwd"]["cases"].append(case)
    return res


def closed_form_from_reps(reps, valid, inv_t):
    """The masked NT-Xent of pre-normalized reps in closed form with one
    cuBLAS product and logsumexp (yardstick only; the port's closed form
    is losses.nt_xent_loss)."""
    n = reps.shape[0]
    sim = torch.mm(reps, reps.t()) * inv_t
    pos = torch.cat([torch.diagonal(sim, n // 2),
                     torch.diagonal(sim, -n // 2)])
    dead = torch.eye(n, dtype=torch.bool, device=reps.device) \
        | (valid == 0)[None, :]
    per_row = torch.logsumexp(sim.masked_fill(dead, float("-inf")), 1) - pos
    return (per_row * valid).sum() / valid.sum().clamp(min=1.0)


def k2_bound_ms(n: int, d: int, backward: bool):
    """K2f: 2 n^2 d operations (the similarity); K2b 4 n^2 d (the
    similarity again and (P + P^T) @ reps); bytes: reps, valid, the row
    statistics, and dreps for K2b; f32 at 67 TFLOP/s."""
    ops = (4 if backward else 2) * n * n * d
    nbytes = 4 * (n * d + n + 3 * n + (n * d if backward else 0))
    t_bytes, t_ops = nbytes / HBM_BPS, ops / PEAK_FLOPS[torch.float32]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ntxent_phase(dev) -> dict:
    """K2f and K2b at 2B = 1,024 and 4,096, D = 256, with and without dead
    pairs, against their plain versions; the closed form's forward and
    backward as the library yardstick (and the crossover)."""
    res = {"fwd": {"max_abs_err": 0.0, "cases": []},
           "bwd": {"max_abs_err": 0.0, "cases": []}}
    inv_t = 10.0
    for n in (1024, 4096):
        for dead in (0, n // 16):
            gen = torch.Generator().manual_seed(n + dead)
            reps = torch.randn(n, 256, generator=gen)
            reps = (reps / reps.norm(dim=1, keepdim=True)).to(dev)
            valid = torch.ones(n)
            if dead:
                pairs = torch.randperm(n // 2, generator=gen)[:dead // 2]
                valid[pairs] = 0
                valid[pairs + n // 2] = 0
            valid = valid.to(dev)
            live = valid > 0
            tag = dict(two_b=n, d=256, dead_rows=int((~live).sum()))
            got = ntxent.ntxent_fwd(reps, valid, inv_t)
            again = ntxent.ntxent_fwd(reps, valid, inv_t)
            want = ntxent.ntxent_fwd_plain(reps, valid, inv_t)
            torch.cuda.synchronize()
            case = dict(tag, bit_identical=all(
                torch.equal(u, v) for u, v in zip(got, again)))
            per_got = (got[0] + torch.log(got[1]) - got[2])[live]
            per_want = (want[0] + torch.log(want[1]) - want[2])[live]
            case["err_per_row"], top = rel_err(per_got, per_want)
            case["lim_per_row"] = NTX_RTOL * max(1.0, top)
            rq = reps.clone().requires_grad_(True)
            lib_loss = closed_form_from_reps(rq, valid, inv_t)
            case["loss_kernel"] = ntxent.masked_mean(*got, valid).item()
            case["loss_closed_form"] = lib_loss.item()
            case.update(
                ms=time_ms(lambda: ntxent.ntxent_fwd(reps, valid, inv_t)),
                plain_ms=time_ms(lambda: ntxent.ntxent_fwd_plain(
                    reps, valid, inv_t)),
                library_ms=time_ms(lambda: closed_form_from_reps(
                    reps, valid, inv_t)))
            case["bound_ms"], case["bound_by"] = k2_bound_ms(n, 256, False)
            print(f"kernel k2f {json.dumps(case)}", flush=True)
            check(case["err_per_row"] <= case["lim_per_row"],
                  f"K2f {tag}: error {case['err_per_row']}")
            check(abs(case["loss_kernel"] - case["loss_closed_form"])
                  <= NTX_RTOL * max(1.0, abs(case["loss_closed_form"])),
                  f"K2f {tag}: loss {case['loss_kernel']} vs closed form "
                  f"{case['loss_closed_form']}")
            check(case["bit_identical"], f"K2f {tag}: runs differ")
            res["fwd"]["max_abs_err"] = max(res["fwd"]["max_abs_err"],
                                            case["err_per_row"])
            res["fwd"]["cases"].append(case)

            m, l, _ = got
            scale = 1.0 / valid.sum().clamp(min=1.0)
            dr = ntxent.ntxent_bwd(reps, valid, inv_t, scale, m, l)
            dr2 = ntxent.ntxent_bwd(reps, valid, inv_t, scale, m, l)
            ref = ntxent.ntxent_bwd_plain(reps, valid, inv_t, scale, m, l)
            (lib_grad,) = torch.autograd.grad(lib_loss, rq, retain_graph=True)
            torch.cuda.synchronize()
            case = dict(tag, bit_identical=torch.equal(dr, dr2))
            case["err_dreps"], top = rel_err(dr, ref)
            case["lim_dreps"] = NTX_RTOL * top
            case["library_err_dreps"] = rel_err(lib_grad, ref)[0]
            case.update(
                ms=time_ms(lambda: ntxent.ntxent_bwd(reps, valid, inv_t,
                                                     scale, m, l)),
                plain_ms=time_ms(lambda: ntxent.ntxent_bwd_plain(
                    reps, valid, inv_t, scale, m, l)),
                library_ms=time_ms(lambda: torch.autograd.grad(
                    lib_loss, rq, retain_graph=True)))
            case["bound_ms"], case["bound_by"] = k2_bound_ms(n, 256, True)
            print(f"kernel k2b {json.dumps(case)}", flush=True)
            check(case["err_dreps"] <= case["lim_dreps"],
                  f"K2b {tag}: error {case['err_dreps']} > "
                  f"{case['lim_dreps']}")
            check(case["library_err_dreps"] <= 1e-3 * top,
                  f"K2b {tag}: the closed form's gradient disagrees "
                  f"({case['library_err_dreps']})")
            check(case["bit_identical"], f"K2b {tag}: runs differ")
            res["bwd"]["max_abs_err"] = max(res["bwd"]["max_abs_err"],
                                            case["err_dreps"])
            res["bwd"]["cases"].append(case)
    return res


# ---------------------------------------------------------------- phase 5


def pretrain_cfg(bf16: bool = False, ntxent_impl: str = "auto"):
    return PretrainConfig(
        batch_size=P_BATCH, ntxent_impl=ntxent_impl,
        model=ModelConfig(num_layers=LAYERS, emb_dim=EMB, feat_dim=FEAT,
                          tile=TILE, bf16=bf16))


def adam_step_bound(t: int, b1: float = 0.9, b2: float = 0.999) -> float:
    """The largest |m_hat / sqrt(v_hat)| Adam's t-th update can take, over
    all gradient histories (Cauchy-Schwarz on the moments' weights): 1 at
    t = 1, 1.0036 at t = 3. An update moves an element by at most lr times
    this, so a sign flip moves it by at most twice that."""
    w = [(1 - b1) * b1 ** (t - i) / (1 - b1 ** t) for i in range(1, t + 1)]
    u = [(1 - b2) * b2 ** (t - i) / (1 - b2 ** t) for i in range(1, t + 1)]
    return sum(a * a / c for a, c in zip(w, u)) ** 0.5


def params_of(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def state_agreement(card_model, cpu_model, step: int, lr: float,
                    what: str) -> tuple[float, float, float]:
    """Check the card's state against the CPU's after the same step from
    the same state (the CPU model's .grad holds the step's gradients):
    parameters within Adam's sign-flip envelope and tight on the elements
    with a real gradient, BatchNorm stats rtol 2e-3 / atol 1e-5. Returns
    (worst fraction off, largest parameter difference, largest BatchNorm
    difference over its limit)."""
    grads = {k: p.grad for k, p in cpu_model.named_parameters()}
    card, cpu = params_of(card_model), params_of(cpu_model)
    worst = top = stat = 0.0
    for k, v in cpu.items():
        got = card[k].cpu()
        if k.endswith("num_batches_tracked"):
            check(int(got) == int(v), f"{what}: {k} differs")
            continue
        diff = (got.double() - v.double()).abs()
        if "running_" in k:
            over = (diff / (1e-5 + 2e-3 * v.double().abs())).max().item()
            stat = max(stat, over)
            check(over <= 1.0, f"{what}: {k} card and CPU differ by "
                  f"{diff.max().item()}")
            continue
        top = max(top, diff.max().item())
        cap = 2.0 * lr * adam_step_bound(step + 1)
        check(diff.max().item() <= cap, f"{what}: {k} differs by "
              f"{diff.max().item()} > the Adam envelope {cap}")
        real = grads[k].abs() > 1e-4
        bad = diff[real] > 5e-5 + 2e-4 * v.double()[real].abs()
        frac = bad.float().mean().item() if bad.numel() else 0.0
        worst = max(worst, frac)
        check(frac <= 3e-4, f"{what}: {k} has {frac:.2%} of its "
              f"real-gradient elements off the CPU's")
    return worst, top, stat


def step_phase(batch, spec, dev) -> dict:
    """3 pretraining steps on the card; before each, the CPU takes the
    card's state (weights, BatchNorm stats, Adam moments) and runs the same
    step with the same augmentation keys on its plain path. (Free-running
    f32 runs drift apart within steps, card and CPU alike: Adam's first
    steps move every element by about lr whatever its gradient's size, so
    the f32 noise on gradients that are 0 in exact arithmetic, such as the
    conv biases ahead of a BatchNorm, flips whole steps.) Launch counts,
    bit-reproducibility, and the kernels' NT-Xent on one step."""
    cfg = pretrain_cfg()
    bw = spec.max_graph_bonds
    lr = cfg.init_lr
    models, opts = {}, {}
    for where in ("card", "cpu"):
        models[where] = build_model(cfg, torch.Generator().manual_seed(
            SEED + 2)).to(dev if where == "card" else "cpu")
        opts[where] = optim.adam_torch(models[where].parameters(),
                                       cfg.weight_decay)
    bg, bc = batch.to(dev), batch.to("cpu")
    report = {"losses": [], "counts": [], "worst_fraction_off": [],
              "max_param_diff": [], "running_stats_over_limit": []}
    totals = dict.fromkeys(ALL_FNS, 0)
    for step in range(P_STEPS):
        models["cpu"].load_state_dict(
            {k: v.cpu() for k, v in models["card"].state_dict().items()})
        opts["cpu"].load_state_dict(copy.deepcopy(opts["card"].state_dict()))
        reset_counts()
        loss_g = train_step(models["card"], opts["card"], bg, cfg, step, lr,
                            bond_window=bw)
        torch.cuda.synchronize()
        counts = read_counts()
        t0 = time.perf_counter()
        loss_c = train_step(models["cpu"], opts["cpu"], bc, cfg, step, lr,
                            bond_window=bw)
        report["cpu_step_s"] = time.perf_counter() - t0
        report["losses"].append([loss_g.item(), loss_c.item()])
        report["counts"].append(counts)
        want = dict(fused_gine_bn_layer=2 * LAYERS,
                    fused_gine_bn_layer_bwd=2 * LAYERS)
        for name, c in counts.items():
            check(c == want.get(name, 0), f"step {step}: {name} launched "
                  f"{c} times, expected {want.get(name, 0)}")
            totals[name] += c
        check(abs(loss_g.item() - loss_c.item())
              <= STEP_LOSS_RTOL * abs(loss_c.item()),
              f"step {step}: loss card {loss_g.item()} cpu {loss_c.item()}")
        worst, top, stat = state_agreement(models["card"], models["cpu"],
                                           step, lr, f"step {step}")
        report["worst_fraction_off"].append(worst)
        report["max_param_diff"].append(top)
        report["running_stats_over_limit"].append(stat)
    report["launches"] = totals

    # two identical card steps from the same state are bit-identical
    model, opt = models["card"], opts["card"]
    snap = (copy.deepcopy(model.state_dict()), copy.deepcopy(
        opt.state_dict()))
    outcomes = []
    for _ in range(2):
        # (load_state_dict keeps the optimizer state's tensors, which the
        # step then updates in place: hand it a copy)
        model.load_state_dict(snap[0])
        opt.load_state_dict(copy.deepcopy(snap[1]))
        loss = train_step(model, opt, bg, cfg, P_STEPS, lr, bond_window=bw)
        outcomes.append((loss.clone(), params_of(model)))
    check(torch.equal(outcomes[0][0], outcomes[1][0])
          and all(torch.equal(outcomes[0][1][k], outcomes[1][1][k])
                  for k in outcomes[0][1]),
          "two identical card steps differ")
    report["bit_identical_steps"] = True

    # the same step with the kernels' NT-Xent (K2f / K2b once each)
    model.load_state_dict(snap[0])
    opt.load_state_dict(copy.deepcopy(snap[1]))
    reset_counts()
    loss_p = train_step(model, opt, bg, pretrain_cfg(ntxent_impl="pallas"),
                        P_STEPS, lr, bond_window=bw)
    torch.cuda.synchronize()
    counts = read_counts()
    report["pallas_counts"] = counts
    want = dict(fused_gine_bn_layer=2 * LAYERS,
                fused_gine_bn_layer_bwd=2 * LAYERS, ntxent_fwd=1,
                ntxent_bwd=1)
    for name, c in counts.items():
        check(c == want.get(name, 0), f"pallas step: {name} launched {c} "
              f"times, expected {want.get(name, 0)}")
    lx = outcomes[0][0].item()
    report["pallas_loss"], report["closed_form_loss"] = loss_p.item(), lx
    check(abs(loss_p.item() - lx) <= PALLAS_LOSS_RTOL * abs(lx),
          f"pallas loss {loss_p.item()} vs closed form {lx}")
    after = params_of(model)
    report["pallas_max_param_diff"] = max(
        (after[k] - outcomes[0][1][k]).abs().max().item()
        for k in after if "running" not in k and "num_batches" not in k)
    check(report["pallas_max_param_diff"]
          <= 2.0 * lr * adam_step_bound(P_STEPS + 1),
          f"pallas step moved the parameters by "
          f"{report['pallas_max_param_diff']} more than the closed form")
    print(f"step {json.dumps(report)}", flush=True)
    return report


# ---------------------------------------------------------------- phase 6


def speed_phase(batch, spec, dev, card: str) -> dict:
    """The step's time on the card, f32 and bf16, and a profile of its
    device time by kernel (f32)."""
    bg = batch.to(dev)
    # bench.py's metric: 2 views x layers x (real directed edges +
    # self-loops) of the base batch
    messages = 2 * LAYERS * (int(batch.edge_mask.sum())
                             + int(batch.node_mask.sum()))
    report = {}
    for bf16 in (False, True):
        cfg = pretrain_cfg(bf16=bf16)
        model = build_model(cfg, torch.Generator().manual_seed(SEED + 2))
        model = model.to(dev)
        opt = optim.adam_torch(model.parameters(), cfg.weight_decay)
        for step in range(WARM_STEPS):
            train_step(model, opt, bg, cfg, step, cfg.init_lr,
                       bond_window=spec.max_graph_bonds)
        torch.cuda.synchronize()
        events, host = [], []
        for step in range(WARM_STEPS, WARM_STEPS + SPEED_STEPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            loss = train_step(model, opt, bg, cfg, step, cfg.init_lr,
                              bond_window=spec.max_graph_bonds)
            e1.record()
            host.append(1e3 * (time.perf_counter() - t0))
            events.append((e0, e1))
        torch.cuda.synchronize()
        check(bool(torch.isfinite(loss)), f"bf16={bf16}: loss {loss}")
        ms = statistics.median(a.elapsed_time(b) for a, b in events)
        # host_ms: the host's time to queue one step (no synchronize), the
        # step's floor while the device waits for it
        row = dict(card=card, dtype="bfloat16" if bf16 else "float32",
                   step_ms=ms, host_ms=statistics.median(host),
                   steps=SPEED_STEPS,
                   message_edges_per_step=messages,
                   message_edges_per_s=messages / (ms / 1e3),
                   mol_per_s=int(batch.graph_mask.sum()) / (ms / 1e3))
        if not bf16:
            row["profile"] = profile_steps(lambda i: train_step(
                model, opt, bg, cfg, 100 + i, cfg.init_lr,
                bond_window=spec.max_graph_bonds))
        report[row["dtype"]] = row
        print(f"speed {json.dumps(row)}", flush=True)
    return report


def profile_steps(step_fn, steps: int = 5) -> dict:
    """torch.profiler over `steps` calls of step_fn(i): device time per
    kernel name (top 12) and the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for step in range(steps):
            step_fn(step)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.key, us, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return dict(window_steps=steps, wall_ms_per_step=wall_us / steps / 1e3,
                device_ms_per_step=busy / steps / 1e3,
                device_busy_share=busy / wall_us if wall_us else None,
                kernels=len(rows),
                top=[dict(name=k[:80], ms_per_step=us / steps / 1e3,
                          launches_per_step=c / steps)
                     for k, us, c in rows[:12]])


# ---------------------------------------------------------------- phase 7


def cli_phase(tmp: str) -> dict:
    """The pretrain CLI on the card: two epochs of a three-epoch schedule,
    then --resume latest for the third."""
    corpus = os.path.join(tmp, "pretrain.txt")
    ckpt = os.path.join(tmp, "pretrain_ckpt")
    base = ["--synthetic", "4096", "--data", corpus, "--ckpt-dir", ckpt,
            "--batch-size", str(P_BATCH), "--epochs", "3", "--warm-up", "1",
            "--save-every", "1"]
    report = {}
    for tag, extra in (("first", ["--stop-after-epoch", "2"]),
                       ("resumed", ["--resume", "latest"])):
        reset_counts()
        t0 = time.perf_counter()
        rc = pretrain_cli.main(base + extra)
        torch.cuda.synchronize()
        report[f"{tag}_s"] = time.perf_counter() - t0
        check(rc == 0, f"pretrain CLI {tag} returned {rc}")
        report[f"{tag}_counts"] = read_counts()
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    report["records"] = recs
    check([r["epoch"] for r in recs] == [0, 1, 2],
          f"metrics.jsonl epochs {[r['epoch'] for r in recs]}")
    for r in recs:
        check(all(np.isfinite(r[k]) for k in ("train_loss", "valid_loss")),
              f"non-finite record {r}")
    spe = recs[0]["steps"]
    check(spe > 0 and [r["step"] for r in recs] == [spe, 2 * spe, 3 * spe],
          f"steps {[r['step'] for r in recs]} do not continue")
    sched = optim.warmup_then_cosine(5e-4, spe, 3, 1)
    check(all(r["lr"] == sched(r["step"]) for r in recs),
          "the LR schedule does not continue across the resume")
    for tag, steps in (("first", 2 * spe), ("resumed", spe)):
        c = report[f"{tag}_counts"]
        check(c["fused_gine_bn_layer_bwd"] == 2 * LAYERS * steps,
              f"{tag}: K1b launched {c['fused_gine_bn_layer_bwd']} times "
              f"for {steps} steps")
    print(f"cli {json.dumps(report)}", flush=True)
    return report


# ---------------------------------------------------------------- phase 8


def finetune_batch():
    """The fine-tuning shape on the host: the first 32 molecules of the
    synthetic BBBP stand-in (write_task_csv writes synthetic_corpus(2000,
    seed=0)) with their hydrogens, packed with the FineTuner's training
    spec ('total' sizing, tile 256)."""
    graphs, _ = featurize_many(synthetic_corpus(FT_MOLS, seed=SEED),
                               add_hs=True)
    spec = spec_for_graphs(graphs, FT_BATCH, tile=TILE)
    return pack_batch(graphs[:FT_BATCH], spec)


def gine_unchained_library(h, adj, cnt, etab, w1, b1, w2, b2):
    """K4f's function (out, agg, mid) as a chain of cuBLAS calls in the
    activation dtype (yardstick only; the port never calls it)."""
    t, s, _ = adj.shape
    n, d = h.shape
    agg = torch.bmm(adj, h.view(t, s, d)).view(n, d)
    agg = torch.addmm(agg, cnt, etab)
    mid = torch.addmm(b1.to(h.dtype), agg, w1).relu_()
    return torch.addmm(b2.to(h.dtype), mid, w2), agg, mid


def gine_unchained_bwd_library(g, adj, cnt, agg, mid, w1, w2):
    """K4b's function as a chain of cuBLAS calls (yardstick only)."""
    t, s, _ = adj.shape
    n, d = g.shape
    dmid = torch.mm(g, w2.t()).mul_(mid > 0)
    dagg = torch.mm(dmid, w1.t())
    dh = torch.bmm(adj, dagg.view(t, s, d)).view(n, d)
    return (dh, torch.mm(agg.t(), dmid), dmid.float().sum(0),
            torch.mm(mid.t(), g), g.float().sum(0), torch.mm(cnt.t(), dagg))


def gcn_unchained_library(x, adj, w):
    """K5f's function A @ (x @ W) with two cuBLAS calls (yardstick only)."""
    t, s, _ = adj.shape
    n, d = x.shape
    return torch.bmm(adj, torch.mm(x, w).view(t, s, d)).view(n, d)


def gcn_unchained_bwd_library(g, x, adj, w):
    """K5b's function (dx, dW) with three cuBLAS calls (yardstick only)."""
    t, s, _ = adj.shape
    n, d = g.shape
    dxw = torch.bmm(adj, g.view(t, s, d)).view(n, d)
    return torch.mm(dxw, w.t()), torch.mm(x.t(), dxw)


def unchained_bound_ms(name, x, p, dt):
    """Least time for an unchained layer's work at these inputs: the dense
    products over the real rows, the adjacency and edge-count products by
    their nonzeros; bytes: each input read once and each output written
    once (K4f's residuals agg and mid are outputs on the training path;
    K5f's x @ W is scratch)."""
    adj, cnt = x["adj"], x["cnt"]
    t, s, _ = adj.shape
    n, d = x["h"].shape
    n_real = int(adj_diag_mask(adj).sum())
    sparse = 2 * int((adj != 0).sum()) * d
    edges = 2 * int((cnt != 0).sum()) * d
    if name.startswith("fused_gine"):
        d2 = p["w1"].shape[1]
        mlp = 2 * 2 * n_real * d * d2
        weights = t * s * s + n * CNT_PAD + 2 * d * d2   # A, cnt, W1, W2
        if name == "fused_gine_layer":
            ops = mlp + sparse + edges
            act = 3 * n * d + n * d2 + CNT_PAD * d + weights
            f32 = d2 + d
        else:
            ops = 2 * mlp + sparse + edges
            act = 3 * n * d + n * d2 + weights            # g, agg, dh, mid
            f32 = 2 * d * d2 + d2 + d + CNT_PAD * d
    else:
        dense = 2 * n_real * d * d
        if name == "fused_gcn_layer":
            ops, act, f32 = dense + sparse, 2 * n * d + t * s * s + d * d, 0
        else:
            ops = 2 * dense + sparse
            act, f32 = 3 * n * d + t * s * s + d * d, d * d
    t_bytes = (act * x["h"].element_size() + f32 * 4) / HBM_BPS
    t_ops = ops / PEAK_FLOPS[dt]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def kernel_case(name, tag, names, run, plain, library, rtol):
    """Run a kernel twice and its plain version once on the same inputs:
    the error of each output against its limit, bit-identity, and the
    kernel's, the plain version's and the library's times. Returns (case,
    the kernel's outputs)."""
    got, again, want = _tuple(run()), _tuple(run()), _tuple(plain())
    torch.cuda.synchronize()
    case = dict(tag, bit_identical=all(torch.equal(u, v)
                                       for u, v in zip(got, again)))
    for out, u, v in zip(names, got, want):
        check(u.dtype == v.dtype and u.shape == v.shape,
              f"{name} {tag}: {out} is {u.dtype} {tuple(u.shape)}, the "
              f"plain version's {v.dtype} {tuple(v.shape)}")
        err, top = rel_err(u, v)
        case[f"err_{out}"], case[f"lim_{out}"] = err, rtol * top
    case.update(ms=time_ms(run), plain_ms=time_ms(plain),
                library_ms=time_ms(library))
    for out in names:
        check(case[f"err_{out}"] <= case[f"lim_{out}"],
              f"{name} {tag}: {out} error {case[f'err_{out}']} > "
              f"{case[f'lim_{out}']}")
    check(case["bit_identical"], f"{name} {tag}: two runs differ")
    return case, got


def finetune_kernel_phase(batch, dev) -> dict:
    """K4f with residuals, K4b, K5f and K5b at the fine-tuning shape, f32
    and bf16, on features that are zero on padded rows (as the unchained
    trunk gives them) and a random cotangent."""
    gen = torch.Generator().manual_seed(SEED + 4)
    res = {name: {"max_abs_err": 0.0, "cases": []} for name in FT_KERNELS}
    for dt in (torch.float32, torch.bfloat16):
        x, pg, pc = layer_inputs(batch, dt, gen)
        mask = adj_diag_mask(x["adj"])
        x["h"] = (x["h"].float() * mask).to(dt)
        n, d = x["h"].shape
        g = (0.1 * torch.randn(n, d, generator=gen)).to(dev) * mask
        g = g.to(dt)
        rtol = KERNEL_RTOL[dt]
        tag = dict(dtype=str(dt).replace("torch.", ""),
                   tiles=x["adj"].shape[0], d=d)
        fargs = (x["h"], x["adj"], x["cnt"], pg["etab"], pg["w1"], pg["b1"],
                 pg["w2"], pg["b2"])
        cases = {}
        cases["fused_gine_layer"], (_, agg, mid) = kernel_case(
            "K4f", tag, ("out", "agg", "mid"),
            lambda: fused_gine_layer_fwd(*fargs, residuals=True),
            lambda: fused_gine_layer_fwd_plain(*fargs),
            lambda: gine_unchained_library(*fargs), rtol)
        bargs = (g, x["adj"], x["cnt"], agg, mid, pg["w1"], pg["w2"])
        cases["fused_gine_layer_bwd"], _ = kernel_case(
            "K4b", tag, ("dh", "dw1", "db1", "dw2", "db2", "detab"),
            lambda: fused_gine_layer_bwd(*bargs),
            lambda: fused_gine_layer_bwd_plain(*bargs),
            lambda: gine_unchained_bwd_library(*bargs), rtol)
        cargs = (x["h"], x["adj"], pc["w"])
        cases["fused_gcn_layer"], _ = kernel_case(
            "K5f", tag, ("out",), lambda: fused_gcn_layer_fwd(*cargs),
            lambda: fused_gcn_layer_plain(*cargs),
            lambda: gcn_unchained_library(*cargs), rtol)
        gargs = (g, x["h"], x["adj"], pc["w"])
        cases["fused_gcn_layer_bwd"], _ = kernel_case(
            "K5b", tag, ("dx", "dw"), lambda: fused_gcn_layer_bwd(*gargs),
            lambda: fused_gcn_layer_bwd_plain(*gargs),
            lambda: gcn_unchained_bwd_library(*gargs), rtol)
        for name, case in cases.items():
            case["bound_ms"], case["bound_by"] = unchained_bound_ms(
                name, x, pg if name.startswith("fused_gine") else pc, dt)
            print(f"kernel {name} {json.dumps(case)}", flush=True)
            first = next(k for k in case if k.startswith("err_"))
            r = res[name]
            r["max_abs_err"] = max(r["max_abs_err"], case[first])
            r["cases"].append(case)
    return res


# ---------------------------------------------------------------- phase 9


def finetune_cfg(tmp: str, gnn: str = "gin", motifs: bool = False,
                 bf16: bool = False) -> FineTuneConfig:
    """configs/finetune.yaml's fine-tuning run (BBBP, batch 32, 5 x 300 /
    512, drop 0.3, pred head 2 x softplus, tile 256) on the synthetic
    stand-in fabricated under tmp."""
    return FineTuneConfig(
        data_root=os.path.join(tmp, "data"), synthetic_fallback=True,
        batch_size=FT_BATCH, ckpt_dir=os.path.join(tmp, "ft_runs"),
        use_motifs=motifs, model=ModelConfig(
            gnn_type=gnn, num_layers=LAYERS, emb_dim=EMB, feat_dim=FEAT,
            drop_ratio=0.3, tile=TILE, bf16=bf16))


def finetuner(cfg, dev, shared):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # synthetic stand-in
        if shared[0] is None:
            shared[0] = ft_lib.SharedTaskData(cfg, TASKS[cfg.task_name])
    return ft_lib.FineTuner(cfg, dev).setup_data(
        shared=shared[0]).setup_state()


def eval_agreement(ft, cpu_model, gnn: str, tag: str):
    """The eval path (drop 0.3 in eval mode: K4f / K5f without residuals)
    on one validation batch, packed with 'max' sizing, on the card and on
    the CPU from the card's state: predictions within SLICE_RTOL, and one
    forward launch per layer. Returns (max error, the batch's tiles)."""
    item = next(iter(ft.iters["valid"]))
    batch, _, mot = ft._device_item("valid", *item)
    cpu_model.load_state_dict(
        {k: v.cpu() for k, v in ft.model.state_dict().items()})
    reset_counts()
    pred_g = ft_lib.predict(ft.model, batch, mot)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: LAYERS for k, v in FT_KERNELS.items()
            if v["model"] == gnn and not k.endswith("_bwd")}
    for name, c in counts.items():
        check(c == want.get(name, 0), f"{tag} eval: {name} launched {c} "
              f"times, expected {want.get(name, 0)}")
    pred_c = ft_lib.predict(cpu_model, item[0].to("cpu"),
                            tuple(m.cpu() for m in mot))
    err = float((pred_g.cpu() - pred_c).abs().max())
    lim = SLICE_RTOL * max(1.0, float(pred_c.abs().max()))
    check(bool(torch.isfinite(pred_g).all()) and err <= lim,
          f"{tag} eval: max |card - cpu| {err} > {lim}")
    return err, batch.nbr.shape[0] // TILE


def motif_table_agreement(ft, cpu_model, tag: str) -> float:
    """The motif table that setup_state encoded on the card against the
    same vocabulary encoded on the CPU by the plain network with the same
    trunk and feat_lin, within SLICE_RTOL."""
    plain = FineTuneNet(**ft._model_kwargs())
    transfer_state(cpu_model.state_dict(), plain)
    m = ft.cfg.model
    want = encode_motif_vocab(ft.motif_vocab, plain, m.feat_dim,
                              max_degree=ft.cfg.max_degree, tile=m.tile)
    got = cpu_model.motif_embedding.weight.detach().numpy()
    check(got.shape == want.shape, f"{tag}: motif table {got.shape}")
    err = float(np.abs(got - want).max())
    lim = SLICE_RTOL * max(1.0, float(np.abs(want).max()))
    check(np.isfinite(got).all() and err <= lim,
          f"{tag}: motif table max |card - cpu| {err} > {lim}")
    return err


def finetune_step_phase(dev, tmp: str, shared: list) -> dict:
    """3 fine-tuning steps on the card for GIN, GCN and GIN with the motif
    head; before each, the CPU takes the card's state (weights, BatchNorm
    stats, Adam moments) and runs the same step with the same dropout
    masks on its plain path. Launch counts per step."""
    report = {}
    totals = dict.fromkeys(ALL_FNS, 0)
    mgen = torch.Generator().manual_seed(SEED + 5)
    for gnn, motifs in (("gin", False), ("gcn", False), ("gin", True)):
        tag = gnn + ("_motifs" if motifs else "")
        cfg = finetune_cfg(tmp, gnn, motifs)
        ft = finetuner(cfg, dev, shared)
        lr = max(cfg.init_lr, cfg.init_base_lr)
        cpu_model = copy.deepcopy(ft.model).to("cpu")
        cpu_opt = optim.two_group_adam(cpu_model, cfg.init_lr,
                                       cfg.init_base_lr, cfg.weight_decay)
        items = []
        for item in ft.iters["train"]:
            items.append(item)
            if len(items) == FT_STEPS:
                break
        row = {"losses": [], "counts": [], "worst_fraction_off": [],
               "max_param_diff": [], "running_stats_over_limit": [],
               "motif_vocab": ft.motif_vocab.size if motifs else 0}
        if motifs:
            row["motif_table_err"] = motif_table_agreement(ft, cpu_model, tag)
        want = {k: LAYERS for k, v in FT_KERNELS.items()
                if v["model"] == gnn}
        for step, item in enumerate(items):
            batch, lab, mot = ft._device_item("train", *item)
            cpu_args = (item[0].to("cpu"), lab.cpu(),
                        tuple(m.cpu() for m in mot))
            cpu_model.load_state_dict(
                {k: v.cpu() for k, v in ft.model.state_dict().items()})
            cpu_opt.load_state_dict(copy.deepcopy(ft.opt.state_dict()))
            n = batch.nbr.shape[0]
            masks = [torch.rand(n, EMB, generator=mgen) < 0.7
                     for _ in range(LAYERS)]
            reset_counts()
            loss_g = ft_lib.train_step(
                ft.model, ft.opt, batch, lab, mot, ft.task.loss,
                dropout_masks=[m.to(dev) for m in masks])
            torch.cuda.synchronize()
            counts = read_counts()
            loss_c = ft_lib.train_step(cpu_model, cpu_opt, *cpu_args,
                                       ft.task.loss, dropout_masks=masks)
            row["losses"].append([loss_g.item(), loss_c.item()])
            row["counts"].append(counts)
            for name, c in counts.items():
                check(c == want.get(name, 0), f"{tag} step {step}: {name} "
                      f"launched {c} times, expected {want.get(name, 0)}")
                totals[name] += c
            check(abs(loss_g.item() - loss_c.item())
                  <= STEP_LOSS_RTOL * abs(loss_c.item()),
                  f"{tag} step {step}: loss card {loss_g.item()} cpu "
                  f"{loss_c.item()}")
            worst, top, stat = state_agreement(ft.model, cpu_model, step, lr,
                                               f"{tag} step {step}")
            row["worst_fraction_off"].append(worst)
            row["max_param_diff"].append(top)
            row["running_stats_over_limit"].append(stat)
        row["eval_err"], row["eval_tiles"] = eval_agreement(
            ft, cpu_model, gnn, tag)
        report[tag] = row
        print(f"finetune step {tag} {json.dumps(row)}", flush=True)
    report["launches"] = totals
    return report


def finetune_speed_phase(dev, tmp: str, card: str, shared: list) -> dict:
    """The fine-tuning step's time on the card (median of CUDA-event times
    over 25 steps after 5 warm-up steps, dropout drawn on the card), the
    host's time to queue a step, an eval batch's forward, and a profile of
    the GIN f32 step."""
    report = {}
    for gnn, bf16 in (("gin", False), ("gcn", False), ("gin", True)):
        cfg = finetune_cfg(tmp, gnn, bf16=bf16)
        ft = finetuner(cfg, dev, shared)
        item = next(iter(ft.iters["train"]))
        batch, lab, mot = ft._device_item("train", *item)

        def step():
            return ft_lib.train_step(ft.model, ft.opt, batch, lab, mot,
                                     ft.task.loss, generator=ft.dropout_gen)

        for _ in range(WARM_STEPS):
            step()
        torch.cuda.synchronize()
        events, host = [], []
        for _ in range(SPEED_STEPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            loss = step()
            e1.record()
            host.append(1e3 * (time.perf_counter() - t0))
            events.append((e0, e1))
        torch.cuda.synchronize()
        check(bool(torch.isfinite(loss)), f"{gnn} bf16={bf16}: loss {loss}")
        ms = statistics.median(a.elapsed_time(b) for a, b in events)
        ebatch, _, emot = ft._device_item("valid",
                                          *next(iter(ft.iters["valid"])))
        row = dict(card=card, model=gnn,
                   dtype="bfloat16" if bf16 else "float32",
                   step_ms=ms, host_ms=statistics.median(host),
                   steps=SPEED_STEPS, tiles=batch.nbr.shape[0] // TILE,
                   mol_per_s=int(item[0].graph_mask.sum()) / (ms / 1e3),
                   eval_tiles=ebatch.nbr.shape[0] // TILE,
                   eval_batch_ms=time_ms(lambda: ft_lib.predict(
                       ft.model, ebatch, emot)))
        if gnn == "gin" and not bf16:
            row["profile"] = profile_steps(lambda i: step())
        report[f"{gnn}_{row['dtype']}"] = row
        print(f"finetune speed {json.dumps(row)}", flush=True)
    return report


# --------------------------------------------------------------- phase 10


def finetune_cli_phase(tmp: str) -> dict:
    """cli.finetune for 2 epochs of configs/finetune.yaml on the synthetic
    stand-in, in a temporary working directory: GIN warm-started from
    phase 7's newest step_<n>.pt, then --model gcn, then --motifs."""
    pre = latest_checkpoint(os.path.join(tmp, "pretrain_ckpt"))
    check(pre is not None, "no step_<n>.pt from the pretrain CLI phase")
    config = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs", "finetune.yaml")
    cwd = os.path.join(tmp, "ft_cli")
    os.makedirs(cwd)
    base = ["--config", config, "--allow-synthetic", "--epochs", "2"]
    report = {"pretrained": os.path.basename(pre)}
    old = os.getcwd()
    os.chdir(cwd)
    try:
        for tag, extra, model in (("gin_warm", ["--pretrained", pre], "gin"),
                                  ("gcn", ["--model", "gcn"], "gcn"),
                                  ("gin_motifs", ["--motifs"], "gin")):
            reset_counts()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                rc = finetune_cli.main(base + extra)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            text = out.getvalue()
            check(rc == 0, f"finetune CLI {tag} returned {rc}")
            results = re.findall(r"^RESULT (\S+): (\S+) = (\S+)$", text, re.M)
            check(len(results) == 1 and np.isfinite(float(results[0][2])),
                  f"finetune CLI {tag}: RESULT lines {results}")
            prefix = os.path.basename(pre) if tag == "gin_warm" \
                else "scratch"
            csv_name = f"{prefix}_BBBP_finetune.csv"
            with open(os.path.join("experiments", csv_name)) as f:
                row = f.read().splitlines()[-1].split(",")
            check(row[-1] == "synthetic=true",
                  f"finetune CLI {tag}: CSV row {row} not stamped synthetic")
            with open(os.path.join("runs", "finetune", "BBBP_p_np",
                                   "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f][-3:]
            check([r.get("epoch") for r in recs[:2]] == [0, 1]
                  and all(np.isfinite(r["train_loss"]) for r in recs[:2]),
                  f"finetune CLI {tag}: records {recs}")
            counts = read_counts()
            for name, spec_k in FT_KERNELS.items():
                check((counts[name] > 0) == (spec_k["model"] == model),
                      f"finetune CLI {tag}: {name} launched "
                      f"{counts[name]} times")
            report[tag] = dict(result=results[0], csv_row=row, cli_s=sec,
                               epochs=recs[:2], test=recs[2],
                               counts=counts)
            print(f"finetune cli {tag} {json.dumps(report[tag])}",
                  flush=True)
    finally:
        os.chdir(old)
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t_start = time.perf_counter()

    def phase(name: str) -> None:
        print(f"phase {name} at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    built = _build.build_all()
    print(f"build: {time.perf_counter() - t_start:.2f} s "
          f"{json.dumps(built)}", flush=True)

    phase("kernels")
    kernels = kernel_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase("slice")
        sl = slice_phase(dev, tmp, card)
        batch, spec = pretrain_batch()
        print(f"pretraining batch: {spec}, {int(batch.node_mask.sum())} "
              f"atoms, {int(batch.edge_mask.sum())} directed bonds",
              flush=True)
        phase("training kernels")
        layer = training_layer_phase(batch.to(dev), dev)
        ntx = ntxent_phase(dev)
        phase("step")
        step = step_phase(batch, spec, dev)
        phase("speed")
        speed_phase(batch, spec, dev, card)
        phase("cli")
        cli_phase(tmp)
        fbatch = finetune_batch()
        print(f"fine-tuning batch: {fbatch.nbr.shape[0] // TILE} tiles, "
              f"{int(fbatch.node_mask.sum())} atoms, "
              f"{int(fbatch.edge_mask.sum())} directed bonds", flush=True)
        phase("fine-tune kernels")
        ft_kernels = finetune_kernel_phase(fbatch.to(dev), dev)
        phase("fine-tune steps")
        shared = [None]
        ft_step = finetune_step_phase(dev, tmp, shared)
        phase("fine-tune speed")
        finetune_speed_phase(dev, tmp, card, shared)
        phase("fine-tune cli")
        finetune_cli_phase(tmp)
    phase("done")

    def row(name, source, replaces, launches, res, case):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches,
                    max_abs_err=res["max_abs_err"], ms=case["ms"],
                    plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
                    bound_by=case["bound_by"],
                    library_ms=case["library_ms"])

    # the main path's cases: f32 with the relu prologue (layers 2-5) at the
    # pretraining shape for K1f / K1b, 2B = 1,024 with no dead pair for K2
    def pick(cases, **want):
        return next(c for c in cases if all(c[k] == v
                                            for k, v in want.items()))

    train_case = dict(dtype="float32", relu_in=True)
    rows = [row("fused_gine_bn_layer", KERNELS["fused_gine_bn_layer"][
        "source"], KERNELS["fused_gine_bn_layer"]["replaces"],
        step["launches"]["fused_gine_bn_layer"], layer["fwd"],
        pick(layer["fwd"]["cases"], **train_case))]
    serving = pick(kernels["fused_gcn_bn_layer"]["cases"], **train_case)
    rows.append(row("fused_gcn_bn_layer", KERNELS["fused_gcn_bn_layer"][
        "source"], KERNELS["fused_gcn_bn_layer"]["replaces"],
        sl["gcn"]["launches"]["fused_gcn_bn_layer"],
        kernels["fused_gcn_bn_layer"], serving))
    spec_b = TRAIN_KERNELS["fused_gine_bn_layer_bwd"]
    rows.append(row("fused_gine_bn_layer_bwd", spec_b["source"],
                    spec_b["replaces"],
                    step["launches"]["fused_gine_bn_layer_bwd"],
                    layer["bwd"], pick(layer["bwd"]["cases"], **train_case)))
    for name, part in (("ntxent_fwd", "fwd"), ("ntxent_bwd", "bwd")):
        spec_k = TRAIN_KERNELS[name]
        rows.append(row(name, spec_k["source"], spec_k["replaces"],
                        step["pallas_counts"][name], ntx[part],
                        pick(ntx[part]["cases"], two_b=1024, dead_rows=0)))
    for name, spec_k in FT_KERNELS.items():
        rows.append(row(name, spec_k["source"], spec_k["replaces"],
                        ft_step["launches"][name], ft_kernels[name],
                        pick(ft_kernels[name]["cases"], dtype="float32")))
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
