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
              a cuBLAS matmul chain computing the same function; the
              shares of dead row blocks or strips and of adjacency chunks
              that the launch skipped (kernel_plan, k3f_plan).
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
              at 2B = 1,024, 2,048, 4,096 and 8,192 with D = 256 and at
              4,096 with D = 512 (NTX_CASES), with and without dead pairs,
              within NTX_RTOL of their plain versions, every row statistic
              finite. Two runs bit-identical; kernel, plain and library
              times (for K2, the closed form's forward and backward: the
              crossover); K1f's, K1b's, K2f's and K2b's device time by
              kernel (torch.profiler over 20 launches: K2f's mainloop and
              merge, K2b's mainloop and sums) and the shares of work K1f
              and K1b skipped; K1b's host time per wrapper call and which
              of the two sets its events ms. Then resolve_ntxent('auto') at
              B = 2,048
              (2B = 4,096) forward and backward: K2f and K2b once each, the
              loss within 1e-5 of the closed form's, the gradients within
              1e-4 of the largest.
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
              `--resume latest` for the third, on the default path (tile-
              units, steps after the first two replayed as a CUDA graph)
              and with --device-cache-mb 0 (host streaming, eager steps);
              metrics.jsonl records, K1b launches = 10 per eager step and
              10 captured per replayed step (the total, captured x replays,
              is derived: a replay counts nothing; phase 15 watches
              replays launch the kernels), the step count and LR schedule
              continue.
  8. fine-tune kernels, at the fine-tuning shape (a batch of 32 molecules
              of the synthetic BBBP stand-in with their hydrogens, packed
              as the FineTuner packs a training batch: T = 4 tiles of 256,
              D = 300): K4f (with residuals), K4b, K5f and K5b against
              their plain versions in f32 and bf16; two runs
              bit-identical; kernel, plain and library times; K4f's, K4b's,
              K5f's and K5b's device time by kernel (torch.profiler over 20
              launches), K4f's, K4b's and K5f's host time per wrapper call,
              and the shares of row blocks, strips, adjacency chunks and
              weight-pass row chunks they skipped (kernel_plan, k5b_plan,
              gine_bwd_plan). Then the same four with their member grid
              axis at M = 3 and 6 members (MEMBER_COUNTS: each member its
              own features, weights and cotangent, the adjacency and
              counts shared), f32 and bf16: one launch equal bit for bit
              to M one-member launches and within KERNEL_RTOL of the plain
              version, its ms against the M-launch loop's, the plain
              version's and a batched cuBLAS chain's, beside the bound of
              M members' work with the adjacency read once. Then the
              eight layer kernels (K1f, K1b, K3f, K3b, K4f, K4b, K5f, K5b)
              at D = 2,048, D2 = 4,096 on 16 molecules packed at tiles 128
              and 256, f32 and bf16: within KERNEL_RTOL of their plain
              versions, two runs bit-identical, K1f's block rows and
              split, and at tile 256 their ms, plain and library ms and
              bounds.
  9. fine-tune steps: the FineTuner at the reference fine-tune model (5 x
              300 / 512, drop 0.3, batch 32, pred head 2 x softplus, f32),
              GIN, GCN and GIN with the motif head: 3 steps on rows of the
              resident train stack on the card, each also run on the CPU
              from the card's state with the same dropout masks (losses,
              parameters, BatchNorm stats agree); launches per step K4f 5,
              K4b 5 (GIN) or K5f 5, K5b 5 (GCN); the eval forward of one
              validation batch ('max' sizing) and the motif table, card
              against the CPU from the same state; then for GIN f32, GCN
              f32 and GIN bf16 the step on three paths: the host path (a
              host batch uploaded per step, eager), resident eager and
              resident graphed: step ms (CUDA events at each step's end,
              median over 25 steps), host ms, the profiler's device ms and
              busy share, the port's kernels per replayed step as per
              eager step; an eval batch's time and the host's time to
              queue one, and the validation split eager against one
              replay.
 9b. ensembles: at full width (f32, drop 0.3), GIN BBBP with 3 seeds,
              GIN ClinTox 2 targets x 3 seeds and GCN BBBP with 3 seeds,
              the members' trunks in lockstep (one member-axis launch of
              each layer kernel per layer): two steps of all members from
              their fresh state bit for bit against each member stepped
              alone (one-member launches, its own Adam, its seed's
              masks); one step of all members card against CPU, member by
              member, with 5 launches each of K4f and K4b (K5f and K5b);
              10 graphed steps bit-identical to 10 eager ones, with 5
              launches of K4f's and K4b's (K5f's and K5b's) first kernels
              per replayed step as the profiler counts them; the graphed
              step's ms, host ms, device ms and busy share against M times
              the one-member graphed step, and the stacks' device ms
              (timed alone, and the profile's cat copies).
 10. fine-tune cli: `molclr_tpu_torch.cli.finetune --allow-synthetic` for
              2 epochs in a temporary working directory: GIN warm-started
              from phase 7's step_<n>.pt, then --model gcn, then --motifs,
              then --n-seeds 3; every RESULT metric finite (with its std
              over the seeds for --n-seeds), every row stamped
              synthetic.
 11. GCN training kernels, at the pretraining shape (phase 4's batch, T =
              22): K3f and K3b (fused_gcn_bn_layer's backward) against
              their plain versions in f32 and bf16, relu_in False and True;
              two runs bit-identical; kernel, plain and library times,
              device us per pass, host us per call and the shares of
              strips, adjacency chunks and weight-pass row chunks they
              skipped (k3f_plan, k3b_plan).
 12. GCN step: GCN pretraining at full width (5 x 300 / 512, B = 512, node
              augmentation, ntxent 'auto'): 3 card-vs-CPU steps in f32 and
              in bf16 with phase 5's limits, K3f 10 and K3b 10 launches per
              step and no other kernel; two identical card steps
              bit-identical; one normalize_gcn step card-vs-CPU; the step's
              time (f32, bf16), the host's time and a profile.
 13. options: K4b at the dropout step's shape (T = 22), K1b at
              concat_views' (T = 44) and K3f / K3b at GCN mix's (T = 47)
              against their plain versions in f32 and bf16 (phase 8's,
              phase 4's and phase 11's limits, two runs bit-identical);
              then one card-vs-CPU step each at full width
              with launch counts for GIN subgraph, GIN mix and GCN mix augmentation (the views
              on the card bit-identical to the CPU's from the same keys;
              mix on the batch featurized with hydrogens), GIN with dropout
              0.1 (the same masks on both; K4f / K4b 5 per view) and GIN
              with concat_views (K1f / K1b 5 per step at T = 44); the
              augmentation's stream, host and device time per step for
              node, subgraph and mix.
 14. gcn cli: `molclr_tpu_torch.cli.pretrain --model gcn --aug mix` as
              phase 7 runs the GIN CLI (two epochs, then a resume), on both
              paths.
 15. resident: the Pretrainer's default one-card path at full width (B =
              512, node augmentation) on phase 7's 4,096-molecule corpus:
              first the host path's step timed on the host by part (key
              draws, batch upload, augmentation, forward, backward, Adam;
              GIN and GCN, f32); the tile-unit plan and the stack's MB wide
              and narrow; on one batch of the units path (T = 20 tile-units
              regrouped by concat_units, with per-unit graph slots and
              sentinel bonds) K1f / K1b / K3f / K3b against their plain
              versions (f32 and bf16, relu_in False and True, phases 4's
              and 11's limits) and one card-vs-CPU step each of GIN and
              GCN, f32 and bf16 (phase 5's limits); 10 units-path steps run
              eagerly and replayed as a CUDA graph from the same state, GIN
              and GCN, chain and fused Adam: losses, parameters, BatchNorm
              stats and Adam moments bit-identical, the wrappers' counts
              captured per step equal to an eager step's, and the
              profiler's launches of the port's kernels per replayed step
              equal to those per eager step; then the step's time (median
              of CUDA events over 25 steps at each step's end in the
              Pretrainer's own epoch loop), molecules/s, message-edges/s,
              the host's time per step and a torch.profiler breakdown for
              the host path, resident eager and resident graphed, GIN and
              GCN, f32 and bf16, and GIN with dropout 0.1 (the port's
              kernels launched per replayed step as per eager step); 10
              graphed steps bit-identical to 10 eager ones also for GIN
              with dropout 0.1, subgraph, mix and concat_views, GCN with
              normalize_gcn and mix, and GIN with the 'pallas' NT-Xent;
              and the graphed f32 step with the chain against the fused
              Adam, 10 alternating rounds of 25 steps each.
 16. corpus: the native featurizer and packer (native/, built with g++
              before phase 1 into build/native/; the seconds printed) and
              the on-disk corpus. Native against Python featurization on
              20,000 synthetic molecules and edge cases (drugs, aromatic
              rings, invalid SMILES), without and with hydrogens: the
              same molecules, every array equal, mol/s of each; the native
              packer against pack_batch(prefer_native=False) on one B =
              512 batch, every field equal, ms per batch of each. A
              100,000-molecule corpus through `cli.featurize --synthetic`
              (its mol/s), the train split's tile-unit plan and stack MB
              wide and narrow, projected to PubChem-10M; a 20,000-molecule
              --add-hs corpus. Phase 7's 4,096 SMILES as the text file and
              as a corpus: the same split, PadSpec, unit spec and unit
              stacks (wide and narrow), and 10 graphed GIN f32 steps with
              bit-identical losses, parameters, BatchNorm stats and Adam
              moments. `cli.pretrain --data <corpus>` at full width (GIN,
              B = 512, node augmentation, f32, --pack-cache-max-mols
              1,000,000) as phase 7 runs it (two epochs, then a resume; K1b
              10 per eager step, 10 captured per replay), then --model gcn
              --aug mix for one epoch on the --add-hs corpus (K3f and K3b).
              The streaming path (--pack-cache-max-mols 10,000): the first
              streamed batch equals the Python pack_batch of the same
              molecules, one epoch with one native indexed pack per step
              and K1f / K1b 10 per step, the host's pack ms per batch, and
              the step's ms, host ms, device ms and busy share as phase 15
              measures them over 25 streamed steps.
 17. model options: the JAX package's ELL trunk (tile 0), pool max,
              LinkFineTuneNet and TensorBoard scalars. gine_aggregate and
              gcn_aggregate (norm None and normalize_gcn) forward and
              backward on phase 5's B = 512 batch packed at tile 0 (D =
              300), f32 and bf16: two card runs bit-identical, the CPU
              within ELL_RTOL, ms per forward + backward; graph_pool max
              on phase 4's batch with planted ties, card equal to the CPU
              and to itself bit for bit; the embed CLI at --tile 0 on
              phase 3's 1,024 SMILES and four above 256 atoms (GIN, GCN:
              all embedded, no kernel launched, against --cpu and against
              --tile 256 on the 1,024, mol/s of both and the forward's);
              three tile-0 GIN steps at full width card against CPU (phase
              5's limits, no kernel) and two identical steps
              bit-identical, one GCN normalize_gcn step; the Pretrainer at
              tile 0 (a host epoch, then the cached batches resident): 10
              graphed steps bit-identical to eager ones and the graphed
              step's ms, host ms, device ms and busy share beside phase
              15's units-path GIN f32 step; pool max at tile 256: one step
              card against CPU (K1f 10, K1b 10) and 10 graphed units-path
              steps against eager; LinkFineTuneNet at the fine-tune model
              on phase 8's molecules, card against CPU with the same keep
              masks, tile 256 (K4f 5, K4b 5) and tile 0 (no kernel); and
              whether torch.utils.tensorboard imports and what the writer
              did.
 18. data parallelism and the Orbax reader. (b) DP_RANKS processes of
              this script (`--dp-rank`) share the card through gloo over
              CUDA tensors, DP_B = 1,024 molecules each (a global 2B of
              4,096: 'auto' runs K2f / K2b on the gathered pairs): three
              eager GIN steps, then three GCN, one bf16 GIN step and one
              GIN step at drop_ratio 0.1 (DP_CASES), each rank's card step
              held to the same rank's DP step on the CPU (plain versions;
              with dropout on the card's own masks) by phase 5's limits at
              the step's dtype from the card's state, K1f 10 / K1b 10 (or
              K3f 10 / K3b 10, K4f 10 / K4b 10) and K2f 1 / K2b 1 per
              step, the ranks'
              states bit-identical after every step, the shared card's ms
              recorded (two processes: no speed figure). (a) World 1 on
              NCCL: the pretrain CLI with data_axis (configs/pretrain.yaml
              plus data_axis) as phase 7 runs it, units path, graphed, with
              a resume; then a DP Pretrainer on phase 7's corpus: two DP
              steps against two one-card steps on the same batches and
              views, bit for bit (DP_COLLECTIVES all-reduces per step), 10
              graphed steps bit-identical to eager ones, one bf16 and one
              dropout-0.1 GIN DP step on its first units-path batch held to
              the CPU as in (b), the dropout Pretrainer's 10 graphed steps
              bit-identical to eager ones, and the graphed DP
              step's ms, host ms, device ms and busy share beside phase
              15's one-card units-path step. (c) tests/data/orbax/ (the
              JAX package's Orbax checkpoints) read without JAX, and the
              embed CLI from its GIN step directory against JAX's
              embeddings within SLICE_RTOL.
 19. partitioned: node-row-sharded giant-batch pretraining
              (parallel/partition.py) and the sharded aggregations
              (parallel/edgepart.py). (a) PART_RANKS processes of this
              script (`--part-rank`) share the card through gloo over
              CUDA tensors, each holding its segment (shard_graph_batch)
              of one giant batch: PART_RANKS x 512 molecules of phase 7's
              corpus, each shard packed as the Pretrainer packs B = 512 at
              tile 256, concat_shards (a global 2B of 4,096). Three eager
              GIN partitioned steps and one GCN step, each rank's card step
              held to its CPU partitioned step (plain versions) from the
              card's state by phase 5's limits, K1f 10 / K1b 10 (K3f 10 /
              K3b 10) and K2f 1 / K2b 1 per step, PART_COLLECTIVES
              all-reduces per step, the ranks' states bit-identical after
              every step, the shared card's ms (no speed figure); one aug
              'none' partitioned step against the one-card step on the
              whole giant batch on the card (phase 5's limits). (b)
              edgepart's gather, halo and tile variants at D = 300 across
              the ranks (phase 5's batch at tile 0 for the first two, the
              halo its largest molecule, tile 256 for the third): forward
              and backward against the single-rank gine_aggregate on the
              card within ELL_RTOL, two runs bit-identical, no all-reduce
              in the tile variant, the all-reduce bytes per layer. (c)
              World 1 on NCCL: two partitioned steps bit-identical to two
              one-card steps.

Phase 3's embed CLI featurizes with the native featurizer, which phase 16
holds to the Python one.

It prints one JSON line listing the kernels, the card's name and power
limit, and as its last line {"ok": true, "device": {...}}. It needs one
CUDA card and imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import itertools
import json
import math
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

from molclr_tpu_torch import native
from molclr_tpu_torch.native import zstd
from molclr_tpu_torch.cli import embed
from molclr_tpu_torch.cli import featurize as featurize_cli
from molclr_tpu_torch.cli import finetune as finetune_cli
from molclr_tpu_torch.cli import pretrain as pretrain_cli
from molclr_tpu_torch.data import corpus as corpus_lib
from molclr_tpu_torch.data.augment import AUG_DELTA_FIELDS, \
    draw_paired_keys, paired_augment, paired_augment_keys
from molclr_tpu_torch.data.featurize import NUM_BOND_DIRS, NUM_BOND_TYPES, \
    featurize_smiles
from molclr_tpu_torch.data.graphs import GraphBatch, concat_shards, \
    concat_views, pack_batch
from molclr_tpu_torch.data.loader import featurize_many, \
    read_pretrain_smiles, spec_for_graphs
from molclr_tpu_torch.data.regroup import concat_units, \
    pack_unit_stack, pack_unit_stack_corpus, plan_corpus_units, \
    unit_stack_bytes, wire_dtypes
from molclr_tpu_torch.data.motifs import encode_motif_vocab
from molclr_tpu_torch.data.synthetic import synthetic_corpus
from molclr_tpu_torch.losses import nt_xent_loss, resolve_ntxent
from molclr_tpu_torch.models import FineTuneNet, LinkFineTuneNet, MolCLRNet
from molclr_tpu_torch.ops import _build, ntxent, scatter_free
from molclr_tpu_torch.data.tasks import TASKS
from molclr_tpu_torch.ops.fused_gcn import (
    fused_gcn_bn_layer,
    k3b_plan,
    k3f_plan,
    k5b_plan,
    fused_gcn_bn_layer_bwd,
    fused_gcn_bn_layer_bwd_plain,
    fused_gcn_bn_layer_plain,
    fused_gcn_layer,
    fused_gcn_layer_bwd,
    fused_gcn_layer_bwd_plain,
    fused_gcn_layer_fwd,
    fused_gcn_layer_members_bwd,
    fused_gcn_layer_members_bwd_plain,
    fused_gcn_layer_members_fwd,
    fused_gcn_layer_members_plain,
    fused_gcn_layer_plain,
)
from molclr_tpu_torch.ops.fused_layer import (
    CNT_PAD,
    STRIP_ROWS,
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
    fused_gine_layer_members_bwd,
    fused_gine_layer_members_bwd_plain,
    fused_gine_layer_members_fwd,
    fused_gine_layer_members_fwd_plain,
    gine_bwd_gt,
    gine_bwd_plan,
    k1f_block_rows,
    k1f_splits,
    kernel_plan,
    pack_cnt,
    sm_count,
    unchained_fwd_plan,
)
from molclr_tpu_torch.ops.scatter_free import _counts
from molclr_tpu_torch.ops.segment import graph_pool
from molclr_tpu_torch.ops.tile_dense import build_tile_adjacency, \
    gcn_normalization
from molclr_tpu_torch.parallel import DPGroup, build_sharded_layer, \
    destroy_distributed, init_distributed, partitioned_train_step, \
    shard_ell_rows, shard_graph_batch
from molclr_tpu_torch.parallel.multihost import free_port
from molclr_tpu_torch.train import finetune as ft_lib
from molclr_tpu_torch.train import optim
from molclr_tpu_torch.train.checkpoints import latest_checkpoint, \
    transfer_state
from molclr_tpu_torch.train.config import FineTuneConfig, ModelConfig, \
    PretrainConfig
from molclr_tpu_torch.train.graphed import GRAPH_WARMUP_STEPS
from molclr_tpu_torch.train.logging_util import MetricWriter
from molclr_tpu_torch.train.optim import load_optimizer_state
from molclr_tpu_torch.train.orbax import read_step_dir
from molclr_tpu_torch.train.pretrain import DROPOUT_STREAM, TRAIN_STREAM, \
    Pretrainer, build_model, forward_backward, step_generator, train_step

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
        source="molclr_tpu_torch/csrc/fused_gine_bwd.cu",
        replaces="molclr_tpu/ops/fused_layer.py:271"),
    "ntxent_fwd": dict(fn=ntxent.ntxent_fwd,
                       source="molclr_tpu_torch/csrc/ntxent.cu",
                       replaces="molclr_tpu/ops/pallas_ntxent.py:43"),
    "ntxent_bwd": dict(fn=ntxent.ntxent_bwd,
                       source="molclr_tpu_torch/csrc/ntxent.cu",
                       replaces="molclr_tpu/ops/pallas_ntxent.py:86"),
    "fused_gcn_bn_layer_bwd": dict(
        fn=fused_gcn_bn_layer_bwd,
        source="molclr_tpu_torch/csrc/fused_gcn_bn.cu",
        replaces="molclr_tpu/ops/fused_gcn.py:175"),
}
# the kernels of the fine-tuning path (the unchained layers)
FT_KERNELS = {
    "fused_gine_layer": dict(
        fn=fused_gine_layer, source="molclr_tpu_torch/csrc/fused_gine_bn.cu",
        replaces="molclr_tpu/ops/fused_layer.py:59", model="gin"),
    "fused_gine_layer_bwd": dict(
        fn=fused_gine_layer_bwd,
        source="molclr_tpu_torch/csrc/fused_gine_bwd.cu",
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
# the fine-tuning kernels with their member grid axis (one launch over an
# ensemble's members, the JAX FineTuner's vmapped pallas_call), counted in
# the one-layer kernels' counters (`counter`); their main path is phase
# 9b's ensemble step (`ensemble`)
MEMBER_KERNELS = {
    name.removesuffix("_bwd") + "_members"
    + ("_bwd" if name.endswith("_bwd") else ""): dict(
        spec, counter=name, ensemble=("bbbp_3_seeds" if spec["model"] == "gin"
                                      else "gcn_bbbp_3_seeds"))
    for name, spec in FT_KERNELS.items()}

# the pretraining main path: bench.py's batch and model (B = 512, the
# Pretrainer's 'total' sizing), 3 steps on the card and the CPU
P_BATCH, P_STEPS, SPEED_STEPS, WARM_STEPS = 512, 3, 25, 5
# K1b against its plain version: the same reasons as KERNEL_RTOL; weight
# gradients are sums over the 5,632 rows of a batch
BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# K2f / K2b against their plain versions (f32): row statistics and dreps
# summed in another order
NTX_RTOL = 1e-4
# card against CPU on each of 3 full-width steps from the same state:
# loss within STEP_LOSS_RTOL. Per tensor: its gradient within
# STEP_GRAD_RTOL of the model's largest gradient (a tensor wrong in full
# fails, however few its elements); its parameters within Adam's sign-flip envelope 2 lr times
# adam_step_bound (elements whose true gradient is ~0 may flip a whole
# lr-sized step) plus the f32 rounding of p +- lr, and within 5e-5 + 2e-4
# |p| on all but max(1, ceil(STEP_FRAC_OFF n)) of its n elements with a
# real gradient: above 1e-4 and above STEP_GRAD_NOISE times the model's
# largest gradient (below that its sign is rounding noise, as on the conv
# output biases ahead of a BatchNorm, whose exact gradient is 0, and Adam
# turns a flipped sign into a whole step); BatchNorm running stats rtol
# 2e-3 / atol STEP_BN_ATOL
# 1e-4 in f32; 5e-4 in bf16, set from readings (runs/port_units_gap.py, 13
# pretraining batches over 3 seeds): the kernels' bf16 step 1.05e-5 to
# 2.17e-4 from the CPU's, the plain versions on the card up to 1.24e-4 (so
# 1e-4 was below what two right implementations differ by), and an eighth
# of a bf16 ulp (2^-8, the CPU tests' bf16 loss limit against JAX)
STEP_LOSS_RTOL = {torch.float32: 1e-4, torch.bfloat16: 5e-4}
# 2e-2 in f32: a relu input within rounding of 0 (the projection head's,
# an MLP's) takes the other branch on one device and moves a whole row of
# the gradients behind it (up to 8.4e-3 seen); 0.15 in bf16, where GCN's
# scalar edge tables are sums over 300 bf16 columns that cancel (7.4e-2)
STEP_GRAD_RTOL = {torch.float32: 2e-2, torch.bfloat16: 0.15}
# 0 in f32 (the 1e-4 floor alone, as the noise on the exact-zero biases
# stays below it); 2e-2 in bf16, five bf16 ulps of the largest gradient
STEP_GRAD_NOISE = {torch.float32: 0.0, torch.bfloat16: 2e-2}
# 3e-4 in f32; 1e-2 in bf16, where a bf16 rounding flip in the sums that
# feed a gradient can flip its sign
STEP_FRAC_OFF = {torch.float32: 3e-4, torch.bfloat16: 1e-2}
# 1e-5 in f32; 2.5e-4 in bf16: a flipped rounding of an O(1) bf16 layer
# output moves the batch mean, and the running mean by a tenth of that
STEP_BN_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2.5e-4}


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


def layer_inputs(batch, dt, gen, d: int = EMB, tile: int = TILE):
    """adj / cnt of a real packed batch (tile `tile`) in dtype dt, and
    seeded random features, BatchNorm coefficients and weights at width d
    (full width by default)."""
    dev = batch.nbr.device
    adj = build_tile_adjacency(batch.nbr, batch.nbr_mask, tile, dtype=dt)
    w = batch.nbr_mask.to(dt)
    cnt = pack_cnt(_counts(batch.nbr_bond_type, w, NUM_BOND_TYPES),
                   _counts(batch.nbr_bond_dir, w, NUM_BOND_DIRS)).contiguous()
    n = batch.nbr.shape[0]

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


def k1f_skipped(x, p) -> dict:
    """The share of K1f's row blocks that are dead (one constant row
    computed) and of the (block, adjacency chunk) products a dense strip
    would do that it skips, from the plan helper on this launch's input,
    with the rows per block that the kernel's library launches with."""
    _, s, _ = x["adj"].shape
    d, d2 = p["w1"].shape
    rows = k1f_block_rows(x["h"].dtype, s, d, d2)
    plan = kernel_plan(x["adj"].cpu(), x["cnt"].cpu(), rows)
    return dict(block_rows=rows,
                dead_blocks=float(plan["dead_blocks"].float().mean()),
                a_chunks=1 - plan["block_chunks"] / plan["dense_chunks"])


def k5b_skipped(adj, d) -> dict:
    """The share of K5b's 16-row strips that are dead, of the adjacency
    chunks its strip pass skips and of its weight pass's row chunks that
    load nothing, from the plan helper on this launch's input and the
    card's SM count, as the wrapper plans the weight pass."""
    plan = k5b_plan(adj.cpu(), d, sm_count(adj.device))
    return dict(dead_strips=float(plan["dead_strips"].float().mean()),
                a_chunks=1 - plan["block_chunks"] / plan["dense_chunks"],
                dw_chunks=1 - float(plan["live_chunks"].float().mean()),
                dw_chunk_count=plan["dw_chunks"])


def k3f_skipped(x, d) -> dict:
    """K3f's blocks per launch (k3f_plan) and the shares of its 16-row
    strips that are dead in the xw pass (A rows all zero: zeros written)
    and in the adjacency pass (A and cnt rows all zero: rnd(bias) written),
    and of the (strip, adjacency chunk) products that it skips, from the
    plan helper on this launch's input."""
    plan = k3f_plan(x["adj"].cpu(), x["cnt"].cpu(), d)
    ap = plan["adj"]
    return dict(blocks={k: v[0] * v[1] for k, v in plan["grids"].items()},
                xw_dead_strips=float(plan["xw"]["dead_strips"].float()
                                     .mean()),
                adj_dead_strips=float(ap["dead_strips"].float().mean()),
                a_chunks=1 - ap["block_chunks"] / ap["dense_chunks"])


def k3b_skipped(x, d, dt) -> dict:
    """K3b's blocks per launch (k3b_plan) and the shares of its strip
    pass's dead strips and skipped (strip, adjacency chunk) products, of
    the strips its weight pass skips (A and cnt rows all zero) and of the
    weight pass's row chunks that load nothing, from the plan helper on
    this launch's input and the card's SM count, as the wrapper plans the
    weight pass."""
    adj = x["adj"]
    plan = k3b_plan(adj.cpu(), x["cnt"].cpu(), d, dt, sm_count(adj.device))
    grids, ap = plan["grids"], plan["adj"]
    blocks = {k: v[0] * v[1] for k, v in grids.items() if k != "weights"}
    blocks["weights"] = sum(c * tm * tc for c, tm, tc in
                            grids["weights"].values())
    return dict(blocks=blocks,
                adj_dead_strips=float(ap["dead_strips"].float().mean()),
                a_chunks=1 - ap["block_chunks"] / ap["dense_chunks"],
                dead_strips=float(plan["dead_strips"].float().mean()),
                dw_chunks=1 - float(plan["live_chunks"].float().mean()),
                dw_chunk_count=plan["dw_chunks"],
                dw_tile_rows=plan["dw_tile_rows"])


def unchained_skipped(x, d, d2, kernel) -> dict:
    """K4f's or K5f's blocks per launch (unchained_fwd_plan) and the shares
    of its 16-row blocks that are dead and of the (block, adjacency chunk)
    products that it skips, from the plan helpers on this launch's input."""
    adj, cnt = x["adj"], x["cnt"]
    t, s, _ = adj.shape
    grids = unchained_fwd_plan(t, s, d, d2)
    kp = kernel_plan(adj.cpu(), cnt.cpu() if kernel == "k4f" else None,
                     STRIP_ROWS)
    return dict(blocks={k: v[0] * v[1] for k, v in grids.items()
                        if k.startswith(kernel)},
                dead_blocks=float(kp["dead_blocks"].float().mean()),
                a_chunks=1 - kp["block_chunks"] / kp["dense_chunks"])


def gine_bwd_skipped(gt, adj, d2, dt) -> dict:
    """K1b's or K4b's blocks per launch and the shares of its 16-row strips
    whose gt is all zero (the dmid and dagg launches write zeros, the weight
    pass skips them), of the adjacency pass's dead strips and skipped
    (strip, chunk) products, and of the weight pass's row chunks that load
    nothing, from gine_bwd_plan on this launch's input and the card's SM
    count, as the wrapper plans the weight pass."""
    plan = gine_bwd_plan(gt.cpu(), adj.cpu(), d2, dt, sm_count(adj.device))
    grids, ap = plan["grids"], plan["adj"]
    blocks = {k: v[0] * v[1] for k, v in grids.items() if k != "weights"}
    blocks["weights"] = sum(c * tm * tc for c, tm, tc in
                            grids["weights"].values())
    return dict(blocks=blocks,
                dead_strips=float(plan["dead_strips"].float().mean()),
                adj_dead_strips=float(ap["dead_strips"].float().mean()),
                a_chunks=1 - ap["block_chunks"] / ap["dense_chunks"],
                dw_chunks=1 - float(plan["live_chunks"].float().mean()),
                dw_chunk_count=plan["dw_chunks"],
                dw_tile_rows=plan["dw_tile_rows"])


def paced(case: dict, fn, skipped: dict) -> None:
    """Add a wrapper's device us per call by pass (pass_profile), its host
    us per call, their sum and which of the two sets its events ms (the
    host where its time per call is the larger), and what it skipped."""
    case.update(passes_us=pass_profile(fn), host_us=host_us(fn),
                skipped=skipped)
    case["device_us"] = sum(case["passes_us"].values())
    case["ms_paced_by"] = ("host" if case["host_us"] > case["device_us"]
                           else "device")


def host_us(fn, reps: int = 50) -> float:
    """Host microseconds per call of a wrapper: the time to queue `reps`
    calls back to back (the card runs behind), after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


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
                case["skipped"] = (k1f_skipped(x, pg)
                                   if name == "fused_gine_bn_layer"
                                   else k3f_skipped(x, x["h"].shape[1]))
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


def packed_batches(graphs, dev, tile: int = TILE):
    """The corpus in embed batches, packed as the CLI packs them, on dev."""
    spec = spec_for_graphs(graphs, BATCH, tile=tile, sizing="max")
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


def forward_throughput(model_type: str, graphs, ckpt: str, dev,
                       tile: int = TILE) -> dict:
    """Device-side serving rate: the model forward over the corpus's
    pre-packed batches already on the card (no featurization)."""
    model = MolCLRNet(num_layers=LAYERS, emb_dim=EMB, feat_dim=FEAT,
                      gnn_type=model_type, tile=tile)
    transfer_state(torch.load(ckpt, weights_only=True), model)
    model = model.to(dev).eval()
    batches = packed_batches(graphs, dev, tile)
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


def pretrain_batch(add_hs: bool = False):
    """The first training batch of the pretraining path on the host: 512
    molecules of synthetic_corpus(512, seed=7) packed as the Pretrainer
    packs them (tile 256, 'total' sizing with the capped slack 1.05), with
    their hydrogens when add_hs (mix augmentation featurizes so)."""
    graphs, _ = featurize_many(synthetic_corpus(P_BATCH, seed=7),
                               add_hs=add_hs)
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
                library_ms=time_ms(lambda: gine_library(*args, relu_in)),
                passes_us=pass_profile(lambda: fused_gine_bn_layer_fwd(
                    *args, relu_in, residuals=True)))
            case["bound_ms"], case["bound_by"] = bound_ms(
                "fused_gine_bn_layer", x, pg, dt)
            case["skipped"] = k1f_skipped(x, pg)
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
            paced(case, lambda: fused_gine_bn_layer_bwd(*bargs),
                  gine_bwd_skipped(gine_bwd_gt(g, dsums, x["adj"], out),
                                   x["adj"], pg["w1"].shape[1], dt))
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


# phase 4's K2 cases: (2B, D); each with and without dead pairs
NTX_CASES = ((1024, 256), (2048, 256), (4096, 256), (8192, 256),
             (4096, 512))
# the 'auto' check: 2B = 4,096, the first size at which 'auto' takes K2
AUTO_B = 2048
# the 'auto' loss against the closed form (rtol), and its gradients within
# AUTO_GRAD_RTOL of the largest gradient (sums in another order)
AUTO_LOSS_RTOL, AUTO_GRAD_RTOL = 1e-5, 1e-4


def ntxent_phase(dev) -> dict:
    """K2f and K2b at NTX_CASES, with and without dead pairs, against their
    plain versions; the closed form's forward and backward as the library
    yardstick (and the crossover); device us by launch (the mainloop, the
    merge, the sums); then the 'auto' path at B = AUTO_B."""
    res = {"fwd": {"max_abs_err": 0.0, "cases": []},
           "bwd": {"max_abs_err": 0.0, "cases": []}}
    inv_t = 10.0
    for n, d in NTX_CASES:
        for dead in (0, n // 16):
            gen = torch.Generator().manual_seed(n + dead)
            reps = torch.randn(n, d, generator=gen)
            reps = (reps / reps.norm(dim=1, keepdim=True)).to(dev)
            valid = torch.ones(n)
            if dead:
                pairs = torch.randperm(n // 2, generator=gen)[:dead // 2]
                valid[pairs] = 0
                valid[pairs + n // 2] = 0
            valid = valid.to(dev)
            live = valid > 0
            plan = ntxent.ntxent_plan(n, torch.cuda.get_device_properties(
                dev).multi_processor_count)
            tag = dict(two_b=n, d=d, dead_rows=int((~live).sum()),
                       splits=plan["splits"])
            got = ntxent.ntxent_fwd(reps, valid, inv_t)
            again = ntxent.ntxent_fwd(reps, valid, inv_t)
            want = ntxent.ntxent_fwd_plain(reps, valid, inv_t)
            torch.cuda.synchronize()
            case = dict(tag, bit_identical=all(
                torch.equal(u, v) for u, v in zip(got, again)))
            case["finite"] = all(bool(torch.isfinite(x).all()) for x in got)
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
            case["bound_ms"], case["bound_by"] = k2_bound_ms(n, d, False)
            if not dead:
                case["passes_us"] = pass_profile(
                    lambda: ntxent.ntxent_fwd(reps, valid, inv_t))
            print(f"kernel k2f {json.dumps(case)}", flush=True)
            check(case["finite"], f"K2f {tag}: a row statistic is not finite")
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
            case["bound_ms"], case["bound_by"] = k2_bound_ms(n, d, True)
            if not dead:
                case["passes_us"] = pass_profile(lambda: ntxent.ntxent_bwd(
                    reps, valid, inv_t, scale, m, l))
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
    res["auto"] = auto_ntxent_check(dev)
    return res


def auto_ntxent_check(dev) -> dict:
    """resolve_ntxent('auto') at B = AUTO_B on the card, forward and
    backward, as the trainer calls it: K2f and K2b once each (and no other
    kernel), the loss and the gradients of both views against the closed
    form (losses.nt_xent_loss) on the same inputs."""
    gen = torch.Generator().manual_seed(AUTO_B)
    zi = torch.randn(AUTO_B, FEAT // 2, generator=gen)
    zj = zi + 0.5 * torch.randn(AUTO_B, FEAT // 2, generator=gen)
    out = {}
    for name, fn in (("auto", resolve_ntxent("auto")),
                     ("closed_form", nt_xent_loss)):
        a, b = (z.to(dev).requires_grad_(True) for z in (zi, zj))
        reset_counts()
        loss = fn(a, b, 0.1, True)
        loss.backward()
        torch.cuda.synchronize()
        out[name] = (loss.item(), a.grad, b.grad, read_counts())
    (la, ga, gb, counts), (lc, ca, cb, _) = out["auto"], out["closed_form"]
    top = max(ca.abs().max().item(), cb.abs().max().item())
    report = dict(b=AUTO_B, d=FEAT // 2, counts=counts, loss=la,
                  loss_closed_form=lc,
                  grad_err=max((ga - ca).abs().max().item(),
                               (gb - cb).abs().max().item()),
                  grad_top=top)
    print(f"ntxent auto {json.dumps(report)}", flush=True)
    for k, c in counts.items():
        want = 1 if k in ("ntxent_fwd", "ntxent_bwd") else 0
        check(c == want, f"'auto' at B = {AUTO_B}: {k} launched {c} times, "
              f"expected {want}")
    check(abs(la - lc) <= AUTO_LOSS_RTOL * abs(lc),
          f"'auto' loss {la} vs closed form {lc}")
    check(report["grad_err"] <= AUTO_GRAD_RTOL * top,
          f"'auto' gradients differ by {report['grad_err']} (largest {top})")
    return report


# ---------------------------------------------------------------- phase 5


def pretrain_cfg(bf16: bool = False, ntxent_impl: str = "auto",
                 gnn: str = "gin", drop_ratio: float = 0.0,
                 normalize_gcn: bool = False, tile: int = TILE,
                 pool: str = "mean", **kw):
    """The full-width pretraining config (B = 512, 5 x 300 / 512, tile
    256 unless asked); kw sets PretrainConfig fields (aug,
    concat_views)."""
    return PretrainConfig(
        batch_size=P_BATCH, ntxent_impl=ntxent_impl,
        model=ModelConfig(num_layers=LAYERS, emb_dim=EMB, feat_dim=FEAT,
                          tile=tile, bf16=bf16, gnn_type=gnn,
                          drop_ratio=drop_ratio, pool=pool,
                          normalize_gcn=normalize_gcn), **kw)


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
                    what: str, dt=torch.float32, hold_share: bool = True,
                    detail: dict | None = None
                    ) -> tuple[float, float, float, float]:
    """Check the card's state against the CPU's after the same step from
    the same state (each model's .grad holds its step's gradients), with
    the limits above for activation dtype dt (hold_share False: the share
    of real-gradient elements off is returned, not held to
    STEP_FRAC_OFF; detail, where given, gets each parameter's (share,
    elements off, real-gradient elements)). Returns (the largest share of a tensor's
    real-gradient elements off, the largest parameter difference, the
    largest BatchNorm difference over its limit, the largest gradient
    difference over the model's largest gradient)."""
    grads = {k: p.grad for k, p in cpu_model.named_parameters()}
    card_grads = {k: p.grad for k, p in card_model.named_parameters()}
    gmax = max(g.abs().max().item() for g in grads.values())
    floor = max(1e-4, STEP_GRAD_NOISE[dt] * gmax)
    card, cpu = params_of(card_model), params_of(cpu_model)
    worst = top = stat = gworst = 0.0
    for k, v in cpu.items():
        got = card[k].cpu()
        if k.endswith("num_batches_tracked"):
            check(int(got) == int(v), f"{what}: {k} differs")
            continue
        diff = (got.double() - v.double()).abs()
        if "running_" in k:
            over = (diff / (STEP_BN_ATOL[dt] + 2e-3 * v.double().abs())
                    ).max().item()
            stat = max(stat, over)
            check(over <= 1.0, f"{what}: {k} card and CPU differ by "
                  f"{diff.max().item()}")
            continue
        top = max(top, diff.max().item())
        cap = (2.0 * lr * adam_step_bound(step + 1)
               + 2.0 ** -22 * v.abs().max().item())
        check(diff.max().item() <= cap, f"{what}: {k} differs by "
              f"{diff.max().item()} > the Adam envelope {cap}")
        gdiff = (card_grads[k].cpu().double() - grads[k].double()).abs()
        gworst = max(gworst, gdiff.max().item() / gmax)
        check(gdiff.max().item() <= STEP_GRAD_RTOL[dt] * gmax,
              f"{what}: {k} gradient differs by {gdiff.max().item()} "
              f"(the model's largest gradient {gmax})")
        real = grads[k].abs() > floor
        n_real = int(real.sum())
        n_bad = int((diff[real] > 5e-5 + 2e-4 * v.double()[real].abs())
                    .sum())
        worst = max(worst, n_bad / max(n_real, 1))
        if detail is not None:
            detail[k] = (n_bad / max(n_real, 1), n_bad, n_real)
        check(not hold_share
              or n_bad <= max(1, math.ceil(STEP_FRAC_OFF[dt] * n_real)),
              f"{what}: {k} has {n_bad} of its {n_real} real-gradient "
              f"elements off the CPU's")
    return worst, top, stat, gworst


def card_and_cpu(cfg, dev, dps=None):
    """The same seeded model and an Adam on the card and on the CPU (under
    data parallelism each built with its DPGroup of `dps`)."""
    models, opts = {}, {}
    for where in ("card", "cpu"):
        models[where] = build_model(cfg, torch.Generator().manual_seed(
            SEED + 2), dps and dps[where]).to(dev if where == "card"
                                              else "cpu")
        opts[where] = optim.adam_torch(models[where].parameters(),
                                       cfg.weight_decay)
    return models, opts


def card_dropout_masks(model, n: int, cfg, step: int, stream=()) -> list:
    """The keep masks [view i, view j] that a train step of a model on the
    card draws on a batch of n nodes from its own generators
    step_generator(cfg.seed, DROPOUT_STREAM, step, view, *stream) (the
    rank's streams under data parallelism), on the CPU."""
    dev = next(model.parameters()).device
    return [[m.cpu() for m in model.keep_masks(n, step_generator(
        cfg.seed, DROPOUT_STREAM, step, view, *stream, device=dev))]
        for view in (0, 1)]


def card_vs_cpu_steps(models, opts, cfg, batch, dev, bw, first, steps, want,
                      tag, max_waves=0, masks=None, dps=None,
                      part=False) -> dict:
    """`steps` train steps on the card from step `first`; before each, the
    CPU takes the card's state (weights, BatchNorm stats, Adam moments) and
    runs the same step with the same augmentation keys (and the same
    dropout masks, masks(step) -> per-view lists, when given) on its plain
    path: losses within STEP_LOSS_RTOL, parameters and BatchNorm stats as
    state_agreement holds them; every kernel launched as `want` says per
    step (0 if absent). With dropout and no `masks`, the card's step draws
    its masks from its own generators and the CPU replays them
    (card_dropout_masks). Under data parallelism (`dps`: the card's and the
    CPU's DPGroup of this rank; the CPU's None at world 1, where the DP
    step is the one-card step) both run the rank's DP step, its streams
    seeded with the rank; with part, the rank's partitioned step on its
    segment of a giant batch (batch: shard_graph_batch's). Returns the
    report, with the launches totalled."""
    lr = cfg.init_lr
    bg, bc = batch.to(dev), batch.to("cpu")
    report = {"losses": [], "counts": [], "fraction_off": [],
              "grad_off": [], "max_param_diff": [],
              "running_stats_over_limit": []}
    totals = dict.fromkeys(ALL_FNS, 0)
    for step in range(first, first + steps):
        models["cpu"].load_state_dict(
            {k: v.cpu() for k, v in models["card"].state_dict().items()})
        opts["cpu"].load_state_dict(copy.deepcopy(opts["card"].state_dict()))
        mk = masks(step) if masks else None
        stream = () if dps is None else (dps["card"].rank,)
        # what the CPU replays: the given masks or, with dropout, the
        # card's own draws
        replay = mk
        if mk is None and cfg.model.drop_ratio > 0:
            replay = card_dropout_masks(models["card"], bc.num_nodes, cfg,
                                        step, stream)
        reset_counts()
        if part:
            loss_g = partitioned_train_step(
                models["card"], opts["card"], bg, cfg, step, lr,
                dps["card"], bond_window=bw, max_waves=max_waves)
        else:
            loss_g = train_step(models["card"], opts["card"], bg, cfg, step,
                                lr, bond_window=bw, max_waves=max_waves,
                                dropout_masks=mk and [
                                    [m.to(dev) for m in v] for v in mk],
                                dp=dps and dps["card"], stream=stream)
        torch.cuda.synchronize()
        counts = read_counts()
        t0 = time.perf_counter()
        if part:
            loss_c = partitioned_train_step(
                models["cpu"], opts["cpu"], bc, cfg, step, lr, dps["cpu"],
                dropout_masks=replay, bond_window=bw, max_waves=max_waves)
        else:
            loss_c = train_step(models["cpu"], opts["cpu"], bc, cfg, step,
                                lr, bond_window=bw, max_waves=max_waves,
                                dropout_masks=replay, dp=dps and dps["cpu"],
                                stream=stream)
        report["cpu_step_s"] = time.perf_counter() - t0
        report["losses"].append([loss_g.item(), loss_c.item()])
        report["counts"].append(counts)
        for name, c in counts.items():
            check(c == want.get(name, 0), f"{tag} {step}: {name} launched "
                  f"{c} times, expected {want.get(name, 0)}")
            totals[name] += c
        check(abs(loss_g.item() - loss_c.item())
              <= STEP_LOSS_RTOL[models["card"].dtype] * abs(loss_c.item()),
              f"{tag} {step}: loss card {loss_g.item()} cpu {loss_c.item()}")
        worst, top, stat, gworst = state_agreement(
            models["card"], models["cpu"], step, lr, f"{tag} {step}",
            models["card"].dtype)
        report["fraction_off"].append(worst)
        report["grad_off"].append(gworst)
        report["max_param_diff"].append(top)
        report["running_stats_over_limit"].append(stat)
    report["launches"] = totals
    return report


def bit_identical_steps(model, opt, cfg, bg, bw, step, tag, max_waves=0):
    """Two identical card steps from the same state must be bit-identical.
    Returns the state before them and the two (loss, parameters)."""
    snap = (copy.deepcopy(model.state_dict()), copy.deepcopy(
        opt.state_dict()))
    outcomes = []
    for _ in range(2):
        # (load_state_dict keeps the optimizer state's tensors, which the
        # step then updates in place: hand it a copy)
        model.load_state_dict(snap[0])
        opt.load_state_dict(copy.deepcopy(snap[1]))
        loss = train_step(model, opt, bg, cfg, step, cfg.init_lr,
                          bond_window=bw, max_waves=max_waves)
        outcomes.append((loss.clone(), params_of(model)))
    check(torch.equal(outcomes[0][0], outcomes[1][0])
          and all(torch.equal(outcomes[0][1][k], outcomes[1][1][k])
                  for k in outcomes[0][1]),
          f"{tag}: two identical card steps differ")
    return snap, outcomes


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
    want = dict(fused_gine_bn_layer=2 * LAYERS,
                fused_gine_bn_layer_bwd=2 * LAYERS)
    models, opts = card_and_cpu(cfg, dev)
    bg = batch.to(dev)
    report = card_vs_cpu_steps(models, opts, cfg, batch, dev, bw, 0, P_STEPS,
                               want, "step")
    model, opt = models["card"], opts["card"]
    snap, outcomes = bit_identical_steps(model, opt, cfg, bg, bw, P_STEPS,
                                         "step")
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


def speed_phase(batch, spec, dev, card: str, gnn: str = "gin") -> dict:
    """The step's time on the card, f32 and bf16, and a profile of its
    device time by kernel (f32)."""
    bg = batch.to(dev)
    # bench.py's metric: 2 views x layers x (real directed edges +
    # self-loops) of the base batch
    messages = 2 * LAYERS * (int(batch.edge_mask.sum())
                             + int(batch.node_mask.sum()))
    report = {}
    for bf16 in (False, True):
        cfg = pretrain_cfg(bf16=bf16, gnn=gnn)
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
        row = dict(card=card, model=gnn,
                   dtype="bfloat16" if bf16 else "float32",
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


def pass_profile(fn, launches: int = 20) -> dict:
    """Device microseconds per call of each kernel (pass) a wrapper runs,
    from profile_steps over `launches` calls."""
    prof = profile_steps(lambda i: fn(), steps=launches)
    return {t["name"][:60]: 1e3 * t["ms_per_step"] for t in prof["top"]}


def profile_steps(step_fn, steps: int = 5) -> dict:
    """torch.profiler over `steps` calls of step_fn(i): device time per
    kernel name (top 12) and the device's busy share of the window. A
    warm-up phase traces one small kernel and is discarded: the tracer can
    miss the first kernels launched as it starts (one K4f of an eager
    fine-tuning window was missed so), and the window counts launches."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    traces = []
    torch.cuda.synchronize()
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1,
                                                    active=1, repeat=1),
                 on_trace_ready=lambda p: traces.append(
                     p.key_averages())) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for step in range(steps):
            step_fn(step)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.step()
    check(len(traces) == 1, f"profiler: {len(traces)} traces, expected 1")
    rows = []
    for e in traces[0]:
        if getattr(e, "is_user_annotation", False):
            # a record_function range (Optimizer.step#Adam.step) spans
            # kernels counted in their own rows
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.key, us, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    # the port's own kernels by function name, template arguments summed:
    # device ms and launches per step
    port, port_launches = {}, {}
    for k, us, c in rows:
        m = re.search(r"(?:fbl|ntx)::(\w+)", k)
        if m:
            port[m.group(1)] = port.get(m.group(1), 0.0) + us / steps / 1e3
            port_launches[m.group(1)] = (port_launches.get(m.group(1), 0)
                                         + c)
    # torch.stack / torch.cat copies (the lockstep trunk's stacks among
    # them)
    cat_us = sum(us for k, us, _ in rows if "CatArrayBatchedCopy" in k)
    return dict(window_steps=steps, wall_ms_per_step=wall_us / steps / 1e3,
                device_ms_per_step=busy / steps / 1e3,
                cat_ms_per_step=cat_us / steps / 1e3,
                device_busy_share=busy / wall_us if wall_us else None,
                kernels=len(rows),
                top=[dict(name=k[:80], ms_per_step=us / steps / 1e3,
                          launches_per_step=c / steps)
                     for k, us, c in rows[:12]],
                port_ms_per_step=port, port_launches=port_launches)


# ---------------------------------------------------------------- phase 7


@contextlib.contextmanager
def trainers(seen: list):
    """Collect every Pretrainer whose train() runs inside the block (the
    CLI builds its own)."""
    train = Pretrainer.train

    def collecting(self, *args, **kwargs):
        seen.append(self)
        return train(self, *args, **kwargs)

    Pretrainer.train = collecting
    try:
        yield seen
    finally:
        Pretrainer.train = train


def trainer_path(pre) -> str:
    if pre._units:
        return "units"
    return "host" if pre._stack is None else "resident"


def graph_record(pre) -> dict | None:
    """A Pretrainer's CUDA graph: launches captured (those of
    steps_per_replay steps) and replays; None where it ran eager."""
    g = pre.graphed
    if g is None:
        return None
    return dict(steps_per_replay=g.k, replays=g.replays,
                captured=g.launches)


def cli_phase(tmp: str, name: str = "pretrain_ckpt", extra_args=(),
              gnn: str = "gin") -> dict:
    """The pretrain CLI on the card, on its default path (tile-units, each
    step after GRAPH_WARMUP_STEPS replayed as a CUDA graph) into tmp/name
    and with --device-cache-mb 0 (host streaming, eager steps) into
    tmp/name_host."""
    return {path: cli_run(tmp, name if path == "units" else f"{name}_host",
                          [*extra_args, *extra], gnn, path)
            for path, extra in (("units", []),
                                ("host", ["--device-cache-mb", "0"]))}


def cli_run(tmp: str, name: str, extra_args, gnn: str, path: str,
            data: str | None = None) -> dict:
    """Two epochs of a three-epoch schedule, then --resume latest for the
    third (`extra_args` choose the model, the augmentation and the path;
    the checkpoints go to tmp/name), on phase 7's 4,096 synthetic SMILES
    or on `data`, an on-disk corpus. The trainer must take `path`; the
    backward kernel must launch 2 x LAYERS times per eager step and be
    captured 2 x LAYERS times per replayed step (launches = eager steps x
    2 LAYERS + captured x replays)."""
    ckpt = os.path.join(tmp, name)
    source = (["--data", data] if data else
              ["--synthetic", "4096", "--data",
               os.path.join(tmp, "pretrain.txt")])
    base = [*source, "--ckpt-dir", ckpt,
            "--batch-size", str(P_BATCH), "--epochs", "3", "--warm-up", "1",
            "--save-every", "1", *extra_args]
    bwd = ("fused_gine_bn_layer_bwd" if gnn == "gin"
           else "fused_gcn_bn_layer_bwd")
    other = ("fused_gcn_bn_layer_bwd" if gnn == "gin"
             else "fused_gine_bn_layer_bwd")
    report = {}
    for tag, extra in (("first", ["--stop-after-epoch", "2"]),
                       ("resumed", ["--resume", "latest"])):
        seen = []
        reset_counts()
        t0 = time.perf_counter()
        with trainers(seen):
            rc = pretrain_cli.main(base + extra)
        torch.cuda.synchronize()
        report[f"{tag}_s"] = time.perf_counter() - t0
        check(rc == 0, f"pretrain CLI {tag} returned {rc}")
        report[f"{tag}_counts"] = read_counts()
        check(len(seen) == 1, f"{name} {tag}: {len(seen)} trainers")
        report[f"{tag}_path"] = trainer_path(seen[0])
        report[f"{tag}_graph"] = graph_record(seen[0])
        check(report[f"{tag}_path"] == path, f"{name} {tag}: took the "
              f"{report[f'{tag}_path']} path, expected {path}")
        check(isinstance(seen[0].train_iter.graphs, corpus_lib.CorpusSubset)
              == bool(data), f"{name} {tag}: read the wrong source")
        check((report[f"{tag}_graph"] is not None) == (path == "units"),
              f"{name} {tag}: graph {report[f'{tag}_graph']}")
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
    per_step = 2 * LAYERS
    for tag, steps in (("first", 2 * spe), ("resumed", spe)):
        c, g = report[f"{tag}_counts"], report[f"{tag}_graph"]
        replayed = g["replays"] * g["steps_per_replay"] if g else 0
        captured = g["captured"][bwd] if g else 0
        if g:
            check(captured == per_step * g["steps_per_replay"]
                  and replayed > 0,
                  f"{name} {tag}: {bwd} captured {captured} times in a "
                  f"graph of {g['steps_per_replay']} steps")
        want = per_step * (steps - replayed) + captured
        check(c[bwd] == want and c[other] == 0,
              f"{name} {tag}: {bwd} launched {c[bwd]} times for {steps} "
              f"steps ({replayed} replayed), expected {want}; {other} "
              f"{c[other]} times")
        # derived, not measured: the wrappers count once while a graph is
        # captured, never on a replay (eager_vs_graphed and path_speed
        # watch the replays launch the kernels)
        report[f"{tag}_{bwd}_launches_derived"] = (
            f"{steps - replayed} eager steps x {per_step} + {captured} "
            f"captured x {g['replays'] if g else 0} replays = "
            f"{per_step * (steps - replayed) + captured * (g['replays'] if g else 0)}")
    print(f"cli {name} {json.dumps(report)}", flush=True)
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


def unchained_bound_ms(name, x, p, dt, members: int = 1):
    """Least time for an unchained layer's work at these inputs: the dense
    products over the real rows, the adjacency and edge-count products by
    their nonzeros; bytes: each input read once and each output written
    once (K4f's residuals agg and mid are outputs on the training path;
    K5f's x @ W is scratch). With `members` members on one batch (the
    member-axis launch): each member's work and bytes, the adjacency and
    the counts read once."""
    adj, cnt = x["adj"], x["cnt"]
    t, s, _ = adj.shape
    n, d = x["h"].shape
    n_real = int(adj_diag_mask(adj).sum())
    sparse = 2 * int((adj != 0).sum()) * d
    edges = 2 * int((cnt != 0).sum()) * d
    if name.startswith("fused_gine"):
        d2 = p["w1"].shape[1]
        mlp = 2 * 2 * n_real * d * d2
        shared = t * s * s + n * CNT_PAD                  # A, cnt
        weights = 2 * d * d2                              # W1, W2
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
        shared = t * s * s
        if name == "fused_gcn_layer":
            ops, act, f32 = dense + sparse, 2 * n * d + d * d, 0
        else:
            ops = 2 * dense + sparse
            act, f32 = 3 * n * d + d * d, d * d
    t_bytes = (((shared + members * act) * x["h"].element_size()
                + members * f32 * 4) / HBM_BPS)
    t_ops = members * ops / PEAK_FLOPS[dt]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def kernel_case(name, tag, names, run, plain, library, rtol,
                times=(5, 20)):
    """Run a kernel twice and its plain version once on the same inputs:
    the error of each output against its limit, bit-identity, and (unless
    `times` is None; else time_ms's loops and reps) the kernel's, the
    plain version's and the library's times. Returns (case, the kernel's
    outputs)."""
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
    if times:
        case.update(ms=time_ms(run, *times), plain_ms=time_ms(plain, *times),
                    library_ms=time_ms(library, *times))
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
        cases["fused_gcn_layer_bwd"].update(
            passes_us=pass_profile(lambda: fused_gcn_layer_bwd(*gargs)),
            skipped=k5b_skipped(x["adj"], d))
        # K4f and K5f: device us per launch by pass; events ms are set by
        # the host's pace where its time per call is the larger
        for name, kernel, fn in (
                ("fused_gine_layer", "k4f",
                 lambda: fused_gine_layer_fwd(*fargs, residuals=True)),
                ("fused_gcn_layer", "k5f",
                 lambda: fused_gcn_layer_fwd(*cargs))):
            paced(cases[name], fn, unchained_skipped(
                x, d, pg["w1"].shape[1], kernel))
        # K4b likewise, with the strips and chunks its passes skip
        paced(cases["fused_gine_layer_bwd"],
              lambda: fused_gine_layer_bwd(*bargs),
              gine_bwd_skipped(g, x["adj"], pg["w1"].shape[1], dt))
        for name, case in cases.items():
            case["bound_ms"], case["bound_by"] = unchained_bound_ms(
                name, x, pg if name.startswith("fused_gine") else pc, dt)
            print(f"kernel {name} {json.dumps(case)}", flush=True)
            first = next(k for k in case if k.startswith("err_"))
            r = res[name]
            r["max_abs_err"] = max(r["max_abs_err"], case[first])
            r["cases"].append(case)
    return res


# phase 8's member-axis cases: the ensembles' member counts (BBBP 3 seeds,
# ClinTox 2 targets x 3 seeds)
MEMBER_COUNTS = (3, 6)
GINE_PARAMS = ("etab", "w1", "b1", "w2", "b2")


def gine_members_library(h, adj, cnt, etab, w1, b1, w2, b2):
    """K4f's function over M members as batched cuBLAS calls, the adjacency
    broadcast over the members (yardstick only; the port never calls
    it)."""
    m, n, d = h.shape
    t, s, _ = adj.shape
    agg = torch.matmul(adj, h.view(m, t, s, d)).view(m, n, d)
    agg = torch.baddbmm(agg, cnt.expand(m, -1, -1), etab)
    mid = torch.baddbmm(b1[:, None].to(h.dtype), agg, w1).relu_()
    return torch.baddbmm(b2[:, None].to(h.dtype), mid, w2), agg, mid


def gine_members_bwd_library(g, adj, cnt, agg, mid, w1, w2):
    """K4b's function over M members as batched cuBLAS calls (yardstick
    only)."""
    m, n, d = g.shape
    t, s, _ = adj.shape
    dmid = torch.bmm(g, w2.transpose(1, 2)).mul_(mid > 0)
    dagg = torch.bmm(dmid, w1.transpose(1, 2))
    dh = torch.matmul(adj, dagg.view(m, t, s, d)).view(m, n, d)
    return (dh, torch.bmm(agg.transpose(1, 2), dmid), dmid.float().sum(1),
            torch.bmm(mid.transpose(1, 2), g), g.float().sum(1),
            torch.matmul(cnt.t(), dagg))


def gcn_members_library(x, adj, w):
    """K5f's function over M members, two batched cuBLAS calls (yardstick
    only)."""
    m, n, d = x.shape
    t, s, _ = adj.shape
    return torch.matmul(adj, torch.bmm(x, w).view(m, t, s, d)).view(m, n, d)


def gcn_members_bwd_library(g, x, adj, w):
    """K5b's function over M members (yardstick only)."""
    m, n, d = g.shape
    t, s, _ = adj.shape
    dxw = torch.matmul(adj, g.view(m, t, s, d)).view(m, n, d)
    return torch.bmm(dxw, w.transpose(1, 2)), torch.bmm(x.transpose(1, 2),
                                                         dxw)


def graph_ms(fn) -> float:
    """time_ms of fn captured as a CUDA graph and replayed: the device's
    time for its launches without the host's pace (as the graphed steps
    run them)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay)


def member_case(name, tag, names, run, loop, plain, library, rtol):
    """A member-axis launch run twice, the loop of one-member launches it
    replaces and the plain version (member by member) on the same inputs:
    each output within rtol of the plain version's max, member m's output
    equal to its one-member launch's bit for bit, two runs bit-identical;
    the member launch's, the loop's, the plain version's and the
    library's times, and the launch's and the loop's replayed as CUDA
    graphs (graph_ms: the loop's eager time is paced by the host's M
    wrapper calls). Returns (case, the launch's outputs)."""
    got, again, want = _tuple(run()), _tuple(run()), _tuple(plain())
    one = [_tuple(o) for o in loop()]
    torch.cuda.synchronize()
    case = dict(tag, bit_identical=all(torch.equal(u, v)
                                       for u, v in zip(got, again)),
                equal_to_single_launches=all(
                    torch.equal(u[i], one[i][j]) for j, u in enumerate(got)
                    for i in range(len(one))))
    for out, u, v in zip(names, got, want):
        check(u.dtype == v.dtype and u.shape == v.shape,
              f"{name} {tag}: {out} is {u.dtype} {tuple(u.shape)}, the "
              f"plain version's {v.dtype} {tuple(v.shape)}")
        err, top = rel_err(u, v)
        case[f"err_{out}"], case[f"lim_{out}"] = err, rtol * top
    case.update(ms=time_ms(run), loop_ms=time_ms(loop),
                graph_ms=graph_ms(run), loop_graph_ms=graph_ms(loop),
                plain_ms=time_ms(plain), library_ms=time_ms(library))
    for out in names:
        check(case[f"err_{out}"] <= case[f"lim_{out}"],
              f"{name} {tag}: {out} error {case[f'err_{out}']} > "
              f"{case[f'lim_{out}']}")
    check(case["bit_identical"], f"{name} {tag}: two runs differ")
    check(case["equal_to_single_launches"], f"{name} {tag}: a member's "
          f"output differs from its one-member launch's")
    return case, got


def member_kernel_phase(batch, dev) -> dict:
    """K4f with residuals, K4b, K5f and K5b with their member grid axis at
    the fine-tuning shape, M = 3 and 6 members (each its own features,
    weights and cotangent, zero on padded rows; the adjacency and the
    counts shared), f32 and bf16 (member_case): one launch against M
    one-member launches bit for bit and the plain version within
    KERNEL_RTOL; its time against the M-launch loop's; the bound of the M
    members' work with the adjacency read once."""
    gen = torch.Generator().manual_seed(SEED + 6)
    res = {name: {"max_abs_err": 0.0, "cases": []} for name in MEMBER_KERNELS}
    for dt in (torch.float32, torch.bfloat16):
        for m in MEMBER_COUNTS:
            members = [layer_inputs(batch, dt, gen) for _ in range(m)]
            x0, pg0, pc0 = members[0]
            adj, cnt = x0["adj"], x0["cnt"]
            mask = adj_diag_mask(adj)
            n, d = x0["h"].shape
            h = torch.stack([(x["h"].float() * mask).to(dt)
                             for x, _, _ in members])
            g = torch.stack([((0.1 * torch.randn(n, d, generator=gen))
                              .to(dev) * mask).to(dt) for _ in range(m)])
            pg = {k: torch.stack([p[k] for _, p, _ in members])
                  for k in GINE_PARAMS}
            w = torch.stack([p["w"] for _, _, p in members])
            tag = dict(dtype=str(dt).replace("torch.", ""), members=m,
                       tiles=adj.shape[0], d=d)
            rtol = KERNEL_RTOL[dt]
            fargs = (h, adj, cnt, *(pg[k] for k in GINE_PARAMS))
            cases = {}
            cases["fused_gine_layer_members"], (_, agg, mid) = member_case(
                "K4f members", tag, ("out", "agg", "mid"),
                lambda: fused_gine_layer_members_fwd(*fargs, residuals=True),
                lambda: [fused_gine_layer_fwd(
                    h[i], adj, cnt, *(pg[k][i] for k in GINE_PARAMS),
                    residuals=True) for i in range(m)],
                lambda: fused_gine_layer_members_fwd_plain(*fargs),
                lambda: gine_members_library(*fargs), rtol)
            bargs = (g, adj, cnt, agg, mid, pg["w1"], pg["w2"])
            cases["fused_gine_layer_members_bwd"], _ = member_case(
                "K4b members", tag, ("dh", "dw1", "db1", "dw2", "db2",
                                     "detab"),
                lambda: fused_gine_layer_members_bwd(*bargs),
                lambda: [fused_gine_layer_bwd(
                    g[i], adj, cnt, agg[i], mid[i], pg["w1"][i],
                    pg["w2"][i]) for i in range(m)],
                lambda: fused_gine_layer_members_bwd_plain(*bargs),
                lambda: gine_members_bwd_library(*bargs), rtol)
            cases["fused_gcn_layer_members"], _ = member_case(
                "K5f members", tag, ("out",),
                lambda: fused_gcn_layer_members_fwd(h, adj, w),
                lambda: [fused_gcn_layer_fwd(h[i], adj, w[i])
                         for i in range(m)],
                lambda: fused_gcn_layer_members_plain(h, adj, w),
                lambda: gcn_members_library(h, adj, w), rtol)
            cases["fused_gcn_layer_members_bwd"], _ = member_case(
                "K5b members", tag, ("dx", "dw"),
                lambda: fused_gcn_layer_members_bwd(g, h, adj, w),
                lambda: [fused_gcn_layer_bwd(g[i], h[i], adj, w[i])
                         for i in range(m)],
                lambda: fused_gcn_layer_members_bwd_plain(g, h, adj, w),
                lambda: gcn_members_bwd_library(g, h, adj, w), rtol)
            one = dict(x0, h=h[0])
            for name, case in cases.items():
                spec = MEMBER_KERNELS[name]
                case["bound_ms"], case["bound_by"] = unchained_bound_ms(
                    spec["counter"], one,
                    pg0 if spec["model"] == "gin" else pc0, dt, m)
                print(f"kernel {name} {json.dumps(case)}", flush=True)
                first = next(k for k in case if k.startswith("err_"))
                r = res[name]
                r["max_abs_err"] = max(r["max_abs_err"], case[first])
                r["cases"].append(case)
    return res


# the wide layers the layer kernels are held at, on WIDE_MOLS molecules of
# the fine-tuning stand-in: (D, tile, timed) with D2 = 2 D. D = 2,048 at
# tiles 128 and 256 (the f32 one-launch K1f stops at about D = 1,037 at S =
# 128, and the [16, D2] operands of K4f's out launch and the dagg launch at
# about D2 = 3,000: there K1f splits into its streamed agg, mid and out
# launches and those operands stream in K-chunks); D = 3,000 (not a multiple of 32) at tile 128 and D = 4,096 at
# tile 256, past f32 D = 2,752, where every [16, D] operand streams too
# (K4f's and the split K1f's agg, K5f's / K3f's x, K5b's / K3b's dxw,
# K1b's / K4b's gtc); there the member-axis K4f / K4b / K5f / K5b as well
# (M = WIDE_MEMBERS, checked, not timed)
WIDE_MOLS, WIDE_MEMBERS = 32, 2
WIDE_SHAPES = ((2048, 128, False), (2048, TILE, True), (3000, 128, True),
               (4096, TILE, True))


def wide_calls(x, pg, pc, g, dsums, dt) -> dict:
    """{kernel: (output names, kernel call, plain call, library call,
    (bound ms, bound by))} of the eight layer kernels on one problem,
    relu_in True where a prologue exists; the backward kernels take the
    plain forward's outputs as their residuals."""
    h, a, b, adj, cnt = (x[k] for k in ("h", "a", "b", "adj", "cnt"))
    gargs, cargs = gine_args(x, pg), gcn_args(x, pc)
    uargs = (h, adj, cnt, pg["etab"], pg["w1"], pg["b1"], pg["w2"], pg["b2"])
    out, _, agg, mid = fused_gine_bn_layer_fwd_plain(*gargs, True)
    k1b = (g, dsums, h, a, b, adj, cnt, agg, mid, out, pg["w1"], pg["w2"],
           True)
    cout, _ = fused_gcn_bn_layer_plain(*cargs, True)
    k3b = (g, dsums, h, a, b, adj, cnt, cout, pc["w"], True)
    _, uagg, umid = fused_gine_layer_fwd_plain(*uargs)
    k4b = (g, adj, cnt, uagg, umid, pg["w1"], pg["w2"])
    k5 = (h, adj, pc["w"])
    k5b = (g, h, adj, pc["w"])
    return {
        "fused_gine_bn_layer": (
            ("out", "sums", "agg", "mid"),
            lambda: fused_gine_bn_layer_fwd(*gargs, True, residuals=True),
            lambda: fused_gine_bn_layer_fwd_plain(*gargs, True),
            lambda: gine_library(*gargs, True),
            bound_ms("fused_gine_bn_layer", x, pg, dt)),
        "fused_gine_bn_layer_bwd": (
            ("dh", "da", "db", "dw1", "db1", "dw2", "db2", "detab"),
            lambda: fused_gine_bn_layer_bwd(*k1b),
            lambda: fused_gine_bn_layer_bwd_plain(*k1b),
            lambda: gine_bwd_library(*k1b), k1b_bound_ms(x, pg, dt)),
        "fused_gcn_bn_layer": (
            ("out", "sums"), lambda: fused_gcn_bn_layer(*cargs, True),
            lambda: fused_gcn_bn_layer_plain(*cargs, True),
            lambda: gcn_library(*cargs, True),
            bound_ms("fused_gcn_bn_layer", x, pc, dt)),
        "fused_gcn_bn_layer_bwd": (
            ("dx", "da", "db", "dw", "dbias", "detab"),
            lambda: fused_gcn_bn_layer_bwd(*k3b),
            lambda: fused_gcn_bn_layer_bwd_plain(*k3b),
            lambda: gcn_bwd_library(*k3b), k3b_bound_ms(x, pc, dt)),
        "fused_gine_layer": (
            ("out", "agg", "mid"),
            lambda: fused_gine_layer_fwd(*uargs, residuals=True),
            lambda: fused_gine_layer_fwd_plain(*uargs),
            lambda: gine_unchained_library(*uargs),
            unchained_bound_ms("fused_gine_layer", x, pg, dt)),
        "fused_gine_layer_bwd": (
            ("dh", "dw1", "db1", "dw2", "db2", "detab"),
            lambda: fused_gine_layer_bwd(*k4b),
            lambda: fused_gine_layer_bwd_plain(*k4b),
            lambda: gine_unchained_bwd_library(*k4b),
            unchained_bound_ms("fused_gine_layer_bwd", x, pg, dt)),
        "fused_gcn_layer": (
            ("out",), lambda: fused_gcn_layer_fwd(*k5),
            lambda: fused_gcn_layer_plain(*k5),
            lambda: gcn_unchained_library(*k5),
            unchained_bound_ms("fused_gcn_layer", x, pc, dt)),
        "fused_gcn_layer_bwd": (
            ("dx", "dw"), lambda: fused_gcn_layer_bwd(*k5b),
            lambda: fused_gcn_layer_bwd_plain(*k5b),
            lambda: gcn_unchained_bwd_library(*k5b),
            unchained_bound_ms("fused_gcn_layer_bwd", x, pc, dt)),
    }


def wide_member_calls(batch, dt, gen, d: int, tile: int,
                      m: int = WIDE_MEMBERS) -> dict:
    """{kernel: (output names, kernel call, plain call)} of the member-axis
    K4f / K4b / K5f / K5b on m members' inputs at width d (the adjacency
    and counts shared, features and cotangents zero on padded rows)."""
    members = [layer_inputs(batch, dt, gen, d, tile) for _ in range(m)]
    adj, cnt = members[0][0]["adj"], members[0][0]["cnt"]
    mask = adj_diag_mask(adj)
    dev = adj.device
    h = torch.stack([(x["h"].float() * mask).to(dt) for x, _, _ in members])
    g = torch.stack([((0.1 * torch.randn(*x["h"].shape, generator=gen))
                      .to(dev) * mask).to(dt) for x, _, _ in members])
    pg = [torch.stack([p[k] for _, p, _ in members]) for k in GINE_PARAMS]
    w = torch.stack([p["w"] for _, _, p in members])
    _, agg, mid = fused_gine_layer_members_fwd_plain(h, adj, cnt, *pg)
    k4b = (g, adj, cnt, agg, mid, pg[1], pg[3])
    return {
        "fused_gine_layer_members": (
            ("out", "agg", "mid"),
            lambda: fused_gine_layer_members_fwd(h, adj, cnt, *pg,
                                                 residuals=True),
            lambda: fused_gine_layer_members_fwd_plain(h, adj, cnt, *pg)),
        "fused_gine_layer_members_bwd": (
            ("dh", "dw1", "db1", "dw2", "db2", "detab"),
            lambda: fused_gine_layer_members_bwd(*k4b),
            lambda: fused_gine_layer_members_bwd_plain(*k4b)),
        "fused_gcn_layer_members": (
            ("out",), lambda: fused_gcn_layer_members_fwd(h, adj, w),
            lambda: fused_gcn_layer_members_plain(h, adj, w)),
        "fused_gcn_layer_members_bwd": (
            ("dx", "dw"), lambda: fused_gcn_layer_members_bwd(g, h, adj, w),
            lambda: fused_gcn_layer_members_bwd_plain(g, h, adj, w)),
    }


def wide_kernel_phase(dev) -> list:
    """The eight layer kernels at each of WIDE_SHAPES (D, D2 = 2 D, the
    tile) on WIDE_MOLS molecules, f32 and bf16 (kernel_case): each within
    KERNEL_RTOL of its plain version, two runs bit-identical, and where
    timed the kernel's, the plain version's and the library's times
    beside the bound; K1f's rows per block and whether it split; past D =
    2,048 the member-axis kernels too (checked)."""
    graphs, _ = featurize_many(synthetic_corpus(WIDE_MOLS, seed=SEED))
    gen = torch.Generator().manual_seed(SEED + 7)
    cases = []
    for d, tile, timed in WIDE_SHAPES:
        batch = pack_batch(graphs, spec_for_graphs(graphs, WIDE_MOLS,
                                                   tile=tile)).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            x, pg, pc = layer_inputs(batch, dt, gen, d, tile)
            n = x["h"].shape[0]
            g = (0.1 * torch.randn(n, d, generator=gen)).to(dev, dt)
            dsums = (0.05 * torch.randn(2, d, generator=gen)).to(dev)
            tag = dict(dtype=str(dt).replace("torch.", ""), tile=tile,
                       tiles=x["adj"].shape[0], d=d, d2=2 * d)
            calls = wide_calls(x, pg, pc, g, dsums, dt)
            for name, (names, run, plain, library, bound) in calls.items():
                case, _ = kernel_case(name, dict(tag, kernel=name), names,
                                      run, plain, library, KERNEL_RTOL[dt],
                                      times=(3, 3) if timed else None)
                if timed:
                    case["bound_ms"], case["bound_by"] = bound
                if name == "fused_gine_bn_layer":
                    case.update(block_rows=k1f_block_rows(dt, tile, d, 2 * d),
                                split=k1f_splits(dt, tile, d, 2 * d))
                print(f"wide {json.dumps(case)}", flush=True)
                cases.append(case)
            del x, pg, pc, calls
            if d <= 2048:
                continue
            for name, (names, run, plain) in wide_member_calls(
                    batch, dt, gen, d, tile).items():
                case, _ = kernel_case(
                    name, dict(tag, kernel=name, members=WIDE_MEMBERS),
                    names, run, plain, None, KERNEL_RTOL[dt], times=None)
                print(f"wide {json.dumps(case)}", flush=True)
                cases.append(case)
    return cases


# ---------------------------------------------------------------- phase 9


def finetune_cfg(tmp: str, gnn: str = "gin", motifs: bool = False,
                 bf16: bool = False, **kw) -> FineTuneConfig:
    """configs/finetune.yaml's fine-tuning run (BBBP, batch 32, 5 x 300 /
    512, drop 0.3, pred head 2 x softplus, tile 256) on the synthetic
    stand-in fabricated under tmp; kw sets FineTuneConfig fields
    (task_name, n_seeds)."""
    return FineTuneConfig(
        data_root=os.path.join(tmp, "data"), synthetic_fallback=True,
        batch_size=FT_BATCH, ckpt_dir=os.path.join(tmp, "ft_runs"),
        use_motifs=motifs, model=ModelConfig(
            gnn_type=gnn, num_layers=LAYERS, emb_dim=EMB, feat_dim=FEAT,
            drop_ratio=0.3, tile=TILE, bf16=bf16), **kw)


def finetuner(cfg, dev, shared: dict, targets=None):
    """A FineTuner of cfg set up on the card, its task's featurization
    shared through `shared` (task name -> SharedTaskData)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # synthetic stand-in
        if cfg.task_name not in shared:
            shared[cfg.task_name] = ft_lib.SharedTaskData(
                cfg, TASKS[cfg.task_name])
    return ft_lib.FineTuner(cfg, dev, targets=targets).setup_data(
        shared=shared[cfg.task_name]).setup_state()


def on_cpu(batch) -> GraphBatch:
    """A GraphBatch of device tensors copied to the CPU."""
    return GraphBatch(**{k: v.cpu() for k, v in vars(batch).items()})


def train_rows(ft) -> torch.Tensor:
    """The train stack filled for an epoch and its order as [S, 1] rows
    on the card."""
    _, order = ft._train_epoch_stack()
    return torch.from_numpy(np.asarray(order, np.int64)[:, None]).to(
        ft.device)


def eval_agreement(ft, cpu_model, gnn: str, tag: str):
    """The eval path (drop 0.3 in eval mode: K4f / K5f without residuals)
    on the validation stack's first batch ('max' sizing), on the card and
    on the CPU from the card's state: predictions within SLICE_RTOL, and
    one forward launch per layer. Returns (max error, the batch's
    tiles)."""
    stack = ft._split_stack("valid")
    batch, _, mot = ft._take(stack, torch.zeros(1, dtype=torch.long,
                                                device=ft.device))
    cpu_model.load_state_dict(
        {k: v.cpu() for k, v in ft.model.state_dict().items()})
    reset_counts()
    pred_g = ft_lib.predict([ft.model], batch, mot)[0]
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: LAYERS for k, v in FT_KERNELS.items()
            if v["model"] == gnn and not k.endswith("_bwd")}
    for name, c in counts.items():
        check(c == want.get(name, 0), f"{tag} eval: {name} launched {c} "
              f"times, expected {want.get(name, 0)}")
    pred_c = ft_lib.predict([cpu_model], on_cpu(batch),
                            tuple(m.cpu() for m in mot))[0]
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


def members_vs_cpu(ft, idx, tag: str, want: dict, step: int = 0) -> dict:
    """One step of all of ft's members on the train stack's row idx on the
    card, and of CPU copies of them (the card's state and Adam moments)
    with the same dropout masks: each member's loss within
    STEP_LOSS_RTOL, its state as state_agreement holds it; the kernels
    launched as `want` says (0 if absent)."""
    cfg = ft.cfg
    lr = max(cfg.init_lr, cfg.init_base_lr)
    batch, lab, mot = ft._take(ft._stacks["train"], idx)
    cpu_models = [copy.deepcopy(m).to("cpu") for m in ft.models]
    cpu_opt = optim.two_group_adam(cpu_models, cfg.init_lr,
                                   cfg.init_base_lr, cfg.weight_decay)
    load_optimizer_state(cpu_opt, copy.deepcopy(ft.opt.state_dict()))
    masks = [[torch.rand(batch.nbr.shape[0], EMB, generator=gen) < 0.7
              for _ in range(LAYERS)] for gen in (
        torch.Generator().manual_seed(SEED + 5 + 1000 * step + s)
        for s in range(cfg.n_seeds))]
    reset_counts()
    loss_g = ft_lib.train_step(ft.models, ft.opt, batch, lab, mot,
                               ft.task.loss, [[m.to(ft.device) for m in ms]
                                              for ms in masks],
                               cfg.n_seeds)
    torch.cuda.synchronize()
    counts = read_counts()
    loss_c = ft_lib.train_step(cpu_models, cpu_opt, on_cpu(batch),
                               lab.cpu(), tuple(m.cpu() for m in mot),
                               ft.task.loss, masks, cfg.n_seeds)
    for name, c in counts.items():
        check(c == want.get(name, 0), f"{tag} step {step}: {name} "
              f"launched {c} times, expected {want.get(name, 0)}")
    row = dict(losses=[loss_g.tolist(), loss_c.tolist()], counts=counts,
               fraction_off=[], grad_off=[], max_param_diff=[],
               running_stats_over_limit=[])
    for m, (card, cpu) in enumerate(zip(ft.models, cpu_models)):
        g, c = float(loss_g[m]), float(loss_c[m])
        check(abs(g - c) <= STEP_LOSS_RTOL[card.dtype] * abs(c),
              f"{tag} step {step} member {m}: loss card {g} cpu {c}")
        worst, top, stat, gworst = state_agreement(
            card, cpu, step, lr, f"{tag} step {step} member {m}",
            card.dtype)
        row["fraction_off"].append(worst)
        row["grad_off"].append(gworst)
        row["max_param_diff"].append(top)
        row["running_stats_over_limit"].append(stat)
    return row


def finetune_step_phase(dev, tmp: str, shared: dict) -> dict:
    """3 fine-tuning steps on the card for GIN, GCN and GIN with the motif
    head, each on a row of the resident train stack; before each, the CPU
    takes the card's state (weights, BatchNorm stats, Adam moments) and
    runs the same step with the same dropout masks on its plain path.
    Launch counts per step."""
    report = {}
    totals = dict.fromkeys(ALL_FNS, 0)
    for gnn, motifs in (("gin", False), ("gcn", False), ("gin", True)):
        tag = gnn + ("_motifs" if motifs else "")
        ft = finetuner(finetune_cfg(tmp, gnn, motifs), dev, shared)
        rows = train_rows(ft)
        row = {"motif_vocab": ft.motif_vocab.size if motifs else 0}
        if motifs:
            row["motif_table_err"] = motif_table_agreement(
                ft, copy.deepcopy(ft.model).to("cpu"), tag)
        want = {k: LAYERS for k, v in FT_KERNELS.items()
                if v["model"] == gnn}
        steps = [members_vs_cpu(ft, rows[step], tag, want, step)
                 for step in range(FT_STEPS)]
        for k in ("losses", "counts", "fraction_off", "grad_off",
                  "max_param_diff", "running_stats_over_limit"):
            row[k] = [st[k] for st in steps]
        for st in steps:
            for name, c in st["counts"].items():
                totals[name] += c
        row["eval_err"], row["eval_tiles"] = eval_agreement(
            ft, copy.deepcopy(ft.model).to("cpu"), gnn, tag)
        report[tag] = row
        print(f"finetune step {tag} {json.dumps(row)}", flush=True)
    report["launches"] = totals
    return report


def device_item(ft, batch, lab, idx):
    """A host train batch of ft's iterator on the card as the FineTuner
    uploaded it per step before its stacks: (batch, labels [G],
    motifs)."""
    labp = np.zeros(ft.spec.n_graphs, np.float32)
    labp[: len(lab)] = lab
    mot = ()
    if ft.cfg.use_motifs:
        mi, mm = ft._batch_motifs("train", idx)
        mot = (torch.from_numpy(mi.astype(np.int64)).to(ft.device),
               torch.from_numpy(mm).to(ft.device))
    return batch.to(ft.device), torch.from_numpy(labp).to(ft.device), mot


def ft_stepper(ft, path: str):
    """run(i): step i of a path, all of ft's members. 'host': a packed host
    batch uploaded per step and an eager step with the plain (not
    capturable) Adam, the FineTuner's path before its stacks; 'resident
    eager' / 'resident_graphed': the train stack's rows through
    _run_steps, eager or replayed."""
    if path == "host":
        cfg = ft.cfg
        items = []
        for item in ft.iters["train"]:
            items.append(item)
        opt = optim.two_group_adam(ft.models, cfg.init_lr,
                                   cfg.init_base_lr, cfg.weight_decay)

        def run(i):
            batch, lab, mot = device_item(ft, *items[i % len(items)])
            return ft_lib.train_step(ft.models, opt, batch, lab, mot,
                                     ft.task.loss,
                                     ft.seed_masks(batch.num_nodes),
                                     cfg.n_seeds)
        return run
    ft.graphed = path == "resident_graphed"
    rows = train_rows(ft)

    def run(i):
        j = i % rows.shape[0]
        return ft._run_steps(rows[j: j + 1])
    return run


def ft_path_speed(ft, path: str, card: str, tag: str) -> dict:
    """One fine-tuning path's step on the card (ft_stepper), WARM_STEPS
    steps first: CUDA events and host clock marks at each step's end;
    step_ms the median of the events' gaps over SPEED_STEPS steps, host_ms
    the median of the host's (its time to queue a step while the device
    keeps up); a torch.profiler breakdown of PROFILED_STEPS more steps:
    device ms and busy share, the port's kernels per step."""
    run = ft_stepper(ft, path)
    for i in range(WARM_STEPS):
        run(i)
    torch.cuda.synchronize()
    marks = []
    for i in range(WARM_STEPS, WARM_STEPS + SPEED_STEPS + 1):
        loss = run(i)
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((e, time.perf_counter()))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(loss).all()), f"{tag} {path}: loss {loss}")
    gaps = [(a[0].elapsed_time(b[0]), 1e3 * (b[1] - a[1]))
            for a, b in zip(marks, marks[1:])]
    ms = statistics.median(g[0] for g in gaps)
    prof = profile_steps(lambda i: run(100 + i), steps=PROFILED_STEPS)
    mols = FT_BATCH
    row = dict(card=card, tag=tag, path=path, model=ft.cfg.model.gnn_type,
               dtype="bfloat16" if ft.cfg.model.bf16 else "float32",
               members=ft.n_members, steps=SPEED_STEPS, step_ms=ms,
               host_ms=statistics.median(g[1] for g in gaps),
               mol_per_s=mols / (ms / 1e3),
               device_ms=prof["device_ms_per_step"],
               device_busy_share=prof["device_busy_share"],
               port_launches_per_step={
                   k: c / prof["window_steps"]
                   for k, c in prof["port_launches"].items()},
               profile=prof)
    if path == "resident_graphed":
        row["graph"] = dict(replays=ft._train_graph.replays,
                            captured=ft._train_graph.launches)
    print(f"finetune speed {json.dumps(row)}", flush=True)
    return row


def finetune_speed_phase(dev, tmp: str, card: str, shared: dict) -> dict:
    """The fine-tuning step's time on the card for GIN f32, GCN f32 and GIN
    bf16 on three paths (ft_path_speed): the host path, resident eager and
    resident graphed, one after the other on one FineTuner; the port's
    kernels per replayed step as per eager step; then an eval batch's
    forward (events ms, the host's ms to queue one) and the whole
    validation split eager against one replay (host ms to the predictions
    on the host)."""
    report = {}
    for gnn, bf16 in (("gin", False), ("gcn", False), ("gin", True)):
        tag = f"{gnn}_{'bfloat16' if bf16 else 'float32'}"
        ft = finetuner(finetune_cfg(tmp, gnn, bf16=bf16), dev, shared)
        rows = {path: ft_path_speed(ft, path, card, tag)
                for path in ("host", "resident_eager", "resident_graphed")}
        launches_agree(f"finetune speed {tag}",
                       rows["resident_eager"]["port_launches_per_step"],
                       rows["resident_graphed"]["port_launches_per_step"])
        stack = ft._split_stack("valid")
        ebatch, _, emot = ft._take(stack, torch.zeros(
            1, dtype=torch.long, device=dev))
        ft.predictions("valid")                      # capture
        split_eager = host_us(lambda: ft._predict_split("valid").cpu(),
                              reps=10) / 1e3
        split_graphed = host_us(lambda: ft.predictions("valid"),
                                reps=10) / 1e3
        rows["eval"] = dict(
            card=card, tag=tag, eval_tiles=ebatch.nbr.shape[0] // TILE,
            eval_batches=int(stack.labels.shape[0]),
            eval_batch_ms=time_ms(lambda: ft_lib.predict(
                ft.models, ebatch, emot)),
            eval_host_ms=host_us(lambda: ft_lib.predict(
                ft.models, ebatch, emot)) / 1e3,
            split_eager_ms=split_eager, split_graphed_ms=split_graphed)
        if not bf16:
            rows["eval"]["eval_profile"] = profile_steps(
                lambda i: ft_lib.predict(ft.models, ebatch, emot), steps=20)
        print(f"finetune eval {json.dumps(rows['eval'])}", flush=True)
        report[tag] = rows
    return report


# ------------------------------------------------------------ phase 9b

# the seed ensembles: (tag, task, targets, model) of BBBP with 3 seeds (GIN
# and GCN) and ClinTox 2 targets x 3 seeds (GIN)
ENSEMBLES = (("bbbp_3_seeds", "BBBP", None, "gin"),
             ("clintox_2x3", "ClinTox", ["CT_TOX", "FDA_APPROVED"], "gin"),
             ("gcn_bbbp_3_seeds", "BBBP", None, "gcn"))
# the first steps of an ensemble, held bit for bit to its members stepped
# alone
ALONE_STEPS = 2


def ft_state(ft) -> dict:
    """Copies of every member's parameters and BatchNorm stats and of the
    Adam moments and step counts."""
    out = {f"m{i}.{k}": v for i, st in enumerate(ft.member_states())
           for k, v in st.items()}
    out.update({f"adam.{i}.{k}": v.clone() for i, st in
                ft.opt.state_dict()["state"].items() for k, v in st.items()})
    return out


def members_alone(ft, rows, tag: str) -> dict:
    """ALONE_STEPS eager steps of all of ft's members from their fresh
    state (the lockstep trunk: one member-axis launch of each layer kernel
    per layer) against each member stepped alone on the same rows with its
    seed's dropout masks (one-member launches) under an Adam of its own:
    losses, parameters and BatchNorm stats bit for bit."""
    cfg = ft.cfg
    check(not ft.opt.state_dict()["state"], f"{tag}: not a fresh state")
    alone = [copy.deepcopy(model) for model in ft.models]
    opts = [optim.two_group_adam([model], cfg.init_lr, cfg.init_base_lr,
                                 cfg.weight_decay, capturable=True)
            for model in alone]
    losses = []
    for step in range(ALONE_STEPS):
        batch, lab, mot = ft._take(ft._stacks["train"], rows[step])
        masks = ft.seed_masks(batch.num_nodes)
        together = ft_lib.train_step(ft.models, ft.opt, batch, lab, mot,
                                     ft.task.loss, masks, cfg.n_seeds)
        for m, (model, opt) in enumerate(zip(alone, opts)):
            t, s = divmod(m, cfg.n_seeds)
            one = ft_lib.train_step(
                [model], opt, batch, lab[:, t] if lab.dim() == 2 else lab,
                mot, ft.task.loss, None if masks is None else [masks[s]])
            check(torch.equal(one[0], together[m]),
                  f"{tag} step {step} member {m}: loss {together[m]} "
                  f"stepped alone {one[0]}")
        losses.append(together.tolist())
    differ = [f"m{m}.{k}" for m, (a, b) in enumerate(zip(ft.models, alone))
              for k, v in a.state_dict().items()
              if not torch.equal(v, b.state_dict()[k])]
    check(not differ, f"{tag}: the ensemble's state differs from its "
          f"members' stepped alone in {differ}")
    return dict(steps=ALONE_STEPS, bit_identical=True, losses=losses)


def stack_ms(ft, idx) -> float:
    """Device ms of the stacks that one lockstep step makes, timed alone as
    a replayed CUDA graph (graph_ms, as the graphed step runs them) at
    the batch of the train stack's row idx: per layer the members' inputs
    and kernel parameters stacked for the member-axis call and the
    members' output gradients stacked in the backward (unbind's
    adjoint)."""
    batch, _, _ = ft._take(ft._stacks["train"], idx)
    model = ft.models[0]
    dt, gin = model.dtype, model.gnn_type == "gin"
    hs = [torch.zeros(batch.nbr.shape[0], model.emb_dim, dtype=dt,
                      device=ft.device) for _ in ft.models]
    layers = [[m.gnns[i] for m in ft.models] for i in range(LAYERS)]

    @torch.no_grad()
    def run():
        for convs in layers:
            torch.stack(hs)
            if gin:
                for x in zip(*(c.kernel_params(dt) for c in convs)):
                    torch.stack(x)
            else:
                torch.stack([c.weight.to(dt) for c in convs])
            torch.stack(hs)
    return graph_ms(run)


def ft_eager_vs_graphed(ft, rows, tag: str) -> dict:
    """EQUAL_STEPS steps of all members run eagerly and, from the same
    state, Adam moments and dropout generator states, through the graph
    (after GRAPH_WARMUP_STEPS eager steps): losses, parameters, BatchNorm
    stats and Adam moments bit-identical. The wrappers' counts of the
    capture are one step's, LAYERS per layer kernel (one member-axis launch
    a layer); the profiler, over the last PROFILED_STEPS steps of each run,
    counts the port's kernels per replayed step as per eager step, LAYERS
    launches of each layer kernel's first pass."""
    m = ft.n_members
    ft.graphed = True
    ft._run_steps(rows[:GRAPH_WARMUP_STEPS])
    snap = (ft.member_states(), copy.deepcopy(ft.opt.state_dict()),
            [g.get_state() for g in ft.dropout_gens])
    rows = rows[GRAPH_WARMUP_STEPS: GRAPH_WARMUP_STEPS + EQUAL_STEPS]
    split = EQUAL_STEPS - PROFILED_STEPS
    ft.graphed = False
    eager = [ft._run_steps(rows[:split])]
    prof_e = profile_steps(
        lambda i: eager.append(ft._run_steps(rows[split:])), steps=1)
    want = ft_state(ft)
    ft.load_member_states(snap[0])
    load_optimizer_state(ft.opt, copy.deepcopy(snap[1]))
    for g, st in zip(ft.dropout_gens, snap[2]):
        g.set_state(st)
    ft.graphed = True
    graphed = [ft._run_steps(rows[:split])]       # the capture, replays
    prof_g = profile_steps(
        lambda i: graphed.append(ft._run_steps(rows[split:])), steps=1)
    torch.cuda.synchronize()
    got = ft_state(ft)
    check(torch.equal(torch.cat(eager), torch.cat(graphed)),
          f"{tag}: graphed losses differ from eager")
    differ = [n for n in want if not torch.equal(want[n], got[n])]
    check(not differ, f"{tag}: graphed state differs from eager in "
          f"{differ}")
    fwd = ("fused_gcn_layer" if ft.cfg.model.gnn_type == "gcn"
           else "fused_gine_layer")
    captured = ft._train_graph.launches
    check(captured[fwd] == LAYERS and captured[fwd + "_bwd"] == LAYERS,
          f"{tag}: captured {captured}, expected {LAYERS} each")
    per_step = launches_agree(
        tag, {n: c / PROFILED_STEPS
              for n, c in prof_e["port_launches"].items()},
        {n: c / PROFILED_STEPS
         for n, c in prof_g["port_launches"].items()})
    first = (("k5f_xw_kernel", "k5b_strip_kernel")
             if fwd == "fused_gcn_layer"
             else ("k4f_mid_kernel", "gine_bwd_dmid_kernel"))
    check(all(per_step.get(k) == LAYERS for k in first),
          f"{tag}: per replayed step {per_step}, expected {LAYERS} of "
          f"{first}")
    return dict(members=m, bit_identical=True, tensors_compared=len(want),
                losses=torch.cat(eager).tolist(), captured=captured,
                kernel_launches_per_step_profiled=per_step)


def ensemble_phase(dev, tmp: str, card: str, shared: dict,
                   one_member: dict) -> dict:
    """The seed ensembles at full width (f32, dropout 0.3): GIN BBBP with 3
    seeds (M = 3), GIN ClinTox with 2 targets x 3 seeds (M = 6) and GCN
    BBBP with 3 seeds. ALONE_STEPS steps of all members bit for bit
    against the members stepped alone (members_alone); one step card
    against CPU, member by member, with 5 launches of each layer kernel
    (members_vs_cpu); EQUAL_STEPS graphed steps bit-identical to eager
    ones with 5 launches of each layer kernel per replayed step
    (ft_eager_vs_graphed); the graphed step's time, host time, device time
    and busy share against M times the one-member graphed step of
    one_member[model] (ft_path_speed's row), and what the lockstep trunk's
    stacks cost (stack_ms; the profile's CatArrayBatchedCopy ms per
    step)."""
    report = {}
    for tag, task, targets, gnn in ENSEMBLES:
        t0 = time.perf_counter()
        cfg = finetune_cfg(tmp, gnn, task_name=task, n_seeds=3)
        ft = finetuner(cfg, dev, shared, targets)
        m = ft.n_members
        rows = train_rows(ft)
        fwd = "fused_gine_layer" if gnn == "gin" else "fused_gcn_layer"
        want = {fwd: LAYERS, fwd + "_bwd": LAYERS}
        row = dict(card=card, model=gnn, members=m,
                   alone=members_alone(ft, rows, tag))
        row["step_vs_cpu"] = members_vs_cpu(ft, rows[ALONE_STEPS], tag,
                                            want)
        row["equal"] = ft_eager_vs_graphed(ft, rows[ALONE_STEPS + 1:], tag)
        speed = ft_path_speed(ft, "resident_graphed", card, tag)
        row.update(step_ms=speed["step_ms"], host_ms=speed["host_ms"],
                   device_ms=speed["device_ms"],
                   device_busy_share=speed["device_busy_share"],
                   cat_ms_per_step=speed["profile"]["cat_ms_per_step"],
                   stack_ms=stack_ms(ft, rows[0]),
                   one_member_step_ms=one_member[gnn]["step_ms"],
                   m_times_one_member_ms=m * one_member[gnn]["step_ms"],
                   seconds=time.perf_counter() - t0)
        report[tag] = row
        print(f"ensemble {tag} {json.dumps(row)}", flush=True)
    return report


# --------------------------------------------------------------- phase 10


def finetune_cli_phase(tmp: str) -> dict:
    """cli.finetune for 2 epochs of configs/finetune.yaml on the synthetic
    stand-in, in a temporary working directory: GIN warm-started from
    phase 7's newest step_<n>.pt, then --model gcn, then --motifs, then
    --n-seeds 3 (RESULT with the std over the seeds, the CSV row with
    it)."""
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
                                  ("gin_motifs", ["--motifs"], "gin"),
                                  ("gin_3_seeds", ["--n-seeds", "3"],
                                   "gin")):
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
            results = re.findall(
                r"^RESULT (\S+): (\S+) = (\S+)(?: \+- (\S+))?$", text, re.M)
            seeds = tag == "gin_3_seeds"
            check(len(results) == 1 and np.isfinite(float(results[0][2]))
                  and bool(results[0][3]) == seeds,
                  f"finetune CLI {tag}: RESULT lines {results}")
            prefix = os.path.basename(pre) if tag == "gin_warm" \
                else "scratch"
            csv_name = f"{prefix}_BBBP_finetune.csv"
            with open(os.path.join("experiments", csv_name)) as f:
                row = f.read().splitlines()[-1].split(",")
            check(row[-1] == "synthetic=true" and len(row) == 3 + seeds,
                  f"finetune CLI {tag}: CSV row {row}")
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


# --------------------------------------------------------------- phase 11


def gcn_bwd_library(g, dsums, x, a, b, adj, cnt, out, w, relu_in):
    """The K3b function as a chain of cuBLAS calls in the activation dtype
    (yardstick only; the port never calls it)."""
    t, s, _ = adj.shape
    n, d = g.shape
    dt = g.dtype
    gt = torch.addcmul(dsums[0], out.float(), dsums[1], value=2.0)
    gt = gt.mul_(adj_diag_mask(adj)).add_(g.float())
    gtc = gt.to(dt)
    dxw = torch.bmm(adj, gtc.view(t, s, d)).view(n, d)
    dpre = torch.mm(dxw, w.t()).float()
    pre = torch.addcmul(b, x.float(), a)
    if relu_in:
        dpre = dpre.mul_(pre > 0)
        pre = pre.relu_()
    xc = pre.to(dt)
    return ((dpre * a).to(dt), (dpre * x.float()).sum(0), dpre.sum(0),
            torch.mm(xc.t(), dxw), gt.sum(0), torch.mm(cnt.t(), gtc))


def k3b_bound_ms(x, p, dt):
    """Least time for K3b's work at these inputs: dxw @ W^T and xc^T @ dxw
    over the real rows, A @ gtc and cnt^T gtc by their nonzeros; bytes: g,
    x, out, dx [N, D], A, cnt and W in the activation type, dsums, a, b,
    da, db, dbias, dW and detab in f32."""
    adj, cnt = x["adj"], x["cnt"]
    t, s, _ = adj.shape
    n, d = x["h"].shape
    n_real = int(adj_diag_mask(adj).sum())
    ops = (2 * 2 * n_real * d * d + 2 * int((adj != 0).sum()) * d
           + 2 * int((cnt != 0).sum()) * d)
    act = 4 * n * d + t * s * s + n * CNT_PAD + d * d
    f32 = 7 * d + d * d + CNT_PAD * d
    t_bytes = (act * x["h"].element_size() + f32 * 4) / HBM_BPS
    t_ops = ops / PEAK_FLOPS[dt]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def gcn_train_kernel_phase(batch, dev) -> dict:
    """K3f and K3b at the pretraining shape (T = 22), f32 and bf16,
    relu_in False and True: K3f against its plain version, K3b against its
    plain version on K3f's output and a random cotangent; two runs
    bit-identical; kernel, plain and library times and the bound; device
    us per pass, host us per call and what each skipped (k3f_plan,
    k3b_plan)."""
    gen = torch.Generator().manual_seed(SEED + 6)
    res = {"fwd": {"max_abs_err": 0.0, "cases": []},
           "bwd": {"max_abs_err": 0.0, "cases": []}}
    names = ("dx", "da", "db", "dw", "dbias", "detab")
    for dt in (torch.float32, torch.bfloat16):
        x, _, pc = layer_inputs(batch, dt, gen)
        args = gcn_args(x, pc)
        n, d = x["h"].shape
        g = (0.1 * torch.randn(n, d, generator=gen)).to(dev, dt)
        dsums = (1e-3 * torch.randn(2, d, generator=gen)).to(dev)
        for relu_in in (False, True):
            tag = dict(dtype=str(dt).replace("torch.", ""), relu_in=relu_in,
                       tiles=x["adj"].shape[0], d=d)
            case, (out, _) = kernel_case(
                "K3f", tag, ("out", "sums"),
                lambda: fused_gcn_bn_layer(*args, relu_in),
                lambda: fused_gcn_bn_layer_plain(*args, relu_in),
                lambda: gcn_library(*args, relu_in), KERNEL_RTOL[dt])
            case["bound_ms"], case["bound_by"] = bound_ms(
                "fused_gcn_bn_layer", x, pc, dt)
            paced(case, lambda: fused_gcn_bn_layer(*args, relu_in),
                  k3f_skipped(x, d))
            print(f"kernel k3f_pretrain {json.dumps(case)}", flush=True)
            res["fwd"]["max_abs_err"] = max(res["fwd"]["max_abs_err"],
                                            case["err_out"])
            res["fwd"]["cases"].append(case)
            bargs = (g, dsums, x["h"], x["a"], x["b"], x["adj"], x["cnt"],
                     out, pc["w"], relu_in)
            case, _ = kernel_case(
                "K3b", tag, names, lambda: fused_gcn_bn_layer_bwd(*bargs),
                lambda: fused_gcn_bn_layer_bwd_plain(*bargs),
                lambda: gcn_bwd_library(*bargs), BWD_RTOL[dt])
            case["library_err_dx"] = rel_err(gcn_bwd_library(*bargs)[0],
                                             fused_gcn_bn_layer_bwd_plain(
                                                 *bargs)[0])[0]
            case["bound_ms"], case["bound_by"] = k3b_bound_ms(x, pc, dt)
            paced(case, lambda: fused_gcn_bn_layer_bwd(*bargs),
                  k3b_skipped(x, d, dt))
            print(f"kernel k3b {json.dumps(case)}", flush=True)
            res["bwd"]["max_abs_err"] = max(res["bwd"]["max_abs_err"],
                                            case["err_dx"])
            res["bwd"]["cases"].append(case)
    return res


# --------------------------------------------------------------- phase 12


def gcn_step_phase(batch, spec, dev, card: str) -> dict:
    """Full-width GCN pretraining (5 x 300 / 512, B = 512, node
    augmentation, ntxent 'auto'): 3 card-vs-CPU steps in f32 and in bf16
    with phase 5's limits, K3f 10 and K3b 10 launches per step and no
    other kernel; two identical card steps bit-identical; one
    normalize_gcn step card-vs-CPU; then phase 6's speed measurement."""
    bw = spec.max_graph_bonds
    want = dict(fused_gcn_bn_layer=2 * LAYERS,
                fused_gcn_bn_layer_bwd=2 * LAYERS)
    report = {}
    for bf16 in (False, True):
        cfg = pretrain_cfg(bf16=bf16, gnn="gcn")
        models, opts = card_and_cpu(cfg, dev)
        key = "bfloat16" if bf16 else "float32"
        report[key] = card_vs_cpu_steps(models, opts, cfg, batch, dev, bw, 0,
                                        P_STEPS, want, f"gcn {key} step")
        if not bf16:
            bit_identical_steps(models["card"], opts["card"], cfg,
                                batch.to(dev), bw, P_STEPS, "gcn step")
            report[key]["bit_identical_steps"] = True
    cfg = pretrain_cfg(gnn="gcn", normalize_gcn=True)
    models, opts = card_and_cpu(cfg, dev)
    report["normalize_gcn"] = card_vs_cpu_steps(
        models, opts, cfg, batch, dev, bw, 0, 1, want, "gcn normalize step")
    print(f"gcn step {json.dumps(report)}", flush=True)
    report["speed"] = speed_phase(batch, spec, dev, card, gnn="gcn")
    return report


# --------------------------------------------------------------- phase 13


def views_equal(batch, cfg, bw, max_waves, dev) -> None:
    """The two views of step 0 drawn on the card equal the CPU's from the
    same keys, bit for bit."""
    got, want = (paired_augment(
        batch.to(where), step_generator(cfg.seed, TRAIN_STREAM, 0), cfg.aug,
        tile=TILE, bond_window=bw, max_waves=max_waves)
        for where in (dev, "cpu"))
    for v, w in zip(got, want):
        for f in AUG_DELTA_FIELDS:
            check(torch.equal(getattr(v, f).cpu(), getattr(w, f)),
                  f"{cfg.aug} views: {f} differs between card and CPU")


def dropout_masks_for(n: int, views: int):
    """masks(step) -> `views` lists of LAYERS keep masks [n, EMB] (keep
    probability 0.9), drawn on the CPU from (SEED + 7, step)."""
    def masks(step):
        gen = torch.Generator().manual_seed(SEED + 7 + 1000 * step)
        return [[torch.rand(n, EMB, generator=gen) < 0.9
                 for _ in range(LAYERS)] for _ in range(views)]
    return masks


def augment_timing(batch, kind: str, bw: int, max_waves: int, dev) -> dict:
    """paired_augment's time per step on the card: the stream's time
    between CUDA events around each call (median of 20 after 3 warm-up
    calls), the host's time to queue a call, and the device's busy time
    from torch.profiler."""
    bg = batch.to(dev)

    def aug(i):
        return paired_augment(bg, step_generator(SEED, TRAIN_STREAM, i),
                              kind, tile=TILE, bond_window=bw,
                              max_waves=max_waves)

    for i in range(3):
        aug(i)
    torch.cuda.synchronize()
    events, host = [], []
    for i in range(20):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        aug(i)
        e1.record()
        host.append(1e3 * (time.perf_counter() - t0))
        events.append((e0, e1))
    torch.cuda.synchronize()
    prof = profile_steps(aug)
    return dict(kind=kind, max_waves=max_waves,
                stream_ms=statistics.median(a.elapsed_time(b)
                                            for a, b in events),
                host_ms=statistics.median(host),
                device_ms=prof["device_ms_per_step"],
                device_kernels=prof["kernels"])


def trainer_bwd_cases(batch, dev) -> dict:
    """K4b at the shape of the dropout step below (the pretraining batch, T
    = 22; features and cotangent zero on padding rows, as the unchained
    trunk gives them) and K1b at that of its concat_views step (the batch
    twice, T = 44; relu prologue, a cotangent on every row), f32 and bf16:
    each against its plain version within phase 8's (K4b) and phase 4's
    (K1b) limits, two runs bit-identical. Their weight passes take other
    row chunks and output tiles there than at phases 4 and 8's shapes."""
    gen = torch.Generator().manual_seed(SEED + 8)
    host = batch.to("cpu")
    twice = concat_views(host, host)
    res = {"k4b": [], "k1b": []}
    for dt in (torch.float32, torch.bfloat16):
        x, pg, _ = layer_inputs(batch.to(dev), dt, gen)
        mask = adj_diag_mask(x["adj"])
        h = (x["h"].float() * mask).to(dt)
        n, d = h.shape
        g = ((0.1 * torch.randn(n, d, generator=gen)).to(dev) * mask).to(dt)
        fargs = (h, x["adj"], x["cnt"], pg["etab"], pg["w1"], pg["b1"],
                 pg["w2"], pg["b2"])
        _, agg, mid = fused_gine_layer_fwd(*fargs, residuals=True)
        bargs = (g, x["adj"], x["cnt"], agg, mid, pg["w1"], pg["w2"])
        tag = dict(dtype=str(dt).replace("torch.", ""),
                   tiles=x["adj"].shape[0], d=d)
        case, _ = kernel_case(
            "K4b", tag, ("dh", "dw1", "db1", "dw2", "db2", "detab"),
            lambda: fused_gine_layer_bwd(*bargs),
            lambda: fused_gine_layer_bwd_plain(*bargs),
            lambda: gine_unchained_bwd_library(*bargs), KERNEL_RTOL[dt])
        case["skipped"] = gine_bwd_skipped(g, x["adj"], pg["w1"].shape[1],
                                           dt)
        print(f"kernel k4b_dropout {json.dumps(case)}", flush=True)
        res["k4b"].append(case)

        x, pg, _ = layer_inputs(twice.to(dev), dt, gen)
        n, d = x["h"].shape
        out, _, agg, mid = fused_gine_bn_layer_fwd(*gine_args(x, pg), True,
                                                   residuals=True)
        g = (0.1 * torch.randn(n, d, generator=gen)).to(dev, dt)
        dsums = (1e-3 * torch.randn(2, d, generator=gen)).to(dev)
        bargs = (g, dsums, x["h"], x["a"], x["b"], x["adj"], x["cnt"], agg,
                 mid, out, pg["w1"], pg["w2"], True)
        tag = dict(tag, tiles=x["adj"].shape[0], relu_in=True)
        case, _ = kernel_case(
            "K1b", tag, ("dh", "da", "db", "dw1", "db1", "dw2", "db2",
                         "detab"),
            lambda: fused_gine_bn_layer_bwd(*bargs),
            lambda: fused_gine_bn_layer_bwd_plain(*bargs),
            lambda: gine_bwd_library(*bargs), BWD_RTOL[dt])
        case["skipped"] = gine_bwd_skipped(
            gine_bwd_gt(g, dsums, x["adj"], out), x["adj"],
            pg["w1"].shape[1], dt)
        print(f"kernel k1b_concat {json.dumps(case)}", flush=True)
        res["k1b"].append(case)
    return res


def gcn_mix_cases(batch, dev) -> dict:
    """K3f and K3b at the GCN mix step's shape below (the pretraining batch
    with hydrogens, T = 47), f32 and bf16, relu prologue: each against its
    plain version within phase 11's limits, two runs bit-identical, with
    what each skipped. No other kernel check reaches this tile count."""
    gen = torch.Generator().manual_seed(SEED + 9)
    res = {"k3f": [], "k3b": []}
    for dt in (torch.float32, torch.bfloat16):
        x, _, pc = layer_inputs(batch.to(dev), dt, gen)
        args = gcn_args(x, pc)
        n, d = x["h"].shape
        g = (0.1 * torch.randn(n, d, generator=gen)).to(dev, dt)
        dsums = (1e-3 * torch.randn(2, d, generator=gen)).to(dev)
        tag = dict(dtype=str(dt).replace("torch.", ""), relu_in=True,
                   tiles=x["adj"].shape[0], d=d)
        case, (out, _) = kernel_case(
            "K3f", tag, ("out", "sums"),
            lambda: fused_gcn_bn_layer(*args, True),
            lambda: fused_gcn_bn_layer_plain(*args, True),
            lambda: gcn_library(*args, True), KERNEL_RTOL[dt])
        case["skipped"] = k3f_skipped(x, d)
        print(f"kernel k3f_mix {json.dumps(case)}", flush=True)
        res["k3f"].append(case)
        bargs = (g, dsums, x["h"], x["a"], x["b"], x["adj"], x["cnt"], out,
                 pc["w"], True)
        case, _ = kernel_case(
            "K3b", tag, ("dx", "da", "db", "dw", "dbias", "detab"),
            lambda: fused_gcn_bn_layer_bwd(*bargs),
            lambda: fused_gcn_bn_layer_bwd_plain(*bargs),
            lambda: gcn_bwd_library(*bargs), BWD_RTOL[dt])
        case["skipped"] = k3b_skipped(x, d, dt)
        print(f"kernel k3b_mix {json.dumps(case)}", flush=True)
        res["k3b"].append(case)
    return res


def options_phase(dev) -> dict:
    """The other pretraining options at full width, each one card-vs-CPU
    step from the same state with phase 5's limits and its launch counts:
    GIN and GCN with subgraph / mix augmentation (views on the card equal
    to the CPU's from the same keys; mix on the batch featurized with
    hydrogens), GIN with dropout 0.1 (the same masks on both; K4f / K4b
    per view), GIN with concat_views (one forward of both views, T = 44).
    The BFS horizon is the one the Pretrainer derives for a corpus of this
    batch (max atoms - 1). Then the augmentation's time per step for
    node, subgraph and mix. First K4b and K1b at the dropout and
    concat_views steps' shapes (trainer_bwd_cases), K3f and K3b at the GCN
    mix step's (gcn_mix_cases)."""
    plain = pretrain_batch()
    report = {"kernels": trainer_bwd_cases(plain[0], dev)}
    with_hs = pretrain_batch(add_hs=True)
    report["gcn_mix_kernels"] = gcn_mix_cases(with_hs[0], dev)
    gin_bn = dict(fused_gine_bn_layer=2 * LAYERS,
                  fused_gine_bn_layer_bwd=2 * LAYERS)
    gcn_bn = dict(fused_gcn_bn_layer=2 * LAYERS,
                  fused_gcn_bn_layer_bwd=2 * LAYERS)
    runs = (("gin_subgraph", dict(aug="subgraph"), plain, gin_bn),
            ("gin_mix", dict(aug="mix"), with_hs, gin_bn),
            ("gcn_mix", dict(aug="mix", gnn="gcn"), with_hs, gcn_bn),
            ("gin_drop", dict(drop_ratio=0.1), plain,
             dict(fused_gine_layer=2 * LAYERS,
                  fused_gine_layer_bwd=2 * LAYERS)),
            ("gin_concat", dict(concat_views=True), plain,
             dict(fused_gine_bn_layer=LAYERS,
                  fused_gine_bn_layer_bwd=LAYERS)))
    for tag, kw, (batch, spec), want in runs:
        cfg = pretrain_cfg(**kw)
        bw = spec.max_graph_bonds
        mw = int(batch.graph_n_nodes.max()) - 1
        if cfg.aug != "node":
            views_equal(batch, cfg, bw, mw, dev)
        masks = None
        if cfg.model.drop_ratio:
            masks = dropout_masks_for(batch.nbr.shape[0], 2)
        models, opts = card_and_cpu(cfg, dev)
        row = card_vs_cpu_steps(models, opts, cfg, batch, dev, bw, 0, 1,
                                want, tag, max_waves=mw, masks=masks)
        row.update(max_waves=mw, tiles=batch.nbr.shape[0] // TILE
                   * (2 if cfg.concat_views else 1),
                   views_equal_cpu=cfg.aug != "node")
        report[tag] = row
        print(f"option {tag} {json.dumps(row)}", flush=True)
    report["augment"] = {}
    for kind, (batch, spec) in (("node", plain), ("subgraph", plain),
                                ("mix", with_hs)):
        row = augment_timing(batch, kind, spec.max_graph_bonds,
                             int(batch.graph_n_nodes.max()) - 1, dev)
        report["augment"][kind] = row
        print(f"augment {json.dumps(row)}", flush=True)
    return report


# --------------------------------------------------------------- phase 15

# eager against graphed steps from the same state, and the speed window;
# the profiler watches the last PROFILED_STEPS of each run
EQUAL_STEPS, PROFILED_STEPS = 10, 3
# the options whose steps replay on the card, each held to its eager steps
# on the units path (mix, which featurizes with hydrogens, has a base of
# its own)
OPTION_GRAPHS = (("gin_dropout", dict(drop_ratio=0.1)),
                 ("gin_subgraph", dict(aug="subgraph")),
                 ("gcn_normalize", dict(gnn="gcn", normalize_gcn=True)),
                 ("gin_concat_views", dict(concat_views=True)),
                 ("gin_pallas", dict(ntxent_impl="pallas")))
# the data attributes a Pretrainer's setup_data sets, and those of its
# tile-unit stack, which a fork shares
DATA_ATTRS = ("spec", "max_waves", "train_iter", "valid_iter",
              "_mean_real_nodes", "_mean_real_edges")
STACK_ATTRS = ("_stack", "_units", "_units_per_batch", "_n_units",
               "unit_spec", "_unit_stack_mb", "_device_cache_used_mb",
               "_mean_real_nodes", "_mean_real_edges")


def fork(base, cfg, stack: bool, dp=None):
    """A Pretrainer of cfg (under data parallelism dp) sharing base's
    featurized data and, when `stack`, its uploaded tile-unit stack (no
    second featurization or packing); its own model (seeded as
    setup_state seeds it) and Adam."""
    pre = Pretrainer(cfg, base.device, dp=dp)
    for k in DATA_ATTRS + (STACK_ATTRS if stack else ()):
        setattr(pre, k, getattr(base, k))
    if not stack:
        pre._mean_real_nodes, pre._mean_real_edges = base.host_means
    return pre.setup_state()


def stack_orders(pre, epochs: int = 6) -> np.ndarray:
    """The stack rows of the first `epochs` epochs' steps, in order: the
    tile-unit rows on the units path, the cached batches' order on the
    resident batch cache (the ELL trunk's, tile 0)."""
    if not pre._units:
        return np.concatenate([pre.train_iter.cached_epoch_order()
                               for _ in range(epochs)])[:, None]
    return np.concatenate([pre._unit_orders(e) for e in range(epochs)])


def host_split(pre) -> dict:
    """The host path's step (a host batch uploaded, node augmentation, both
    forwards, the loss, the backward, Adam: the body of train_step) timed
    on the host by part, without a synchronize: the host's time to queue
    each part, median over SPEED_STEPS steps after WARM_STEPS; `pack` is
    the time to pack the batch from its molecules (the packed-batch cache
    does it once per batch)."""
    cfg, model, opt, dev = pre.cfg, pre.model, pre.opt, pre.device
    gb, _, ids = next(iter(pre.train_iter))
    mols = [pre.train_iter.graphs[i] for i in ids]
    t0 = time.perf_counter()
    pack_batch(mols, pre.spec)
    pack_ms = 1e3 * (time.perf_counter() - t0)
    bw, mw = pre.spec.max_graph_bonds, pre.max_waves
    loss_fn = resolve_ntxent(cfg.ntxent_impl)
    names = ("keys", "upload", "augment", "forward", "backward", "adam")
    parts = {k: [] for k in names + ("total",)}
    for step in range(WARM_STEPS + SPEED_STEPS):
        t = [time.perf_counter()]
        keys = draw_paired_keys(cfg.aug, gb.num_nodes, gb.num_graphs,
                                step_generator(cfg.seed, TRAIN_STREAM, step))
        t.append(time.perf_counter())
        bg = gb.to(dev)
        t.append(time.perf_counter())
        vi, vj = paired_augment_keys(bg, keys, cfg.aug, tile=TILE,
                                     bond_window=bw, max_waves=mw)
        t.append(time.perf_counter())
        model.train()
        _, zi = model(vi)
        _, zj = model(vj)
        loss = loss_fn(zi.float(), zj.float(), cfg.temperature,
                       cfg.use_cosine_similarity, pair_mask=bg.graph_mask)
        t.append(time.perf_counter())
        opt.zero_grad(set_to_none=True)
        loss.backward()
        t.append(time.perf_counter())
        optim.set_lr(opt, cfg.init_lr)
        opt.step()
        t.append(time.perf_counter())
        if step >= WARM_STEPS:
            for k, a, b in zip(names, t, t[1:]):
                parts[k].append(1e3 * (b - a))
            parts["total"].append(1e3 * (t[-1] - t[0]))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(loss)), f"host split: loss {loss}")
    return dict({f"{k}_ms": statistics.median(v) for k, v in parts.items()},
                pack_ms=pack_ms, steps=SPEED_STEPS)


def model_state(pre) -> dict:
    """Copies of the parameters, BatchNorm stats and Adam moments."""
    out = {f"model.{k}": v.clone() for k, v in
           pre.model.state_dict().items()}
    sd = pre.opt.state_dict()
    if "state" in sd:          # torch.optim.Adam
        for i, st in sd["state"].items():
            out.update({f"adam.{i}.{k}": v.clone() for k, v in st.items()})
    else:                      # FusedAdam
        out.update({f"adam.{k}": v.clone() for k, v in sd.items()})
    return out


def launches_agree(tag: str, per_e: dict, per_g: dict,
                   some: bool = True) -> dict:
    """The port's kernels as the profiler saw them launched per step, by
    kernel name: on replayed steps (per_g) exactly as on eager steps
    (per_e), and some at all unless `some` is False (the ELL trunk
    launches none)."""
    check(bool(per_e) == some and per_g == per_e, f"{tag}: the port's "
          f"kernels launched {per_g} times per replayed step, {per_e} per "
          f"eager step")
    return per_g


def eager_vs_graphed(pre, tag: str) -> dict:
    """EQUAL_STEPS units-path steps run eagerly and, from the same state
    with the same optimizer object, replayed as a CUDA graph (after
    GRAPH_WARMUP_STEPS eager steps that build the kernels and Adam's
    state): losses, parameters, BatchNorm stats and Adam moments
    bit-identical. Counts set to 0 just before each run and read just
    after: the eager run's, counted per launch, and the graphed run's,
    those of the capture alone (the wrappers count once, while capturing),
    which must be one eager step's per step captured. The profiler
    watches the last PROFILED_STEPS steps of each run: the port's kernels
    launched per replayed step exactly as per eager step."""
    log = lambda *_: None  # noqa: E731
    t0 = time.perf_counter()
    orders = stack_orders(pre)
    pre._resident_epoch(0, orders[:GRAPH_WARMUP_STEPS], log)
    rows = orders[GRAPH_WARMUP_STEPS: GRAPH_WARMUP_STEPS + EQUAL_STEPS]
    snap = (copy.deepcopy(pre.model.state_dict()),
            copy.deepcopy(pre.opt.state_dict()), pre.step)
    k, pre.graph_steps = pre.graph_steps, 0
    split = EQUAL_STEPS - PROFILED_STEPS
    reset_counts()
    eager = pre._resident_epoch(0, rows[:split], log)
    prof_e = profile_steps(lambda i: eager.extend(
        pre._resident_epoch(0, rows[split:], log)), steps=1)
    eager_counts = read_counts()
    want = model_state(pre)
    pre.model.load_state_dict(snap[0])
    load_optimizer_state(pre.opt, copy.deepcopy(snap[1]))
    pre.step, pre.graph_steps = snap[2], k
    reset_counts()
    graphed = pre._resident_epoch(0, rows[:split], log)  # the capture
    prof_g = profile_steps(lambda i: graphed.extend(
        pre._resident_epoch(0, rows[split:], log)), steps=1)
    torch.cuda.synchronize()
    counts = read_counts()
    got = model_state(pre)
    check(eager == graphed, f"{tag}: graphed losses {graphed} differ from "
          f"eager {eager}")
    differ = [n for n in want if not torch.equal(want[n], got[n])]
    check(not differ, f"{tag}: graphed state differs from eager in {differ}")
    g = graph_record(pre)
    check(g is not None and g["replays"] == EQUAL_STEPS // k
          and counts == g["captured"]
          and all(c * EQUAL_STEPS == eager_counts[n] * k
                  for n, c in counts.items()),
          f"{tag}: graph {g}, captured counts {counts}, eager counts "
          f"{eager_counts} over {EQUAL_STEPS} steps")
    per_step = launches_agree(
        tag, {n: c / PROFILED_STEPS
              for n, c in prof_e["port_launches"].items()},
        {n: c / PROFILED_STEPS
         for n, c in prof_g["port_launches"].items()},
        some=pre.cfg.model.tile > 0)
    report = dict(losses_eager=eager, losses_graphed=graphed,
                  bit_identical=True, tensors_compared=len(want),
                  graph=g, eager_launches=eager_counts,
                  kernel_launches_per_step_profiled=per_step,
                  launches_derived={n: c * g["replays"]
                                    for n, c in counts.items() if c},
                  seconds=time.perf_counter() - t0)
    print(f"resident equal {tag} {json.dumps(report)}", flush=True)
    return report


def path_speed(pre, path: str, card: str) -> dict:
    """One path's step on the card, driven through the Pretrainer's own
    epoch loop (_host_epoch or _resident_epoch): CUDA events and host
    clock marks at each step's end (Pretrainer._advance), WARM_STEPS steps
    first. step_ms: median of the events' gaps; host_ms: median of the
    host's gaps (its time to queue a step while the device keeps up);
    the means over the window too; a torch.profiler breakdown of
    PROFILED_STEPS more steps, with the port's kernels' launches per step
    (the caller holds a graphed path's against its eager path's)."""
    log = lambda *_: None  # noqa: E731
    if path == "host":
        spe = pre.steps_per_epoch

        def run(n):
            for _ in range(-(-n // spe)):
                pre._host_epoch(0, log)
    else:
        orders = stack_orders(pre)
        at = [0]

        def run(n):
            pre._resident_epoch(0, orders[at[0]: at[0] + n], log)
            at[0] += n
    run(WARM_STEPS)
    marks = []
    advance = pre._advance

    def marking(n, losses, epoch, log):
        advance(n, losses, epoch, log)
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((e, time.perf_counter(), n))

    torch.cuda.synchronize()
    pre._advance = marking
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    marks.append((start, time.perf_counter(), 0))
    run(SPEED_STEPS)
    torch.cuda.synchronize()
    del pre._advance
    gaps = [(a[0].elapsed_time(b[0]) / b[2], 1e3 * (b[1] - a[1]) / b[2])
            for a, b in zip(marks, marks[1:])]
    steps = sum(m[2] for m in marks)
    events_total = marks[0][0].elapsed_time(marks[-1][0])
    host_total = 1e3 * (marks[-1][1] - marks[0][1])
    before = pre.step
    prof = profile_steps(lambda i: run(PROFILED_STEPS), steps=1)
    per = pre.step - before
    ms = statistics.median(g[0] for g in gaps)
    messages = 2 * LAYERS * (pre._mean_real_edges + pre._mean_real_nodes)
    mols = (len(pre.train_iter.graphs) * pre._units_per_batch / pre._n_units
            if pre._units else P_BATCH)
    row = dict(card=card, path=path, model=pre.cfg.model.gnn_type,
               dtype="bfloat16" if pre.cfg.model.bf16 else "float32",
               adam=pre.cfg.adam_impl, drop_ratio=pre.cfg.model.drop_ratio,
               steps=steps, step_ms=ms, step_ms_mean=events_total / steps,
               host_ms=statistics.median(g[1] for g in gaps),
               host_ms_mean=host_total / steps,
               message_edges_per_step=messages,
               message_edges_per_s=messages / (ms / 1e3),
               mol_per_step=mols, mol_per_s=mols / (ms / 1e3),
               device_ms=prof["device_ms_per_step"] / per,
               device_busy_share=prof["device_busy_share"],
               graph=graph_record(pre),
               profile=dict(prof, window_steps=per, top=[
                   dict(t, ms_per_step=t["ms_per_step"] / per,
                        launches_per_step=t["launches_per_step"] / per)
                   for t in prof["top"]],
                   wall_ms_per_step=prof["wall_ms_per_step"] / per,
                   device_ms_per_step=prof["device_ms_per_step"] / per,
                   port_ms_per_step={k: v / per for k, v in
                                     prof["port_ms_per_step"].items()}),
               port_launches_per_step={k: c / per for k, c in
                                       prof["port_launches"].items()})
    check(all(np.isfinite(x).all() for x in pre.epoch_losses),
          f"{path}: non-finite loss")
    print(f"resident speed {json.dumps(row)}", flush=True)
    return row


def units_kernel_cases(batch, dev) -> dict:
    """K1f (with residuals) and K1b, K3f and K3b on the units path's batch
    (T tile-units regrouped on the card by concat_units: per-unit graph
    slots, sentinel bonds), f32 and bf16, relu prologue off and on: each
    against its plain version within phases 4's and 11's limits, two runs
    bit-identical."""
    gen = torch.Generator().manual_seed(SEED + 10)
    res = {"k1f": [], "k1b": [], "k3f": [], "k3b": []}
    for dt in (torch.float32, torch.bfloat16):
        x, pg, pc = layer_inputs(batch, dt, gen)
        n, d = x["h"].shape
        g = (0.1 * torch.randn(n, d, generator=gen)).to(dev, dt)
        dsums = (1e-3 * torch.randn(2, d, generator=gen)).to(dev)
        for relu_in in (False, True):
            tag = dict(dtype=str(dt).replace("torch.", ""), relu_in=relu_in,
                       tiles=x["adj"].shape[0], d=d)
            args = gine_args(x, pg)
            case, (out, _, agg, mid) = kernel_case(
                "K1f units", tag, ("out", "sums", "agg", "mid"),
                lambda: fused_gine_bn_layer_fwd(*args, relu_in,
                                                residuals=True),
                lambda: fused_gine_bn_layer_fwd_plain(*args, relu_in),
                lambda: gine_library(*args, relu_in), KERNEL_RTOL[dt])
            res["k1f"].append(case)
            bargs = (g, dsums, x["h"], x["a"], x["b"], x["adj"], x["cnt"],
                     agg, mid, out, pg["w1"], pg["w2"], relu_in)
            case, _ = kernel_case(
                "K1b units", tag, ("dh", "da", "db", "dw1", "db1", "dw2",
                                   "db2", "detab"),
                lambda: fused_gine_bn_layer_bwd(*bargs),
                lambda: fused_gine_bn_layer_bwd_plain(*bargs),
                lambda: gine_bwd_library(*bargs), BWD_RTOL[dt])
            res["k1b"].append(case)
            args = gcn_args(x, pc)
            case, (out, _) = kernel_case(
                "K3f units", tag, ("out", "sums"),
                lambda: fused_gcn_bn_layer(*args, relu_in),
                lambda: fused_gcn_bn_layer_plain(*args, relu_in),
                lambda: gcn_library(*args, relu_in), KERNEL_RTOL[dt])
            res["k3f"].append(case)
            bargs = (g, dsums, x["h"], x["a"], x["b"], x["adj"], x["cnt"],
                     out, pc["w"], relu_in)
            case, _ = kernel_case(
                "K3b units", tag, ("dx", "da", "db", "dw", "dbias", "detab"),
                lambda: fused_gcn_bn_layer_bwd(*bargs),
                lambda: fused_gcn_bn_layer_bwd_plain(*bargs),
                lambda: gcn_bwd_library(*bargs), BWD_RTOL[dt])
            res["k3b"].append(case)
    for name, cases in res.items():
        for case in cases:
            print(f"kernel {name}_units {json.dumps(case)}", flush=True)
    return res


def units_steps_vs_cpu(batch, bw: int, dev) -> dict:
    """One pretraining step on the units path's batch on the card against
    the same step on the CPU from the same state with the same keys
    (card_vs_cpu_steps: phase 5's limits), GIN and GCN, f32 and bf16, the
    forward and backward kernel 2 x LAYERS times each."""
    report = {}
    # card_vs_cpu_steps takes a host batch (numpy fields)
    host = type(batch)(**{k: v.cpu().numpy() for k, v in vars(batch).items()})
    for gnn in ("gin", "gcn"):
        fwd, bwd = (("fused_gine_bn_layer", "fused_gine_bn_layer_bwd")
                    if gnn == "gin" else
                    ("fused_gcn_bn_layer", "fused_gcn_bn_layer_bwd"))
        for bf16 in (False, True):
            tag = f"units_{gnn}_{'bfloat16' if bf16 else 'float32'}"
            cfg = pretrain_cfg(bf16=bf16, gnn=gnn)
            models, opts = card_and_cpu(cfg, dev)
            report[tag] = card_vs_cpu_steps(
                models, opts, cfg, host, dev, bw, 0, 1,
                {fwd: 2 * LAYERS, bwd: 2 * LAYERS}, tag)
            print(f"step {tag} {json.dumps(report[tag])}", flush=True)
    return report


# rounds of SPEED_STEPS graphed steps per Adam in adam_rounds
ADAM_ROUNDS = 10


def adam_rounds(base, gnn: str, card: str) -> dict:
    """The graphed f32 step with the chain and the fused Adam, each from
    its own fork of the same seeded state, timed by CUDA events in
    2 x ADAM_ROUNDS blocks of SPEED_STEPS steps in the order chain, fused,
    fused, chain, ... so that a drift of the card's clock falls on both:
    ms per step per block, the medians, the quartile spread of each,
    fused minus chain per pair of neighbouring blocks and the pairs fused
    won."""
    log = lambda *_: None  # noqa: E731
    impls = ("chain", "fused")
    pres = {a: fork(base, pretrain_cfg(gnn=gnn, adam_impl=a), True)
            for a in impls}
    need = WARM_STEPS + ADAM_ROUNDS * SPEED_STEPS
    orders = stack_orders(base, -(-need // base.steps_per_epoch))
    at = dict.fromkeys(impls, 0)

    def block(a, n):
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        pres[a]._resident_epoch(0, orders[at[a]: at[a] + n], log)
        e1.record()
        torch.cuda.synchronize()
        at[a] += n
        return e0.elapsed_time(e1) / n

    for a in impls:
        block(a, WARM_STEPS)
    ms = {a: [] for a in impls}
    for r in range(ADAM_ROUNDS):
        for a in (impls if r % 2 == 0 else impls[::-1]):
            ms[a].append(block(a, SPEED_STEPS))
    for a in impls:
        check(pres[a].graphed is not None and all(
            np.isfinite(x).all() for x in pres[a].epoch_losses),
            f"adam rounds {gnn} {a}: graph {graph_record(pres[a])}")
    diff = [f - c for c, f in zip(ms["chain"], ms["fused"])]
    row = dict(card=card, model=gnn, dtype="float32",
               steps_per_block=SPEED_STEPS, ms=ms,
               median_ms={a: statistics.median(v) for a, v in ms.items()},
               iqr_ms={a: float(np.subtract(*np.percentile(v, [75, 25])))
                       for a, v in ms.items()},
               fused_minus_chain_ms=diff,
               fused_won=sum(d < 0 for d in diff), pairs=len(diff))
    print(f"resident adam {json.dumps(row)}", flush=True)
    return row


def resident_phase(tmp: str, card: str, dev) -> dict:
    """The Pretrainer's default one-card path at full width (5 x 300 /
    512, B = 512, node augmentation) on phase 7's 4,096-molecule corpus:
    first the host path's step split by part (GIN and GCN, f32), then the
    unit plan and the stack's MB wide and narrow; K1f / K1b / K3f / K3b
    against their plain versions and one step against the CPU on the
    units path's own batch; EQUAL_STEPS eager against graphed steps for
    GIN and GCN with chain and fused Adam; the step's speed on the host
    path, resident eager and resident graphed, GIN and GCN, f32 and bf16
    (and graphed f32 with the fused Adam), the port's kernels launched per
    replayed step as per eager step; and the graphed f32 step with the
    chain against the fused Adam in alternating rounds."""
    log = lambda *_: None  # noqa: E731
    smiles = read_pretrain_smiles(os.path.join(tmp, "pretrain.txt"))
    base = Pretrainer(pretrain_cfg(), dev)
    base.setup_data(smiles)
    base.host_means = (base._mean_real_nodes, base._mean_real_edges)
    report = {"host_split": {}}
    for gnn in ("gin", "gcn"):
        pre = fork(base, pretrain_cfg(gnn=gnn, device_cache_mb=0), False)
        report["host_split"][gnn] = host_split(pre)
        print(f"resident host_split {gnn} "
              f"{json.dumps(report['host_split'][gnn])}", flush=True)
    base.setup_state()
    check(base.graph_steps == 1, f"graph steps {base.graph_steps}")
    base._activate_units(log)
    check(base._units, "the units path did not activate")
    u, us = base._n_units, base.unit_spec
    report["plan"] = dict(
        units=u, units_per_step=base._units_per_batch,
        steps_per_epoch=base.steps_per_epoch, unit_spec=str(us),
        train_molecules=len(base.train_iter.graphs),
        stack_mb_wide=unit_stack_bytes(us, u) / 2**20,
        stack_mb_narrow=unit_stack_bytes(us, u, wire_dtypes(us)) / 2**20,
        stack_mb_uploaded=base._unit_stack_mb)
    print(f"resident plan {json.dumps(report['plan'])}", flush=True)
    ubatch = concat_units(base._stack, torch.from_numpy(
        stack_orders(base, 1)[0].astype(np.int64)).to(dev))
    print(f"units batch: {ubatch.nbr.shape[0] // TILE} tiles, "
          f"{int(ubatch.node_mask.sum())} atoms, "
          f"{int(ubatch.edge_mask.sum())} directed bonds, "
          f"{ubatch.num_graphs} graph slots", flush=True)
    report["units_kernels"] = units_kernel_cases(ubatch, dev)
    report["units_steps"] = units_steps_vs_cpu(
        ubatch, base.spec.max_graph_bonds, dev)
    report["equal"] = {}
    for gnn in ("gin", "gcn"):
        for adam in ("chain", "fused"):
            tag = f"{gnn}_{adam}"
            pre = fork(base, pretrain_cfg(gnn=gnn, adam_impl=adam), True)
            report["equal"][tag] = eager_vs_graphed(pre, tag)
    # every option that replays on the card, against its eager steps
    for tag, kw in OPTION_GRAPHS:
        report["equal"][tag] = eager_vs_graphed(
            fork(base, pretrain_cfg(**kw), True), tag)
    # mix featurizes with hydrogens: a base of its own
    mix = Pretrainer(pretrain_cfg(aug="mix"), dev)
    mix.setup_data(smiles).setup_state()
    mix._activate_units(log)
    report["equal"]["gin_mix"] = eager_vs_graphed(mix, "gin_mix")
    report["equal"]["gcn_mix"] = eager_vs_graphed(
        fork(mix, pretrain_cfg(aug="mix", gnn="gcn"), True), "gcn_mix")
    report["speed"] = []
    for gnn in ("gin", "gcn"):
        runs = [(bf16, path, kw) for bf16 in (False, True)
                for path, kw in (("host", dict(device_cache_mb=0)),
                                 ("resident_eager",
                                  dict(steps_per_dispatch=1)),
                                 ("resident_graphed", {}))]
        # the graphed f32 step once more with the fused Adam, and GIN's
        # dropout 0.1 step eager and graphed
        runs.append((False, "resident_graphed", dict(adam_impl="fused")))
        if gnn == "gin":
            runs += [(False, path, dict(kw, drop_ratio=0.1)) for path, kw in
                     (("resident_eager", dict(steps_per_dispatch=1)),
                      ("resident_graphed", {}))]
        rows = []
        for bf16, path, kw in runs:
            pre = fork(base, pretrain_cfg(bf16=bf16, gnn=gnn, **kw),
                       path != "host")
            rows.append(path_speed(pre, path, card))
        for r in rows:
            if r["path"] == "resident_graphed":
                eager = next(e for e in rows if e["path"] == "resident_eager"
                             and e["dtype"] == r["dtype"]
                             and e["drop_ratio"] == r["drop_ratio"])
                launches_agree(f"speed {gnn} {r['dtype']} {r['adam']} drop "
                               f"{r['drop_ratio']}",
                               eager["port_launches_per_step"],
                               r["port_launches_per_step"])
        report["speed"] += rows
    report["adam"] = [adam_rounds(base, gnn, card) for gnn in ("gin", "gcn")]
    return report


# --------------------------------------------------------------- phase 16

CORPUS_MOLS, CORPUS_HS_MOLS, AGREE_MOLS = 100_000, 20_000, 20_000
PUBCHEM_MOLS = 10_000_000      # the reference protocol's corpus
STREAM_MAX_MOLS = 10_000       # --pack-cache-max-mols of the stream run
PACK_REPS = 20
EDGE_SMILES = [
    "CC(=O)Oc1ccccc1C(=O)O", "Cn1cnc2c1c(=O)n(C)c(=O)n2C",
    "CC1(C)S[C@@H]2[C@H](NC(=O)Cc3ccccc3)C(=O)N2[C@H]1C(=O)O",
    "CN[C@H]1CC[C@@H](c2ccc(Cl)c(Cl)c2)c2ccccc21", "[NH4+].[Cl-]",
    "F/C=C\\F", "O=S(=O)(N)c1ccccc1", "C%10CC%10", "[13CH4]",
    "c1ccc(cc1)c1ccccc1", "c1ccc-2c(c1)-c1ccccc1-2", "c1ccc1", "cc",
    "c1ccccccc1", "c1cc1C", "", "C1CC", "((", "[Zz]", "xyz",
    "c1ccccc1c1", "C==C", "CC==O", "C=#C", "C/=C"]


def graphs_equal(a, b) -> bool:
    return all(getattr(a, f).dtype == getattr(b, f).dtype
               and np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("atom_type", "chirality", "edge_src", "edge_dst",
                         "bond_type", "bond_dir"))


def batch_fields_equal(tag: str, got: dict, want: dict) -> None:
    differ = [f for f in want if not (got[f].dtype == want[f].dtype
                                      and np.array_equal(got[f], want[f]))]
    check(not differ, f"{tag}: fields {differ} differ")


def featurizer_agreement(card: str) -> dict:
    """Native against the Python featurizer on AGREE_MOLS synthetic
    molecules and EDGE_SMILES, without and with hydrogens: the same
    molecules kept, every array equal; mol/s of each on this host. The
    native packer against the Python packer on one B = 512 batch, every
    field equal; ms per packed batch of each."""
    smiles = synthetic_corpus(AGREE_MOLS, seed=SEED + 16) + EDGE_SMILES
    report = dict(card=card, molecules=len(smiles))
    for add_hs in (False, True):
        t0 = time.perf_counter()
        graphs, kept = native.featurize_corpus_native(smiles, add_hs)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        py = [featurize_smiles(s, add_hs) for s in smiles]
        python_s = time.perf_counter() - t0
        check(kept == [i for i, g in enumerate(py) if g is not None],
              f"add_hs={add_hs}: native kept other molecules than Python")
        check(all(graphs_equal(g, py[i]) for g, i in zip(graphs, kept)),
              f"add_hs={add_hs}: native arrays differ from Python's")
        for s in EDGE_SMILES:
            one, want = native.featurize_smiles_native(s, add_hs), \
                featurize_smiles(s, add_hs)
            check((one is None) == (want is None)
                  and (one is None or graphs_equal(one, want)),
                  f"{s!r} add_hs={add_hs}: native differs from Python")
        report[f"add_hs_{add_hs}"] = dict(
            kept=len(kept), native_mol_per_s=len(smiles) / native_s,
            python_mol_per_s=len(smiles) / python_s,
            speedup=python_s / native_s)
    graphs, _ = featurize_many(synthetic_corpus(P_BATCH, seed=7))
    spec = spec_for_graphs(graphs, P_BATCH, slack=1.05, tile=TILE)
    got, want = pack_batch(graphs, spec), pack_batch(graphs, spec,
                                                     prefer_native=False)
    batch_fields_equal("packer", vars(got), vars(want))
    report["pack_native_ms"] = 1e3 * statistics.median(
        timed(lambda: pack_batch(graphs, spec)) for _ in range(PACK_REPS))
    report["pack_python_ms"] = 1e3 * statistics.median(
        timed(lambda: pack_batch(graphs, spec, prefer_native=False))
        for _ in range(5))
    print(f"corpus agreement {json.dumps(report)}", flush=True)
    return report


def timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def featurize_run(argv) -> dict:
    """cli.featurize with its output captured (and echoed): its mol/s is
    the rate its last line prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = featurize_cli.main(argv)
    out = buf.getvalue()
    print(out, end="", flush=True)
    check(rc == 0, f"featurize {argv} returned {rc}")
    m = re.search(r"built .*: (\d+) molecules, (\d+) atoms, (\d+) directed "
                  r"edges in ([\d.]+)s \(([\d,]+) mol/s\)", out)
    check(m is not None, f"featurize {argv}: no result line")
    return dict(molecules=int(m[1]), atoms=int(m[2]), directed_edges=int(m[3]),
                seconds=float(m[4]), mol_per_s=int(m[5].replace(",", "")))


def corpus_builds(tmp: str, card: str) -> dict:
    """A CORPUS_MOLS corpus and a CORPUS_HS_MOLS --add-hs corpus through
    cli.featurize --synthetic; the train split's tile-unit plan and stack
    MB wide and narrow (as the Pretrainer plans it), projected to
    PUBCHEM_MOLS by the ratio of molecules."""
    report = {"card": card}
    for tag, n, extra in (("corpus100k", CORPUS_MOLS, []),
                          ("corpus20k_hs", CORPUS_HS_MOLS, ["--add-hs"])):
        row = featurize_run([os.path.join(tmp, f"{tag}.txt"),
                             os.path.join(tmp, f"{tag}.mtpu"),
                             "--synthetic", str(n), *extra])
        check(row["molecules"] > 0.99 * n, f"{tag}: {row}")
        report[tag] = row
    path = os.path.join(tmp, "corpus100k.mtpu")
    pre = Pretrainer(pretrain_cfg(data_path=path), "cpu").setup_data()
    train = pre.train_iter.graphs
    groups, uspec = plan_corpus_units(train, TILE, seed=SEED)
    u = len(groups)
    wide = unit_stack_bytes(uspec, u) / 2**20
    narrow = unit_stack_bytes(uspec, u, wire_dtypes(uspec)) / 2**20
    scale = PUBCHEM_MOLS / len(train)
    report["plan"] = dict(
        train_molecules=len(train),
        atoms_per_molecule=float(train.atom_counts.mean()), units=u,
        unit_spec=str(uspec), stack_mb_wide=wide, stack_mb_narrow=narrow,
        pubchem_10m_units=u * scale, pubchem_10m_mb_wide=wide * scale,
        pubchem_10m_mb_narrow=narrow * scale)
    print(f"corpus builds {json.dumps(report)}", flush=True)
    return report


def text_vs_corpus(tmp: str, dev) -> dict:
    """Phase 7's 4,096 SMILES as the text file and as the corpus built
    from it: the Pretrainer takes the same train and valid molecules, the
    same PadSpec and unit spec, bit-identical unit stacks (wide and
    narrow on the host, narrow as uploaded), and EQUAL_STEPS graphed GIN
    f32 steps give bit-identical losses, parameters, BatchNorm stats and
    Adam moments."""
    log = lambda *_: None  # noqa: E731
    text = os.path.join(tmp, "pretrain.txt")
    cdir = os.path.join(tmp, "pretrain.mtpu")
    corpus_lib.build_corpus(iter(read_pretrain_smiles(text)), cdir)
    pres = []
    for src in (text, cdir):
        pre = Pretrainer(pretrain_cfg(data_path=src), dev)
        pre.setup_data().setup_state()
        pre._activate_units(log)
        check(pre._units, f"{src}: the units path did not activate")
        pres.append(pre)
    a, b = pres
    check(isinstance(b.train_iter.graphs, corpus_lib.CorpusSubset),
          "the corpus run did not read the corpus")
    smiles = read_pretrain_smiles(text)
    _, kept = featurize_many(smiles)               # the text file's
    _, parsed = featurize_many(smiles, max_degree=1 << 20)  # the corpus's
    kept, parsed = np.asarray(kept), np.asarray(parsed)
    order = np.random.RandomState(SEED).permutation(len(kept))
    n_valid = int(len(kept) * a.cfg.valid_size)
    check(np.array_equal(kept[order[n_valid:]],
                         parsed[b.train_iter.graphs.ids])
          and np.array_equal(kept[order[:n_valid]],
                             parsed[b.valid_iter.graphs.ids]),
          "text and corpus splits differ")
    check(a.spec == b.spec and a.unit_spec == b.unit_spec
          and (a._n_units, a._units_per_batch)
          == (b._n_units, b._units_per_batch),
          f"specs differ: {a.spec} / {b.spec}, {a.unit_spec} / "
          f"{b.unit_spec}")
    for f in a._stack:
        check(torch.equal(a._stack[f], b._stack[f]),
              f"uploaded unit stacks differ in {f}")
    wide_t = vars(pack_unit_stack(a.train_iter.graphs, TILE, seed=SEED)[0])
    for narrow in (None, wire_dtypes(a.unit_spec)):
        stack, _, _ = pack_unit_stack_corpus(b.train_iter.graphs, TILE,
                                             seed=SEED, narrow=narrow)
        want = {f: (np.asarray(v).astype(narrow[f]) if narrow
                    else np.asarray(v)) for f, v in wide_t.items()}
        batch_fields_equal(f"unit stack narrow={narrow is not None}",
                           stack, want)
    rows = stack_orders(a, 2)[:EQUAL_STEPS]
    losses = [pre._resident_epoch(0, rows, log) for pre in pres]
    check(losses[0] == losses[1], f"losses differ: {losses}")
    sa, sb = model_state(a), model_state(b)
    differ = [k for k in sa if not torch.equal(sa[k], sb[k])]
    check(not differ, f"states differ in {differ}")
    graphs = [graph_record(pre) for pre in pres]
    check(all(g is not None and g["replays"] > 0 for g in graphs),
          f"not graphed: {graphs}")
    report = dict(molecules=len(parsed), train=len(b.train_iter.graphs),
                  spec=str(a.spec), unit_spec=str(a.unit_spec),
                  units=a._n_units, losses=losses[0], tensors=len(sa),
                  graph=graphs[1], bit_identical=True)
    print(f"corpus text_vs_corpus {json.dumps(report)}", flush=True)
    return report


def corpus_gcn_mix(tmp: str) -> dict:
    """--model gcn --aug mix for one epoch on the --add-hs corpus, on the
    units path: K3f and K3b 2 x LAYERS per eager step and captured so per
    replayed step (K3f also 2 x LAYERS per validation batch), no GIN
    kernel; metrics.jsonl finite."""
    ckpt = os.path.join(tmp, "corpus_gcn_mix")
    seen = []
    reset_counts()
    with trainers(seen):
        rc = pretrain_cli.main([
            "--data", os.path.join(tmp, "corpus20k_hs.mtpu"), "--ckpt-dir",
            ckpt, "--batch-size", str(P_BATCH), "--epochs", "1",
            "--warm-up", "1", "--model", "gcn", "--aug", "mix"])
    torch.cuda.synchronize()
    check(rc == 0, f"gcn mix CLI returned {rc}")
    counts = read_counts()
    pre = seen[0]
    check(trainer_path(pre) == "units" and isinstance(
        pre.train_iter.graphs, corpus_lib.CorpusSubset),
        f"gcn mix took the {trainer_path(pre)} path")
    g = graph_record(pre)
    steps = pre.step
    replayed = g["replays"] * g["steps_per_replay"] if g else 0
    valid = len(pre.valid_iter)
    for name in ("fused_gcn_bn_layer", "fused_gcn_bn_layer_bwd"):
        captured = g["captured"][name] if g else 0
        want = 2 * LAYERS * (steps - replayed) + captured
        if name == "fused_gcn_bn_layer":
            want += 2 * LAYERS * valid
        check(counts[name] == want, f"gcn mix: {name} {counts[name]}, "
              f"expected {want}")
    check(counts["fused_gine_bn_layer"] == counts[
        "fused_gine_bn_layer_bwd"] == 0, f"gcn mix: {counts}")
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    check(len(recs) == 1 and all(np.isfinite(recs[0][k]) for k in
                                 ("train_loss", "valid_loss")),
          f"gcn mix records {recs}")
    report = dict(steps=steps, valid_batches=valid, graph=g, counts=counts,
                  record=recs[0])
    print(f"corpus gcn_mix {json.dumps(report)}", flush=True)
    return report


def stream_phase(tmp: str, card: str, dev) -> dict:
    """The host path streaming from the CORPUS_MOLS corpus (pack_cache_max
    _mols STREAM_MAX_MOLS): the first streamed batch equals the Python
    pack_batch of the same molecules; the host's ms to pack (and narrow)
    a batch; one epoch with one native indexed call and K1f / K1b 2 x
    LAYERS launches per step (K1f also 2 x LAYERS per validation batch),
    finite metrics; then the step's ms (CUDA
    events, median over SPEED_STEPS steps of the Pretrainer's epoch loop),
    host ms, the profiler's device ms and busy share."""
    log = lambda *_: None  # noqa: E731
    cfg = pretrain_cfg(data_path=os.path.join(tmp, "corpus100k.mtpu"),
                       epochs=1, pack_cache_max_mols=STREAM_MAX_MOLS,
                       ckpt_dir=os.path.join(tmp, "corpus_stream"))
    pre = Pretrainer(cfg, dev).setup_data().setup_state()
    it = pre.train_iter
    check(not it.cache_packed and len(it.graphs) > STREAM_MAX_MOLS,
          "the stream run would cache its batches")
    wire = wire_dtypes(pre.spec)
    stream = pre._stream_batches()
    t0 = time.perf_counter()
    first = [next(stream) for _ in range(PACK_REPS)]
    pack_ms = 1e3 * (time.perf_counter() - t0) / PACK_REPS
    stream.close()
    it.set_epoch(0)
    sub = it.graphs
    order = np.random.RandomState(SEED).permutation(len(sub))[:P_BATCH]
    py = pack_batch([sub[i] for i in order], pre.spec, prefer_native=False)
    batch_fields_equal("first streamed batch", first[0], {
        f: np.asarray(v).astype(wire[f]) for f, v in vars(py).items()})
    calls = native.calls["pack_batch_indexed"]
    reset_counts()
    t0 = time.perf_counter()
    hist = pre.train(log=log)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    counts = read_counts()
    steps = hist[0]["steps"]
    check(pre._stack is None and steps == len(it) > 0,
          f"stream: {steps} steps, stack {pre._stack is not None}")
    check(native.calls["pack_batch_indexed"] - calls == steps,
          f"stream: {native.calls['pack_batch_indexed'] - calls} indexed "
          f"packs for {steps} steps")
    valid = len(pre.valid_iter)
    check(counts["fused_gine_bn_layer_bwd"] == 2 * LAYERS * steps
          and counts["fused_gine_bn_layer"] == 2 * LAYERS * (steps + valid),
          f"stream: {counts} for {steps} steps and {valid} validation "
          f"batches")
    check(np.isfinite(hist[0]["train_loss"])
          and np.isfinite(hist[0]["valid_loss"]), f"stream: {hist}")
    # the speed of SPEED_STEPS-step epochs of the same stream
    full = pre._stream_batches
    pre._stream_batches = lambda: itertools.islice(full(), SPEED_STEPS)
    pre.steps_per_epoch = SPEED_STEPS
    speed = path_speed(pre, "host", card)
    report = dict(card=card, train_molecules=len(sub), steps=steps,
                  valid_batches=valid, epoch_s=epoch_s, record=hist[0],
                  counts=counts, indexed_packs=steps, host_pack_ms=pack_ms,
                  step_ms=speed["step_ms"], host_ms=speed["host_ms"],
                  device_ms=speed["device_ms"],
                  device_busy_share=speed["device_busy_share"],
                  mol_per_s=speed["mol_per_s"],
                  message_edges_per_s=speed["message_edges_per_s"])
    print(f"corpus stream {json.dumps(report)}", flush=True)
    return report


def corpus_phase(tmp: str, card: str, dev, native_build_s: float) -> dict:
    """Phase 16: the native library, featurizer agreement, corpus builds,
    text against corpus, the corpus CLI and the streaming path."""
    t0 = time.perf_counter()
    check(native.lib_path().exists(), "the native library was not built")
    report = dict(card=card, native_build_s=native_build_s)
    print(f"corpus build: native library {native.lib_path().name} in "
          f"{native_build_s:.2f} s", flush=True)
    report["agreement"] = featurizer_agreement(card)
    report["builds"] = corpus_builds(tmp, card)
    report["text_vs_corpus"] = text_vs_corpus(tmp, dev)
    report["cli"] = cli_run(tmp, "corpus_cli", ["--pack-cache-max-mols",
                                                "1000000"], "gin", "units",
                            data=os.path.join(tmp, "corpus100k.mtpu"))
    report["gcn_mix"] = corpus_gcn_mix(tmp)
    report["stream"] = stream_phase(tmp, card, dev)
    report["seconds"] = time.perf_counter() - t0
    print(f"phase corpus took {report['seconds']:.1f} s", flush=True)
    return report


# --------------------------------------------------------------- phase 17

# molecules above the 256-atom tile, which only the ELL trunk (tile 0)
# takes: a 300-atom chain, a cyclohexane ring with a 274-atom tail (280
# atoms), a benzene ring with a 264-atom tail, an amino alcohol chain
BIG_SMILES = ["C" * 300, "C1CCCCC1" + "C" * 274, "c1ccccc1" + "C" * 264,
              "OC" + "C" * 268 + "N"]
# the ELL aggregations on the card against the CPU, max |card - cpu| over
# max(1, max |cpu|): f32 1e-6 (the K slot sums run in the same order on
# both, elementwise; the count products and the tables' gradients sum in
# another order); bf16 1e-2: the slot sums round each add in bf16 on both
# devices, and a count product accumulated in f32 in another order can
# round the other way, one bf16 ulp (2^-8, 3.9e-3 relative) of an element
ELL_RTOL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}


def ell_batch(graphs, tile: int = 0) -> GraphBatch:
    """graphs packed as the Pretrainer packs a B = 512 batch ('total'
    sizing, the capped slack 1.05) at `tile`, on the host."""
    return pack_batch(graphs, spec_for_graphs(graphs, len(graphs),
                                              slack=1.05, tile=tile))


def ell_run(op: str, batch, dt, dev):
    """One forward and backward of gine_aggregate / gcn_aggregate (norm
    None or the normalize_gcn weights) at D = 300 on `dev`, from seeded
    CPU draws; returns (out, dh, d t_type, d t_dir) on the CPU and a
    closure that reruns forward and backward (for timing)."""
    gen = torch.Generator().manual_seed(SEED + 17)
    n, cols = batch.num_nodes, EMB if op == "gine" else 1
    h, tt, td, g = (torch.randn(shape, generator=gen).to(dev, dt)
                    for shape in ((n, EMB), (NUM_BOND_TYPES, cols),
                                  (NUM_BOND_DIRS, cols), (n, EMB)))
    extra = (batch.nbr, batch.nbr_bond_type, batch.nbr_bond_dir,
             batch.nbr_mask)
    fn = scatter_free.gine_aggregate
    if op != "gine":
        fn = scatter_free.gcn_aggregate
        norm = None
        if op == "gcn_normalize":
            _, norm = gcn_normalization(batch.nbr, batch.nbr_mask, dt)
        extra += (norm,)
    prim = [x.requires_grad_() for x in (h, tt, td)]

    def run():
        for x in prim:
            x.grad = None
        out = fn(*prim, *extra)
        out.backward(g)
        return out

    out = run()
    return [out.detach().cpu()] + [x.grad.cpu() for x in prim], run


def ell_op_cases(graphs, card: str, dev) -> dict:
    """(a) The ELL aggregations on phase 5's batch packed at tile 0, f32
    and bf16: forward and backward on the card twice (bit-identical) and
    on the CPU (within ELL_RTOL), the card's ms per forward + backward."""
    batch = ell_batch(graphs)
    bg, bc = batch.to(dev), batch.to("cpu")
    report = {}
    for op in ("gine", "gcn", "gcn_normalize"):
        for dt in (torch.float32, torch.bfloat16):
            tag = f"{op}_{str(dt)[6:]}"
            first, run = ell_run(op, bg, dt, dev)
            second, _ = ell_run(op, bg, dt, dev)
            want, _ = ell_run(op, bc, dt, "cpu")
            check(all(torch.equal(a, b) for a, b in zip(first, second)),
                  f"ell {tag}: two card runs differ")
            errs = {}
            for name, a, b in zip(("out", "dh", "dt_type", "dt_dir"),
                                  first, want):
                err, top = rel_err(a, b)
                errs[name] = err / max(1.0, top)
                check(errs[name] <= ELL_RTOL[dt], f"ell {tag} {name}: "
                      f"|card - cpu| {err} of {top}")
            ms = time_ms(run)
            report[tag] = dict(rel_err=errs, fwd_bwd_ms=ms)
            print(f"options ell {tag} {json.dumps(report[tag])}",
                  flush=True)
            print(f"options timing ell {tag} forward + backward {ms:.4f} "
                  f"ms; {card}", flush=True)
    report["nodes"], report["slots"] = batch.num_nodes, batch.nbr.shape[1]
    return report


def pool_max_cases(batch, dev) -> dict:
    """(b) graph_pool(method='max') on phase 4's batch (tile 256, 512
    graphs) at D = 300 with ties planted (atom 1 of each molecule a copy
    of atom 0): forward and backward on the card equal to the CPU's bit
    for bit (the max is exact and the tie split a count), the card's two
    runs too; f32 and bf16."""
    real = np.flatnonzero(batch.node_mask)
    first = torch.as_tensor(real[np.unique(batch.node_graph[real],
                                           return_index=True)[1]])
    gen = torch.Generator().manual_seed(SEED + 18)
    h = torch.randn(batch.num_nodes, EMB, generator=gen)
    h[first + 1] = h[first]
    g = torch.randn(batch.num_graphs, EMB, generator=gen)
    report = {}
    for dt in (torch.float32, torch.bfloat16):
        runs = []
        for where in (dev, dev, torch.device("cpu")):
            b = batch.to(where)
            x = h.to(where, dt, copy=True).requires_grad_()
            out = graph_pool(x, b.node_graph, b.node_mask, b.num_graphs,
                             method="max")
            out.backward(g.to(where, dt))
            runs.append((out.detach().cpu(), x.grad.cpu()))
        same = [torch.equal(a, b) for a, b in zip(runs[0], runs[1])]
        cpu = [torch.equal(a, b) for a, b in zip(runs[0], runs[2])]
        check(all(same) and all(cpu), f"pool max {dt}: card runs equal "
              f"{same}, equal to the CPU {cpu}")
        split = runs[0][1][first].float()
        check(torch.equal(split, runs[0][1][first + 1].float())
              and bool(split.abs().max() > 0),
              f"pool max {dt}: the tied atoms' gradients differ")
        report[str(dt)[6:]] = dict(equal_to_cpu=True, bit_identical=True,
                                   tied_pairs=int(first.numel()))
    print(f"options pool_max {json.dumps(report)}", flush=True)
    return report


def embed_tile0_cases(tmp: str, card: str, dev) -> dict:
    """(c) The embed CLI at --tile 0 on phase 3's 1,024 SMILES and
    BIG_SMILES with phase 3's checkpoints, GIN and GCN: every molecule
    embedded, no kernel launched, within SLICE_RTOL of the --cpu run; the
    1,024 within 1e-4 * max(1, |x|) of the --tile 256 run; both runs'
    mol/s, and the forward's over pre-packed batches at tile 0."""
    smiles = synthetic_corpus(N_MOLS, seed=SEED) + BIG_SMILES
    corpus = os.path.join(tmp, "corpus_big.txt")
    with open(corpus, "w") as f:
        f.write("\n".join(smiles) + "\n")
    graphs, _ = featurize_many(smiles)
    report = {}
    for model_type in ("gin", "gcn"):
        ckpt = os.path.join(tmp, f"{model_type}.pth")
        base = ["--checkpoint", ckpt, "--model", model_type, "--layers",
                str(LAYERS), "--emb-dim", str(EMB), "--feat-dim", str(FEAT),
                "--batch-size", str(BATCH)]
        out = {k: os.path.join(tmp, f"{model_type}_big_{k}.npy")
               for k in ("ell", "tile", "cpu")}
        counts, sec = embed_run([corpus, out["ell"], *base, "--tile", "0"])
        check(not any(counts.values()), f"embed --tile 0 {model_type}: "
              f"kernels launched {counts}")
        _, sec_tile = embed_run([corpus, out["tile"], *base, "--tile",
                                 str(TILE)])
        embed_run([corpus, out["cpu"], *base, "--tile", "0", "--cpu"])
        ell, tiled, cpu = (np.load(out[k]) for k in ("ell", "tile", "cpu"))
        check(ell.shape == (len(smiles), FEAT)
              and bool(np.isfinite(ell).all()),
              f"embed --tile 0 {model_type}: {ell.shape}, expected every "
              f"one of {len(smiles)} molecules embedded and finite")
        err = float(np.abs(ell - cpu).max())
        lim = SLICE_RTOL * max(1.0, float(np.abs(cpu).max()))
        check(err <= lim, f"embed --tile 0 {model_type}: |card - cpu| "
              f"{err} > {lim}")
        check(tiled.shape == (N_MOLS, FEAT), f"embed --tile {TILE}: "
              f"{tiled.shape}")
        over = float((np.abs(ell[:N_MOLS] - tiled)
                      / np.maximum(1.0, np.abs(tiled))).max())
        check(over <= 1e-4, f"embed {model_type}: tile 0 against tile "
              f"{TILE} {over} of max(1, |x|)")
        row = dict(card=card, molecules=len(smiles), err_vs_cpu=err,
                   limit=lim, rel_err_vs_tile=over, cli_s=sec,
                   cli_mol_per_s=len(smiles) / sec, cli_tile_s=sec_tile,
                   cli_tile_mol_per_s=N_MOLS / sec_tile)
        row.update(forward_throughput(model_type, graphs, ckpt, dev,
                                      tile=0))
        report[model_type] = row
        print(f"options embed {model_type} {json.dumps(row)}", flush=True)
        print(f"options timing embed {model_type} CLI --tile 0 "
              f"{row['cli_mol_per_s']:.1f} mol/s, --tile {TILE} "
              f"{row['cli_tile_mol_per_s']:.1f} mol/s, forward at tile 0 "
              f"{row['forward_mol_per_s']:.1f} mol/s; {card}", flush=True)
    return report


def ell_step_cases(graphs, dev) -> dict:
    """(d) Three full-width GIN steps at tile 0 (B = 512, node, f32) card
    against CPU under phase 5's limits, no kernel launched, and two
    identical card steps bit-identical; (f) one GCN normalize_gcn step."""
    batch = ell_batch(graphs)
    bw = spec_for_graphs(graphs, len(graphs), slack=1.05,
                         tile=0).max_graph_bonds
    report = {}
    for tag, kw, steps in (("gin", {}, P_STEPS),
                           ("gcn_normalize", dict(gnn="gcn",
                                                  normalize_gcn=True), 1)):
        cfg = pretrain_cfg(tile=0, **kw)
        models, opts = card_and_cpu(cfg, dev)
        rep = card_vs_cpu_steps(models, opts, cfg, batch, dev, bw, 0, steps,
                                {}, f"ell step {tag}")
        if tag == "gin":
            bit_identical_steps(models["card"], opts["card"], cfg,
                                batch.to(dev), bw, steps, "ell step")
            rep["bit_identical_steps"] = True
        report[tag] = rep
        print(f"options ell step {tag} {json.dumps(rep)}", flush=True)
    return report


def ell_resident_cases(tmp: str, card: str, dev, units_row) -> dict:
    """(e) The Pretrainer at tile 0 on phase 7's corpus and BIG_SMILES:
    no tile-units, a host epoch, then the cached batches resident;
    EQUAL_STEPS graphed steps bit-identical to eager ones, no kernel
    launched; the graphed step's speed (phase 15's method) beside phase
    15's units-path GIN f32 graphed step."""
    log = lambda *_: None  # noqa: E731
    smiles = read_pretrain_smiles(os.path.join(tmp, "pretrain.txt"))
    pre = Pretrainer(pretrain_cfg(tile=0), dev)
    pre.setup_data(smiles + BIG_SMILES).setup_state()
    pre._activate_units(log)
    check(not pre._units, "tile 0 took the units path")
    pre._host_epoch(0, log)
    pre._maybe_upload_cache(log)
    check(pre._stack is not None, "tile 0: the batch cache was not "
          "uploaded")
    big = int((pre._stack["graph_n_nodes"] > TILE).sum())
    report = dict(cached_batches=int(pre._stack["graph_mask"].shape[0]),
                  cached_molecules_over_tile=big)
    report["equal"] = eager_vs_graphed(pre, "gin_tile0")
    row = path_speed(pre, "resident_graphed", card)
    report["speed"] = row
    report["units_graphed"] = {k: units_row[k] for k in (
        "step_ms", "host_ms", "device_ms", "device_busy_share",
        "message_edges_per_s", "mol_per_s")}
    print(f"options timing resident graphed step tile 0: {row['step_ms']:.3f}"
          f" ms (host {row['host_ms']:.3f}, device {row['device_ms']:.3f}, "
          f"busy {row['device_busy_share']:.3f}); units path tile {TILE}: "
          f"{units_row['step_ms']:.3f} ms (host {units_row['host_ms']:.3f}, "
          f"device {units_row['device_ms']:.3f}, busy "
          f"{units_row['device_busy_share']:.3f}); {card}", flush=True)
    return report


def pool_max_step_cases(tmp: str, batch, spec, dev) -> dict:
    """(g) pool max at tile 256 (GIN): one step card against CPU on phase
    4's batch (K1f 10, K1b 10), and EQUAL_STEPS units-path steps graphed
    against eager on phase 7's corpus, bit-identical."""
    log = lambda *_: None  # noqa: E731
    cfg = pretrain_cfg(pool="max")
    models, opts = card_and_cpu(cfg, dev)
    want = dict(fused_gine_bn_layer=2 * LAYERS,
                fused_gine_bn_layer_bwd=2 * LAYERS)
    report = dict(step=card_vs_cpu_steps(
        models, opts, cfg, batch, dev, spec.max_graph_bonds, 0, 1, want,
        "pool max step"))
    pre = Pretrainer(cfg, dev)
    pre.setup_data(read_pretrain_smiles(os.path.join(tmp, "pretrain.txt")))
    pre.setup_state()
    pre._activate_units(log)
    check(pre._units, "pool max: the units path did not activate")
    report["equal"] = eager_vs_graphed(pre, "gin_pool_max")
    return report


def link_cases(dev) -> dict:
    """(h) LinkFineTuneNet at configs/finetune.yaml's model (5 x 300 / 512,
    drop 0.3, pred head 2 x softplus) on phase 8's 32 molecules: forward
    and backward of the task's CE loss on the card and on the CPU with
    the same keep masks, at tile 256 (K4f 5, K4b 5) and tile 0 (no
    kernel): h and the scores within SLICE_RTOL, gradients within
    STEP_GRAD_RTOL of the largest (phase 5's rule for a step's
    gradients), the label table's gradient nonzero."""
    graphs, _ = featurize_many(synthetic_corpus(FT_MOLS, seed=SEED),
                               add_hs=True)
    labels = torch.randint(0, 2, (FT_BATCH,),
                           generator=torch.Generator().manual_seed(SEED))
    report = {}
    for tile in (TILE, 0):
        batch = pack_batch(graphs[:FT_BATCH], spec_for_graphs(
            graphs, FT_BATCH, tile=tile))
        masks = None
        out = {}
        for where in ("card", "cpu"):
            d = dev if where == "card" else torch.device("cpu")
            model = LinkFineTuneNet(
                num_layers=LAYERS, emb_dim=EMB, feat_dim=FEAT,
                drop_ratio=0.3, tile=tile,
                generator=torch.Generator().manual_seed(SEED + 5))
            model = model.to(d).train()
            if masks is None:
                masks = model.keep_masks(batch.num_nodes, torch.Generator(
                    device=d).manual_seed(SEED + 6))
            b = batch.to(d)
            lab = torch.zeros(b.num_graphs)
            lab[:FT_BATCH] = labels.float()
            reset_counts()
            h, pred = model(b, dropout_masks=[m.to(d) for m in masks])
            ft_lib.compute_loss(pred.float(), lab.to(d), b.graph_mask,
                                "ce").backward()
            if where == "card":
                torch.cuda.synchronize()
                counts = read_counts()
            out[where] = (h.detach().cpu(), pred.detach().cpu(), {
                k: p.grad.cpu() for k, p in model.named_parameters()})
        want = (dict(fused_gine_layer=LAYERS, fused_gine_layer_bwd=LAYERS)
                if tile else {})
        for name, c in counts.items():
            check(c == want.get(name, 0), f"link tile {tile}: {name} "
                  f"launched {c} times, expected {want.get(name, 0)}")
        errs = {}
        for what, a, b in zip(("h", "pred"), out["card"], out["cpu"]):
            err, top = rel_err(a, b)
            errs[what] = err / max(1.0, top)
            check(errs[what] <= SLICE_RTOL, f"link tile {tile} {what}: "
                  f"{err} of {top}")
        gc, gp = out["card"][2], out["cpu"][2]
        gmax = max(g.abs().max().item() for g in gp.values())
        gworst = max((gc[k] - gp[k]).abs().max().item() for k in gp) / gmax
        check(gworst <= STEP_GRAD_RTOL[torch.float32],
              f"link tile {tile}: gradients {gworst} of the largest")
        check(bool(gc["label_embedding"].abs().max() > 0),
              f"link tile {tile}: no label_embedding gradient")
        report[f"tile_{tile}"] = dict(counts=counts, rel_err=errs,
                                      grad_off=gworst)
    print(f"options link {json.dumps(report)}", flush=True)
    return report


def tensorboard_case(tmp: str) -> dict:
    """(i) Whether torch.utils.tensorboard imports here, and what
    MetricWriter(tensorboard=True) did: event files written, or the one
    line that says none are."""
    try:
        import torch.utils.tensorboard  # noqa: F401
        importable, why = True, None
    except ImportError as e:
        importable, why = False, str(e)
    run_dir = os.path.join(tmp, "tensorboard")
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        w = MetricWriter(run_dir, tensorboard=True)
        w.scalars(1, train_loss=0.5, validation_loss=float("nan"))
        w.close()
    events = [f for f in os.listdir(run_dir) if "tfevents" in f]
    check(bool(events) == importable and (importable or "writing no "
                                          "TensorBoard" in said.getvalue()),
          f"tensorboard: importable {importable}, events {events}, said "
          f"{said.getvalue()!r}")
    report = dict(importable=importable, import_error=why,
                  event_files=len(events), said=said.getvalue().strip())
    print(f"options tensorboard {json.dumps(report)}", flush=True)
    return report


def model_options_phase(tmp: str, card: str, dev, batch, spec,
                        units_row) -> dict:
    """Phase 17: the JAX package's model options on the card."""
    t0 = time.perf_counter()
    graphs, _ = featurize_many(synthetic_corpus(P_BATCH, seed=7))
    report = dict(card=card)
    report["ell_ops"] = ell_op_cases(graphs, card, dev)
    report["pool_max"] = pool_max_cases(batch, dev)
    report["embed"] = embed_tile0_cases(tmp, card, dev)
    report["ell_steps"] = ell_step_cases(graphs, dev)
    report["ell_resident"] = ell_resident_cases(tmp, card, dev, units_row)
    report["pool_max_steps"] = pool_max_step_cases(tmp, batch, spec, dev)
    report["link"] = link_cases(dev)
    report["tensorboard"] = tensorboard_case(tmp)
    report["seconds"] = time.perf_counter() - t0
    print(f"phase options took {report['seconds']:.1f} s", flush=True)
    return report


# ---------------------------------------------------------------- phase 18

# (b): images per rank, so that the global 2B = 2 x DP_B x DP_RANKS is
# 4,096, where 'auto' takes K2f / K2b on the gathered projections
DP_RANKS, DP_B, DP_STEPS = 2, 1024, 3
# the DP steps held card against CPU: (name, gnn, the trunk's layer kernel,
# steps, config): GIN and GCN in f32, then one bf16 GIN step (K1f / K1b)
# and one GIN step at drop_ratio 0.1, the unchained trunk (K4f / K4b
# between cross-rank BatchNorms), its masks from each rank's own streams
DP_CASES = (("gin", "gin", "fused_gine_bn_layer", DP_STEPS, {}),
            ("gcn", "gcn", "fused_gcn_bn_layer", DP_STEPS, {}),
            ("gin_bf16", "gin", "fused_gine_bn_layer", 1, dict(bf16=True)),
            ("gin_dropout", "gin", "fused_gine_layer", 1,
             dict(drop_ratio=0.1)))
DP_TIMEOUT_S = 400
# per rank and GIN step: 2 views x LAYERS BatchNorm moment sums forward and
# backward, the pairs' gather forward and backward, the pair mask's gather,
# the gradient mean
DP_COLLECTIVES = 4 * LAYERS + 4
ORBAX_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "data", "orbax")


def dp_config(tmp: str) -> str:
    """configs/pretrain.yaml with data_axis: data, in tmp."""
    import yaml

    with open("configs/pretrain.yaml") as f:
        raw = yaml.safe_load(f)
    raw["data_axis"] = "data"
    path = os.path.join(tmp, "pretrain_dp.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def dp_vs_one_card(pre, dev) -> dict:
    """Two steps from the same seeded state on the same units-path batches
    and views: the world-1 DP step (its collectives on the NCCL group)
    against the one-card step, loss, gradients, parameters and BatchNorm
    stats bit for bit."""
    cfg1, cfgd = pretrain_cfg(), pretrain_cfg(data_axis="data")
    models, opts = {}, {}
    for tag, cfg, dp in (("one", cfg1, None), ("dp", cfgd, pre.dp)):
        models[tag] = build_model(cfg, torch.Generator().manual_seed(
            SEED + 2), dp).to(dev)
        opts[tag] = optim.adam_torch(models[tag].parameters(),
                                     cfg.weight_decay)
    bw, mw = pre.spec.max_graph_bonds, pre.max_waves
    losses = []
    for step, row in enumerate(pre._unit_orders(1)[:2]):
        batch = concat_units(pre._stack, torch.as_tensor(row, device=dev))
        keys = draw_paired_keys(cfg1.aug, batch.num_nodes, batch.num_graphs,
                                step_generator(SEED, TRAIN_STREAM, step))
        views = paired_augment_keys(batch, keys, cfg1.aug, tile=TILE,
                                    bond_window=bw, max_waves=mw)
        c0 = pre.dp.collectives
        got = {tag: train_step(models[tag], opts[tag], batch,
                               cfg1 if tag == "one" else cfgd, step,
                               cfg1.init_lr, views=views, bond_window=bw,
                               max_waves=mw, dp=pre.dp if tag == "dp"
                               else None) for tag in ("one", "dp")}
        check(pre.dp.collectives - c0 == DP_COLLECTIVES,
              f"dp world 1: {pre.dp.collectives - c0} collectives in a step")
        check(torch.equal(got["one"], got["dp"]), f"dp world 1 step {step}: "
              f"loss {got['dp'].item()} against {got['one'].item()}")
        one, dp = models["one"], models["dp"]
        differ = [k for k, v in one.state_dict().items()
                  if not torch.equal(v, dp.state_dict()[k])]
        differ += [k for (k, p), q in zip(one.named_parameters(),
                                          dp.parameters())
                   if not torch.equal(p.grad, q.grad)]
        check(not differ, f"dp world 1 step {step}: differs in {differ}")
        losses.append(got["one"].item())
    return dict(steps=len(losses), losses=losses, bit_identical=True,
                collectives_per_step=DP_COLLECTIVES)


def dp_world1_steps(pre, dev) -> dict:
    """(a) At world 1 on NCCL, one DP step of each DP_CASES beyond f32 (GIN
    bf16: K1f / K1b; GIN drop_ratio 0.1: K4f / K4b, its masks from the
    card's own streams of rank 0) on the DP Pretrainer pre's first
    units-path batch (the batch dp_vs_one_card steps first), from the state
    of the CPU twin, which runs the one-card step (at world 1 the DP step
    is the one-card step bit for bit, and the NCCL group takes no CPU
    tensor) on the card's masks: the STEP_* limits of the step's dtype and
    the launches per step."""
    batch = on_cpu(concat_units(pre._stack, torch.as_tensor(
        pre._unit_orders(1)[0], device=dev)))
    out = {}
    for name, gnn, layer, _, kw in DP_CASES[2:]:
        cfg = pretrain_cfg(gnn=gnn, data_axis="data", **kw)
        dps = {"card": pre.dp, "cpu": None}
        models, opts = card_and_cpu(cfg, dev, dps)
        out[name] = card_vs_cpu_steps(
            models, opts, cfg, batch, dev, pre.spec.max_graph_bonds, 0, 1,
            {layer: 2 * LAYERS, f"{layer}_bwd": 2 * LAYERS},
            f"dp world 1 {name}", max_waves=pre.max_waves, dps=dps)
        print(f"dp world 1 {name} {json.dumps(out[name])}", flush=True)
    return out


def dp_world1_cases(tmp: str, card: str, dev, units_row: dict) -> dict:
    """(a) World 1 on NCCL: the pretrain CLI with data_axis through the
    default units path (graphed) with a resume (cli_run's checks); then in
    this process, on the CLI's group, a DP Pretrainer on phase 7's corpus:
    one eager step's collectives, EQUAL_STEPS graphed steps bit-identical
    to eager ones, its speed beside phase 15's one-card units path, the DP
    step against the one-card step bit for bit, a bf16 and a dropout DP
    step against the CPU (dp_world1_steps), and the same Pretrainer at
    drop_ratio 0.1 with its graphed steps bit-identical to eager ones
    (K4f 10 / K4b 10 per step)."""
    import torch.distributed as dist

    log = lambda *_: None  # noqa: E731
    report = dict(cli=cli_run(tmp, "pretrain_dp_world1",
                              ["--config", dp_config(tmp), "--distributed"],
                              "gin", "units"))
    check(not dist.is_initialized(), "dp world 1: the CLI left its group")
    dp = init_distributed(backend="nccl", log=log)
    check(dp.world == 1 and dist.get_backend() == "nccl",
          f"dp world 1: {dp}")
    pre = Pretrainer(pretrain_cfg(data_axis="data"), dev, dp=dp)
    pre.setup_data(read_pretrain_smiles(os.path.join(tmp, "pretrain.txt")))
    pre.setup_state()
    pre._activate_units(log)
    check(pre._units and pre.graph_steps > 0,
          "dp world 1: the units path with graphs did not activate")
    # before the Pretrainer's own steps, which must capture their graph
    # after eager_vs_graphed's warm-up, as in phase 15
    report["dp_vs_one_card"] = dp_vs_one_card(pre, dev)
    report["equal"] = eager_vs_graphed(pre, "dp_world1")
    per_step = {k: c / EQUAL_STEPS
                for k, c in report["equal"]["eager_launches"].items() if c}
    check(per_step == {"fused_gine_bn_layer": 2 * LAYERS,
                       "fused_gine_bn_layer_bwd": 2 * LAYERS},
          f"dp world 1: launches per eager step {per_step}")
    report["steps"] = dp_world1_steps(pre, dev)
    drop = fork(pre, pretrain_cfg(data_axis="data", drop_ratio=0.1), True,
                dp)
    check(drop.graph_steps > 0, "dp world 1 dropout: no graphs")
    report["equal_dropout"] = eager_vs_graphed(drop, "dp_world1_dropout")
    per_step = {k: c / EQUAL_STEPS for k, c in report["equal_dropout"][
        "eager_launches"].items() if c}
    check(per_step == {"fused_gine_layer": 2 * LAYERS,
                       "fused_gine_layer_bwd": 2 * LAYERS},
          f"dp world 1 dropout: launches per eager step {per_step}")
    report["speed"] = path_speed(pre, "resident_graphed", card)
    report["one_card_units_row"] = {k: units_row[k] for k in (
        "step_ms", "host_ms", "device_ms", "device_busy_share")}
    sp = report["speed"]
    print(f"dp world 1 (NCCL): graphed step {sp['step_ms']:.3f} ms, host "
          f"{sp['host_ms']:.3f}, device {sp['device_ms']:.3f}, busy "
          f"{sp['device_busy_share']:.3f}; one-card units path "
          f"{units_row['step_ms']:.3f} / {units_row['host_ms']:.3f} / "
          f"{units_row['device_ms']:.3f} / "
          f"{units_row['device_busy_share']:.3f}; {card}", flush=True)
    return report


def ranks_bit_identical(model, dp) -> bool:
    """Whether every rank holds this model's state bit for bit: the
    elementwise max and min across the ranks equal this rank's values."""
    flat = torch.cat([v.detach().reshape(-1).double()
                      for v in model.state_dict().values()])
    hi = dp.all_reduce_(flat.clone(), torch.distributed.ReduceOp.MAX)
    lo = dp.all_reduce_(flat.clone(), torch.distributed.ReduceOp.MIN)
    return bool(torch.equal(hi, flat) and torch.equal(lo, flat))


def dp_rank_main(rank: int, port: int, out_dir: str,
                 dev=torch.device("cuda", 0)) -> int:
    """(b), one rank: DP_RANKS processes share the card through gloo over
    CUDA tensors. The DP_CASES at full width with DP_B molecules per rank
    (GIN, GCN: DP_STEPS eager steps; GIN bf16, GIN dropout 0.1: one), each
    card step from the state of the CPU twin that runs the same rank's
    step with the plain versions (gloo on CPU tensors; with dropout on the
    card's own masks): the STEP_* limits of the step's dtype, the launches
    per step, the ranks' states bit-identical after each step; then for
    GIN and GCN the card step's time (two processes on one card: a
    record, not a speed figure)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # each rank its share of the host's cores, as the partitioned ranks take:
    # with all the cores each, the two ranks' CPU twins once rounded the loss
    # of the same gathered pairs differently
    torch.set_num_threads(max(1, (os.cpu_count() or DP_RANKS) // DP_RANKS))
    dps = {"card": init_distributed(
        f"127.0.0.1:{port}", DP_RANKS, rank, backend="gloo", device=dev,
        timeout_s=DP_TIMEOUT_S)}
    dps["cpu"] = DPGroup(rank, DP_RANKS, "gloo", "cpu")
    graphs, _ = featurize_many(synthetic_corpus(DP_RANKS * DP_B,
                                                seed=SEED + 11))
    spec = spec_for_graphs(graphs, DP_B, tile=TILE)
    batch = pack_batch(graphs[rank * DP_B: (rank + 1) * DP_B], spec)
    report = dict(rank=rank, spec=str(spec))
    try:
        for name, gnn, layer, n_steps, kw in DP_CASES:
            want = {layer: 2 * LAYERS, f"{layer}_bwd": 2 * LAYERS,
                    "ntxent_fwd": 1, "ntxent_bwd": 1}
            cfg = pretrain_cfg(gnn=gnn, data_axis="data", **kw)
            cfg.batch_size = DP_B
            models, opts = card_and_cpu(cfg, dev, dps)
            steps = []
            for step in range(n_steps):
                steps.append(card_vs_cpu_steps(
                    models, opts, cfg, batch, dev, spec.max_graph_bonds,
                    step, 1, want, f"dp {name} rank {rank}", dps=dps))
                check(ranks_bit_identical(models["card"], dps["card"]),
                      f"dp {name} step {step}: the ranks' states differ")
            if name != gnn:
                report[name] = dict(steps=steps, ranks_bit_identical=True)
                continue
            bg = batch.to(dev)
            times = []
            for step in range(DP_STEPS, 2 * DP_STEPS):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                train_step(models["card"], opts["card"], bg, cfg, step,
                           cfg.init_lr, bond_window=spec.max_graph_bonds,
                           dp=dps["card"], stream=(rank,))
                e1.record()
                torch.cuda.synchronize()
                times.append(e0.elapsed_time(e1))
            report[gnn] = dict(steps=steps, shared_card_step_ms=times,
                               ranks_bit_identical=True)
    finally:
        destroy_distributed()
    with open(os.path.join(out_dir, f"dp_rank{rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def run_script_ranks(flag: str, world: int, tmp: str, timeout_s: float,
                     tag: str) -> list:
    """`world` processes of this script (`flag RANK PORT TMP`), all done
    within timeout_s or killed; their reports (TMP/<tag>_rank<r>.json)."""
    port = free_port()
    logs = [os.path.join(tmp, f"{tag}_rank{r}.log") for r in range(world)]
    files = [open(path, "wb") for path in logs]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r),
         str(port), tmp], stdout=f, stderr=subprocess.STDOUT)
        for r, f in enumerate(files)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p, f in zip(procs, files):
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    for r, (p, path) in enumerate(zip(procs, logs)):
        with open(path, errors="replace") as f:
            out = f.read()
        check(p.returncode == 0, f"{tag} rank {r} exited {p.returncode}:\n"
              f"{out[-3000:]}")
    reports = []
    for r in range(world):
        with open(os.path.join(tmp, f"{tag}_rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def dp_two_rank_cases(tmp: str) -> dict:
    """(b) DP_RANKS processes of this script (`--dp-rank`), all done within
    DP_TIMEOUT_S or killed; their reports."""
    reports = run_script_ranks("--dp-rank", DP_RANKS, tmp, DP_TIMEOUT_S,
                               "dp")
    summary = {}
    for name, *_ in DP_CASES:
        losses = [[s["losses"] for s in rep[name]["steps"]]
                  for rep in reports]
        check(all(x == losses[0] for x in losses),
              f"dp {name}: the ranks' losses differ: {losses}")
        summary[name] = [dict(
            rank=rep["rank"], losses=[s["losses"][0] for s in
                                      rep[name]["steps"]],
            counts={k: v for k, v in rep[name]["steps"][0]["counts"][
                0].items() if v},
            fraction_off=max(s["fraction_off"][0]
                             for s in rep[name]["steps"]),
            grad_off=max(s["grad_off"][0] for s in rep[name]["steps"]),
            max_param_diff=max(s["max_param_diff"][0]
                               for s in rep[name]["steps"]),
            shared_card_step_ms=rep[name].get("shared_card_step_ms"))
            for rep in reports]
    print(f"dp two ranks {json.dumps(summary)}", flush=True)
    return dict(ranks=reports, summary=summary)


def orbax_cases(tmp: str, card: str) -> dict:
    """(c) The JAX package's Orbax fixture (tests/data/orbax, written by
    runs/write_orbax_fixture.py) read on this machine, which has no JAX,
    Orbax, tensorstore or zstandard: the zstd decoder's g++ build (0 where
    it was built), the read's time, and cli.embed
    --checkpoint <dir> on the card against JAX's embeddings within
    SLICE_RTOL (phase 3's limit), K1f launched once per layer."""
    step = os.path.join(ORBAX_FIXTURE, "gin", "step_0")
    build_s = native.build(zstd.SRC)
    t0 = time.perf_counter()
    tree = read_step_dir(step)
    read_s = time.perf_counter() - t0
    n_leaves = sum(1 for part in ("params", "batch_stats")
                   for _ in _leaves(tree[part]))
    two = read_step_dir(os.path.join(ORBAX_FIXTURE, "two_process", "step_2"))
    check(np.array_equal(two["params"]["sharded"], np.arange(
        48, dtype=np.float32).reshape(8, 6)), "orbax: the two-process "
          "fixture's sharded leaf reads wrong")
    out = os.path.join(tmp, "orbax_embed.npy")
    counts, sec = embed_run([os.path.join(ORBAX_FIXTURE, "smiles.txt"), out,
                             "--checkpoint", step, "--layers", "2",
                             "--emb-dim", "64", "--feat-dim", "128"])
    got = np.load(out)
    ref = np.load(os.path.join(ORBAX_FIXTURE, "embeddings.npy"))
    check(got.shape == ref.shape, f"orbax embed: {got.shape} {ref.shape}")
    err = float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))
    check(err <= SLICE_RTOL, f"orbax embed: {err} of JAX's embeddings")
    check(counts["fused_gine_bn_layer"] == 2,
          f"orbax embed: launches {counts}")
    report = dict(card=card, zstd_build_s=build_s, read_s=read_s,
                  leaves=n_leaves,
                  embed_s=sec, rel_err=err, launches=counts)
    print(f"dp orbax {json.dumps(report)}", flush=True)
    return report


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def dp_phase(tmp: str, card: str, dev, units_row: dict) -> dict:
    """Phase 18: data parallelism on the card, and the Orbax reader."""
    t0 = time.perf_counter()
    report = dict(card=card)
    report["two_ranks"] = dp_two_rank_cases(tmp)
    report["world1"] = dp_world1_cases(tmp, card, dev, units_row)
    destroy_distributed()
    report["orbax"] = orbax_cases(tmp, card)
    report["seconds"] = time.perf_counter() - t0
    print(f"dp {json.dumps({k: v for k, v in report.items() if k != 'world1'})}",
          flush=True)
    print(f"phase dp took {report['seconds']:.1f} s", flush=True)
    return report


# ---------------------------------------------------------------- phase 19

# (a): PART_RANKS processes share the card; the giant batch is PART_RANKS
# shards of P_BATCH molecules of phase 7's corpus, each packed as the
# Pretrainer packs B = 512 at tile 256, concatenated (a global 2B of
# 4,096: 'auto' runs K2f / K2b on the gathered pairs)
PART_RANKS, PART_STEPS = 4, 3
PART_TIMEOUT_S = 400
# per rank and GIN step: the data-parallel step's all-reduces and the
# running statistics' mean
PART_COLLECTIVES = DP_COLLECTIVES + 1
# the partitioned steps held card against CPU: (name, gnn, the trunk's
# layer kernel, steps, config): GIN (PART_STEPS) and GCN (1) in f32 on the
# BN chain, then one GIN and one GCN step at drop_ratio 0.1 on the
# unchained trunk: K4f / K4b (K5f / K5b) on the rank's local tiles with
# the cross-rank BatchNorm between them, expected 2 views x LAYERS = 10
# launches of each per rank and step, its masks from each rank's own
# streams, the same PART_COLLECTIVES (MaskedBatchNorm sums its moments in
# one all-reduce each way, as the chained trunk's coefficient mode)
PART_CASES = (("gin", "gin", "fused_gine_bn_layer", PART_STEPS, {}),
              ("gcn", "gcn", "fused_gcn_bn_layer", 1, {}),
              ("gin_dropout", "gin", "fused_gine_layer", 1,
               dict(drop_ratio=0.1)),
              ("gcn_dropout", "gcn", "fused_gcn_layer", 1,
               dict(drop_ratio=0.1)))


def part_giant_batch():
    """PART_RANKS shards of P_BATCH molecules of phase 7's corpus
    (synthetic_corpus(4096, seed=0)), each packed with one spec as the
    Pretrainer sizes B = 512 at tile 256 ('total', the capped slack 1.05),
    concatenated: (the concat_shards batch of CPU tensors, the spec)."""
    graphs, _ = featurize_many(synthetic_corpus(4096, seed=0)[
        : PART_RANKS * P_BATCH])
    spec = spec_for_graphs(graphs, P_BATCH, slack=1.05, tile=TILE)
    shards = [pack_batch(graphs[i * P_BATCH: (i + 1) * P_BATCH], spec)
              for i in range(PART_RANKS)]
    for sh in shards:
        check(int(sh.graph_mask.sum()) == P_BATCH,
              "partitioned: a shard dropped molecules")
    return concat_shards([sh.to("cpu") for sh in shards]), spec


def part_edge_batches(world: int):
    """Phase 5's B = 512 molecules packed at tile 0 (rows a multiple of
    the world) and at tile 256 (tiles a multiple of the world), on the
    host."""
    graphs, _ = featurize_many(synthetic_corpus(P_BATCH, seed=7))
    out = {}
    for tile in (0, TILE):
        spec = spec_for_graphs(graphs, P_BATCH, slack=1.05, tile=tile)
        unit = world * (tile or 1)
        spec = dataclasses.replace(spec, n_nodes=-(-spec.n_nodes // unit)
                                   * unit)
        out[tile] = pack_batch(graphs, spec)
    return out, max(g.n_atoms for g in graphs)


def part_edge_cases(dp, dev) -> dict:
    """(b) edgepart's three variants at D = 300 across the ranks on the
    card: gather and halo on phase 5's batch at tile 0 (halo the largest
    molecule's atoms), the tile variant at tile 256; forward and backward
    (the tables' partials summed across the ranks) against the
    single-rank gine_aggregate on the card within ELL_RTOL, two runs
    bit-identical, the tile variant without a collective; the all-reduce
    bytes per layer, forward and backward, and the ms of a forward and
    backward on the shared card."""
    batches, halo = part_edge_batches(dp.world)
    report = dict(halo_rows=halo)
    for variant, tile in (("gather", 0), ("halo", 0), ("tile", TILE)):
        batch = batches[tile].to(dev)
        n = batch.num_nodes
        n_local = n // dp.world
        check(halo <= n_local, f"partitioned edge: halo {halo} > "
              f"{n_local} rows per rank")
        gen = torch.Generator().manual_seed(SEED + 19)
        h, tt, td, g = (torch.randn(shape, generator=gen).to(dev)
                        for shape in ((n, EMB), (NUM_BOND_TYPES, EMB),
                                      (NUM_BOND_DIRS, EMB), (n, EMB)))
        h = h * batch.node_mask[:, None]
        prim = [x.clone().requires_grad_() for x in (h, tt, td)]
        ref_out = scatter_free.gine_aggregate(
            *prim, batch.nbr, batch.nbr_bond_type, batch.nbr_bond_dir,
            batch.nbr_mask)
        ref_out.backward(g)
        rows = slice(dp.rank * n_local, (dp.rank + 1) * n_local)
        ref = [ref_out.detach()[rows], prim[0].grad[rows], prim[1].grad,
               prim[2].grad]
        shard = {k: v[dp.rank] for k, v in shard_ell_rows(batch,
                                                          dp.world).items()}
        layer = build_sharded_layer(dp, variant, halo=halo, tile=TILE)

        def run():
            loc = [h[rows].clone().requires_grad_(), tt.clone()
                   .requires_grad_(), td.clone().requires_grad_()]
            c0, b0 = dp.collectives, dp.reduced_bytes
            out = layer(*loc, shard["nbr"], shard["nbr_bond_type"],
                        shard["nbr_bond_dir"], shard["nbr_mask"])
            c1, b1 = dp.collectives, dp.reduced_bytes
            out.backward(g[rows])
            c2, b2 = dp.collectives, dp.reduced_bytes
            got = [out.detach(), loc[0].grad, dp.all_reduce_(loc[1].grad),
                   dp.all_reduce_(loc[2].grad)]
            return got, (c1 - c0, c2 - c1), (b1 - b0, b2 - b1)

        first, calls, sent = run()
        second, _, _ = run()
        check(all(torch.equal(a, b) for a, b in zip(first, second)),
              f"partitioned edge {variant}: two runs differ")
        errs = {}
        for name, a, b in zip(("out", "dh", "dt_type", "dt_dir"), first,
                              ref):
            err, top = rel_err(a, b)
            errs[name] = err / max(1.0, top)
            check(errs[name] <= ELL_RTOL[torch.float32],
                  f"partitioned edge {variant} {name}: |sharded - single| "
                  f"{err} of {top}")
        want_calls = (0, 0) if variant == "tile" else (1, 1)
        check(calls == want_calls, f"partitioned edge {variant}: "
              f"all-reduces {calls}, expected {want_calls}")
        times = []
        for _ in range(5):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            run()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        report[variant] = dict(
            rows=n, rows_per_rank=n_local, rel_err=errs, all_reduces=calls,
            reduced_bytes=sent, shared_card_fwd_bwd_ms=times,
            ppermute_bytes=(2 * halo * EMB * 4 if variant == "halo"
                            else None))
    return report


def part_one_card_none(cfg, shard, cat, dps, dev) -> dict:
    """The aug 'none' partitioned step on the card against the one-card
    step on the whole giant batch on the card (rank 0), from the same
    seeded state: the return_grads call against the one-card gradients
    (loss within STEP_LOSS_RTOL, each tensor's gradient within
    STEP_GRAD_RTOL of the largest, as JAX holds its partitioned step to
    its unsharded one at the gradient), then one step each: the loss, the
    parameters within Adam's envelope and the BatchNorm stats as
    state_agreement holds them; the share of real-gradient elements off
    is recorded (a 2,048-molecule batch sums four times the atoms of
    phase 5's per embedding row, and a sign flip of a gradient near 1e-4
    moves a whole Adam step). K1f 10 / K1b 10 / K2f 1 / K2b 1 launches
    per step on both."""
    cfg_n = dataclasses.replace(cfg, aug="none")
    model_p, one = (build_model(cfg, torch.Generator().manual_seed(
        SEED + 3), d).to(dev) for d in (dps["card"], None))
    opt_p = optim.adam_torch(model_p.parameters(), cfg.weight_decay)
    opt_1 = optim.adam_torch(one.parameters(), cfg.weight_decay)
    sg = shard.to(dev)
    loss_rg, grads_p = partitioned_train_step(
        model_p, opt_p, sg, cfg_n, 0, cfg.init_lr, dps["card"],
        return_grads=True)
    reset_counts()
    loss_p = partitioned_train_step(model_p, opt_p, sg, cfg_n, 0,
                                    cfg.init_lr, dps["card"])
    torch.cuda.synchronize()
    counts_p = read_counts()
    check(torch.equal(loss_rg, loss_p), "partitioned none: the return_grads "
          "call moved the state")
    report = dict(loss_partitioned=loss_p.item(),
                  counts={k: v for k, v in counts_p.items() if v})
    if dps["card"].rank != 0:
        return report
    bc = cat.to(dev)
    snap = copy.deepcopy(one.state_dict())
    loss_fb = forward_backward(one, opt_1, bc, cfg_n, 0)
    grads_1 = {k: p.grad.clone() for k, p in one.named_parameters()}
    one.load_state_dict(snap)
    reset_counts()
    loss_1 = train_step(one, opt_1, bc, cfg_n, 0, cfg.init_lr)
    torch.cuda.synchronize()
    counts_1 = read_counts()
    report["counts_one_card"] = {k: v for k, v in counts_1.items() if v}
    for c in (counts_p, counts_1):
        check({k: v for k, v in c.items() if v} == {
            "fused_gine_bn_layer": 2 * LAYERS,
            "fused_gine_bn_layer_bwd": 2 * LAYERS, "ntxent_fwd": 1,
            "ntxent_bwd": 1}, f"partitioned none: launches {c}")
    check(torch.equal(loss_fb.detach(), loss_1), "partitioned none: the "
          "one-card forward_backward and step differ")
    check(abs(loss_p.item() - loss_1.item())
          <= STEP_LOSS_RTOL[one.dtype] * abs(loss_1.item()),
          f"partitioned none: loss {loss_p.item()} against the one-card "
          f"step's {loss_1.item()}")
    gmax = max(g.abs().max().item() for g in grads_1.values())
    gworst = 0.0
    for k, g in grads_1.items():
        off = (grads_p[k] - g).abs().max().item()
        gworst = max(gworst, off / gmax)
        check(off <= STEP_GRAD_RTOL[torch.float32] * gmax,
              f"partitioned none: {k} gradient differs by {off} (the "
              f"largest gradient {gmax})")
    off, top, stat, _ = state_agreement(
        model_p, one.cpu(), 0, cfg.init_lr,
        "partitioned none against one card", hold_share=False)
    report.update(loss_one_card=loss_1.item(), grad_off=gworst,
                  fraction_off=off, max_param_diff=top,
                  running_stats_over_limit=stat)
    return report


def part_rank_main(rank: int, port: int, out_dir: str,
                   dev=torch.device("cuda", 0)) -> int:
    """(a) and (b), one rank: PART_RANKS processes share the card through
    gloo over CUDA tensors. GIN: PART_STEPS eager partitioned steps on the
    rank's segment of the giant batch, each card step from the state of
    the CPU twin that runs the same rank's partitioned step with the plain
    versions: the STEP_* limits, K1f 10 / K1b 10 / K2f 1 / K2b 1 per step,
    PART_COLLECTIVES all-reduces, the ranks' states bit-identical after
    every step; the card step's ms (PART_RANKS processes on one card: a
    record, not a speed figure). GCN: one such step (K3f 10 / K3b 10). GIN
    and GCN at drop_ratio 0.1: one such step each (PART_CASES: K4f 10 / K4b
    10, K5f 10 / K5b 10; the CPU on the card's masks). Then one aug 'none'
    step against the one-card step on the whole giant batch
    (part_one_card_none), and edgepart (part_edge_cases)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or PART_RANKS)
                              // PART_RANKS))
    dps = {"card": init_distributed(
        f"127.0.0.1:{port}", PART_RANKS, rank, backend="gloo", device=dev,
        timeout_s=PART_TIMEOUT_S)}
    dps["cpu"] = DPGroup(rank, PART_RANKS, "gloo", "cpu")
    t0 = time.perf_counter()
    cat, spec = part_giant_batch()
    shard = shard_graph_batch(cat, dps["card"], device="cpu", tile=TILE)
    report = dict(rank=rank, spec=str(spec), giant_rows=cat.num_nodes,
                  shard_rows=shard.num_nodes, setup_s=time.perf_counter()
                  - t0)
    bw = spec.max_graph_bonds
    try:
        for name, gnn, layer, steps, kw in PART_CASES:
            want = {layer: 2 * LAYERS, f"{layer}_bwd": 2 * LAYERS,
                    "ntxent_fwd": 1, "ntxent_bwd": 1}
            cfg = pretrain_cfg(gnn=gnn, **kw)
            models, opts = card_and_cpu(cfg, dev, dps)
            rec = []
            for step in range(steps):
                c0 = dps["card"].collectives
                rec.append(card_vs_cpu_steps(
                    models, opts, cfg, shard, dev, bw, step, 1, want,
                    f"partitioned {name} rank {rank}", dps=dps, part=True))
                calls = dps["card"].collectives - c0
                check(calls == PART_COLLECTIVES, f"partitioned {name} step "
                      f"{step}: {calls} all-reduces")
                check(ranks_bit_identical(models["card"], dps["card"]),
                      f"partitioned {name} step {step}: the ranks' states "
                      f"differ")
            report[name] = dict(steps=rec, all_reduces=PART_COLLECTIVES,
                                ranks_bit_identical=True)
            if name == "gin":
                sg, times = shard.to(dev), []
                for step in range(steps, 2 * steps):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    partitioned_train_step(models["card"], opts["card"], sg,
                                           cfg, step, cfg.init_lr,
                                           dps["card"], bond_window=bw)
                    e1.record()
                    torch.cuda.synchronize()
                    times.append(e0.elapsed_time(e1))
                report[gnn]["shared_card_step_ms"] = times
                report["none"] = part_one_card_none(cfg, shard, cat, dps,
                                                    dev)
        report["edge"] = part_edge_cases(dps["card"], dev)
    finally:
        destroy_distributed()
    with open(os.path.join(out_dir, f"part_rank{rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def part_ranks_cases(tmp: str) -> dict:
    """(a), (b): PART_RANKS processes of this script (`--part-rank`); the
    ranks' losses equal, their summary."""
    reports = run_script_ranks("--part-rank", PART_RANKS, tmp,
                               PART_TIMEOUT_S, "part")
    summary = dict(giant_rows=reports[0]["giant_rows"],
                   shard_rows=reports[0]["shard_rows"])
    for name, *_ in PART_CASES:
        losses = [[s["losses"] for s in rep[name]["steps"]]
                  for rep in reports]
        check(all(x == losses[0] for x in losses),
              f"partitioned {name}: the ranks' losses differ: {losses}")
        summary[name] = dict(
            losses=[s["losses"][0] for s in reports[0][name]["steps"]],
            counts=[{k: v for k, v in rep[name]["steps"][0]["counts"][
                0].items() if v} for rep in reports],
            all_reduces=reports[0][name]["all_reduces"],
            fraction_off=max(s["fraction_off"][0] for rep in reports
                             for s in rep[name]["steps"]),
            grad_off=max(s["grad_off"][0] for rep in reports
                         for s in rep[name]["steps"]),
            max_param_diff=max(s["max_param_diff"][0] for rep in reports
                               for s in rep[name]["steps"]))
    summary["gin"]["shared_card_step_ms"] = [
        rep["gin"]["shared_card_step_ms"] for rep in reports]
    summary["none"] = reports[0]["none"]
    summary["edge"] = {v: {k: reports[0]["edge"][v][k] for k in (
        "rows", "rows_per_rank", "rel_err", "all_reduces", "reduced_bytes",
        "ppermute_bytes")} | {"shared_card_fwd_bwd_ms": [
            rep["edge"][v]["shared_card_fwd_bwd_ms"] for rep in reports]}
        for v in ("gather", "halo", "tile")}
    summary["edge"]["halo_rows"] = reports[0]["edge"]["halo_rows"]
    return dict(ranks=reports, summary=summary)


def part_world1_cases(dev) -> dict:
    """(c) World 1 on NCCL: two partitioned steps on phase 5's batch (its
    shard_graph_batch at world 1 is itself) bit-identical to two one-card
    steps from the same state on the same views, PART_COLLECTIVES
    all-reduces per step."""
    dp = init_distributed(backend="nccl", log=lambda *_: None)
    check(dp.world == 1, f"partitioned world 1: {dp}")
    try:
        batch, spec = pretrain_batch()
        bw = spec.max_graph_bonds
        cfg = pretrain_cfg()
        models, opts = {}, {}
        for tag, d in (("one", None), ("part", dp)):
            models[tag] = build_model(cfg, torch.Generator().manual_seed(
                SEED + 2), d).to(dev)
            opts[tag] = optim.adam_torch(models[tag].parameters(),
                                         cfg.weight_decay)
        bg = batch.to(dev)
        shard = shard_graph_batch(concat_shards([batch.to("cpu")]), dp,
                                  tile=TILE)
        losses = []
        for step in range(2):
            keys = draw_paired_keys(cfg.aug, bg.num_nodes, bg.num_graphs,
                                    step_generator(SEED, TRAIN_STREAM, step))
            views = paired_augment_keys(bg, keys, cfg.aug, tile=TILE,
                                        bond_window=bw)
            c0 = dp.collectives
            got = dict(
                one=train_step(models["one"], opts["one"], bg, cfg, step,
                               cfg.init_lr, views=views, bond_window=bw),
                part=partitioned_train_step(models["part"], opts["part"],
                                            shard, cfg, step, cfg.init_lr,
                                            dp, views=views,
                                            bond_window=bw))
            check(dp.collectives - c0 == PART_COLLECTIVES,
                  f"partitioned world 1: {dp.collectives - c0} all-reduces")
            check(torch.equal(got["one"], got["part"]),
                  f"partitioned world 1 step {step}: loss "
                  f"{got['part'].item()} against {got['one'].item()}")
            one, part = models["one"], models["part"]
            differ = [k for k, v in one.state_dict().items()
                      if not torch.equal(v, part.state_dict()[k])]
            differ += [k for (k, p), q in zip(one.named_parameters(),
                                              part.parameters())
                       if not torch.equal(p.grad, q.grad)]
            check(not differ, f"partitioned world 1 step {step}: differs "
                  f"in {differ}")
            losses.append(got["one"].item())
    finally:
        destroy_distributed()
    return dict(steps=2, losses=losses, bit_identical=True,
                all_reduces_per_step=PART_COLLECTIVES)


def part_phase(tmp: str, card: str, dev) -> dict:
    """Phase 19: node-row-sharded giant-batch pretraining and sharded
    aggregation on the card."""
    t0 = time.perf_counter()
    report = dict(card=card)
    report["ranks"] = part_ranks_cases(tmp)
    report["world1"] = part_world1_cases(dev)
    report["seconds"] = time.perf_counter() - t0
    summary = dict(report, ranks=report["ranks"]["summary"])
    print(f"partitioned {json.dumps(summary)}", flush=True)
    print(f"phase partitioned took {report['seconds']:.1f} s", flush=True)
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

    native_build_s = native.build()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t_start:.2f} s "
          f"{json.dumps(built)}; native featurizer {native_build_s:.2f} s",
          flush=True)

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
        members = member_kernel_phase(fbatch.to(dev), dev)
        phase("wide kernels")
        wide_kernel_phase(dev)
        phase("fine-tune steps")
        shared = {}
        ft_step = finetune_step_phase(dev, tmp, shared)
        phase("fine-tune speed")
        ft_speed = finetune_speed_phase(dev, tmp, card, shared)
        phase("ensembles")
        ens = ensemble_phase(dev, tmp, card, shared, {
            gnn: ft_speed[f"{gnn}_float32"]["resident_graphed"]
            for gnn in ("gin", "gcn")})
        phase("fine-tune cli")
        finetune_cli_phase(tmp)
        phase("gcn training kernels")
        gcn_layer = gcn_train_kernel_phase(batch.to(dev), dev)
        phase("gcn step")
        gcn_step = gcn_step_phase(batch, spec, dev, card)
        phase("pretraining options")
        options_phase(dev)
        phase("gcn cli")
        cli_phase(tmp, "pretrain_gcn_mix", ["--model", "gcn", "--aug", "mix"],
                  gnn="gcn")
        phase("resident")
        resident = resident_phase(tmp, card, dev)
        phase("corpus")
        corpus_phase(tmp, card, dev, native_build_s)
        phase("model options")
        units_row = next(r for r in resident["speed"]
                         if r["model"] == "gin" and r["dtype"] == "float32"
                         and r["path"] == "resident_graphed"
                         and r["adam"] == "chain" and not r["drop_ratio"])
        model_options_phase(tmp, card, dev, batch, spec, units_row)
        phase("data parallelism")
        dp_phase(tmp, card, dev, units_row)
        phase("partitioned")
        part_phase(tmp, card, dev)
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
    spec_b = TRAIN_KERNELS["fused_gcn_bn_layer_bwd"]
    rows.append(row("fused_gcn_bn_layer_bwd", spec_b["source"],
                    spec_b["replaces"],
                    gcn_step["float32"]["launches"]["fused_gcn_bn_layer_bwd"],
                    gcn_layer["bwd"],
                    pick(gcn_layer["bwd"]["cases"], **train_case)))
    for name, spec_k in FT_KERNELS.items():
        rows.append(row(name, spec_k["source"], spec_k["replaces"],
                        ft_step["launches"][name], ft_kernels[name],
                        pick(ft_kernels[name]["cases"], dtype="float32")))
    # the member-axis launches: BBBP's 3 seeds in f32, launched on phase
    # 9b's ensemble step
    for name, spec_k in MEMBER_KERNELS.items():
        counts = ens[spec_k["ensemble"]]["step_vs_cpu"]["counts"]
        rows.append(row(name, spec_k["source"], spec_k["replaces"],
                        counts[spec_k["counter"]], members[name],
                        pick(members[name]["cases"], dtype="float32",
                             members=3)))
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        # one rank of phase 18 (b), started by dp_two_rank_cases
        raise SystemExit(dp_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                      sys.argv[4]))
    if sys.argv[1:2] == ["--part-rank"]:
        # one rank of phase 19 (a) and (b), started by part_ranks_cases
        raise SystemExit(part_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                        sys.argv[4]))
    raise SystemExit(main())
