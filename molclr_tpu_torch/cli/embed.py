"""Batch inference CLI: encode SMILES into embedding vectors on the GPU.

Port of molclr_tpu/cli/embed.py with the same arguments and outputs: load
a pretrained encoder from a torch .pth state dict or from an Orbax step
directory that the JAX package wrote (read by train/orbax.py, without
JAX), featurize an input
corpus, and write the pooled molecular embeddings (feat_lin output `h`,
or the projection `z` with --projection) as .npy, with a sidecar
.smiles.txt of the kept SMILES. The trunk runs the BN-chained fused
layers, which are CUDA kernels on the card, or with --tile 0 the ELL
trunk's PyTorch ops. It runs on the first CUDA
device unless --cpu is given, and raises when there is none.

    python -m molclr_tpu_torch.cli.embed corpus.txt out.npy --checkpoint model.pth
"""

from __future__ import annotations

import argparse
import os
import sys


def resolve_device(cpu: bool):
    """torch.device for an entry point: the CPU only when asked for, else
    the first CUDA device; no silent CPU fallback."""
    import torch

    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass --cpu to run on the "
                           "CPU")
    return torch.device("cuda", 0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="molclr-embed")
    p.add_argument("input", help="SMILES file (one per line / CSV last col)")
    p.add_argument("output", help="output .npy path ([n, feat_dim] fp32)")
    p.add_argument("--checkpoint", required=True,
                   help="torch .pth file, or an Orbax step directory of "
                        "the JAX package")
    p.add_argument("--model", choices=["gin", "gcn"], default="gin")
    p.add_argument("--layers", type=int, default=5)
    p.add_argument("--emb-dim", type=int, default=300)
    p.add_argument("--feat-dim", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--tile", type=int, default=256,
                   help="tile-dense aggregation tile size (a multiple of "
                        "16 on the GPU; molecules larger than the tile are "
                        "skipped); 0 = the ELL trunk, which embeds every "
                        "molecule whatever its size")
    p.add_argument("--projection", action="store_true",
                   help="emit the contrastive projection z instead of h")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU with the kernels' plain versions")
    args = p.parse_args(argv)

    device = resolve_device(args.cpu)

    import numpy as np
    import torch

    from molclr_tpu_torch.data.graphs import pack_batch
    from molclr_tpu_torch.data.loader import (
        featurize_many,
        read_pretrain_smiles,
        spec_for_graphs,
    )
    from molclr_tpu_torch.models import MolCLRNet
    from molclr_tpu_torch.train import checkpoints as ckpt_lib

    smiles = read_pretrain_smiles(args.input)
    graphs, kept = featurize_many(smiles)
    if args.tile:
        over = [i for g, i in zip(graphs, kept) if g.n_atoms > args.tile]
        if over:
            print(f"skipping {len(over)} molecules larger than the "
                  f"{args.tile}-atom tile (e.g. input row {over[0]})")
            keep = [(g, i) for g, i in zip(graphs, kept)
                    if g.n_atoms <= args.tile]
            graphs = [g for g, _ in keep]
            kept = [i for _, i in keep]
    if not graphs:
        p.error("no featurizable molecules in input")
    print(f"{len(graphs)}/{len(smiles)} molecules featurized")

    model = MolCLRNet(gnn_type=args.model, num_layers=args.layers,
                      emb_dim=args.emb_dim, feat_dim=args.feat_dim,
                      tile=args.tile,
                      generator=torch.Generator().manual_seed(0))
    if args.checkpoint.endswith(".pth"):
        state = ckpt_lib.load_torch_state_dict(args.checkpoint)
    else:
        # an Orbax step directory of the JAX package (read without JAX)
        state = ckpt_lib.load_orbax_state(args.checkpoint)
    tstats = ckpt_lib.transfer_state(state, model)
    print(f"transferred {tstats['copied']} param leaves "
          f"({len(tstats['skipped'])} skipped)")
    if tstats["copied"] == 0:
        p.error(
            "checkpoint transferred ZERO parameters — architecture "
            "mismatch? Pass --layers/--emb-dim/--feat-dim matching the "
            f"checkpoint. First skipped keys: {tstats['skipped'][:4]}")
    if tstats["skipped"]:
        print(f"WARNING: {len(tstats['skipped'])} leaves skipped (shape "
              f"mismatch?) e.g. {tstats['skipped'][:3]} — embeddings may "
              f"come from partially random weights", file=sys.stderr)
    model = model.to(device).eval()

    # sizing='max': embed packs SEQUENTIAL chunks (no shuffle, no
    # drop-retry), so capacity must fit any batch_size-subset exactly
    spec = spec_for_graphs(graphs, min(args.batch_size, len(graphs)),
                           tile=args.tile, sizing="max")
    out = []
    with torch.no_grad():
        for lo in range(0, len(graphs), spec.n_graphs):
            chunk = graphs[lo : lo + spec.n_graphs]
            h, z = model(pack_batch(chunk, spec).to(device))
            emb = (z if args.projection else h)[: len(chunk)]
            out.append(emb.float().cpu().numpy())
    embeddings = np.concatenate(out).astype(np.float32)
    np.save(args.output, embeddings)
    side = os.path.splitext(args.output)[0] + ".smiles.txt"
    with open(side, "w") as f:
        for i in kept:
            f.write(smiles[i] + "\n")
    print(f"wrote {embeddings.shape} embeddings -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
