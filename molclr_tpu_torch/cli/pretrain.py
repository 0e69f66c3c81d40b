"""Contrastive pretraining CLI (replaces `python molclr.py`, ref
molclr.py:180-199).

Port of molclr_tpu/cli/pretrain.py with the flags that apply to one card.
It trains on the first CUDA device unless --cpu is given (the kernels'
plain versions), and raises when there is none. By default it takes the
units path with CUDA-graph steps on the card; --device-cache-mb 0 streams
batches from the host, --steps-per-dispatch 1 runs eager steps. --data
names a SMILES text file, featurized at the start, or an on-disk corpus
that cli.featurize built, memory-mapped (a corpus above
--pack-cache-max-mols streams its batches from the maps). --no-native
featurizes a text file and packs with the Python chem layer and packer.

    python -m molclr_tpu_torch.cli.featurize corpus.txt corpus.mtpu
    python -m molclr_tpu_torch.cli.pretrain --data corpus.mtpu --epochs 2
    python -m molclr_tpu_torch.cli.pretrain --data corpus.txt --epochs 2
    python -m molclr_tpu_torch.cli.pretrain --synthetic 4096 --cpu
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="molclr-pretrain",
        description="MolCLR contrastive pretraining on one GPU (PyTorch)")
    p.add_argument("--config", default="configs/pretrain.yaml",
                   help="YAML config (reference config.yaml keys accepted)")
    p.add_argument("--data", default=None,
                   help="override corpus path: a SMILES text file or an "
                        "on-disk corpus directory (cli.featurize)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--aug", choices=["node", "subgraph", "mix"],
                   default=None, help="augmentation kind (mix featurizes "
                   "with hydrogens)")
    p.add_argument("--model", choices=["gin", "gcn"], default=None,
                   help="encoder")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--steps-per-dispatch", type=int, default=None,
                   help="training steps per CUDA graph replay on the "
                        "resident paths (0 = auto: one; 1 = eager "
                        "steps)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the first steps "
                        "here")
    p.add_argument("--device-cache-mb", type=int, default=None,
                   help="device budget of the resident unit stack, batch "
                        "cache and eval stack (0 = stream batches from the "
                        "host)")
    p.add_argument("--pack-cache-max-mols", type=int, default=None,
                   help="corpora up to this size are eligible for the "
                        "packed-batch cache and the resident stacks "
                        "(default 500k)")
    p.add_argument("--narrow-cache", choices=["auto", "on", "off"],
                   default=None,
                   help="store the tile-unit stack in int8 / int16 / uint8 "
                        "where the unit spec fits (auto, on) or at full "
                        "width (off); the numbers are identical")
    p.add_argument("--replan-units-every", type=int, default=None,
                   help="re-plan the tile-units from a fresh molecule "
                        "shuffle every N epochs")
    p.add_argument("--resume", default=None, metavar="PATH|latest",
                   help="resume from a checkpoint; 'latest' picks the "
                        "newest full-state checkpoint in --ckpt-dir")
    p.add_argument("--valid-size", type=float, default=None,
                   help="validation fraction (reference 0.05)")
    p.add_argument("--eval-every", type=int, default=None,
                   help="validate every N epochs")
    p.add_argument("--save-every", type=int, default=None,
                   help="full-state checkpoint every N epochs")
    p.add_argument("--warm-up", type=int, default=None)
    p.add_argument("--stop-after-epoch", type=int, default=None,
                   help="stop after this many epochs WITHOUT changing the "
                        "--epochs schedule (forces a full-state checkpoint; "
                        "--resume latest continues the same cosine)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="generate an N-molecule synthetic corpus if the "
                        "data path is missing")
    p.add_argument("--no-native", action="store_true",
                   help="featurize a SMILES file with the Python chem layer "
                        "(dataset.num_workers processes) and pack with the "
                        "Python packer, not the native library")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU with the kernels' plain versions")
    args = p.parse_args(argv)

    from molclr_tpu_torch.cli.embed import resolve_device

    device = resolve_device(args.cpu)

    from molclr_tpu_torch.train.checkpoints import latest_checkpoint
    from molclr_tpu_torch.train.config import PretrainConfig, \
        pretrain_from_yaml
    from molclr_tpu_torch.train.pretrain import Pretrainer

    cfg = (pretrain_from_yaml(args.config) if os.path.exists(args.config)
           else PretrainConfig())
    for flag, attr in (("data", "data_path"), ("epochs", "epochs"),
                       ("batch_size", "batch_size"), ("aug", "aug"),
                       ("ckpt_dir", "ckpt_dir"),
                       ("valid_size", "valid_size"),
                       ("eval_every", "eval_every_epochs"),
                       ("save_every", "save_every_epochs"),
                       ("warm_up", "warm_up"),
                       ("stop_after_epoch", "stop_after_epochs"),
                       ("seed", "seed"),
                       ("steps_per_dispatch", "steps_per_dispatch"),
                       ("profile_dir", "profile_dir"),
                       ("device_cache_mb", "device_cache_mb"),
                       ("pack_cache_max_mols", "pack_cache_max_mols"),
                       ("narrow_cache", "narrow_cache"),
                       ("replan_units_every", "replan_units_every")):
        value = getattr(args, flag)
        if value is not None:
            setattr(cfg, attr, value)
    if args.model:
        cfg.model.gnn_type = args.model
    if args.resume == "latest":
        latest = latest_checkpoint(cfg.ckpt_dir)
        if latest is None:
            print(f"no checkpoint under {cfg.ckpt_dir}; starting from "
                  f"scratch")
        else:
            cfg.resume_from = latest
    elif args.resume:
        cfg.resume_from = args.resume

    if args.synthetic:
        # size-keyed corpus path, so that different --synthetic N do not
        # reuse a smaller cached corpus (unless --data names one)
        if not args.data:
            root, ext = os.path.splitext(cfg.data_path)
            cfg.data_path = f"{root}_{args.synthetic}{ext}"
        if not os.path.exists(cfg.data_path):
            from molclr_tpu_torch.data.synthetic import write_pretrain_corpus

            print(f"generating synthetic corpus ({args.synthetic} "
                  f"molecules) -> {cfg.data_path}")
            write_pretrain_corpus(cfg.data_path, args.synthetic,
                                  seed=cfg.seed)

    print(f"device: {device}")
    pre = Pretrainer(cfg, device,
                     prefer_native=not args.no_native).setup_data()
    print(f"bucket: {pre.spec}")
    pre.setup_state()
    if pre.step:
        print(f"resumed from {cfg.resume_from} at step {pre.step}, epoch "
              f"{pre._start_epoch}")
    pre.train()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
