"""MoleculeNet fine-tuning CLI (replaces `python finetune.py`, ref
finetune.py:398-506): trains every target column (in one run where the
columns keep the same rows), --n-seeds seeds each, and appends the results
to experiments/<ckpt>_<task>_finetune.csv under the current directory.

Port of molclr_tpu/cli/finetune.py, with its flags and RESULT lines. It
trains on the first CUDA device unless --cpu is given (the kernels' plain
versions), and raises when there is none.

    python -m molclr_tpu_torch.cli.finetune --task BBBP --data-root data
    python -m molclr_tpu_torch.cli.finetune --allow-synthetic --cpu \
        --config small.yaml
    python -m molclr_tpu_torch.cli.finetune --task HIV --model graphormer
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="molclr-finetune",
        description="Fine-tune a (pretrained) encoder on MoleculeNet tasks "
                    "on one GPU (PyTorch)")
    p.add_argument("--config", default="configs/finetune.yaml")
    p.add_argument("--task", default=None, help="task name (BBBP, Tox21, …)")
    p.add_argument("--target", default=None,
                   help="train only this target column")
    p.add_argument("--pretrained", default=None,
                   help="reference .pth or the port's step_<n>.pt to "
                        "warm-start from")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--model", choices=["gin", "gcn", "graphormer"],
                   default=None,
                   help="the encoder; graphormer: Graphormer-base (12 x "
                        "768, 32 heads) in place of the config's widths")
    p.add_argument("--data-root", default=None)
    p.add_argument("--motifs", action="store_true",
                   help="use the motif (clique) attention head")
    p.add_argument("--n-seeds", type=int, default=None,
                   help="seeds per target column, trained side by side "
                        "(the CSV row then carries their std)")
    p.add_argument("--allow-synthetic", action="store_true",
                   help="permit fabricating a synthetic stand-in CSV when "
                        "the task CSV is missing (results are stamped "
                        "synthetic=true)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU with the kernels' plain versions")
    args = p.parse_args(argv)

    from molclr_tpu_torch.cli.embed import resolve_device

    device = resolve_device(args.cpu)

    from molclr_tpu_torch.data.tasks import TASKS
    from molclr_tpu_torch.train.config import GRAPHORMER_BASE, \
        FineTuneConfig, ModelConfig, finetune_from_yaml
    from molclr_tpu_torch.train.finetune import FineTuner, run_all_targets

    cfg = (finetune_from_yaml(args.config) if os.path.exists(args.config)
           else FineTuneConfig())
    if args.task:
        cfg.task_name = args.task
    if args.pretrained:
        cfg.pretrained = args.pretrained
    if args.epochs is not None:
        cfg.epochs = args.epochs
    if args.batch_size is not None:
        cfg.batch_size = args.batch_size
    if args.model == "graphormer":
        cfg.model = ModelConfig(**GRAPHORMER_BASE, tile=cfg.model.tile)
    elif args.model:
        cfg.model.gnn_type = args.model
    if args.data_root:
        cfg.data_root = args.data_root
    if args.motifs:
        cfg.use_motifs = True
    if args.n_seeds is not None:
        cfg.n_seeds = args.n_seeds
    if args.allow_synthetic:
        cfg.synthetic_fallback = True
    if cfg.task_name not in TASKS:
        p.error(f"unknown task {cfg.task_name!r}; known: "
                f"{', '.join(sorted(TASKS))}")

    print(f"device: {device}")
    if args.target:
        if args.target not in TASKS[cfg.task_name].targets:
            p.error(f"unknown target {args.target!r} for {cfg.task_name}; "
                    f"known: {', '.join(TASKS[cfg.task_name].targets)}")
        ft = FineTuner(cfg, device, target=args.target).setup_data()
        ft.setup_state()
        results = [ft.train()]
    else:
        results = run_all_targets(cfg, device)
    for r in results:
        std = f" +- {r['test_std']:.4f}" if "test_std" in r else ""
        print(f"RESULT {cfg.task_name}/{r['target']}: "
              f"{r['metric_name']} = {r['test_metric']:.4f}{std}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
