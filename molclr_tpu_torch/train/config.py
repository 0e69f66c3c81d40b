"""Typed configuration, YAML-compatible with the reference config keys.

Port of molclr_tpu/train/config.py (`ModelConfig`, `PretrainConfig`,
`pretrain_from_yaml`, `FineTuneConfig`, `finetune_from_yaml`), cut to the
options the port runs on one card. The YAML keys and the value names
(`ntxent_impl` 'auto' / 'xla' / 'pallas', `adam_impl` 'chain' / 'fused')
are the JAX package's, so one file serves both packages; keys for options
the port does not have are ignored. The top-level key `tensorboard` sets
the dataclasses' field of that name (the JAX package's YAML readers leave
it at its default).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field


@dataclass
class ModelConfig:
    gnn_type: str = "gin"           # 'gin' | 'gcn' (config.yaml model_type)
                                    # | 'graphormer' (fine-tuning only)
    num_layers: int = 5
    emb_dim: int = 300
    feat_dim: int = 512
    drop_ratio: float = 0.0
    pool: str = "mean"
    pred_n_layer: int = 2           # fine-tune prediction head depth
    pred_act: str = "softplus"      # 'softplus' | 'relu'
    normalize_gcn: bool = False     # True fixes quirk Q2
    bf16: bool = False              # bfloat16 activations (params stay f32)
    tile: int = 256                 # tile-dense aggregation, tile-aligned
                                    # packing (a multiple of 16 on the
                                    # card); 0 = the ELL trunk, any size
    num_heads: int = 32             # graphormer: attention heads
    ffn_dim: int = 768              # graphormer: feed-forward width
    max_hops: int = 5               # graphormer: bonds of a path that bias
                                    # its pair (multi_hop_max_dist)


# Graphormer-base (arXiv:2106.05234, PCQM4M and ogbg-molhiv): 12 layers of
# 768, FFN 768, 32 heads, 5 hops, dropout 0.1 (cli/finetune.py --model
# graphormer)
GRAPHORMER_BASE = dict(gnn_type="graphormer", num_layers=12, emb_dim=768,
                       ffn_dim=768, num_heads=32, max_hops=5, drop_ratio=0.1)


@dataclass
class PretrainConfig:
    data_path: str = "data/pubchem_synthetic.txt"
    batch_size: int = 512           # config.yaml:1
    epochs: int = 100               # config.yaml:2
    warm_up: int = 10               # config.yaml:3
    init_lr: float = 5e-4           # config.yaml:11
    weight_decay: float = 1e-5      # config.yaml:12
    temperature: float = 0.1        # config.yaml:30
    use_cosine_similarity: bool = True
    ntxent_impl: str = "auto"       # 'auto' | 'xla' | 'pallas': the closed
                                    # form, the K2 kernels, or the kernels
                                    # for CUDA tensors at 2B >= 4096
    adam_impl: str = "chain"        # 'chain' (torch.optim.Adam) | 'fused'
                                    # (train/optim.py FusedAdam: one f32
                                    # buffer, the same update). Checkpoints
                                    # are stamped with it; a resume must
                                    # use the same impl
    aug: str = "node"               # 'node' | 'subgraph' | 'mix' | 'none'
    max_waves: int = 0              # BFS horizon of subgraph / mix; 0 =
                                    # derive (max atoms per molecule - 1,
                                    # capped at 2000) from the corpus at
                                    # setup_data, a bound on every graph's
                                    # eccentricity (the reference BFS is
                                    # unbounded, dataset_subgraph.py:70-88)
    valid_size: float = 0.05        # config.yaml:26
    model: ModelConfig = field(default_factory=ModelConfig)
    max_degree: int = 6
    pad_sizing: str = "total"       # 'total' (statistical batch totals) |
                                    # 'max' (worst case)
    pad_quantile: float = 1.0       # only used with pad_sizing='max'
    pad_slack: float = 1.1          # capped at 1.05 under pad_sizing='total'
    eval_every_epochs: int = 1
    save_every_epochs: int = 5      # molclr.py:142-143
    stop_after_epochs: int = 0      # > 0: stop after this many epochs
                                    # WITHOUT changing the cfg.epochs
                                    # schedule (a full-state checkpoint is
                                    # forced; resume continues it)
    log_every_steps: int = 50       # molclr.py:116
    ckpt_dir: str = "runs/pretrain"
    data_axis: str = ""             # data parallelism over torch.distributed
                                    # ranks when set (the JAX mesh axis's
                                    # name; '' = one card)
    resume_from: str = ""           # config.yaml load_model
    seed: int = 0
    featurize_processes: int = 2    # processes of the Python featurizer
                                    # (Pretrainer(prefer_native=False),
                                    # --no-native; the native one runs in
                                    # one call)
    steps_per_dispatch: int = 0     # 0 = auto: the resident paths replay
                                    # each step as a CUDA graph on the card
                                    # (train/graphed.py); 1 = eager steps;
                                    # k > 1 = k steps per captured graph.
                                    # The CPU and the host path run eager
    aug_precompute: bool = True     # the JAX package's key, read from
                                    # its YAML; changes nothing here (the
                                    # resident paths always draw a window
                                    # of steps' keys ahead and augment
                                    # inline, in the graph on the card)
    replan_units_every: int = 0     # > 0: every N epochs re-plan the
                                    # tile-units from a fresh molecule
                                    # shuffle (seed + 7919 * epoch; repack
                                    # and upload). Resume reproduces it
    fresh_compositions: bool = True # the resident path re-draws batch
                                    # membership every epoch through the
                                    # tile-unit regroup (data/regroup.py);
                                    # False = the frozen batch cache (order
                                    # reshuffled only). Needs tile > 0
    pack_cache_max_mols: int = 500_000  # cache packed batches across
                                    # epochs (compositions fixed after epoch
                                    # 0, order reshuffled) up to this size;
                                    # the resident stacks need the corpus
                                    # to be at most this size too
    prefetch: int = 2               # host-path batches packed and uploaded
                                    # ahead in a background thread (0 = off)
    device_cache_mb: int = 2048     # the device budget of the resident
                                    # unit stack, batch cache and eval
                                    # stack (0 = the host streaming path)
    narrow_cache: str = "auto"      # 'auto' / 'on': store the unit stack
                                    # in int8 / int16 / uint8 where the unit
                                    # spec fits; 'off': int32 / bool
    profile_dir: str = ""           # write a torch.profiler trace of
                                    # PROFILE_STEPS steps after the warm-up
                                    # (and capture) here
    concat_views: bool = False      # True: both views in ONE forward
                                    # (joint BatchNorm statistics); False
                                    # runs them one after the other, as the
                                    # reference does (molclr.py:57-60)
    tensorboard: bool = False       # also write TB scalars into ckpt_dir


@dataclass
class FineTuneConfig:
    task_name: str = "BBBP"
    data_root: str = "data"
    batch_size: int = 32            # config_finetune.yaml:1
    epochs: int = 100
    init_lr: float = 5e-4           # head LR, config_finetune.yaml:7
    init_base_lr: float = 1e-4      # encoder LR, config_finetune.yaml:8
    weight_decay: float = 1e-6
    model: ModelConfig = field(
        default_factory=lambda: ModelConfig(drop_ratio=0.3))
    pretrained: str = ""            # .pth, the port's step_<n>.pt, or a
                                    # directory holding either
    use_motifs: bool = False        # the fork's motif-MP head
    max_motifs_per_mol: int = 12
    valid_size: float = 0.1
    test_size: float = 0.1
    splitting: str = "scaffold"     # config_finetune.yaml:27
    score_mode: str = "softmax"     # 'softmax' | 'logit1' (quirk Q7)
    max_degree: int = 6
    seed: int = 0
    ckpt_dir: str = "runs/finetune"
    synthetic_n: int = 2000         # rows when fabricating a missing CSV
    synthetic_fallback: bool = False  # opt-in: fabricate a synthetic CSV
                                    # when the task CSV is absent; results
                                    # are then stamped synthetic=true
    repack_each_epoch: bool = True  # re-draw the train batches'
                                    # compositions every epoch (reference
                                    # DataLoader semantics) and refill the
                                    # device stack; False freezes them after
                                    # epoch 0 (one upload, reshuffled order)
    tensorboard: bool = False       # also write TB scalars into the run's
                                    # directory under ckpt_dir
    n_seeds: int = 1                # > 1: a seed ensemble, members trained
                                    # side by side on the same batches
    batch_targets: bool = True      # multi-target tasks whose columns keep
                                    # the same rows: all columns in one run
                                    # (members = targets x seeds); else the
                                    # per-target loop


_REF_MODEL_KEYS = {"num_layer": "num_layers", "drop_ratio": "drop_ratio",
                   "emb_dim": "emb_dim", "feat_dim": "feat_dim",
                   "pool": "pool", "pred_n_layer": "pred_n_layer",
                   "pred_act": "pred_act"}
_EXT_MODEL_KEYS = ("tile", "bf16", "normalize_gcn", "gnn_type", "num_heads",
                   "ffn_dim", "max_hops")


def _apply_model_keys(model_cfg: ModelConfig, raw: dict) -> None:
    model = raw.get("model", {})
    for src, dst in _REF_MODEL_KEYS.items():
        if src in model:
            setattr(model_cfg, dst, model[src])
    for k in _EXT_MODEL_KEYS:
        if k in model:
            setattr(model_cfg, k, model[k])


def pretrain_from_yaml(path: str) -> PretrainConfig:
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    cfg = PretrainConfig()
    for k in ("batch_size", "epochs", "warm_up", "aug", "seed"):
        if k in raw:
            setattr(cfg, k, raw[k])
    if "init_lr" in raw:
        cfg.init_lr = float(raw["init_lr"])
    if "weight_decay" in raw:
        cfg.weight_decay = float(raw["weight_decay"])  # no eval() (Q11)
    if "eval_every_n_epochs" in raw:
        cfg.eval_every_epochs = int(raw["eval_every_n_epochs"])
    if "save_every_n_epochs" in raw:
        cfg.save_every_epochs = int(raw["save_every_n_epochs"])
    if "log_every_n_steps" in raw:
        cfg.log_every_steps = int(raw["log_every_n_steps"])
    if raw.get("fp16_precision"):
        cfg.model.bf16 = True          # apex amp O2 -> bf16 activations
    if "model_type" in raw:
        cfg.model.gnn_type = raw["model_type"]
    if "load_model" in raw and raw["load_model"] not in (None, "None"):
        cfg.resume_from = str(raw["load_model"])
    _apply_model_keys(cfg.model, raw)
    loss = raw.get("loss", {})
    if "temperature" in loss:
        cfg.temperature = float(loss["temperature"])
    if "use_cosine_similarity" in loss:
        cfg.use_cosine_similarity = bool(loss["use_cosine_similarity"])
    ds = raw.get("dataset", {})
    for k in ("valid_size", "data_path"):
        if k in ds:
            setattr(cfg, k, ds[k])
    if "num_workers" in ds:
        cfg.featurize_processes = max(1, int(ds["num_workers"]))
    for k in ("data_path", "ckpt_dir", "data_axis"):
        if k in raw:
            setattr(cfg, k, raw[k])
    for k in _DISPATCH_KEYS:
        if k in raw:
            setattr(cfg, k, type(getattr(cfg, k))(raw[k]))
    if "tensorboard" in raw:
        cfg.tensorboard = bool(raw["tensorboard"])
    return cfg


# the one-card dispatch options, read as top-level keys of the YAML
_DISPATCH_KEYS = ("adam_impl", "steps_per_dispatch", "aug_precompute",
                  "replan_units_every", "fresh_compositions", "prefetch",
                  "device_cache_mb", "narrow_cache", "profile_dir",
                  "pack_cache_max_mols")


def finetune_from_yaml(path: str) -> FineTuneConfig:
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    cfg = FineTuneConfig()
    for k in ("task_name", "batch_size", "epochs", "seed", "data_root",
              "use_motifs", "splitting", "score_mode", "ckpt_dir"):
        if k in raw:
            setattr(cfg, k, raw[k])
    for k in ("init_lr", "init_base_lr", "weight_decay"):
        if k in raw:
            setattr(cfg, k, float(raw[k]))
    if raw.get("fp16_precision"):
        cfg.model.bf16 = True
    if "model_type" in raw:
        cfg.model.gnn_type = raw["model_type"]
    if "fine_tune_from" in raw and raw["fine_tune_from"] \
            not in (None, "None", ""):
        # reference semantics: a bare name is a subdirectory of ./ckpt,
        # resolved by checkpoints.resolve_pretrained at load time
        cfg.pretrained = str(raw["fine_tune_from"])
    if "pretrained" in raw:
        cfg.pretrained = str(raw["pretrained"])
    _apply_model_keys(cfg.model, raw)
    ds = raw.get("dataset", {})
    for k in ("valid_size", "test_size", "splitting"):
        if k in ds:
            setattr(cfg, k, ds[k])
    if "tensorboard" in raw:
        cfg.tensorboard = bool(raw["tensorboard"])
    return cfg


def to_dict(cfg) -> dict:
    return asdict(cfg)
