"""Checkpoints: reference .pth state dicts, partial transfer, the
carry-over of JAX (Flax) weights, and full training state.

Port of molclr_tpu/train/checkpoints.py. The port's models use the
reference torch state-dict schema, so a .pth needs no renaming;
`transfer_state` reproduces load_my_state_dict (ref
models/ginet_finetune.py:149-157). `state_dict_from_jax` is the inverse of
the JAX package's import_torch_params: it turns a Flax (params,
batch_stats) tree of numpy arrays, of any of the networks, into this
schema. Full training state (model, optimizer, step, epoch) is one torch
file `step_<step>.pt` per checkpoint, where the JAX package writes an
Orbax directory `step_<step>`, which the port reads (train/orbax.py, no
JAX needed) but does not write. `resolve_pretrained` and
`load_pretrained_state` find and read a warm start: a reference .pth, the
port's own step_<n>.pt or an Orbax step directory of the JAX package (its
params and batch_stats through state_dict_from_jax).
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")
# a checkpoint name: the port's step_<n>.pt or the JAX package's step_<n>/
_STEP_NAME = re.compile(r"^step_(\d+)(\.pt)?$")


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Load a torch .pth state dict onto the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def transfer_state(src: dict, model: torch.nn.Module) -> dict:
    """Copy the entries of `src` whose key exists in the model's state dict
    with the same shape; leave the rest as initialized. Returns
    {"copied": n, "skipped": [keys]}."""
    dst = model.state_dict()
    take, skipped = {}, []
    for k, v in src.items():
        v = torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
        if k in dst and tuple(v.shape) == tuple(dst[k].shape):
            take[k] = v.to(dst[k].dtype)
        else:
            skipped.append(k)
    model.load_state_dict(take, strict=False)
    return {"copied": len(take), "skipped": skipped}


def state_dict_from_jax(params: dict, batch_stats: dict | None = None
                        ) -> dict[str, torch.Tensor]:
    """Flax MolCLRNet / FineTuneNet / LinkFineTuneNet / MotifFineTuneNet
    trees (numpy leaves) -> the port's state dict.

    Dense kernels [in, out] are transposed to torch Linear weights
    [out, in]; the GCN `weight` (used as x @ W) is kept as it is; BatchNorm
    scale/bias/mean/var become weight/bias/running_mean/running_var;
    pred_i / pred_out become pred_head.{2i} (pred_out last), motif_gate
    motif_pool.gate_nn.0; label_embedding and label_lin keep their names.
    The number of layers, the conv type and the head depth are read from
    the tree."""
    def t(a):
        return torch.tensor(np.ascontiguousarray(np.asarray(a)))

    state = {}
    tr = params["trunk"]
    state["x_embedding1.weight"] = t(tr["x_embedding1"])
    state["x_embedding2.weight"] = t(tr["x_embedding2"])
    layers = sorted(int(k.split("_")[1]) for k in tr if k.startswith("conv_"))
    for i in layers:
        c = tr[f"conv_{i}"]
        for e in ("edge_embedding1", "edge_embedding2"):
            state[f"gnns.{i}.{e}.weight"] = t(c[e])
        if "mlp_0" in c:
            for j, sub in ((0, "mlp_0"), (2, "mlp_1")):
                state[f"gnns.{i}.mlp.{j}.weight"] = t(
                    np.asarray(c[sub]["kernel"]).T)
                state[f"gnns.{i}.mlp.{j}.bias"] = t(c[sub]["bias"])
        else:
            state[f"gnns.{i}.weight"] = t(c["weight"])
            state[f"gnns.{i}.bias"] = t(c["bias"])
        bn = tr[f"bn_{i}"]
        state[f"batch_norms.{i}.weight"] = t(bn["scale"])
        state[f"batch_norms.{i}.bias"] = t(bn["bias"])
        if batch_stats is not None:
            sbn = batch_stats["trunk"][f"bn_{i}"]
            state[f"batch_norms.{i}.running_mean"] = t(sbn["mean"])
            state[f"batch_norms.{i}.running_var"] = t(sbn["var"])
    dense = [("feat_lin", "feat_lin"), ("out_lin_0", "out_lin.0"),
             ("out_lin_1", "out_lin.2"), ("motif_lin", "motif_lin"),
             ("motif_gate", "motif_pool.gate_nn.0"),
             ("label_lin", "label_lin")]
    hidden = sorted(int(k.split("_")[1]) for k in params
                    if k.startswith("pred_") and k != "pred_out")
    dense += [(f"pred_{i}", f"pred_head.{2 * i}") for i in hidden]
    dense.append(("pred_out", f"pred_head.{2 * len(hidden)}"))
    for name, key in dense:
        if name in params:
            state[f"{key}.weight"] = t(np.asarray(params[name]["kernel"]).T)
            state[f"{key}.bias"] = t(params[name]["bias"])
    if "motif_embedding" in params:
        state["motif_embedding.weight"] = t(params["motif_embedding"])
    if "label_embedding" in params:
        state["label_embedding"] = t(params["label_embedding"])
    return state


def save_checkpoint(directory: str, step: int, state: dict) -> str:
    """Write `state` (tensors, optimizer state dicts, ints) to
    <directory>/step_<step>.pt atomically; returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(os.path.abspath(directory), f"step_{step}.pt")
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def train_meta_path(path: str) -> str:
    """The sidecar stamp of a step_<n>.pt: step_<n>.train_meta.json."""
    return os.path.splitext(path)[0] + ".train_meta.json"


def load_checkpoint(path: str) -> dict:
    """A full-state checkpoint written by save_checkpoint, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def latest_checkpoint(directory: str) -> str | None:
    """The checkpoint with the largest step in `directory`: a step_<n>.pt
    of the port or a step_<n> Orbax directory of the JAX package (the .pt
    where both have the step); None when there is none."""
    if not os.path.isdir(directory):
        return None
    found = []
    for name in os.listdir(directory):
        m = _STEP_NAME.match(name)
        if m and (m.group(2) or os.path.isdir(os.path.join(directory, name))):
            found.append((int(m.group(1)), bool(m.group(2)), name))
    if not found:
        return None
    return os.path.join(directory, max(found)[2])


def resolve_pretrained(path: str) -> str:
    """Resolve a warm-start spec to a loadable checkpoint path, as the JAX
    package does: everything the reference's `fine_tune_from` key accepts
    (a bare name is ./ckpt/<name>/checkpoints/model.pth, finetune.py:249),
    an explicit file or Orbax step directory, or a directory holding
    step_<n>.pt files or step_<n> directories (the newest is taken)."""
    if not path:
        return path
    for cand in (path, os.path.join(path, "checkpoints", "model.pth"),
                 os.path.join("ckpt", path, "checkpoints", "model.pth")):
        if os.path.exists(cand):
            if os.path.isdir(cand):
                latest = latest_checkpoint(cand)
                if latest is not None:
                    return latest
            return cand
    return path


def load_orbax_state(path: str) -> dict[str, torch.Tensor]:
    """The state dict of the JAX package's Orbax step directory `path`: its
    params (the whole tree where it has no `params`) and batch_stats, as
    molclr_tpu's FineTuner and cli.embed read them, carried onto the
    port's schema."""
    from molclr_tpu_torch.train.orbax import read_step_dir

    tree = read_step_dir(path)
    return state_dict_from_jax(tree.get("params", tree),
                               tree.get("batch_stats") or None)


def load_pretrained_state(path: str) -> dict[str, torch.Tensor]:
    """The model state dict of a warm start: a reference .pth state dict,
    the model of a full-state step_<n>.pt written by the port's
    pretraining, or an Orbax step directory written by the JAX package."""
    if os.path.isdir(path):
        # read as an Orbax step directory: one without _METADATA raises
        # OrbaxFormatError naming it
        return load_orbax_state(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"pretrained checkpoint not found: {path!r}")
    if _STEP_FILE.match(os.path.basename(path)):
        return load_checkpoint(path)["model"]
    return load_torch_state_dict(path)
