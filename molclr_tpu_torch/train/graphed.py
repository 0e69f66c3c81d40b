"""Training steps replayed as CUDA graphs: the counterpart of the JAX
Pretrainer's scan-folded dispatches (`multi_step_units`,
`multi_step_resident`, `multi_step`, molclr_tpu/train/pretrain.py:357-406,
`steps_per_dispatch`).

On the resident paths a step's inputs are all on the device: the stack of
tile-units (or of cached batches), a row of unit indices and a row of
augmentation keys (data/regroup.py, data/augment.py), and the optimizer's
LR and step count (train/optim.py). So one whole step (`concat_units`,
both views, both forwards, the loss, the backward and Adam) can be
captured once with `torch.cuda.graph` and replayed: before each replay a
few device copies fill the static index and key buffers and the trainer
fills the LR tensor; the loss lands in a static buffer that the trainer
copies out. The host's time per step falls from the launches of some
thousand kernels to that of a replay.

The Pretrainer runs its first GRAPH_WARMUP_STEPS resident steps eagerly
(they build the kernels and warm the allocator, and Adam creates its
state), then captures `k` steps (steps_per_dispatch, 1 under 'auto') and
replays them. A replay runs the kernels the eager step runs, on the same
inputs, so it gives the same bits. The kernel wrappers count a launch
when they launch, which during a capture happens once: `launches` records
the counts of the capture, which each replay repeats. A capture that
fails raises; nothing falls back.
"""

from __future__ import annotations

import torch

# eager resident steps of a run before the first capture
GRAPH_WARMUP_STEPS = 2


def graph_blocker(cfg) -> str | None:
    """Why a graph cannot capture this config's training step, or None."""
    if cfg.model.drop_ratio > 0:
        return ("dropout draws its masks from per-step device generators, "
                "which a replay would repeat")
    return None


def launch_counts() -> dict[str, int]:
    """The launch count of every kernel wrapper of the port."""
    from molclr_tpu_torch.ops import fused_gcn, fused_layer, ntxent

    fns = (fused_layer.fused_gine_bn_layer,
           fused_layer.fused_gine_bn_layer_bwd,
           fused_layer.fused_gine_layer, fused_layer.fused_gine_layer_bwd,
           fused_gcn.fused_gcn_bn_layer, fused_gcn.fused_gcn_bn_layer_bwd,
           fused_gcn.fused_gcn_layer, fused_gcn.fused_gcn_layer_bwd,
           ntxent.ntxent_fwd, ntxent.ntxent_bwd)
    return {fn.__name__: fn.launches for fn in fns}


class GraphedSteps:
    """`k` training steps captured as one CUDA graph.

    body(idx_row, key_row) runs one step from a [T] row of unit indices
    and a [K] row of keys on the device and returns its loss (0-d); it
    must read everything else from tensors that outlive the graph. The
    first `run` captures; every `run` copies its rows into the static
    buffers and replays. The loss buffer is overwritten by the next run."""

    def __init__(self, body, k: int, units: int, key_len: int, device):
        self.body = body
        self.k = k
        self.idx = torch.zeros(k, units, dtype=torch.long, device=device)
        self.keys = torch.zeros(k, key_len, dtype=torch.long, device=device)
        self.loss = torch.zeros(k, dtype=torch.float32, device=device)
        self.graph = None
        self.replays = 0
        self.launches: dict[str, int] = {}

    def _capture(self) -> None:
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for j in range(self.k):
                self.loss[j].copy_(self.body(self.idx[j], self.keys[j]))
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        self.graph = graph

    def run(self, idx_rows: torch.Tensor,
            key_rows: torch.Tensor) -> torch.Tensor:
        """The k steps of idx_rows [k, T] and key_rows [k, K]; returns the
        static [k] loss buffer."""
        self.idx.copy_(idx_rows)
        self.keys.copy_(key_rows)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1
        return self.loss
