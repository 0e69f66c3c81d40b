"""Training steps replayed as CUDA graphs: the counterpart of the JAX
package's scan-folded dispatches (the Pretrainer's `multi_step_units`,
`multi_step_resident`, `multi_step`, molclr_tpu/train/pretrain.py:357-406,
`steps_per_dispatch`; the FineTuner's `multi_train` and `multi_predict`,
molclr_tpu/train/finetune.py:483-507).

On the resident paths a step's inputs are all on the device: a stack of
tile-units or of packed batches, a row of stack indices, a row of
augmentation keys (data/regroup.py, data/augment.py), and the optimizer's
LR and step count (train/optim.py). So one whole step (the batch's take,
the views, every forward, the loss, the backward and Adam) can be
captured once with `torch.cuda.graph` and replayed: before each replay a
few device copies fill the static input buffers; the step's output (a
loss, the members' losses, a split's predictions) lands in a static
buffer that the caller copies out. The host's time per step falls from
the launches of some thousand kernels to that of a replay.

Dropout draws its keep masks with torch.rand from torch.Generators on the
card. Each such generator is registered with the graph
(`CUDAGraph.register_generator_state`): a replay then reads the
generator's seed and offset as they stand and advances the offset by what
the captured draws consume, so it draws the masks that an eager step from
the same generator state draws. A caller may reseed a registered
generator between replays (the Pretrainer's per-step dropout streams).

A data-parallel step (parallel/dp.py) replays too when its group runs
NCCL: its all-reduces (BatchNorm moments, the gathered pairs, the
gradient mean) are captured on the capturing stream and rerun by each
replay, on the buffers the capture allocated. The communicator exists
before any capture: init_distributed runs one all-reduce at once, and the
eager warm-up steps run every collective of the step. A gloo group
stages its collectives through the host and cannot be captured; the
Pretrainer runs its steps eager there.

The trainers run their first GRAPH_WARMUP_STEPS resident steps eagerly
(they build the kernels and warm the allocator, and Adam creates its
state), then capture and replay. A replay runs the kernels the eager step
runs, on the same inputs, so it gives the same bits. The kernel wrappers
count a launch when they launch, which during a capture happens once:
`launches` records the counts of the capture, which each replay repeats.
A capture that fails raises; nothing falls back.
"""

from __future__ import annotations

import gc

import torch

# eager resident steps of a run before the first capture
GRAPH_WARMUP_STEPS = 2


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
    """`k` steps captured as one CUDA graph.

    body(j, *rows) runs step j (0 .. k - 1) of the graph from one row of
    each static input and returns its output (a tensor of shape `out`); it
    must read everything else from tensors that outlive the graph. `rows`
    gives each static input's per-step (shape, dtype); `generators` are
    the torch.Generators on the card that the body draws from. The first
    `run` captures; every `run` copies its rows into the static buffers
    and replays. The output buffer [k, *out] is overwritten by the next
    run."""

    def __init__(self, body, k: int, rows, device, out=(),
                 generators=()):
        self.body = body
        self.k = k
        self.inputs = [torch.zeros((k,) + tuple(shape), dtype=dtype,
                                   device=device) for shape, dtype in rows]
        self.out = torch.zeros((k,) + tuple(out), dtype=torch.float32,
                               device=device)
        self.generators = tuple(generators)
        self.graph = None
        self.replays = 0
        self.launches: dict[str, int] = {}

    def _capture(self) -> None:
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        # No garbage collection inside the capture: a collected reference
        # cycle that holds an earlier graph (a trainer and its
        # GraphedSteps) would destroy that graph mid-capture, a call the
        # capture's global mode forbids, and the capture would fail.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                for j in range(self.k):
                    self.out[j].copy_(self.body(j, *(x[j] for x in
                                                       self.inputs)))
        finally:
            if collecting:
                gc.enable()
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        self.graph = graph

    def run(self, *rows: torch.Tensor) -> torch.Tensor:
        """The k steps of `rows` (one [k, *shape] tensor per static
        input); returns the static [k, *out] output buffer."""
        for buf, row in zip(self.inputs, rows, strict=True):
            buf.copy_(row)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1
        return self.out
