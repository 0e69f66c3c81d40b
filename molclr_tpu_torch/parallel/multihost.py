"""Multi-process start-up of data-parallel pretraining.

Port of molclr_tpu/parallel/multihost.py. The JAX package runs one
process per host and calls jax.distributed.initialize; the port runs one
process per GPU and joins a torch.distributed process group
(`init_distributed`). The rest of the JAX multi-controller recipe carries
over with one device per process:
  - each process keeps only its slice of the corpus (`corpus_shard_range`,
    applied by the Pretrainer to its seeded split);
  - small host integers (the unit spec by max, steps per epoch by min) are
    agreed across the ranks (dp.agree_ints);
  - every rank keeps its own batches or units, the remainder dropped at
    device granularity (dp.shard_batch_cache; the Pretrainer's
    _upload_units for its units).

The backend is the caller's explicit choice: NCCL for CUDA devices, gloo
for the CPU (and for several ranks sharing one card, where NCCL refuses a
second rank on the same device). Nothing switches backend or device on
its own.
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

from molclr_tpu_torch.parallel.dp import DPGroup

# seconds a rank waits for its peers (init and every collective) before it
# raises
DEFAULT_TIMEOUT_S = 600.0


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     log=print) -> DPGroup:
    """Join the data-parallel process group and return this rank's
    DPGroup.

    coordinator "HOST:PORT", num_processes and process_id name the group
    (the --dist-* flags, as jax.distributed.initialize takes them); with
    none of them, torchrun's RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT
    are read where they are set (as JAX detects its environment), and
    otherwise the group is this one process on a free localhost port.
    backend ('nccl' or 'gloo') is required. device is where the rank's
    tensors live: by default cuda:(LOCAL_RANK, else rank modulo the
    device count) for NCCL and the CPU for gloo. A group that is already
    joined is reused. One all_reduce runs at once, so that the
    communicator exists before any CUDA graph captures a collective and a
    peer that cannot be reached fails here, within timeout_s."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"init_distributed needs an explicit backend, "
                         f"'nccl' (CUDA) or 'gloo' (CPU), not {backend!r}")
    env = os.environ
    if not dist.is_initialized():
        given = (coordinator, num_processes, process_id)
        if all(v is None for v in given):
            if "WORLD_SIZE" in env and "RANK" in env:
                for k in ("MASTER_ADDR", "MASTER_PORT"):
                    if k not in env:
                        raise ValueError(f"RANK and WORLD_SIZE are set but "
                                         f"{k} is not")
                coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
                num_processes = int(env["WORLD_SIZE"])
                process_id = int(env["RANK"])
            else:
                coordinator = f"127.0.0.1:{free_port()}"
                num_processes, process_id = 1, 0
        elif any(v is None for v in given):
            raise ValueError(
                f"name the coordinator, the number of processes and this "
                f"process's id together (got {given})")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process id {process_id} outside "
                             f"[0, {num_processes})")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=timeout_s))
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not {backend!r}")
    rank, world = dist.get_rank(), dist.get_world_size()
    if device is None:
        if backend == "nccl":
            local = int(env.get("LOCAL_RANK", rank % max(
                1, torch.cuda.device_count())))
            device = torch.device("cuda", local)
        else:
            device = torch.device("cpu")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, not {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dp = DPGroup(rank, world, backend, device)
    # the first collective: creates the NCCL communicator eagerly and
    # checks that every peer is there
    dp.all_reduce_(torch.ones(1, device=device))
    dp.collectives = 0
    log(f"torch.distributed: rank {rank} of {world}, backend {backend}, "
        f"device {device}")
    return dp


def destroy_distributed() -> None:
    """Leave the process group, where one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def corpus_shard_range(n_items: int, process_index: int,
                       process_count: int) -> range:
    """This process's contiguous slice of an n_items corpus (contiguous,
    so that a memory-mapped corpus reads one dense region per process);
    the remainder goes to the first processes, so slices differ by at most
    one. The JAX package's corpus_shard_range."""
    base, rem = divmod(n_items, process_count)
    start = process_index * base + min(process_index, rem)
    return range(start, start + base + (1 if process_index < rem else 0))
