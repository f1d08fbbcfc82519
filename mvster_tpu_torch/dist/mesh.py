"""Process group and device of a data-parallel rank (counterpart of mvster_tpu.dist.mesh).

The JAX package runs one SPMD program over a data mesh and joins processes
through JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID.  The
port runs one process a card, launched by torchrun:

  python -m torch.distributed.run --nproc_per_node N \\
      -m mvster_tpu_torch.tools.train --batch_size <global batch> ...

which sets WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT for
each process.  Without WORLD_SIZE there is no process group and a program
runs on one device as before.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def world_size() -> int:
    """The number of ranks in the default process group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main() -> bool:
    """Whether this process is rank 0, the one that prints, logs and writes."""
    return rank() == 0


def rank_device(name: str | torch.device = "cuda") -> torch.device:
    """The device of this process: cuda:LOCAL_RANK for a CUDA device (raising
    where LOCAL_RANK names no card, so two ranks never share one), the CPU
    as given."""
    device = torch.device(name)
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", device.index or 0))
    count = torch.cuda.device_count()
    if local >= count:
        raise RuntimeError(f"LOCAL_RANK {local} but {count} CUDA device(s): launch one "
                           "process a card (torchrun --nproc_per_node <= cards)")
    return torch.device("cuda", local)


def maybe_initialize_distributed(device: str | torch.device = "cuda",
                                 backend: str | None = None) -> tuple[int, int]:
    """Join the process group that torchrun's environment describes and
    return (rank, world_size); (0, 1) and no group where WORLD_SIZE is unset.

    `backend` defaults to NCCL for a CUDA device and gloo for the CPU.  A
    group that already exists is kept.  With WORLD_SIZE set, a failed
    rendezvous raises: a rank never goes on alone.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if "WORLD_SIZE" not in os.environ:
        return 0, 1
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(backend=backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    return dist.get_rank(), dist.get_world_size()
