"""Multi-process launch (port of holo_diffusion_tpu/parallel/launch.py): one
process per GPU, started by torchrun, which sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT:

    torchrun --nproc_per_node 8 -m holo_diffusion_torch.cli train --config-name hydrant ...

`initialize_distributed()` joins the process group once before training:
NCCL on the card (after `torch.cuda.set_device(LOCAL_RANK)`), gloo only
when the caller asks for the CPU. Without torchrun's variables it does
nothing and training runs in one process.

One deliberate deviation from JAX: when joining fails, this raises. JAX
logs a warning and carries on as a single process (launch.py:31-42), which
would hide a broken multi-GPU launch behind N independent runs.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

ENV_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize_distributed(device: DeviceLike = None,
                           timeout: Optional[datetime.timedelta] = None) -> bool:
    """Join torchrun's process group; returns whether a group is up. A
    no-op (False) without torchrun's variables, and (True) when a group is
    up already. `device` None or CUDA: NCCL, with this process on the card
    LOCAL_RANK; "cpu": gloo. Raises when the variables are incomplete or
    the rendezvous fails (within `timeout`)."""
    if is_initialized():
        return True
    present = [k for k in ENV_VARS if k in os.environ]
    if not present:
        return False
    if len(present) != len(ENV_VARS):
        missing = sorted(set(ENV_VARS) - set(present))
        raise RuntimeError(f"incomplete launch environment: {missing} unset (launch with torchrun)")
    rank, world, local = (int(os.environ[k]) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        resolve_device(dev)  # raises without CUDA
        torch.cuda.set_device(local)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    init = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                            **({} if timeout is None else {"timeout": timeout}))
    logger.info("distributed: rank %d of %d (%s, local rank %d)", rank, world, backend, local)
    return True


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    """Whether this process writes the run's files (rank 0, or no group)."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing without a group)."""
    if is_initialized():
        dist.barrier()
