"""The data-parallel "mesh" (port of holo_diffusion_tpu/parallel/mesh.py):
the port's counterpart of JAX's 1-axis `data` mesh is a process group
with one device a process. Each rank trains on its own scene, the ranks
average their gradients after each backward (parallel/train_step.py), and
the replicated state stays bitwise equal across ranks.

    initialize_distributed()          # parallel/launch.py, under torchrun
    mesh = make_mesh()
    state = replicate(state, mesh)    # rank 0's state on every rank

JAX's `shard_batch` has no counterpart: it places a global batch's shards
on the mesh's devices, but here each rank loads only its own slice
(data/source.py:device_batched_loader) onto its own device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from .launch import is_initialized


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group, its size, this process's rank in it, and the device
    this process trains on."""

    group: Any
    world_size: int
    rank: int
    device: torch.device


def make_mesh(device: DeviceLike = None) -> Mesh:
    """The mesh of the default process group on `device` (the card unless
    "cpu"); NCCL needs the card, gloo the CPU."""
    if not is_initialized():
        raise RuntimeError("no process group: call parallel.launch.initialize_distributed() first")
    dev = resolve_device(device)
    group = dist.group.WORLD
    backend = dist.get_backend(group)
    if (backend == "nccl") != (dev.type == "cuda"):
        raise ValueError(f"a {backend} process group cannot train on {dev}")
    return Mesh(group, dist.get_world_size(group), dist.get_rank(group), dev)


def _state_tensors(state) -> List[torch.Tensor]:
    """Every tensor of a TrainState in one fixed order: the model's
    parameters and buffers, the optimizer's state by parameter, the EMA,
    the sampler's state."""
    model = state.model
    out = [p.data for p in model.parameters()] + list(model.buffers())
    opt = state.optimizer.optimizer
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state.get(p, {})
            out += [st[k] for k in sorted(st) if isinstance(st[k], torch.Tensor)]
    if state.ema is not None:
        out += [state.ema[k] for k in sorted(state.ema)]
    if state.sampler_state is not None:
        out += [state.sampler_state.loss_history, state.sampler_state.loss_counts]
    return out


@torch.no_grad()
def replicate(state, mesh: Mesh):
    """Broadcast rank 0's TrainState (parameters, buffers, optimizer state,
    EMA, sampler state, step counts) to every rank, in place; returns it.
    Raises on every rank when the ranks' states differ in structure."""
    tensors = _state_tensors(state)
    n, numel = len(tensors), sum(t.numel() for t in tensors)
    # the max of (n, -n, numel, -numel) over ranks is this rank's own on
    # every rank exactly when all ranks agree
    sizes = torch.tensor([n, -n, numel, -numel], dtype=torch.int64, device=mesh.device)
    ref = sizes.clone()
    dist.all_reduce(sizes, op=dist.ReduceOp.MAX, group=mesh.group)
    if not torch.equal(sizes, ref):
        raise ValueError("the ranks' training states differ in structure; replicate needs the same model, "
                         "optimizer state, EMA and sampler on every rank")
    for t in tensors:
        if t.device == mesh.device:
            dist.broadcast(t, src=0, group=mesh.group)
        else:  # such as Adam's step counts, which torch keeps on the CPU
            buf = t.to(mesh.device)
            dist.broadcast(buf, src=0, group=mesh.group)
            t.copy_(buf)
    steps = torch.tensor([state.step, state.optimizer.steps], dtype=torch.int64, device=mesh.device)
    dist.broadcast(steps, src=0, group=mesh.group)
    state.step, state.optimizer.steps = (int(v) for v in steps.tolist())
    state.optimizer._set_lr()
    return state
