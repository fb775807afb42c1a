"""Collectives that keep the replicated training state in step (port of
holo_diffusion_tpu/parallel/collectives.py).

The reference's one explicit `torch.distributed` call is the loss-aware
timestep sampler's `all_gather` of each rank's (timestep, loss) pairs,
followed by the same update on every rank (timestep_sampler.py:89-127);
`gathered_loss_aware_update` is that. `mean_over_ranks` averages a list of
tensors (the gradients, the metrics) with ONE `all_reduce` over a flat
buffer: at hydrant width the gradients are 186.8 M floats in ~300 tensors,
and a collective for each would add hundreds of NCCL launches to a step
that is launch-bound already.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..models import diffusion as gd


def mean_over_ranks(tensors: Sequence[torch.Tensor], group: Optional[object] = None) -> List[torch.Tensor]:
    """The mean of each tensor over the group's ranks, by one sum
    `all_reduce` over a flat buffer and one divide by the world size.
    Returns views into that buffer, shaped as the inputs (one dtype and
    one device for all)."""
    if not tensors:
        return []
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"mean_over_ranks takes tensors of one dtype, got {sorted(map(str, dtypes))}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    return [v.view(t.shape) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def gathered_loss_aware_update(
    state: gd.LossSecondMomentState,
    ts: torch.Tensor,
    losses: torch.Tensor,
    mask=None,
    group: Optional[object] = None,
) -> gd.LossSecondMomentState:
    """The loss-aware sampler's update from every rank's (t, loss, valid)
    triples: one `all_gather` of this rank's K triples (as float32: the
    timesteps are exact below 2^24), then the same `loss_aware_update` on
    every rank over the pairs in rank order, so the state stays bitwise
    equal across ranks. ts (K,) timesteps; losses a scalar or (K,); mask
    (K,) validity (host booleans or a tensor; None: all valid)."""
    dev = state.loss_history.device
    k = ts.numel()
    valid = torch.ones(k, dtype=torch.bool) if mask is None else torch.as_tensor(mask, dtype=torch.bool)
    local = torch.stack([ts.reshape(-1).to(device=dev, dtype=torch.float32),
                         losses.to(device=dev, dtype=torch.float32).expand(k),
                         valid.to(device=dev, dtype=torch.float32)], dim=1)
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    pairs = torch.cat(parts)
    return gd.loss_aware_update(state, pairs[:, 0].to(torch.int64), pairs[:, 1], pairs[:, 2] > 0.5)
