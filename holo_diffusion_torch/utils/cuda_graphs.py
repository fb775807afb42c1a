"""How the port captures CUDA graphs: one cache per model and device, each
with a private memory pool and a side stream that its captures share.

A graph takes the storage of the model's parameters and buffers as fixed
and reads their values live at each replay, so weights updated in place
(an optimizer step, `load_state_dict`) need no capture, while weights
moved or replaced change the cache's key (`storage_key` and what the
caller adds to it) and `GraphCache.of` hands back an empty cache. Users:
the chunk loop's graphs (`render_eval._ChunkGraphs`) and the UNet's
(`models/unet3d._UNetGraphs`).
"""
from __future__ import annotations

import itertools
import weakref
from typing import Callable, Hashable

import torch


def storage_key(module: torch.nn.Module) -> tuple:
    """Where each parameter and buffer of `module` is stored."""
    return tuple(t.data_ptr() for t in itertools.chain(module.parameters(), module.buffers()))


class GraphCache:
    """One model's CUDA graphs on one device. A subclass declares its own
    `_of` (a `weakref.WeakKeyDictionary`) and the dicts its graphs live in."""

    _of: weakref.WeakKeyDictionary  # model -> {device: cache}

    def __init__(self, dev: torch.device):
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(dev)
        self.key = None

    @classmethod
    def of(cls, model: torch.nn.Module, dev: torch.device, key: Hashable):
        """The model's cache on `dev`: a new, empty one where `key` differs
        from the key of the one held."""
        per_device = cls._of.setdefault(model, {})
        cache = per_device.get(dev)
        if cache is None or cache.key != key:
            cache = per_device[dev] = cls(dev)
            cache.key = key
        return cache

    def capture(self, fn: Callable, *args):
        """Warm `fn(*args)` up on the side stream (kernels loaded, shared
        memory set, cuDNN's plans and cuBLAS's workspace made), then capture
        it on that stream into the pool -> (graph, its static output)."""
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            fn(*args)
        current.wait_stream(self.stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream, capture_error_mode="thread_local"):
            out = fn(*args)
        return graph, out
