"""Data sources (port of holo_diffusion_tpu/data/source.py): same-sequence
batches of FrameData for the training loop.

Every batch holds `batch_size` frames of ONE scene, as the reference's
SequenceDataLoaderMapProvider gives them (conditioning SAME); the model's
split into render targets and pooling sources relies on it. Frame indices
are drawn with the same `np.random.RandomState` calls as the JAX package, so
a seed gives the same frames in the same order on both sides.

Providers: `SyntheticDataProvider` (sphere scenes of data/synthetic.py, made
on the given device, so its batches are gathered there) and
`data/co3d.py:CO3DDataProvider` (CO3Dv2, scenes cached on the host: its
batches are CPU tensors, which the training loop pins and copies).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Optional

import numpy as np
import torch

from ..device import DeviceLike
from .frame_data import FrameData
from .synthetic import make_synthetic_scene


class SceneDataset:
    """A list of scenes; each scene is a FrameData holding all its views."""

    def __init__(self, scenes: List[FrameData]):
        self.scenes = scenes

    def __len__(self):
        return len(self.scenes)

    def get_scene(self, idx: int) -> FrameData:
        return self.scenes[idx]

    def iter_scenes(self, limit: int = -1):
        """Yield the first `limit` scenes (all when negative), one at a time."""
        n = len(self) if limit < 0 else min(limit, len(self))
        for i in range(n):
            yield self.get_scene(i)

    def first_scenes(self, k: int):
        return list(self.iter_scenes(k))

    def sample_batch(self, rng: np.random.RandomState, batch_size: int) -> FrameData:
        """`batch_size` frames of one random scene, drawn with replacement
        when the scene has fewer frames. The batch lies where the scene does."""
        scene = self.scenes[rng.randint(len(self.scenes))]
        n = scene.batch_size
        replace = n < batch_size
        idx = rng.choice(n, size=min(batch_size, n) if not replace else batch_size,
                         replace=replace)
        return scene[torch.as_tensor(idx, device=scene.camera.R.device)]


class SyntheticDataProvider:
    """`n_scenes` training scenes from seeds `seed + i`, and
    max(1, n_scenes // 4) validation scenes from `seed + 1000 + i`, made on
    `device` (the card unless "cpu")."""

    def __init__(
        self,
        n_scenes: int = 8,
        n_views_per_scene: int = 8,
        image_size: int = 64,
        seed: int = 0,
        device: DeviceLike = None,
        **_,
    ):
        self.train = SceneDataset([
            make_synthetic_scene(n_views_per_scene, image_size, seed=seed + i, device=device)
            for i in range(n_scenes)
        ])
        self.val = SceneDataset([
            make_synthetic_scene(n_views_per_scene, image_size, seed=seed + 1000 + i, device=device)
            for i in range(max(1, n_scenes // 4))
        ])


def epoch_loader(
    dataset: SceneDataset, batch_size: int, n_batches: int, seed: int
) -> Iterator[FrameData]:
    """The epoch's batches, drawn from `np.random.RandomState(seed)` (the
    loop passes seed + epoch, as the reference reseeds every epoch)."""
    rng = np.random.RandomState(seed)
    for _ in range(n_batches):
        yield dataset.sample_batch(rng, batch_size)


def device_batched_loader(
    dataset: SceneDataset,
    batch_size: int,
    n_batches: int,
    seed: int,
    n_devices: int,
    process_index: int = 0,
    process_count: int = 1,
    transform: Optional[Callable[[FrameData], FrameData]] = None,
) -> Iterator:
    """The batches of this process's devices for data-parallel training
    (one scene a device). Device d of the `n_devices` in all draws batch b
    from `np.random.RandomState(SeedSequence((seed, b, d)))`, as JAX's
    loader does, so every process agrees on the global batch without
    building it; this process holds the contiguous block of devices
    `process_index * local ...` with local = n_devices // process_count.
    `transform` (such as a SourceCompactor) applies to each device's batch
    first. With one device a process (the port's launch: one process a
    GPU) each item is that device's FrameData; with more, the list of them
    (the port stacks nothing across devices)."""
    if n_devices % process_count:
        raise ValueError(f"{n_devices} devices do not split over {process_count} processes")
    local = n_devices // process_count
    first = process_index * local
    for b in range(n_batches):
        batches = [
            dataset.sample_batch(
                np.random.RandomState(np.random.SeedSequence((seed, b, first + d)).generate_state(1)[0]),
                batch_size)
            for d in range(local)
        ]
        if transform is not None:
            batches = [transform(x) for x in batches]
        yield batches[0] if local == 1 else batches


class AsyncLoader:
    """Iterates `iterator` in a background thread, `prefetch` items ahead.
    `transfer` (such as `lambda b: b.to(device, non_blocking=True)`) is
    applied in that thread, so batch N+1's copy overlaps step N. An error
    in the thread is raised where the loop reads the item it would have
    been."""

    def __init__(self, iterator, prefetch: int = 2, transfer: Optional[Callable] = None):
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for item in iterator:
                    if transfer is not None:
                        item = transfer(item)
                    self._q.put(item)
            except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
                self._err = e
            finally:
                self._q.put(_SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                self._thread.join()
                if self._err is not None:
                    raise self._err
                return
            yield item


_SENTINEL = object()


class WholeDatasetLoader:
    """`whole_dataset_batch` mode (reference training_loop.py:715-739): one
    batch drawn from `seed`, replayed `n_batches_in_epoch` times an epoch."""

    def __init__(self, dataset: SceneDataset, batch_size: int, n_batches_in_epoch: int, seed: int = 0):
        self._batch = dataset.sample_batch(np.random.RandomState(seed), batch_size)
        self.n_batches_in_epoch = n_batches_in_epoch

    def __iter__(self):
        for _ in range(self.n_batches_in_epoch):
            yield self._batch
