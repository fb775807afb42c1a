"""FrameData, the batch the model takes (port of
holo_diffusion_tpu/data/frame_data.py): one scene's frames, channels-last
images. Images and masks are float32 in [0, 1] or uint8, depths float32 or
float16 (the CO3D cache's dtypes); the model converts them on the device
(models/metrics.py:as_unit_float).

A compact batch (data/compact.py) sets the `src_*` fields: `image_rgb`,
`fg_probability`, `mask_crop` and `depth_map` then hold only the render
targets at full resolution, the `src_*` fields the pooling sources, already
masked and resized to the feature extractor's input (uint8), and `camera`
covers the targets, then the sources."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..geometry.cameras import PerspectiveCameras


@dataclasses.dataclass
class FrameData:
    camera: PerspectiveCameras
    image_rgb: Optional[torch.Tensor] = None  # (B, H, W, 3) in [0, 1]
    fg_probability: Optional[torch.Tensor] = None  # (B, H, W, 1)
    mask_crop: Optional[torch.Tensor] = None  # (B, H, W, 1)
    depth_map: Optional[torch.Tensor] = None  # (B, H, W, 1)
    sequence_id: Optional[torch.Tensor] = None  # (B,) int
    src_image_rgb: Optional[torch.Tensor] = None  # (S, h, w, 3) uint8
    src_fg_probability: Optional[torch.Tensor] = None  # (S, h, w, 1) uint8
    src_mask_crop: Optional[torch.Tensor] = None  # (S, h, w, 1) uint8

    @property
    def batch_size(self) -> int:
        return self.camera.batch_size

    @property
    def device(self) -> torch.device:
        return self.camera.R.device

    def _map(self, fn) -> "FrameData":
        return FrameData(
            PerspectiveCameras(*(fn(getattr(self.camera, f.name)) for f in dataclasses.fields(self.camera))),
            *(None if getattr(self, f.name) is None else fn(getattr(self, f.name))
              for f in dataclasses.fields(self)[1:]))

    def to(self, device, non_blocking: bool = False) -> "FrameData":
        return self._map(lambda x: x.to(device, non_blocking=non_blocking))

    def nbytes(self) -> int:
        """The bytes of the batch's tensors, the camera's included."""
        leaves = [getattr(self.camera, f.name) for f in dataclasses.fields(self.camera)]
        leaves += [getattr(self, f.name) for f in dataclasses.fields(self)[1:]]
        return sum(x.nbytes for x in leaves if x is not None)

    def pin_memory(self) -> "FrameData":
        """A copy of a CPU batch in page-locked memory, so that
        `.to(card, non_blocking=True)` copies asynchronously. PyTorch's
        pinned-memory allocator records the copy's stream: a freed buffer
        is not handed out again before the copy that reads it completes."""
        return self._map(lambda x: x.pin_memory())

    def __getitem__(self, idx) -> "FrameData":
        """The frames `idx` (an index tensor or a slice) of every field.
        A compact batch cannot be indexed so: its targets and sources have
        different leading sizes (`data/compact.py:CompactSceneSampler`
        selects their frames apart)."""
        if self.src_image_rgb is not None:
            raise ValueError("cannot index the frames of a compact batch: targets and sources have "
                             "different leading sizes")
        return FrameData(self.camera[idx], *(
            None if getattr(self, f.name) is None else getattr(self, f.name)[idx]
            for f in dataclasses.fields(self)[1:]))

    @classmethod
    def stack_steps(cls, batches: Sequence["FrameData"]) -> "FrameData":
        """K batches of equal shapes as one FrameData whose every tensor
        has a leading step axis (K, B, ...): the batch of one call of a
        train step with `steps_per_call` K."""
        first = batches[0]

        def stacked(get):
            return torch.stack([get(b) for b in batches])

        camera = PerspectiveCameras(*(stacked(lambda b, n=f.name: getattr(b.camera, n))
                                      for f in dataclasses.fields(first.camera)))
        return cls(camera, *(None if getattr(first, f.name) is None else stacked(lambda b, n=f.name: getattr(b, n))
                             for f in dataclasses.fields(cls)[1:]))

    def step(self, k: int) -> "FrameData":
        """The k-th batch of a step-stacked FrameData (`stack_steps`)."""
        return self._map(lambda x: x[k])
