"""FrameData, the batch the model takes (port of
holo_diffusion_tpu/data/frame_data.py, non-compact batches): one scene's
frames, channels-last images. Images and masks are float32 in [0, 1] or
uint8, depths float32 or float16 (the CO3D cache's dtypes); the model
converts them on the device (models/metrics.py:as_unit_float)."""
from __future__ import annotations

import dataclasses
from typing import Optional

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

    def pin_memory(self) -> "FrameData":
        """A copy of a CPU batch in page-locked memory, so that
        `.to(card, non_blocking=True)` copies asynchronously. PyTorch's
        pinned-memory allocator records the copy's stream: a freed buffer
        is not handed out again before the copy that reads it completes."""
        return self._map(lambda x: x.pin_memory())

    def __getitem__(self, idx) -> "FrameData":
        """The frames `idx` (an index tensor or a slice) of every field."""
        return FrameData(self.camera[idx], *(
            None if getattr(self, f.name) is None else getattr(self, f.name)[idx]
            for f in dataclasses.fields(self)[1:]))
