"""FrameData, the batch the model takes (port of
holo_diffusion_tpu/data/frame_data.py, non-compact batches): one scene's
frames, channels-last images."""
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

    def to(self, device, non_blocking: bool = False) -> "FrameData":
        return FrameData(self.camera.to(device, non_blocking), *(
            None if getattr(self, f.name) is None else getattr(self, f.name).to(device, non_blocking=non_blocking)
            for f in dataclasses.fields(self)[1:]))

    def __getitem__(self, idx) -> "FrameData":
        """The frames `idx` (an index tensor or a slice) of every field."""
        return FrameData(self.camera[idx], *(
            None if getattr(self, f.name) is None else getattr(self, f.name)[idx]
            for f in dataclasses.fields(self)[1:]))
