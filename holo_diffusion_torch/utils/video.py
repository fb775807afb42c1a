"""Video writing (port of holo_diffusion_tpu/utils/video.py).

Frames are written as PNGs (encoded here with zlib, no imaging package) into
`<name>_frames/`; with an `ffmpeg` binary on PATH they are also joined into
the requested .mp4.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional

import numpy as np

from ..data.image_io import png_bytes


def write_png(path: str, frame: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 frame as an 8-bit RGB PNG."""
    with open(path, "wb") as f:
        f.write(png_bytes(frame, 2))


class VideoWriter:
    def __init__(self, out_path: str, fps: int = 20):
        self.out_path = out_path
        self.fps = fps
        self._frames: List[np.ndarray] = []
        self.frame_dir = os.path.splitext(out_path)[0] + "_frames"

    def write_frame(self, frame: np.ndarray) -> None:
        """frame: (H, W, 3) float in [0, 1] or uint8."""
        frame = np.asarray(frame)
        if frame.dtype != np.uint8:
            frame = (np.clip(frame, 0.0, 1.0) * 255).astype(np.uint8)
        self._frames.append(frame)

    def get_video(self) -> Optional[str]:
        """Flush the frames to disk; returns the .mp4 path when ffmpeg made
        one, else the frame directory."""
        if not self._frames:
            return None
        os.makedirs(self.frame_dir, exist_ok=True)
        for i, f in enumerate(self._frames):
            write_png(os.path.join(self.frame_dir, f"frame_{i:05d}.png"), f)
        if self.out_path.endswith(".mp4") and shutil.which("ffmpeg"):
            subprocess.run(
                [
                    "ffmpeg", "-y", "-framerate", str(self.fps),
                    "-i", os.path.join(self.frame_dir, "frame_%05d.png"),
                    "-pix_fmt", "yuv420p", self.out_path,
                ],
                check=True, capture_output=True,
            )
            return self.out_path
        return self.frame_dir
