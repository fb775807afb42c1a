"""Fly-around frames: the orbit's poses in turn, each rendered densely
through the program's chunked renderer (`render_eval.render_image_chunked`)
from one grid made from the seed in [-1, 1], and read back to the host as
the fly-around does for a grid it is given. Nothing is written to disk.

Compared after the window: a sample of the frames drawn from the seed, and
the last, against the reference's render of the same pose: the widest RGB
gap, and the mean gap of the normals."""
from __future__ import annotations

import math
import random
from typing import Dict, List

import torch

from ...reference import cameras as cam
from ...reference.spec import precision
from ..program import Context, free_cuda, program_model
from ..seeds import generator, stream_seed

E2E = "frame_s"


class Cell:
    unit_name = "frame"

    def __init__(self, ctx: Context):
        self.ctx = ctx
        m = ctx.mix
        self.poses = cam.orbit_cameras(m["poses"], m["distance"], m["elevation"], m["up"], m["focal"])
        self.n_poses = m["poses"]

    def flops_per_unit(self) -> Dict[str, float]:
        from ...counts import model as counts

        return counts.frame(self.ctx.spec)

    def setup(self) -> None:
        from holo_diffusion_torch.geometry.cameras import PerspectiveCameras

        ctx, dev, s = self.ctx, self.ctx.device, self.ctx.spec
        self.model = program_model(ctx, ctx.weights())
        self.model.eval()
        g = generator(ctx.seed, "grid", dev)
        self.grid = 2.0 * torch.rand((s.resol, s.resol, s.resol, s.feature_size), generator=g, device=dev) - 1.0
        p = cam.to(self.poses, dev)
        self.cams = PerspectiveCameras(p["R"], p["T"], p["focal"], p["pp"])
        self.frames: List = []
        self._render(0)

    def _render(self, pose: int) -> Dict[str, torch.Tensor]:
        from holo_diffusion_torch.render_eval import render_image_chunked

        out = render_image_chunked(self.model, self.cams[pose], self.grid, device=self.ctx.device)
        return {k: v.cpu() for k, v in out.items()}

    def unit(self) -> None:
        from torch.profiler import record_function

        pose = len(self.frames) % self.n_poses
        with record_function("bench.frame"):
            out = self._render(pose)
        self.frames.append((pose, {k: out[k] for k in ("images_render", "normals_render") if k in out}))

    def drain(self) -> None:
        pass

    def failed(self) -> int:
        return sum(not bool(torch.isfinite(f["images_render"]).all()) for _, f in self.frames)

    def host_timers(self) -> Dict[str, List[float]]:
        return {}

    def release(self) -> None:
        del self.model
        free_cuda()

    # ---- the comparison

    def checked(self) -> List[int]:
        """Indices of the frames compared: a sample drawn from the seed and
        the last frame."""
        n = len(self.frames)
        k = min(self.ctx.mix["check_frames"], n)
        pick = set(random.Random(stream_seed(self.ctx.seed, "check")).sample(range(n), k))
        return sorted(pick | {n - 1})

    def reference_frames(self, idx: List[int], tf32: bool = False) -> List[Dict[str, torch.Tensor]]:
        ref = self.ctx.reference()
        out = []
        with precision(tf32):
            for i in idx:
                f = ref.frame(self.grid, cam.to(cam.select(self.poses, self.frames[i][0]), self.ctx.device))
                out.append({k: v.cpu() for k, v in f.items()})
        del ref
        free_cuda()
        return out

    @staticmethod
    def readings(got: List[Dict], ref: List[Dict]) -> Dict[str, float]:
        rgb = max(float((g["images_render"] - r["rgb"]).abs().max()) for g, r in zip(got, ref))
        out = {"rgb_gap": rgb}
        if "normals" in ref[0]:
            out["normals_gap"] = max(float((g["normals_render"] - r["normals"]).abs().mean())
                                     for g, r in zip(got, ref))
        return {k: (v if math.isfinite(v) else float("inf")) for k, v in out.items()}

    def check(self, controls=()) -> Dict[str, Dict[str, float]]:
        idx = self.checked()
        ref = self.reference_frames(idx)
        out = {"program": self.readings([self.frames[i][1] for i in idx], ref)}
        for c in controls:
            alt = self.reference_frames(idx, tf32=True)
            out[c] = self.readings([{"images_render": a["rgb"], "normals_render": a.get("normals")} for a in alt],
                                   ref)
        return out
