"""DDPM ancestral sampling of one grid at a time, chains back to back, each
driven step by step through the program's `p_sample_loop_progressive` with
`model.apply_net_3d` and draws from a generator seeded from the seed.

Compared after the window: the first `start_steps` steps, which the
reference follows from its own x_T (the generator's draws replayed), and a
sample of the window's steps drawn from the seed (reservoir) with the last
one, which the reference takes from the program's state before the step.
Numbers: the widest gap of the x0 prediction and of the sample."""
from __future__ import annotations

import random
from typing import Dict, List

import torch

from ...reference import diffusion as rdiff
from ...reference.spec import precision
from ..program import Context, free_cuda, program_model
from ..seeds import generator, stream_seed

E2E = "sample_grid_s"


class Cell:
    unit_name = "ddpm_step"

    def __init__(self, ctx: Context):
        self.ctx = ctx
        s = ctx.spec
        self.shape = (1, s.resol, s.resol, s.resol, s.feature_size)
        self.n_steps = s.num_steps

    def flops_per_unit(self) -> Dict[str, float]:
        from ...counts import model as counts

        return counts.ddpm_step(self.ctx.spec)

    def e2e_scale(self) -> float:
        """sample_grid_s is the seconds of a whole chain: num_steps units."""
        return float(self.n_steps)

    def setup(self) -> None:
        ctx = self.ctx
        self.model = program_model(ctx, ctx.weights())
        self.model.eval()
        self.gen = generator(ctx.seed, "draws", ctx.device)
        self.chain_index = -1
        self._new_chain()
        self.rng = random.Random(stream_seed(ctx.seed, "check"))
        self.kept: List = []
        self.seen = 0
        self.start = [self._advance() for _ in range(ctx.mix["start_steps"])]

    def _new_chain(self) -> None:
        from holo_diffusion_torch.models import diffusion as gd

        self.chain = gd.p_sample_loop_progressive(self.model.schedule, self.model.apply_net_3d, self.shape,
                                                  generator=self.gen, device=self.ctx.device)
        self.chain_index += 1
        self.k = 0
        self.prev = None

    @torch.no_grad()
    def _advance(self):
        try:
            out = next(self.chain)
        except StopIteration:
            self._new_chain()
            out = next(self.chain)
        rec = (self.chain_index, self.k, self.prev, out["sample"], out["pred_xstart"])
        self.prev = out["sample"]
        self.k += 1
        return rec

    def unit(self) -> None:
        from torch.profiler import record_function

        with record_function("bench.ddpm_step"):
            rec = self._advance()
        self.seen += 1
        self.last = rec
        k = self.ctx.mix["check_steps"]
        if len(self.kept) < k:
            self.kept.append(rec)
        else:
            j = self.rng.randrange(self.seen)
            if j < k:
                self.kept[j] = rec

    def drain(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def failed(self) -> int:
        return int(not bool(torch.isfinite(self.last[3]).all())) if self.seen else 0

    def host_timers(self) -> Dict[str, List[float]]:
        return {}

    def release(self) -> None:
        del self.model, self.chain
        free_cuda()

    # ---- the comparison

    def _noises(self, indices) -> Dict[int, torch.Tensor]:
        """The generator's draws at `indices`, replayed in its order: x_T of
        chain c is draw c * (T + 1), step k's noise draw c * (T + 1) + 1 + k."""
        g = generator(self.ctx.seed, "draws", self.ctx.device)
        want, out = set(indices), {}
        for i in range(max(want) + 1):
            x = torch.randn(self.shape, generator=g, device=self.ctx.device)
            if i in want:
                out[i] = x
        return out

    @torch.no_grad()
    def reference_steps(self, tf32: bool = False) -> Dict[str, List]:
        T1 = self.n_steps + 1
        window = list(self.kept)
        if self.seen and all(r is not self.last for r in window):
            window.append(self.last)
        idx = {0} | {c * T1 + 1 + k for c, k, *_ in self.start + window} | {c * T1 for c, k, *_ in window if k == 0}
        noise = self._noises(idx)
        ref = self.ctx.reference()
        sched = rdiff.Schedule(self.n_steps, self.ctx.spec.beta_start, self.ctx.spec.beta_end, self.ctx.device)
        got, want = [], []
        with precision(tf32):
            x = noise[0]
            for c, k, _, sample, pred in self.start:
                t = torch.full((1,), self.n_steps - 1 - k, dtype=torch.long, device=self.ctx.device)
                r = ref.p_sample(sched, x, t, noise[c * T1 + 1 + k])
                got.append((sample, pred))
                want.append((r["sample"], r["pred_xstart"]))
                x = r["sample"]
            for c, k, prev, sample, pred in window:
                x = noise[c * T1] if k == 0 else prev
                t = torch.full((1,), self.n_steps - 1 - k, dtype=torch.long, device=self.ctx.device)
                r = ref.p_sample(sched, x, t, noise[c * T1 + 1 + k])
                got.append((sample, pred))
                want.append((r["sample"], r["pred_xstart"]))
        del ref
        free_cuda()
        return {"got": got, "want": want}

    @staticmethod
    def readings(got, want) -> Dict[str, float]:
        return {
            "pred_gap": max(float((g[1] - w[1]).abs().max()) for g, w in zip(got, want)),
            "sample_gap": max(float((g[0] - w[0]).abs().max()) for g, w in zip(got, want)),
        }

    def check(self, controls=()) -> Dict[str, Dict[str, float]]:
        r = self.reference_steps()
        out = {"program": self.readings(r["got"], r["want"])}
        for c in controls:
            alt = self.reference_steps(tf32=True)
            out[c] = self.readings(alt["want"], r["want"])
        return out
