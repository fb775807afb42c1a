"""Training steps, driven as the program's training loop drives them:
`make_train_step`'s step with the configuration's Adam, fed by `AsyncLoader`
through the loop's `Experiment._to_device` (pinned host batch, copied
`non_blocking` in the loader's thread) from a pool of distinct batches made
from the seed, draws from a generator seeded from it, and each step's
metrics read one step late.

Set-up drives the first `check_steps` steps through that same call and feed,
recording their draws; the reference follows them from the same weights,
batches and draws. The readings: the objective of the first step and of
all check steps, the first gradient by leaf (from Adam's first moment after
one step) and each leaf's change after the check steps; the cell's limits
file names those compared (the first step's objective, the median leaf's
gradient, the worst moving leaf's change)."""
from __future__ import annotations

import collections
import functools
import math
import sys
import time
import types
from typing import Dict, List

import torch

from ...reference.model import Trainer
from ...reference.spec import precision
from .. import compare
from ..program import Context, free_cuda, program_model
from ..scenes import make_pool, to_device
from ..seeds import generator

E2E = "train_step_s"


def frame_data(batch: Dict[str, torch.Tensor]):
    from holo_diffusion_torch.data.frame_data import FrameData
    from holo_diffusion_torch.geometry.cameras import PerspectiveCameras

    return FrameData(PerspectiveCameras(batch["R"], batch["T"], batch["focal"], batch["pp"]),
                     image_rgb=batch["image_rgb"], fg_probability=batch["fg_probability"],
                     mask_crop=batch["mask_crop"], depth_map=batch["depth_map"])


def recording_draws(gen: torch.Generator):
    """The program's `Draws` on `gen`, keeping each value it hands out by
    name: the same numbers as passing `gen` itself."""
    from holo_diffusion_torch.random_draws import Draws

    class Recording(Draws):
        def __init__(self):
            super().__init__(generator=gen)
            self.record = {}

        def _keep(self, name, v):
            self.record[name] = v
            return v

        def uniform(self, name, shape, device):
            return self._keep(name, super().uniform(name, shape, device))

        def normal(self, name, shape, device):
            return self._keep(name, super().normal(name, shape, device))

        def randint(self, name, high, shape, device):
            return self._keep(name, super().randint(name, high, shape, device))

        def categorical(self, name, probs, shape):
            return self._keep(name, super().categorical(name, probs, shape))

        def coin(self, name, p):
            return self._keep(name, super().coin(name, p))

    return Recording()


class Cell:
    unit_name = "step"

    def __init__(self, ctx: Context):
        self.ctx = ctx
        data = ctx.config["data"]
        self.n_frames, self.size = data["frames"], data["image_size"]
        self.n_check = ctx.mix["check_steps"]

    def flops_per_unit(self) -> Dict[str, float]:
        from ...counts import model as counts

        return counts.train_step(self.ctx.spec, self.n_frames, self.size, self.size)

    def setup(self) -> None:
        from holo_diffusion_torch.config import optimizer_args_from_config
        from holo_diffusion_torch.data.source import AsyncLoader
        from holo_diffusion_torch.experiment import Experiment, _host_floats
        from holo_diffusion_torch.parallel.train_step import TrainState, make_train_step
        from holo_diffusion_torch.train.optimizer import make_lr_schedule, make_optimizer

        ctx, dev = self.ctx, self.ctx.device
        self._host_floats = _host_floats
        t0 = time.perf_counter()
        sd = ctx.weights()
        self.model = program_model(ctx, sd)
        oa = optimizer_args_from_config(ctx.cfg)
        loader = ctx.cfg["data_source_ImplicitronDataSource_args"][
            "data_loader_map_provider_SequenceDataLoaderMapProvider_args"]
        steps_per_epoch = max(1, loader["dataset_length_train"] // loader["batch_size"])
        opt = make_optimizer(self.model.named_parameters(), **oa["optimizer"],
                             schedule=make_lr_schedule(oa["optimizer"]["lr"], **oa["schedule"],
                                                       steps_per_epoch=steps_per_epoch))
        self.state = TrainState.create(self.model, opt)
        self.step = make_train_step(self.model, opt)
        self.model.train()
        t1 = time.perf_counter()
        self.pool = make_pool(ctx.seed, ctx.mix["pool_batches"], self.n_frames, self.size, dev)
        frames = [frame_data(b) for b in self.pool]
        t2 = time.perf_counter()
        self._stop = False

        def feed():
            i = 0
            while not self._stop:
                yield frames[i % len(frames)]
                i += 1

        transfer = functools.partial(Experiment._to_device, types.SimpleNamespace(device=dev))
        self.loader = AsyncLoader(feed(), transfer=transfer)
        self.it = iter(self.loader)
        self.gen = generator(ctx.seed, "draws", dev)
        named = list(self.model.named_parameters())
        beta1 = oa["optimizer"]["betas"][0]
        self.draws: List[Dict] = []
        self.losses: List[float] = []
        for k in range(self.n_check):
            rec = recording_draws(self.gen)
            self.state, metrics = self.step(self.state, next(self.it), rec)
            self.losses.append(_host_floats(metrics)["objective"])
            self.draws.append(rec.record)
            if k == 0:
                st = opt.optimizer.state
                self.first_grad = {n: float(st[p]["exp_avg"].norm()) / (1 - beta1) if p in st else 0.0
                                   for n, p in named}
        with torch.no_grad():
            self.change = {n: float((p - sd[n]).norm()) for n, p in named}
        del sd
        print(f"setup: model and optimizer {t1 - t0!r} s, batches {t2 - t1!r} s, "
              f"{self.n_check} check steps {time.perf_counter() - t2!r} s", file=sys.stderr)
        self.pending = collections.deque()
        self.waits: List[float] = []
        self.objectives: List[float] = []

    def unit(self) -> None:
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function("bench.loader_wait"):
            batch = next(self.it)
        self.waits.append(time.perf_counter() - t0)
        self.state, metrics = self.step(self.state, batch, self.gen)
        self.pending.append(metrics)
        if len(self.pending) > 1:
            self.objectives.append(self._host_floats(self.pending.popleft())["objective"])

    def drain(self) -> None:
        while self.pending:
            self.objectives.append(self._host_floats(self.pending.popleft())["objective"])

    def failed(self) -> int:
        return sum(not math.isfinite(o) for o in self.objectives)

    def host_timers(self) -> Dict[str, List[float]]:
        return {"loader_wait_s": list(self.waits)}

    def release(self) -> None:
        """Stop the feed and free the program's state."""
        self._stop = True
        for _ in self.it:
            pass
        del self.model, self.state, self.step, self.loader, self.it, self.pending
        free_cuda()

    # ---- the comparison

    def reference_run(self, tf32: bool = False, ray_share: float = 1.0) -> Dict:
        ctx = self.ctx
        trainer = Trainer(ctx.reference(), ray_share)
        with precision(tf32):
            for k in range(self.n_check):
                trainer.step(to_device(self.pool[k], ctx.device), self.draws[k])
        out = {"losses": trainer.losses, "grad": trainer.first_grad_norms, "change": trainer.change_norms()}
        del trainer
        free_cuda()
        return out

    @staticmethod
    def readings(got: Dict, ref: Dict) -> Dict[str, float]:
        """Every number the comparison can take (the cell's limits file
        names those it holds): the objective's relative gap at the first
        step and over all check steps; the first gradient's and the
        change's leaf gaps, at the worst leaf and at the median leaf."""
        moving = compare.moving_leaves(ref["grad"])
        return {
            "loss1_gap": compare.relative_gap(got["losses"][0], ref["losses"][0]),
            "loss_gap": max(compare.relative_gap(a, b) for a, b in zip(got["losses"], ref["losses"])),
            "grad_gap": compare.worst_leaf_gap(got["grad"], ref["grad"])[0],
            "grad_median_gap": compare.median_leaf_gap(got["grad"], ref["grad"]),
            "change_gap": compare.worst_leaf_gap(got["change"], ref["change"], moving)[0],
            "change_median_gap": compare.median_leaf_gap(got["change"], ref["change"], moving),
        }

    def program_record(self) -> Dict:
        return {"losses": self.losses, "grad": self.first_grad, "change": self.change}

    def check(self, controls=()) -> Dict[str, Dict[str, float]]:
        """{"program": readings[, "tf32": ..., "half_batch": ...], "worst":
        the leaves that give the program's gaps}: the program's readings,
        and each control's in its place, against the float32 reference."""
        ref = self.reference_run()
        got = self.program_record()
        out = {"program": self.readings(got, ref),
               "loss_gaps": [compare.relative_gap(a, b) for a, b in zip(got["losses"], ref["losses"])],
               "worst": {"grad": compare.worst_leaf_gap(got["grad"], ref["grad"])[1],
                         "change": compare.worst_leaf_gap(got["change"], ref["change"],
                                                          compare.moving_leaves(ref["grad"]))[1]}}
        for c in controls:
            alt = self.reference_run(tf32=True) if c == "tf32" else self.reference_run(ray_share=0.5)
            out[c] = self.readings(alt, ref)
        return out
