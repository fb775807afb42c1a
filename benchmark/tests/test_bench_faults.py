"""Runs with the timed path broken underneath come out not correct. Each
drives a whole run at a tiny size on the CPU (the look for a card skipped),
with the cell's real limits, once for each fault the cell can have: a step
that returns its state unchanged; half of the batch left out, the mean over
the rest; an answer altered where it is produced. (One card: no exchange
between cards to leave out.)"""
import time

import pytest
import torch

import holo_diffusion_torch.models.diffusion as gd
import holo_diffusion_torch.models.holo_model as holo_model
import holo_diffusion_torch.models.metrics as metrics
import holo_diffusion_torch.render_eval as render_eval
from benchmark.harness.manifest import Manifest
from benchmark.harness.runner import run_cell
from benchmark.tests.tiny import make_tiny_root
from holo_diffusion_torch.train.optimizer import Optimizer


@pytest.fixture(scope="module")
def man(tmp_path_factory):
    torch.set_num_threads(2)
    return Manifest(make_tiny_root(tmp_path_factory.mktemp("tiny")))


def state_unchanged(mp):
    def step(self):
        self.steps += 1

    mp.setattr(Optimizer, "step", step)


def half_the_rays(mp):
    plain = metrics.view_metrics

    def half(features, depths, masks, xys, *rest, **kw):
        n = xys.shape[1] // 2
        return plain(features[:, :n], depths[:, :n], masks[:, :n], xys[:, :n], *rest, **kw)

    mp.setattr(metrics, "view_metrics", half)


def objective_altered(mp):
    plain = holo_model.get_objective
    mp.setattr(holo_model, "get_objective", lambda preds, w: plain(preds, w) * (1.0 + 1e-3))


def chunk_altered(mp):
    plain = render_eval.make_chunk_render_fn

    def make(model):
        fn = plain(model)

        def altered(grid, bundle):
            out = fn(grid, bundle)
            out.features[0, 0, 0] += 0.05
            return out

        return altered

    mp.setattr(render_eval, "make_chunk_render_fn", make)


def half_the_chunk(mp):
    plain = render_eval.make_chunk_render_fn

    def make(model):
        fn = plain(model)

        def half(grid, bundle):
            n = bundle.origins.shape[1]
            out = fn(grid, bundle.slice_rays(slice(0, (n + 1) // 2)))
            pad = lambda x: torch.cat([x, x[:, : n - x.shape[1]]], dim=1)  # noqa: E731
            out.features, out.depths, out.masks = pad(out.features), pad(out.depths), pad(out.masks)
            if out.normals is not None:
                out.normals = pad(out.normals)
            return out

        return half

    mp.setattr(render_eval, "make_chunk_render_fn", make)


def step_unchanged(mp):
    plain = gd.p_sample

    def same(sched, model_fn, x, t, *a, **kw):
        out = plain(sched, model_fn, x, t, *a, **kw)
        return {**out, "sample": x}

    mp.setattr(gd, "p_sample", same)


def sample_altered(mp):
    plain = gd.p_sample

    def altered(*a, **kw):
        out = plain(*a, **kw)
        s = out["sample"].clone()
        s.view(-1)[0] += 0.05
        return {**out, "sample": s}

    mp.setattr(gd, "p_sample", altered)


FAULTS = [
    ("hydrant.train", state_unchanged), ("hydrant.train", half_the_rays), ("hydrant.train", objective_altered),
    ("teddybear.train", state_unchanged), ("teddybear.train", half_the_rays),
    ("teddybear.train", objective_altered),
    ("hydrant.frames", half_the_chunk), ("hydrant.frames", chunk_altered),
    ("hydrant.sample", step_unchanged), ("hydrant.sample", sample_altered),
]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_fault_is_not_correct(man, monkeypatch, workload, fault):
    fault(monkeypatch)
    r = run_cell(man, workload, 2 ** 31 + 5, 0.3, False, "cpu", time.perf_counter(), log=lambda s: None)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("workload", ["hydrant.train", "teddybear.train", "hydrant.frames", "hydrant.sample"])
def test_sound_run_is_correct(man, workload):
    r = run_cell(man, workload, 2 ** 31 + 5, 0.3, False, "cpu", time.perf_counter(), log=lambda s: None)
    assert r["correct"] is True, r["checks"]
