"""Release-scale training rehearsals on the synthetic CO3D tree (port of
scripts/release_rehearsal.py and scripts/release_rehearsal_long.py).

The hydrant release recipe (`configs/hydrant.yaml`: batches of 33
same-sequence frames at 800^2 through the CO3Dv2 loader, ResNet34, the
bootstrapped two-pass denoise, 3 x 1024 rays, Adam) runs through the real
training loop (`Experiment.run`: validation epochs, checkpoints, stats) on
the release tree of `data/synthetic_co3d.py`. The only cuts from the
release recipe are the epoch's length (40 steps) and the number of epochs.

With the probes (the long rehearsal) epochs run one `Experiment.run` call
at a time on one `Experiment`, so every epoch resumes from the previous
one's checkpoint, and after each epoch:

  * the diffusion leg's probe: E_t ||pred_x0(q_sample(v, t), t) - v||^2 at
    t in PROBE_TS, on the pooled grid v of a fixed validation batch with
    fixed noise (`pooled_grid`, `denoise_leg_mse`), raw and relative to
    var(v), since v moves as the extractor learns;
  * a 1000-step DDPM sample from a fixed seed, rendered at `render_size`^2
    from the probe's camera and saved as a PNG;
  * a record with the JAX script's keys; `curve.json` at the end.

Without the probes (the short rehearsal) the epochs run in one call and
each prints its stats line. Each epoch of the long rehearsal also prints
its seconds and, on the card, its peak device memory.

    python -m holo_diffusion_torch.rehearsal [max_epochs] [--no-probes] [--out DIR]
        [--exp-dir DIR] [--device cpu]

It runs on CUDA unless `--device` names another device, and raises when
CUDA is absent.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import logging
import os
import shutil
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import data_source_args_from_config, load_config
from .data.frame_data import FrameData
from .data.synthetic_co3d import RELEASE_CATEGORY, RELEASE_ROOT, ensure_release_tree, release_provider
from .device import DeviceLike, module_device, resolve_device, set_full_precision
from .experiment import Experiment
from .models import diffusion as gd
from .models.holo_model import HoloDiffusionModel
from .models.metrics import preprocess_input
from .render_eval import render_image_chunked
from .sampling import sample_random_voxel_features
from .utils.vis import save_image

PROBE_TS = (50, 250, 500, 750, 950)
PROBE_FRAMES = 9
OUT_ROOT = Path(__file__).resolve().parent.parent / "build" / "rehearsal"

_PROVIDER = "data_source_ImplicitronDataSource_args.dataset_map_provider_JsonIndexDatasetMapProviderV2_args."
_LOADER = "data_source_ImplicitronDataSource_args.data_loader_map_provider_SequenceDataLoaderMapProvider_args."


def release_overrides(category: str, root: str, exp_dir: str, epoch_frames: int, print_interval: int) -> List[str]:
    """The rehearsals' dotted overrides of `hydrant.yaml`: the tree, an epoch
    of `epoch_frames` frames, one 33-frame validation batch, compact
    sources, validation on."""
    return [
        _PROVIDER + f"category={category}",
        _PROVIDER + f"dataset_root={root}",
        _LOADER + f"dataset_length_train={epoch_frames}",
        _LOADER + "dataset_length_val=33",
        "compact_sources=true",
        "disable_validation=false",
        f"exp_dir={exp_dir}",
        f"training_loop_ImplicitronTrainingLoop_args.metric_print_interval={print_interval}",
    ]


@contextlib.contextmanager
def _eval_mode(model: torch.nn.Module):
    """`model` in eval mode and without autograd; its mode comes back after."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield model
    finally:
        model.train(was_training)


def pooled_grid(model: HoloDiffusionModel, batch: FrameData) -> torch.Tensor:
    """The raw pooled voxel grid (r, r, r, C) in [-1, 1] of `batch`'s
    frames, before the denoiser: the x0 the diffusion leg learns to
    recover. `preprocess_input`, then `pool_features` over every frame of
    the batch, in eval mode (the extractor's BatchNorm reads its running
    statistics and updates nothing)."""
    dev = module_device(model)
    with _eval_mode(model):
        img, fg, _ = preprocess_input(batch.image_rgb.to(dev), batch.fg_probability.to(dev), None,
                                      model.mask_images, model.mask_depths, model.mask_threshold, model.bg_color)
        return model.pool_features(img, batch.camera.to(dev), fg, batch.mask_crop.to(dev))


def denoise_leg_mse(model: HoloDiffusionModel, sched: gd.DiffusionSchedule, v: torch.Tensor, noise: torch.Tensor,
                    ts: Sequence[int] = PROBE_TS) -> torch.Tensor:
    """mean((pred_x0(q_sample(v, t, noise), t) - v)^2) at each t of `ts`
    -> (len(ts),). `v` (B, r, r, r, C) and the same `noise` at every t;
    pred_x0 is `p_mean_variance(..., clip_denoised=True)`'s through the
    raw denoiser."""
    out = []
    with _eval_mode(model):
        for t_scalar in ts:
            t = torch.full((v.shape[0],), t_scalar, dtype=torch.long, device=v.device)
            x_t = gd.q_sample(sched, v, t, noise)
            pred = gd.p_mean_variance(sched, model.apply_net_3d, x_t, t, clip_denoised=True)["pred_xstart"]
            out.append(torch.mean((pred - v) ** 2))
    return torch.stack(out)


def _g(d: Dict, k: str) -> str:
    v = d.get(k)
    return f"{v:.3f}" if isinstance(v, float) else str(v)


def run_rehearsal(
    max_epochs: int,
    out_dir: str,
    exp_dir: str,
    *,
    probes: bool = True,
    steps_per_epoch: int = 40,
    sample_seed: int = 7,
    probe_seed: int = 1234,
    render_size: int = 256,
    device: DeviceLike = None,
    root: Optional[str] = None,
    overrides: Sequence[str] = (),
) -> Tuple[Dict, List[Dict]]:
    """Train `max_epochs` epochs of `steps_per_epoch` steps of the hydrant
    recipe from scratch in `exp_dir` (emptied first) on the release tree
    (written first when missing), or on the CO3D tree `root` (category
    "synthball") with `overrides` applied after the rehearsal's own.

    Returns (summary, epochs). With `probes`, summary is what `curve.json`
    in `out_dir` holds: max_epochs, steps, wall_s and the per-epoch
    records of the JAX script; otherwise the same without the curve and
    with the loop's stats history. `epochs` holds each epoch's device
    numbers: seconds, peak and resting memory (GiB, on the card), the step
    count after it."""
    dev = resolve_device(device)
    category = ensure_release_tree() if root is None else RELEASE_CATEGORY
    root = str(root or RELEASE_ROOT)
    shutil.rmtree(exp_dir, ignore_errors=True)  # a fresh run, no resume from an earlier one
    os.makedirs(out_dir, exist_ok=True)
    batch_size = data_source_args_from_config(load_config("hydrant.yaml", list(overrides)))["batch_size"]
    cfg = load_config("hydrant.yaml", [
        *release_overrides(category, root, exp_dir, batch_size * steps_per_epoch, 20 if probes else 10),
        *overrides])
    exp = Experiment(cfg, device=dev)
    print(f"[rehearsal] {len(exp.data.train)} train sequences, batch {exp.batch_size}, {max_epochs} epochs",
          flush=True)
    on_card = dev.type == "cuda"

    def epoch_numbers(epoch, seconds, state):
        rec = {"epoch": epoch, "seconds": seconds, "step": state.step}
        if on_card:
            rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        return rec

    t_start = time.perf_counter()
    if not probes:
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        state, stats = exp.run(max_epochs=max_epochs, use_mesh=False)
        wall = time.perf_counter() - t_start
        for h in stats.history:
            tr, va = h.get("train", {}), h.get("val", {})
            print(f"[rehearsal] epoch {h['epoch']}: objective={_g(tr, 'objective')} psnr={_g(tr, 'loss_rgb_psnr')} "
                  f"val_objective={_g(va, 'objective')} val_psnr={_g(va, 'loss_rgb_psnr')}", flush=True)
        steps = max_epochs * exp.n_batches_train
        print(f"[rehearsal] {steps} release-scale steps + {max_epochs} val epochs + ckpts in {wall:.0f}s wall "
              f"({steps / wall:.2f} steps/s incl. loader, val, checkpointing)", flush=True)
        return ({"max_epochs": max_epochs, "steps": steps, "wall_s": round(wall, 1), "history": stats.history},
                [epoch_numbers(max_epochs - 1, wall, state)])

    model = exp.model
    data_args = exp.data_args
    provider = release_provider(root, category, data_args["image_height"], data_args["image_width"])
    probe = provider.val.sample_batch(np.random.RandomState(0), PROBE_FRAMES)
    sched = gd.make_named_schedule_from_config(model.diffusion_args, dev)
    grid_shape = (1, model.resol, model.resol, model.resol, model.feature_size)
    # the same noise on every device: drawn on the CPU
    noise = torch.randn(grid_shape, generator=torch.Generator().manual_seed(probe_seed)).to(dev)

    curve, epochs = [], []
    for epoch in range(max_epochs):
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state, stats = exp.run(max_epochs=epoch + 1, use_mesh=False)
        t_loop = time.perf_counter() - t0

        # the diffusion leg's probe on the fixed validation batch
        v = pooled_grid(model, probe)[None]
        per_t = denoise_leg_mse(model, sched, v, noise).cpu().numpy()
        # an unconditional DDPM sample, rendered from the probe's camera
        with _eval_mode(model):
            sample = sample_random_voxel_features(
                model, torch.Generator(device=dev).manual_seed(sample_seed), n_samples=1, device=dev)
            out = render_image_chunked(model, probe.camera[:1], sample[0], image_height=render_size,
                                       image_width=render_size, device=dev)
        image = out["images_render"].cpu().numpy()  # (H, W, 3)
        png = os.path.join(out_dir, f"sample_epoch_{epoch:02d}.png")
        save_image(png, image)

        h = stats.history[-1]
        tr, va = h.get("train", {}), h.get("val", {})
        # v moves as the extractor and pooler learn, so the denoiser's
        # progress shows in MSE / var(v) more than in the raw MSE
        v_var = float(torch.var(v))
        rec = {
            "epoch": epoch,
            "train_psnr": float(tr.get("loss_rgb_psnr", float("nan"))),
            "val_psnr": float(va.get("loss_rgb_psnr", float("nan"))),
            "objective": float(tr.get("objective", float("nan"))),
            "prev_stage_rgb_mse": float(tr.get("loss_prev_stage_rgb_mse", float("nan"))),
            "prev_stage_rgb_psnr": float(tr.get("loss_prev_stage_rgb_psnr", float("nan"))),
            "denoise_mse_per_t": {str(t): float(m) for t, m in zip(PROBE_TS, per_t)},
            "denoise_mse_mean": float(per_t.mean()),
            "pooled_grid_var": v_var,
            "denoise_mse_rel": float(per_t.mean() / max(v_var, 1e-12)),
            "sample_png": png,
            "sample_render_mean": float(image.mean()),
        }
        curve.append(rec)
        numbers = epoch_numbers(epoch, time.perf_counter() - t0, state)
        numbers["loop_s"] = t_loop
        del state, v, sample, out
        gc.collect()  # what stays allocated now is what the next epoch inherits
        if on_card:
            numbers["resting_gib"] = torch.cuda.memory_allocated(dev) / 2 ** 30
        epochs.append(numbers)
        mem = (f", peak {numbers['peak_gib']:.3f} GiB, resting {numbers['resting_gib']:.3f} GiB"
               if on_card else "")
        print(f"[rehearsal] epoch {epoch}: {numbers['seconds']:.1f} s (loop {t_loop:.1f} s), "
              f"step {numbers['step']}{mem}", flush=True)
        print(f"[rehearsal] epoch {epoch}: train_psnr={rec['train_psnr']:.3f} val_psnr={rec['val_psnr']:.3f} "
              f"prev_stage_mse={rec['prev_stage_rgb_mse']:.5f} denoise_mse={rec['denoise_mse_mean']:.5f} "
              f"(rel {rec['denoise_mse_rel']:.3f}, var(v) {v_var:.4f})", flush=True)

    wall = time.perf_counter() - t_start
    steps = max_epochs * exp.n_batches_train
    summary = {"max_epochs": max_epochs, "steps": steps, "wall_s": round(wall, 1), "curve": curve}
    with open(os.path.join(out_dir, "curve.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"[rehearsal] {steps} steps / {max_epochs} epochs in {wall:.0f}s; denoise_mse "
          f"{curve[0]['denoise_mse_mean']:.5f} -> {curve[-1]['denoise_mse_mean']:.5f}; artifacts in {out_dir}",
          flush=True)
    return summary, epochs


def main(argv: Optional[List[str]] = None):
    """The command line: `[max_epochs]` (10 with the probes, 3 without),
    `--no-probes`, `--out DIR`, `--exp-dir DIR`, `--device DEV`."""
    parser = argparse.ArgumentParser(description="Release-scale training rehearsal of the hydrant recipe.")
    parser.add_argument("max_epochs", type=int, nargs="?", default=None)
    parser.add_argument("--no-probes", action="store_true",
                        help="train the epochs in one call, without the per-epoch probes and samples")
    parser.add_argument("--out", default=str(OUT_ROOT / "artifacts"), help="curve.json and the sample PNGs")
    parser.add_argument("--exp-dir", default=str(OUT_ROOT / "exp"), help="the experiment (emptied first)")
    parser.add_argument("--device", default=None, help="torch device (default: CUDA)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    set_full_precision()
    max_epochs = args.max_epochs or (3 if args.no_probes else 10)
    return run_rehearsal(max_epochs, args.out, args.exp_dir, probes=not args.no_probes, device=device)


if __name__ == "__main__":
    main()
