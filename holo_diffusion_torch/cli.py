"""Sample CLI of the port (counterpart of holo_diffusion_tpu/cli.py
`generate_samples_main`): sample voxel grids and render fly-around videos.

    python -m holo_diffusion_torch.cli config=hydrant weights=model.npz \\
        num_samples=2 render_size=[512,512] n_flyaround_poses=40 seed=0

Arguments are key=value (values parse as YAML). Keys with a dot are dotted
config overrides. Without `weights=` the model gets a seeded random init.
Runs on CUDA unless `device=cpu`; float32 stays full float32 (TF32 off).
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Dict, List, Optional

import torch
import yaml

from .config import load_config, model_args_from_config
from .device import resolve_device, set_full_precision
from .models.holo_model import HoloDiffusionModel
from .utils.flyaround import render_flyaround
from .weights import init_weights, load_weights


def build_model(
    config: str, overrides: Optional[List[str]] = None, render_size=None, **model_args
) -> HoloDiffusionModel:
    """The config's model; `model_args` (such as `fuse_decode`, which no
    config key sets) override its arguments."""
    cfg = load_config(config, overrides)
    args = {**model_args_from_config(cfg), **model_args}
    if render_size is not None:
        args["render_image_height"], args["render_image_width"] = (int(v) for v in render_size)
    return HoloDiffusionModel(**args)


def generate_samples_main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, str]]:
    logging.basicConfig(level=logging.INFO)
    opts, overrides = {}, []
    for kv in sys.argv[1:] if argv is None else argv:
        k, sep, v = kv.partition("=")
        if not sep:
            raise ValueError(f"expected key=value, got {kv!r}")
        if "." in k:
            overrides.append(kv)
        else:
            opts[k] = yaml.safe_load(v)

    config = opts.pop("config", "hydrant")
    weights = opts.pop("weights", None)
    num_samples = int(opts.pop("num_samples", 1))
    output_directory = opts.pop("output_directory", "samples")
    render_size = opts.pop("render_size", None)
    n_flyaround_poses = int(opts.pop("n_flyaround_poses", 40))
    trajectory_distance = float(opts.pop("trajectory_distance", 15.0))
    seed = int(opts.pop("seed", 0))
    use_ddim = bool(opts.pop("use_ddim", False))
    max_iter = opts.pop("max_iter", None)
    video_fps = int(opts.pop("video_fps", 20))
    save_voxel_features = bool(opts.pop("save_voxel_features", False))
    device = resolve_device(opts.pop("device", None))
    if opts:
        raise ValueError(f"unknown args: {list(opts)}")

    set_full_precision()
    model = build_model(config, overrides, render_size)
    if weights:
        load_weights(model, weights)
    else:
        init_weights(model, seed)
    model.to(device).eval()

    results = {}
    for i in range(num_samples):
        name = f"sample_{i:05d}"
        gen = torch.Generator(device=device).manual_seed(seed + i)
        results[name] = render_flyaround(
            model,
            os.path.join(output_directory, name),
            n_flyaround_poses=n_flyaround_poses,
            trajectory_distance=trajectory_distance,
            generator=gen,
            video_fps=video_fps,
            save_voxel_features=save_voxel_features,
            sample_use_ddim=use_ddim,
            sample_max_iter=max_iter,
            device=device,
        )
        logging.info("%s: %s", name, results[name])
    return results


if __name__ == "__main__":
    generate_samples_main()
