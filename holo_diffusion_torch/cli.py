"""Train and sample CLIs of the port (counterparts of
holo_diffusion_tpu/cli.py `train_main` and `generate_samples_main`).

Train (resumes from the last checkpoint in exp_dir when run again):

    python -m holo_diffusion_torch.cli train --config-name synthetic_debug.yaml \\
        --max-epochs 3 exp_dir=./out seed=7 [--device cpu]

Evaluate a trained exp_dir's checkpoint instead of training (novel-view
metrics dumped to exp_dir/eval_results_epoch_*.json; `eval_use_ema=true`
evaluates through the EMA of the parameters):

    python -m holo_diffusion_torch.cli train --config-name hydrant exp_dir=./out \
        training_loop_ImplicitronTrainingLoop_args.eval_only=true

Sample grids and render fly-around videos, from a trained exp_dir (through
the EMA of its parameters with `use_ema=true`) or from a config with `.npz`
weights (a seeded random init without `weights=`):

    python -m holo_diffusion_torch.cli exp_dir=./out num_samples=2 use_ddim=true max_iter=50 [use_ema=true]
    python -m holo_diffusion_torch.cli config=hydrant weights=model.npz \\
        num_samples=2 render_size=[512,512] n_flyaround_poses=40 seed=0

Sample arguments are key=value (values parse as YAML); keys with a dot are
dotted config overrides. Both run on CUDA unless given the CPU
(`--device cpu`, `device=cpu`); float32 stays full float32 (TF32 off).
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Dict, List, Optional

import torch
import yaml

from .config import load_config, model_args_from_config
from .device import resolve_device, set_full_precision
from .experiment import Experiment
from .models.holo_model import HoloDiffusionModel
from .utils.checkpoint_utils import load_experiment
from .utils.flyaround import render_flyaround
from .weights import init_weights, load_weights


def train_main(argv: Optional[List[str]] = None):
    """Train (or resume) the experiment a config describes; returns
    (state, stats), or the evaluation's results when the config sets
    `training_loop_ImplicitronTrainingLoop_args.eval_only`."""
    parser = argparse.ArgumentParser(description="Train the port's HoloDiffusion model.")
    parser.add_argument("--config-name", default="base.yaml")
    parser.add_argument("--config-dir", default=None)
    parser.add_argument("--max-epochs", type=int, default=None)
    parser.add_argument("--no-mesh", action="store_true",
                        help="accepted for the JAX CLI's sake; training here is single-device")
    parser.add_argument("--device", default=None, help="torch device (default: CUDA)")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    set_full_precision()
    cfg = load_config(args.config_name, args.overrides, args.config_dir)
    return Experiment(cfg, device=args.device).run(max_epochs=args.max_epochs)


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

    exp_dir = opts.pop("exp_dir", None)
    config = opts.pop("config", None)
    weights = opts.pop("weights", None)
    if exp_dir is not None and (config is not None or weights is not None):
        raise ValueError("give exp_dir= or config=/weights=, not both")
    num_samples = int(opts.pop("num_samples", 1))
    output_directory = opts.pop("output_directory",
                                "samples" if exp_dir is None else os.path.join(exp_dir, "samples"))
    render_size = opts.pop("render_size", None)
    n_flyaround_poses = int(opts.pop("n_flyaround_poses", 40))
    trajectory_distance = float(opts.pop("trajectory_distance", 15.0))
    seed = int(opts.pop("seed", 0))
    use_ddim = bool(opts.pop("use_ddim", False))
    max_iter = opts.pop("max_iter", None)
    video_fps = int(opts.pop("video_fps", 20))
    save_voxel_features = bool(opts.pop("save_voxel_features", False))
    # sample through the EMA of the parameters (a run trained with ema_rate > 0)
    use_ema = bool(opts.pop("use_ema", False))
    device = resolve_device(opts.pop("device", None))
    if opts:
        raise ValueError(f"unknown args: {list(opts)}")
    if use_ema and exp_dir is None:
        raise ValueError("use_ema needs exp_dir= (the EMA lives in a training checkpoint)")

    set_full_precision()
    if exp_dir is not None:
        model = load_experiment(exp_dir, overrides, render_size, use_ema=use_ema, device=device)[1].model
    else:
        model = build_model(config or "hydrant", overrides, render_size)
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
    if sys.argv[1:2] == ["train"]:
        train_main(sys.argv[2:])
    else:
        generate_samples_main()
