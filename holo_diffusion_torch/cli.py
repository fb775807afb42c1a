"""Train, sample, reconstruction and sample-evaluation CLIs of the port
(counterparts of holo_diffusion_tpu/cli.py `train_main`,
`generate_samples_main`, `visualize_reconstruction_main` and
`evaluate_samples_main`).

Train (resumes from the last checkpoint in exp_dir when run again):

    python -m holo_diffusion_torch.cli train --config-name synthetic_debug.yaml \\
        --max-epochs 3 exp_dir=./out seed=7 [--device cpu]

Train data parallel on N GPUs of one node (one process a GPU over NCCL;
`--no-mesh` trains each rank alone; with `--device cpu` the ranks use gloo):

    torchrun --nproc_per_node N -m holo_diffusion_torch.cli train --config-name hydrant exp_dir=./out

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

Render few-view reconstructions of a trained non-diffusion exp_dir (such as
`unet_with_no_diffusion.yaml` trains) along trajectories fitted to its
first validation scenes:

    python -m holo_diffusion_torch.cli visualize_reconstruction exp_dir=./recon \\
        n_eval_sequences=2 trajectory_type=circular_lsq_fit [empty_space_skip=true]

Score a trained diffusion exp_dir's samples with FID/KID against its train
frames (`extractor=inception|vgg weights_path=<state_dict>`, or the
weights-free `random_inception|random_vgg`; installed as
`holo-torch-evaluate-samples`):

    python -m holo_diffusion_torch.cli evaluate_samples exp_dir=./out num_samples=8 \\
        poses_per_sample=4 extractor=inception weights_path=pt_inception-2015-12-05.pth

Sample, reconstruction and evaluation arguments are key=value (values parse as YAML);
keys with a dot are dotted config overrides. All run on CUDA unless given the CPU
(`--device cpu`, `device=cpu`); float32 stays full float32 (TF32 off).
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
import yaml

from .config import load_config, model_args_from_config
from .device import resolve_device, set_full_precision
from .evaluate_samples import evaluate_samples
from .experiment import Experiment
from .models.holo_model import HoloDiffusionModel
from .parallel import launch
from .utils.checkpoint_utils import load_experiment
from .utils.flyaround import render_flyaround
from .sampling import sample_random_voxel_features
from .weights import init_weights, load_weights


def train_main(argv: Optional[List[str]] = None):
    """Train (or resume) the experiment a config describes; returns
    (state, stats), or the evaluation's results when the config sets
    `training_loop_ImplicitronTrainingLoop_args.eval_only`. Under torchrun
    it joins the process group first (and leaves it at the end) and trains
    data parallel over its ranks, unless `--no-mesh`."""
    parser = argparse.ArgumentParser(description="Train the port's HoloDiffusion model.")
    parser.add_argument("--config-name", default="base.yaml")
    parser.add_argument("--config-dir", default=None)
    parser.add_argument("--max-epochs", type=int, default=None)
    parser.add_argument("--no-mesh", action="store_true",
                        help="train each rank alone, without data parallelism across the launched ranks")
    parser.add_argument("--device", default=None, help="torch device (default: CUDA)")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    set_full_precision()
    cfg = load_config(args.config_name, args.overrides, args.config_dir)
    owned = not launch.is_initialized() and launch.initialize_distributed(args.device)
    try:
        return Experiment(cfg, device=args.device).run(max_epochs=args.max_epochs, use_mesh=not args.no_mesh)
    finally:
        if owned:
            dist.destroy_process_group()


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


def _key_values(argv: Optional[List[str]]):
    """key=value arguments (values parse as YAML) -> (options, the dotted
    config overrides among them)."""
    opts, overrides = {}, []
    for kv in sys.argv[1:] if argv is None else argv:
        k, sep, v = kv.partition("=")
        if not sep:
            raise ValueError(f"expected key=value, got {kv!r}")
        if "." in k:
            overrides.append(kv)
        else:
            opts[k] = yaml.safe_load(v)
    return opts, overrides


def generate_samples_main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, str]]:
    """Sample grids and render a fly-around of each; returns {sample name:
    {stream: video path}} of the samples this process rendered. With
    exp_dir= the options and defaults are the JAX CLI's (3 samples at
    256^2); config=/weights= keeps the port's own (1 sample at the config's
    render size). Under torchrun each rank samples and renders its share:
    `sample_batch_size` 0 becomes min(num_samples, ranks), rank r samples
    the grids r, r + ranks, ... of every batch, and each sample is written
    by one rank."""
    logging.basicConfig(level=logging.INFO)
    opts, overrides = _key_values(argv)
    exp_dir = opts.pop("exp_dir", None)
    config = opts.pop("config", None)
    weights = opts.pop("weights", None)
    if exp_dir is not None and (config is not None or weights is not None):
        raise ValueError("give exp_dir= or config=/weights=, not both")
    num_samples = int(opts.pop("num_samples", 1 if exp_dir is None else 3))
    output_directory = opts.pop("output_directory",
                                "samples" if exp_dir is None else os.path.join(exp_dir, "samples"))
    render_size = opts.pop("render_size", None if exp_dir is None else [256, 256])
    n_flyaround_poses = int(opts.pop("n_flyaround_poses", 40))
    trajectory_distance = float(opts.pop("trajectory_distance", 15.0))
    # > 0: render the DDPM chain while it denoises, this many steps a pose
    progressive = int(opts.pop("progressive_sampling_steps_per_render", -1))
    seed = int(opts.pop("seed", 0))
    use_ddim = bool(opts.pop("use_ddim", False))
    max_iter = opts.pop("max_iter", None)
    video_fps = int(opts.pop("video_fps", 20))
    save_voxel_features = bool(opts.pop("save_voxel_features", False))
    # sample through the EMA of the parameters (a run trained with ema_rate > 0)
    use_ema = bool(opts.pop("use_ema", False))
    # > 1: that many grids a batch, each rank sampling its share in one
    # call, then rendered one at a time (the JAX CLI's batch over a mesh)
    sample_batch_size = int(opts.pop("sample_batch_size", 0))
    # evaluation-only occupancy skip for the fly-around renders
    empty_space_skip = bool(opts.pop("empty_space_skip", False))
    device_arg = opts.pop("device", None)
    device = resolve_device(device_arg)
    if opts:
        raise ValueError(f"unknown args: {list(opts)}")
    if use_ema and exp_dir is None:
        raise ValueError("use_ema needs exp_dir= (the EMA lives in a training checkpoint)")

    set_full_precision()
    owned = not launch.is_initialized() and launch.initialize_distributed(device_arg)
    try:
        # under torchrun, the card of this rank
        device = resolve_device(device_arg)
        rank, world = launch.rank(), launch.world_size()
        if sample_batch_size == 0 and progressive <= 0 and world > 1:
            sample_batch_size = min(num_samples, world)
        if exp_dir is not None:
            model = load_experiment(exp_dir, overrides, render_size, use_ema=use_ema, device=device)[1].model
        else:
            model = build_model(config or "hydrant", overrides, render_size)
            if weights:
                load_weights(model, weights)
            else:
                init_weights(model, seed)
        if not (model.net_3d_enabled and model.diffusion_enabled):
            raise ValueError("generate_samples needs a diffusion model (generate_samples.py:90-92 in the reference)")
        model.to(device).eval()

        def generator(s):
            return torch.Generator(device=device).manual_seed(s)

        grids, mine = {}, [i for i in range(num_samples) if i % world == rank]
        if sample_batch_size > 1 and progressive <= 0:
            mine = []
            for start in range(0, num_samples, sample_batch_size):
                # this rank's share of a whole batch, even at the tail, as the
                # JAX CLI pads it; one rank alone samples the batch as it was
                share = list(range(rank, sample_batch_size, world))
                if not share:
                    continue
                batch = sample_random_voxel_features(
                    model, generator(seed + start + 10000 * rank), max_iter=max_iter, use_ddim=use_ddim,
                    n_samples=len(share), device=device)
                for row, j in enumerate(share):
                    if start + j < num_samples:
                        grids[start + j] = batch[row:row + 1]
                        mine.append(start + j)

        results = {}
        for i in mine:
            name = f"sample_{i:05d}"
            results[name] = render_flyaround(
                model,
                os.path.join(output_directory, name),
                n_flyaround_poses=n_flyaround_poses,
                trajectory_distance=trajectory_distance,
                generator=generator(seed + i),
                progressive_sampling_steps_per_render=progressive,
                video_fps=video_fps,
                save_voxel_features=save_voxel_features,
                voxel_features=grids.get(i),
                sample_use_ddim=use_ddim,
                sample_max_iter=max_iter,
                empty_space_skip=empty_space_skip,
                device=device,
            )
            logging.info("%s: %s", name, results[name])
        return results
    finally:
        if owned:
            dist.destroy_process_group()


def visualize_reconstruction_main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, str]]:
    """Render few-view reconstructions of a trained non-diffusion exp_dir,
    one for each of the first `n_eval_sequences` scenes (val, else train),
    along `trajectory_type` (fitted to the scene's cameras, or simple_360);
    returns {sequence name: {stream: video path}}. Options and defaults are
    the JAX CLI's (cli.py:173-235)."""
    logging.basicConfig(level=logging.INFO)
    opts, overrides = _key_values(argv)
    exp_dir = opts.pop("exp_dir")
    output_directory = opts.pop("output_directory", os.path.join(exp_dir, "reconstructions"))
    render_size = opts.pop("render_size", [256, 256])
    n_eval_sequences = int(opts.pop("n_eval_sequences", 2))
    n_source_views = int(opts.pop("n_source_views", 9))
    n_flyaround_poses = int(opts.pop("n_flyaround_poses", 40))
    trajectory_type = opts.pop("trajectory_type", "circular_lsq_fit")
    seed = int(opts.pop("seed", 0))
    # render through the EMA of the parameters (a run trained with ema_rate > 0)
    use_ema = bool(opts.pop("use_ema", False))
    # evaluation-only occupancy skip for the fly-around renders
    empty_space_skip = bool(opts.pop("empty_space_skip", False))
    device = resolve_device(opts.pop("device", None))
    if opts:
        raise ValueError(f"unknown args: {list(opts)}")

    set_full_precision()
    exp, state = load_experiment(exp_dir, overrides, render_size, use_ema=use_ema, device=device)
    model = state.model
    if model.diffusion_enabled:
        raise ValueError("visualize_reconstruction needs a non-diffusion model "
                         "(visualize_reconstruction.py:95-99 in the reference)")
    model.to(device).eval()

    eval_ds = exp.data.val if len(exp.data.val) else exp.data.train
    results = {}
    for si, scene in enumerate(eval_ds.first_scenes(n_eval_sequences)):
        name = f"sequence_{si:03d}"
        results[name] = render_flyaround(
            model,
            os.path.join(output_directory, name),
            scene=scene,
            sample_mode=False,
            n_source_views=n_source_views,
            n_flyaround_poses=n_flyaround_poses,
            trajectory_type=trajectory_type,
            seed=seed,
            empty_space_skip=empty_space_skip,
            device=device,
        )
        logging.info("%s: %s", name, results[name])
    return results


def evaluate_samples_main(argv: Optional[List[str]] = None, timings: Optional[Dict[str, float]] = None) -> Dict:
    """Score a trained diffusion exp_dir's samples: FID/KID of renders of
    `num_samples` sampled grids x `poses_per_sample` poses against the train
    split's frames (the JAX CLI's options and defaults, cli.py:254-316);
    returns the results, also dumped to `dump_path`. `extractor=inception`
    with a pytorch-fid pt_inception state_dict (`weights_path`) gives the
    paper's Inception-FID; `extractor=vgg` with torchvision vgg16 weights
    VGG-FID; `random_inception` and `random_vgg` need no weights (protocol
    smoke tests). `timings` receives `evaluate_samples`' seconds by phase."""
    logging.basicConfig(level=logging.INFO)
    opts, overrides = _key_values(argv)
    exp_dir = opts.pop("exp_dir")
    num_samples = int(opts.pop("num_samples", 8))
    poses_per_sample = int(opts.pop("poses_per_sample", 4))
    trajectory_distance = float(opts.pop("trajectory_distance", 15.0))
    extractor = opts.pop("extractor", "random_vgg")
    # `weights_path` names the inception or vgg state_dict; `vgg_weights_path` is its alias
    weights_path = opts.pop("weights_path", opts.pop("vgg_weights_path", None))
    n_real = opts.pop("n_real", None)
    max_iter = opts.pop("max_iter", None)
    render_size = opts.pop("render_size", None)
    use_ema = bool(opts.pop("use_ema", False))
    seed = int(opts.pop("seed", 0))
    dump_path = opts.pop("dump_path", os.path.join(exp_dir, "sample_eval_results.json"))
    device = resolve_device(opts.pop("device", None))
    if opts:
        raise ValueError(f"unknown args: {list(opts)}")

    set_full_precision()
    exp, state = load_experiment(exp_dir, overrides, tuple(render_size) if render_size else None,
                                 use_ema=use_ema, device=device)
    # scenes one at a time: the real set stops reading at n_real, and the
    # CO3D cache stays bounded
    res = evaluate_samples(
        state.model,
        exp.data.train.iter_scenes(),
        num_samples=num_samples,
        poses_per_sample=poses_per_sample,
        trajectory_distance=trajectory_distance,
        extractor=extractor,
        vgg_weights_path=weights_path,
        n_real=n_real,
        generator=torch.Generator(device=device).manual_seed(seed),
        max_iter=max_iter,
        dump_path=dump_path,
        device=device,
        timings=timings,
    )
    logging.info("sample evaluation: %s", res)
    return res


if __name__ == "__main__":
    if sys.argv[1:2] == ["train"]:
        train_main(sys.argv[2:])
    elif sys.argv[1:2] == ["visualize_reconstruction"]:
        visualize_reconstruction_main(sys.argv[2:])
    elif sys.argv[1:2] == ["evaluate_samples"]:
        evaluate_samples_main(sys.argv[2:])
    else:
        generate_samples_main()
