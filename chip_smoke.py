#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`holo_diffusion_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  build    compile the CUDA kernels with nvcc (build/holo_diffusion_torch/)
  kernels  each kernel against its plain PyTorch version at hydrant shapes:
           the decode forward (K1, K3) at a fine-pass render chunk, its
           backward (K2) at a training step's fine pass; each kernel's
           device time per launch (torch.profiler) beside the time of a
           wrapper call (CUDA events)
  sample   hydrant model (seeded random weights), 1000-step DDPM, B=1
  render   fly-around at 512^2 through the chunked renderer: 2 poses with
           normals (K3), 1 pose of the same model with normals off (K1)
  check    outputs finite and in range; a small render and two DDPM steps
           on the card against the same model on the CPU
  train    hydrant training at full width on a synthetic batch of 33
           frames at 800^2: one warm-up step, then 5 timed steps of
           `make_train_step` (pool, two-pass denoise, render, loss, Adam)
  check    one training step of a narrow model on the card and on the CPU
           with the same injected draws: objective and gradients
  profile  device time by kernel and the device's idle share over one
           512^2 frame, over 10 DDPM steps and over one training step
  kernels summary, the card's name and power limit, and the result line.
Two main paths, each with the launch counters zeroed right before it and
read right after it: serving (`sample` + `render`, which must launch K1 and
K3) and training (the 5 timed steps, which must launch K3 and K2).
Float32 stays full float32 (TF32 off for cuDNN and cuBLAS).
"""
import copy
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 CUDA-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# kernel vs plain version: float32 with another summation order over dot
# products of <= 283 terms of O(1) values
KERNEL_TOL = 1e-4
# backward kernel vs plain backward, relative to each cotangent's largest
# magnitude. Both sum float32 over all 393,216 points in different orders
# (atomics against cuBLAS), and both compute each point's 257
# pre-activations in their own order: one that lies within rounding of 0
# takes the leaky-ReLU slope 1 on one side and 0.2 on the other, which
# moves that point's contribution to d_grid by up to ~1e-3 of d_grid's
# scale (the phase counts such pre-activations). Under the 2e-3 the JAX
# package holds its training gradients to.
KERNEL_BWD_TOL = 1e-3
# training step, card vs CPU at a narrow width: objective (absolute) and
# gradients relative to each leaf's largest magnitude; float32 through two
# UNet passes, two render passes and an importance resampling
TRAIN_OBJ_TOL = 1e-4
TRAIN_GRAD_TOL = 2e-3
# card vs CPU, end to end: cuDNN/cuBLAS and CPU kernels sum in other orders;
# a 2-pass render compounds it through the importance resampling
RENDER_TOL = 2e-3
SAMPLE_TOL = 1e-3

HYDRANT_MODEL = "model_factory_ImplicitronModelFactory_args.model_HoloDiffusionModel_args"


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, iters=20):
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def decode_cost(n_points, n_rays, grid_shape, hidden, pe_dim, normals):
    """(bytes, flops) the fused decode must move and do: each input read
    once, each output written once; per point the trilinear sample, the
    collapsed density affine and the radiance layer."""
    D, H, W, C = grid_shape
    j = hidden + 1
    lanes = 7 if normals else 4
    n_bytes = 4 * (
        n_points * 3 + n_rays * pe_dim + D * H * W * C + C * j + j
        + (hidden + pe_dim) * 3 + 3 + (D * H * W if normals else 0)
        + n_points * lanes
    )
    per_point = 2 * 8 * C + 2 * C * j + 2 * (hidden + pe_dim) * 3 + (2 * 8 * 3 if normals else 0)
    return n_bytes, n_points * per_point


def decode_bwd_cost(n_points, n_rays, grid_shape, hidden, pe_dim):
    """(bytes, flops, bytes with the grid scatter's read-modify-writes) of
    the decode backward. Bytes: each input read once (points, per-ray
    directions, the (n, 4) cotangent, grid and weights), each cotangent
    written once. FLOPs per point: the recomputed forward (sample, affine,
    radiance layer), then dWr, d_rin, dA, d_s and the 8-corner scatter.
    The third figure adds 8 corners x C read-modify-writes of d_grid per
    point, which the scatter makes (in L2 on the H100)."""
    D, H, W, C = grid_shape
    j = hidden + 1
    n_in = n_points * (3 + 4) + n_rays * pe_dim + D * H * W * C + C * j + j + (hidden + pe_dim) * 3 + 3
    n_out = D * H * W * C + C * j + j + (hidden + pe_dim) * 3 + 3
    fwd = 2 * 8 * C + 2 * C * j + 2 * (hidden + pe_dim) * 3
    bwd = 2 * (hidden + pe_dim) * 3 + 2 * 3 * hidden + 2 * C * j + 2 * C * j + 2 * 8 * C
    n_bytes = 4 * (n_in + n_out)
    return n_bytes, n_points * (fwd + bwd), n_bytes + 4 * 2 * 8 * C * n_points


def device_ms_per_launch(fn, name_part, iters=20):
    """Device time per launch of the kernel whose name contains `name_part`,
    from torch.profiler over `iters` calls of `fn` (after one warm-up)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name_part in e.key and e.self_device_time_total > 0]
    count = sum(e.count for e in rows)
    if count != iters:
        raise AssertionError(f"profiled {count} launches of {name_part!r}, expected {iters}")
    return sum(e.self_device_time_total for e in rows) / 1e3 / count


def unet_conv_flops(model, dev):
    """2 x multiply-adds of the UNet's 3D convolutions in one evaluation at
    B=1, counted from the shapes they see (forward hooks); the convolutions
    are nearly all of the UNet's arithmetic."""
    import torch

    flops = []

    def hook(mod, inputs, out):
        o, i, kd, kh, kw = mod.weight.shape
        flops.append(2 * out.numel() * i * kd * kh * kw)

    convs = [m for m in model.net_3d.modules() if isinstance(m, torch.nn.Conv3d)]
    handles = [m.register_forward_hook(hook) for m in convs]
    r, C = model.resol, model.feature_size
    with torch.no_grad():
        model.apply_net_3d(torch.zeros((1, r, r, r, C), device=dev),
                           torch.zeros((1,), dtype=torch.long, device=dev))
    for h in handles:
        h.remove()
    return sum(flops), len(convs)


def kernel_phase(model, results):
    """K1 and K3 at a fine-pass chunk of the hydrant render (640 rays x 128
    points) against the plain version on the same card."""
    import torch

    from holo_diffusion_torch.ops import fused_decode as fd

    fn = model.implicit_function
    mlp = fn.render_mlp
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    R, P = 640, 128
    D, C = model.resol, model.feature_size
    grid = torch.tanh(torch.randn((D, D, D, C), generator=gen, device=dev))
    extent = model.volume_extent
    half = 0.6 * extent  # points inside and outside the grid
    points = (torch.rand((R, P, 3), generator=gen, device=dev) * 2 - 1) * half
    dirs = torch.randn((R, 3), generator=gen, device=dev)
    with torch.no_grad():
        A, c = mlp.density_affine()
        Wr, br = (t.detach() for t in mlp.radiance_linear())
        pe = mlp.encode_dirs(dirs / dirs.norm(dim=-1, keepdim=True))
        g1 = torch.einsum("dhwc,c->dhw", grid, A[:, -1])
    hidden = mlp.dnet_hidden_dim
    for name, normals, replaces in (
        ("fused_decode_fwd", False, "holo_diffusion_tpu/ops/pallas/fused_decode.py:122"),
        ("fused_decode_fwd_normals", True, "holo_diffusion_tpu/ops/pallas/fused_decode.py:144"),
    ):
        args = (grid, A, c, Wr, br, points, pe, extent, hidden)
        kw = {"g1": g1} if normals else {}
        with torch.no_grad():
            out = fd.fused_sample_decode(*args, **kw)
            ref = fd.fused_sample_decode_reference(*args, **kw)
            torch.cuda.synchronize()
            errs = [float((a - b).abs().max()) for a, b in zip(out, ref)]
            wrapper_ms = cuda_time_ms(lambda: fd.fused_sample_decode(*args, **kw))
            ms = device_ms_per_launch(lambda: fd.fused_sample_decode(*args, **kw), "fused_decode_kernel")
            plain_ms = cuda_time_ms(lambda: fd.fused_sample_decode_reference(*args, **kw))
        n_bytes, flops = decode_cost(R * P, R, grid.shape, hidden, pe.shape[-1], normals)
        bytes_ms, flops_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_F32_FLOPS
        rec = {
            "name": name,
            "route": "cuda",
            "source": "holo_diffusion_torch/csrc/fused_decode.cu",
            "replaces": replaces,
            "max_abs_err": max(errs),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms > flops_ms else "operations",
            "library_ms": None,  # no single PyTorch call computes this function
        }
        emit({"phase": "kernels", **rec, "wrapper_ms": wrapper_ms, "points": R * P,
              "lane_errs": dict(zip(("density", "rgb", "normals"), errs)), "tol": KERNEL_TOL})
        if not max(errs) <= KERNEL_TOL:
            raise AssertionError(f"{name}: max_abs_err {max(errs)} > {KERNEL_TOL}")
        results[name] = rec
    kernel_bwd_phase(model, grid, A, c, Wr, br, results)


def kernel_bwd_phase(model, grid, A, c, Wr, br, results):
    """K2 at a hydrant training step's fine pass (3 x 1024 rays x 128
    points) against the plain backward on the same card, with a random
    cotangent of the (density, rgb) outputs."""
    import torch

    from holo_diffusion_torch.ops import fused_decode as fd
    from holo_diffusion_torch.ops.voxel import sample_voxel_grid_world

    dev = grid.device
    gen = torch.Generator(device=dev).manual_seed(3)
    R = 3 * model.n_rays_per_image
    P = model.n_pts_per_ray_training + model.n_pts_per_ray_fine_training
    half = 0.6 * model.volume_extent
    points = (torch.rand((R, P, 3), generator=gen, device=dev) * 2 - 1) * half
    dirs = torch.randn((R, 3), generator=gen, device=dev)
    g = torch.randn((R, P, 4), generator=gen, device=dev)
    mlp = model.implicit_function.render_mlp
    with torch.no_grad():
        pe = mlp.encode_dirs(dirs / dirs.norm(dim=-1, keepdim=True))
        # pre-activations close enough to 0 for the two summation orders to
        # disagree on their sign (exact zeros, as outside the grid, agree)
        pre = sample_voxel_grid_world(grid, points, model.volume_extent) @ A + c
        near_zero = int(((pre != 0) & (pre.abs() < 1e-6)).sum())
        del pre
    hidden = mlp.dnet_hidden_dim
    args = (grid, A, c, Wr, br, points, pe, model.volume_extent, hidden, g)
    got = fd._fused_sample_decode_bwd_cuda(*args)
    want = fd.fused_sample_decode_bwd_reference(*args)
    torch.cuda.synchronize()
    names = ("d_grid", "dA", "dc", "dWr", "dbr")
    abs_errs = {n: float((a - b).abs().max()) for n, a, b in zip(names, got, want)}
    rel_errs = {n: abs_errs[n] / max(float(b.abs().max()), 1e-30) for n, b in zip(names, want)}
    del got, want
    wrapper_ms = cuda_time_ms(lambda: fd._fused_sample_decode_bwd_cuda(*args))
    ms = device_ms_per_launch(lambda: fd._fused_sample_decode_bwd_cuda(*args), "fused_decode_bwd_kernel")
    plain_ms = cuda_time_ms(lambda: fd.fused_sample_decode_bwd_reference(*args), iters=5)
    n_bytes, flops, rmw_bytes = decode_bwd_cost(R * P, R, grid.shape, hidden, pe.shape[-1])
    bytes_ms, flops_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_F32_FLOPS
    rec = {
        "name": "fused_decode_bwd",
        "route": "cuda",
        "source": "holo_diffusion_torch/csrc/fused_decode_bwd.cu",
        "replaces": "holo_diffusion_tpu/ops/pallas/fused_decode.py:173",
        "max_abs_err": max(abs_errs.values()),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms > flops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes this function
    }
    emit({"phase": "kernels", **rec, "wrapper_ms": wrapper_ms, "points": R * P, "gflop": flops / 1e9,
          "bytes": n_bytes, "bytes_with_scatter_rmw": rmw_bytes, "abs_errs": abs_errs,
          "rel_errs": rel_errs, "rel_tol": KERNEL_BWD_TOL, "nonzero_pre_activations_below_1e-6": near_zero})
    if not max(rel_errs.values()) <= KERNEL_BWD_TOL:
        raise AssertionError(f"fused_decode_bwd: relative error {rel_errs} > {KERNEL_BWD_TOL}")
    results["fused_decode_bwd"] = rec


def profile_phase(model, v, dev, train_step_fn):
    """Where the time goes: device time by kernel, and the device's idle
    share (1 - device busy / host wall time of an unprofiled run of the same
    work), over one 512^2 fly-around frame, over 10 DDPM steps and over one
    hydrant training step (`train_step_fn`), with the decode kernels' share
    of the busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from holo_diffusion_torch.render_eval import render_image_chunked
    from holo_diffusion_torch.sampling import sample_random_voxel_features
    from holo_diffusion_torch.utils.flyaround import simple_360_cameras

    cam = simple_360_cameras(1)
    windows = {
        "render_frame": lambda: render_image_chunked(model, cam, v[0], device=dev),
        "ddpm_10_steps": lambda: sample_random_voxel_features(
            model, torch.Generator(device=dev).manual_seed(2), max_iter=10, device=dev),
        "train_step": train_step_fn,
    }
    for label, fn in windows.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = sorted(
            ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
            key=lambda r: -r[1],
        )
        busy_ms = sum(r[1] for r in rows)
        decode = {}
        for part in ("fused_decode_kernel", "fused_decode_bwd_kernel"):
            ms = sum(r[1] for r in rows if part in r[0])
            if ms > 0:
                decode[part] = {"ms": ms, "count": sum(r[2] for r in rows if part in r[0]),
                                "share_of_busy": ms / busy_ms}
        emit({"phase": "profile", "window": label, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
              "idle_share": 1.0 - busy_ms / wall_ms, "device_launches": sum(r[2] for r in rows),
              "decode_kernels": decode,
              "top": [{"kernel": k[:90], "ms": ms, "count": n} for k, ms, n in rows[:10]]})


def train_phase(model, cfg, dev, results, steps=5):
    """Hydrant training at full width: the config's optimizer, a synthetic
    batch of the config's size (33 frames at 800^2), one warm-up step, then
    `steps` timed steps of `make_train_step`: the training main path, with
    the launch counters zeroed right before it and read right after.
    Returns a function that runs one more step (for the profile)."""
    import torch

    from holo_diffusion_torch.config import optimizer_args_from_config
    from holo_diffusion_torch.data.synthetic import make_synthetic_scene
    from holo_diffusion_torch.ops import fused_decode as fd
    from holo_diffusion_torch.parallel.train_step import TrainState, make_train_step
    from holo_diffusion_torch.train.optimizer import make_lr_schedule, make_optimizer

    data = cfg["data_source_ImplicitronDataSource_args"]
    n_frames = data["data_loader_map_provider_SequenceDataLoaderMapProvider_args"]["batch_size"]
    size = data["dataset_map_provider_JsonIndexDatasetMapProviderV2_args"]["dataset_JsonIndexDataset_args"]["image_height"]
    batch = make_synthetic_scene(n_views=n_frames, image_size=size, radius=2.0, dist=8.0, seed=0, device=dev)
    oa = optimizer_args_from_config(cfg)
    opt = make_optimizer(model.named_parameters(), **oa["optimizer"],
                         schedule=make_lr_schedule(oa["optimizer"]["lr"], **oa["schedule"]))
    model.train()
    state = TrainState(model, opt)
    step = make_train_step(model, opt)
    gen = torch.Generator(device=dev).manual_seed(7)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step(state, batch, gen)
    warm_obj = metrics["objective"].item()
    warm_s = time.perf_counter() - t0
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    fd.reset_launch_counts()
    secs, objectives = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        objectives.append(metrics["objective"].item())
        secs.append(time.perf_counter() - t0)
    counts = fd.launch_counts()
    changed = {n for n, p in model.named_parameters() if not torch.equal(p.detach(), before[n])}
    modules = {n.split(".")[0] for n, _ in model.named_parameters()}
    emit({"phase": "train", "frames": n_frames, "image_size": size, "rays": 3 * model.n_rays_per_image,
          "params": sum(p.numel() for p in model.parameters()), "warmup_s": warm_s,
          "warmup_objective": warm_obj, "s_per_step": secs, "median_s_per_step": sorted(secs)[len(secs) // 2],
          "objectives": objectives, "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "params_changed": len(changed), "params_total": len(before), "lr": opt.optimizer.param_groups[0]["lr"],
          "launches": counts})
    emit({"phase": "main_path", "path": "train", "launches": counts})
    if not all(math.isfinite(o) for o in objectives + [warm_obj]):
        raise AssertionError(f"non-finite training objective: {objectives}")
    if {n.split(".")[0] for n in changed} != modules:
        raise AssertionError(f"parameters of {sorted(modules - {n.split('.')[0] for n in changed})} did not change")
    for name in ("fused_decode_fwd_normals", "fused_decode_bwd"):
        if counts[name] != 2 * steps:
            raise AssertionError(f"kernel {name}: {counts[name]} launches on the training path, expected {2 * steps}")
    results["fused_decode_bwd"]["launches"] = counts["fused_decode_bwd"]
    results["fused_decode_fwd_normals"]["train_launches"] = counts["fused_decode_fwd_normals"]
    return lambda: step(state, batch, gen)


def train_check_phase(dev):
    """One training step of a narrow model (C 32, UNet 32 channels, resnet18
    stages 1-2, 2 x 128 rays) on the card and on the CPU with the same
    weights and the same injected draws: the objective and the gradients
    of the UNet's last conv, the pooled-feature mapper, the density net's
    first layer and the extractor's stem (each relative to its largest
    magnitude)."""
    import numpy as np
    import torch

    from holo_diffusion_torch.data.synthetic import make_synthetic_scene
    from holo_diffusion_torch.models.holo_model import HoloDiffusionModel
    from holo_diffusion_torch.weights import init_weights

    toy = dict(
        resol=8, volume_extent=4.0, feature_size=32, n_train_target_views=2, n_rays_per_image=128,
        n_pts_per_ray_training=16, n_pts_per_ray_fine_training=16, scene_extent=2.0, render_normals=True,
        net_3d_args=dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=(2,)),
        image_feature_extractor_args=dict(name_arch="resnet18", stages=(1, 2), proj_dim=8, image_rescale=0.5),
        view_pooler_args=dict(aggregator_class_type="MLPMeanFeatureAggregator",
                              aggregator_args=dict(n_hidden=32, dim_out=32)),
        render_mlp_args=dict(dnet_hidden_dim=64, rnet_hidden_dim=16),
    )
    cpu_model = init_weights(HoloDiffusionModel(**toy), seed=1)
    card_model = copy.deepcopy(cpu_model).to(dev)
    scene = make_synthetic_scene(n_views=6, image_size=48, seed=2)
    rs = np.random.RandomState(3)
    B, N, P, F = 2, 128, 16, 16
    draws = {
        "timesteps": np.array([400, 90]), "take_boot": True,
        "noise": rs.randn(1, 8, 8, 8, 32), "noise2": rs.randn(1, 8, 8, 8, 32),
        "ray_pixel_u": rs.rand(B, N), "ray_length_u": rs.rand(B, N, P), "density_noise_0": rs.randn(B, N, P),
        "refine_u_1": rs.rand(B, N, F), "density_noise_1": rs.randn(B, N, P + F),
    }
    objs = {}
    for label, m, b in (("card", card_model, scene.to(dev)), ("cpu", cpu_model, scene)):
        preds = m(camera=b.camera, image_rgb=b.image_rgb, fg_probability=b.fg_probability,
                  mask_crop=b.mask_crop, depth_map=b.depth_map, training=True, draws=draws)
        preds["objective"].backward()
        objs[label] = preds["objective"].item()
    gated = ("net_3d.out.2.weight", "pooled_feature_mapper.weight",
             "implicit_function.render_mlp._density_net.mlp.0.0.weight", "image_feature_extractor.net.conv1.weight")
    cpu_grads = dict(cpu_model.named_parameters())
    rel, scale = {}, {}
    for n, p in card_model.named_parameters():
        want = cpu_grads[n].grad
        scale[n] = float(want.abs().max())
        rel[n] = float((p.grad.cpu() - want).abs().max()) / max(scale[n], 1e-30)
    # leaves whose gradient vanishes up to rounding (a conv bias right before
    # a GroupNorm of one channel per group) have no meaningful relative error
    largest = max(scale.values())
    worst = max((n for n in rel if scale[n] > 1e-6 * largest), key=rel.get)
    obj_err = abs(objs["card"] - objs["cpu"])
    emit({"phase": "check", "variant": "train_card_vs_cpu", "objective": objs, "objective_abs_err": obj_err,
          "grad_rel_errs": {n: rel[n] for n in gated}, "worst_leaf_above_1e-6_of_largest_grad": [worst, rel[worst]],
          "tol": {"objective": TRAIN_OBJ_TOL, "grad_rel": TRAIN_GRAD_TOL}})
    if obj_err > TRAIN_OBJ_TOL or max(rel[n] for n in gated) > TRAIN_GRAD_TOL:
        raise AssertionError("training step: card and CPU disagree beyond tolerance")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "holo_diffusion_torch")):
        print("chip_smoke.py: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    import numpy as np

    from holo_diffusion_torch.cli import build_model
    from holo_diffusion_torch.config import load_config
    from holo_diffusion_torch.device import set_full_precision
    from holo_diffusion_torch.ops import _build
    from holo_diffusion_torch.ops import fused_decode as fd
    from holo_diffusion_torch.render_eval import render_image_chunked
    from holo_diffusion_torch.sampling import sample_random_voxel_features
    from holo_diffusion_torch.utils.flyaround import (
        CANONICAL_CO3D_UP_AXIS, render_flyaround, simple_360_cameras)
    from holo_diffusion_torch.weights import init_weights

    set_full_precision()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "gpu": smi})

    # ---- build
    t0 = time.perf_counter()
    compiled = _build.build()
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in _build.SOURCES}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "compiled": compiled,
          "ptxas": ptxas})

    # ---- the hydrant model, seeded random weights
    model = build_model("hydrant")
    init_weights(model, seed=0)
    model.to(dev).eval()
    model_k1 = build_model("hydrant", [f"{HYDRANT_MODEL}.implicit_function_HoloVoxelGridImplicitFunction_args.render_normals=false"])
    model_k1.load_state_dict(model.state_dict())
    model_k1.to(dev).eval()

    results = {}
    kernel_phase(model, results)

    conv_flops, n_convs = unet_conv_flops(model, dev)

    # ---- main path: sample, then render (launch counts read after)
    fd.reset_launch_counts()
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v = sample_random_voxel_features(model, gen)
    torch.cuda.synchronize()
    t_sample = time.perf_counter() - t0
    steps = model.schedule.num_timesteps
    emit({"phase": "sample", "steps": steps, "seconds": t_sample,
          "unet_evals_per_s": steps / t_sample, "shape": list(v.shape),
          "unet_convs": n_convs, "conv_gflop_per_eval": conv_flops / 1e9,
          "conv_f32_bound_ms_per_eval": 1e3 * conv_flops / PEAK_F32_FLOPS})

    out_dir = os.path.join(here, "build", "chip_smoke")
    frames = {}
    for label, m, poses in (("normals", model, 2), ("no_normals", model_k1, 1)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths = render_flyaround(m, os.path.join(out_dir, label), n_flyaround_poses=poses,
                                 voxel_features=v, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        frames[label] = dt / poses
        emit({"phase": "render", "variant": label, "poses": poses,
              "size": [m.render_image_height, m.render_image_width],
              "s_per_frame": dt / poses, "streams": sorted(paths)})
    counts = fd.launch_counts()
    emit({"phase": "main_path", "path": "serve", "launches": counts})
    for name in ("fused_decode_fwd", "fused_decode_fwd_normals"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the serving path")
        results[name]["launches"] = counts[name]

    # ---- check: outputs in range, card against the CPU on a small input
    with torch.no_grad():
        cams = simple_360_cameras(2, up=CANONICAL_CO3D_UP_AXIS)
        for label, m in (("normals", model), ("no_normals", model_k1)):
            out = render_image_chunked(m, cams[0], v[0], device=dev)
            H, W = m.render_image_height, m.render_image_width
            for k, x in out.items():
                if not bool(torch.isfinite(x).all()):
                    raise AssertionError(f"{label} {k}: non-finite values")
                if x.shape[:2] != (H, W):
                    raise AssertionError(f"{label} {k}: shape {tuple(x.shape)}")
            for k in ("masks_render", "images_render"):
                if float(out[k].min()) < 0.0 or float(out[k].max()) > 1.0:
                    raise AssertionError(f"{label} {k} outside [0, 1]")
            if ("normals_render" in out) != (label == "normals"):
                raise AssertionError(f"{label}: normals stream presence")
            emit({"phase": "check", "variant": label, "mask_mean": float(out["masks_render"].mean()),
                  "finite": True})

        cpu_model = copy.deepcopy(model).cpu()
        small = dict(image_height=48, image_width=48)
        grid_cpu = v[0].cpu()
        a = render_image_chunked(model, cams[1], v[0], device=dev, **small)
        b = render_image_chunked(cpu_model, cams[1], grid_cpu, device="cpu", **small)
        render_err = {k: float((a[k].cpu() - b[k]).abs().max()) for k in b}
        shape = (1, model.resol, model.resol, model.resol, model.feature_size)
        rs = np.random.RandomState(0)
        x_T = torch.from_numpy(rs.randn(*shape).astype(np.float32))
        steps_noise = [torch.from_numpy(rs.randn(*shape).astype(np.float32)) for _ in range(2)]
        s_gpu = sample_random_voxel_features(model, max_iter=2, noise=x_T, step_noise=steps_noise, device=dev)
        s_cpu = sample_random_voxel_features(cpu_model, max_iter=2, noise=x_T, step_noise=steps_noise, device="cpu")
        sample_err = float((s_gpu.cpu() - s_cpu).abs().max())
    emit({"phase": "check", "card_vs_cpu": {"render_48px": render_err, "ddpm_2_steps": sample_err},
          "tol": {"render": RENDER_TOL, "sample": SAMPLE_TOL}})
    if max(render_err.values()) > RENDER_TOL or sample_err > SAMPLE_TOL:
        raise AssertionError("card and CPU disagree beyond tolerance")

    # ---- training main path, then the card against the CPU
    train_step_fn = train_phase(model, load_config("hydrant"), dev, results)
    train_check_phase(dev)

    model.eval()
    profile_phase(model, v, dev, train_step_fn)

    emit({"kernels": [results[n] for n in fd.ENTRY_POINTS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
