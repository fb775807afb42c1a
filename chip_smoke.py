#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`holo_diffusion_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  build    compile the CUDA kernels with nvcc (build/holo_diffusion_torch/)
  kernels  each kernel against its plain PyTorch version at hydrant shapes
  sample   hydrant model (seeded random weights), 1000-step DDPM, B=1
  render   fly-around at 512^2 through the chunked renderer: 2 poses with
           normals (K3), 1 pose of the same model with normals off (K1)
  check    outputs finite and in range; a small render and two DDPM steps
           on the card against the same model on the CPU
  profile  device time by kernel and the device's idle share over one
           512^2 frame and over 10 DDPM steps (torch.profiler)
  kernels summary, the card's name and power limit, and the result line.
The launch counters are zeroed right before `sample` and read right after
`render`: that is the main path, and every kernel must have run in it.
Float32 stays full float32 (TF32 off for cuDNN and cuBLAS).
"""
import copy
import json
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
        Wr, br = mlp.radiance_linear()
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
            ms = cuda_time_ms(lambda: fd.fused_sample_decode(*args, **kw))
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
        emit({"phase": "kernels", **rec, "points": R * P,
              "lane_errs": dict(zip(("density", "rgb", "normals"), errs)), "tol": KERNEL_TOL})
        if not max(errs) <= KERNEL_TOL:
            raise AssertionError(f"{name}: max_abs_err {max(errs)} > {KERNEL_TOL}")
        results[name] = rec


def profile_phase(model, v, dev):
    """Where the time goes: device time by kernel, and the device's idle
    share (1 - device busy / host wall time of an unprofiled run of the same
    work), over one 512^2 fly-around frame and over 10 DDPM steps."""
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
        emit({"phase": "profile", "window": label, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
              "idle_share": 1.0 - busy_ms / wall_ms, "device_launches": sum(r[2] for r in rows),
              "top": [{"kernel": k[:90], "ms": ms, "count": n} for k, ms, n in rows[:8]]})


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
    ptxas = [ln.strip() for ln in _build.build_log("fused_decode").splitlines() if "registers" in ln]
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
    emit({"phase": "main_path", "launches": counts})
    for name in fd.ENTRY_POINTS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
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

    profile_phase(model, v, dev)

    emit({"kernels": [results[n] for n in fd.ENTRY_POINTS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
