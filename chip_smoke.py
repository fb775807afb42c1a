#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`holo_diffusion_torch`) on one GPU.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --only c128  # build, then the c128 phase alone
    python3 chip_smoke.py --only sample  # build, K9's kernel case, then the DDPM sample alone

Phases, each printing one JSON line; any failure exits non-zero:
  build    compile the CUDA kernels with nvcc (build/holo_diffusion_torch/)
  kernels  each kernel against its plain PyTorch version at hydrant shapes:
           the decode forward (K1, K3) at both render chunks (640 rays x 128
           points after the fine pass, x 64 in the coarse pass), its
           backward (K2) at a training step's fine pass, on random points
           and on points in depth order along rays; the trilinear
           sample (K4) at a render chunk (C 64, and C 257 as the collapsed
           density samples it), its grid cotangent (K5) at a training fine
           pass, its points cotangent (K6) at C 1 with the ones cotangent
           (the normals) and at C 64, the one-hot-formulation sample (K7);
           K5 and K7 on random and on ray-ordered points;
           each kernel's device time per launch (torch.profiler) beside
           the time of a wrapper call (CUDA events), and for K4-K7 the
           time of `torch.nn.functional.grid_sample` computing the same;
           the view sampler (K8) forward and backward at the release
           pooling shapes (30 and 23 source views, the 16^3 voxel centres,
           the six extractor maps) by CUDA events, against its bound, its
           plain version and `grid_sample`; the small-volume convolution
           (K9) at the hydrant UNet's 51 routed calls (at most 64 output
           positions), each bitwise `F.conv3d` (cuDNN) and itself on a
           rerun, by level of output voxels (1^3, 2^3, 4^3) its device ms
           a launch, its bound and `F.conv3d`'s ms
  c128     the C-128 kernels (csrc/fused_decode_c128.cu) on the
           hydrant_g32c128 model (32^3 x 128 grid, hidden 256): K1 and K3
           at a training fine pass (393,216 points) and an evaluation chunk
           (640 rays x 128 points), K2 at the fine pass on random and
           ray-ordered points with a slope-safe cotangent, each against its
           plain version with its device ms, bound and shared memory; then
           its training main path, 2 steps of 33 frames at 800^2 (K3 and K2
           twice a step at C 128, nothing else of the decode or sampling)
  sample   hydrant model (seeded random weights), 1000-step DDPM, B=1
  render   fly-around at 512^2 through the chunked renderer: 2 poses with
           normals (K3), 1 pose of the same model with normals off (K1)
  check    outputs finite and in range; a small render and two DDPM steps
           on the card against the same model on the CPU
  serve_unfused  the same grid rendered by the unfused implicit function
           (fuse_decode="off"): 2 poses with sampler "fused" (K4, normals
           by K6), 1 with collapse_density="on" (K4 at C 257), 1 with
           sampler "pallas" (K7)
  check    the unfused frame against the fused frame of the same grid; the
           unfused model on the card against the CPU
  train    hydrant training at full width on a synthetic batch of 33
           frames at 800^2: one warm-up step, then 5 timed steps of
           `make_train_step` (pool, two-pass denoise, render, loss, Adam);
           then the unfused model (sampler "fused"): a warm-up and 3 steps
  check    one training step and a 24 px frame of a narrow model on the
           card and on the CPU with the same injected draws: objective,
           gradients and frame, fused, unfused, and at C 8 with default
           arguments (which "auto" sends to the unfused decode: no
           fused-decode launch)
  profile  device time by kernel and the device's idle share over one
           512^2 frame (fused and unfused), over 10 DDPM steps and over
           one training step (fused and unfused)
  train_loop  the training loop at hydrant width (`Experiment` on 2
           synthetic scenes of 33 frames at 800^2, 2 steps an epoch, a
           512^2 validation frame after each epoch, a checkpoint with
           purge 1): run A trains 2 epochs; a new Experiment restores
           epoch 1, which must equal run A's final state bitwise, and
           runs epoch 2 only; then `generate_samples_main exp_dir=...`
           samples (10 DDIM steps) and renders a frame from the checkpoint,
           held against the same grid rendered by run B's model
  co3d     the training loop on CO3D-format data: the port's synthetic CO3D
           writer (2 sequences x 36 frames at 900 x 1200), cold scene loads
           with hydrant's load arguments and one 33-frame batch's pinned
           copy (bitwise on the card), `Experiment.run` 2 epochs of 2 steps
           with a 512^2 validation frame each on `hydrant.yaml` with the
           CO3D provider, one profiled step (idle share), 6 steps from a
           one-scene cache (cold decodes: the loader's wait), a narrow step
           card vs CPU on a uint8/float16 batch at 800^2
  train_full  the whole training step on the same tree: `hydrant.yaml` with
           ema_rate 0.9999, the loss-second-moment sampler and 2 optimizer
           steps per dispatch; run A 1 epoch (2 dispatches), a bitwise
           restore (model, Adam, EMA, sampler state), run B resumes for a
           second epoch; the EMA and sampler updates' device time; a
           sampler warmed on the card whose 20,000 draws follow its
           weights; `run_eval_only` through the EMA over the tree's eval
           batches at 800^2 (pooling, render and host metrics timed);
           `generate_samples_main exp_dir=... use_ema=true`; a narrow
           loss-aware + EMA step card vs CPU
  flyaround_full  the fly-around's modes and the reconstruction entry point
           at hydrant width: `generate_samples_main config=hydrant` (10 DDIM
           steps, 4 poses at 512^2, the four streams), the same with the
           empty-space skip (the probe's time and occupied share, s per
           frame with and without it, the PSNR between the two, the
           invariance gates on the card), progressive sampling (10 DDPM
           steps, 2 a pose); one 512^2 frame with stratified evaluation
           sampling; the three shaded-depth methods on a 128^2 depth, each
           against the CPU; `unet_with_no_diffusion.yaml` trained 2 steps on
           the CO3D tree, then `visualize_reconstruction_main`: 2 sequences
           x 4 poses at 256^2 on a fitted circle, 1 on a trefoil knot, one
           512^2 frame through the forward
  quality  sample quality and the loop's outputs on train_full's EMA
           checkpoint: `evaluate_samples_main` (2 samples x 4 poses, 10
           DDPM steps, 512^2) with the extractors random_inception,
           random_vgg, and inception / vgg reading random weights in the
           published layouts, timed by phase; Inception, VGG and LPIPS on
           the card against the CPU, and their ms per image against a
           float32 bound from their conv FLOPs; `run_eval_only` with
           `lpips_vgg_weights_path` over the tree's eval batches; then
           `Experiment.run` on synthetic scenes, 1 epoch of 2 steps with
           validation, visualizations, the denoising video (a 250-step
           schedule, cut from 1000 for time; a chunked 512^2 frame every
           50 steps) and the profiler, and the files it leaves
           (train_stats.pdf needs matplotlib)
  scale_out  compact sources, packed transfer and data parallelism at
           hydrant width on the CO3D tree: `Experiment.run` 2 epochs of 2
           steps with and without `compact_sources` (s per step, K2/K3 a
           step, the scene cache, a batch's bytes and pinned copy, a
           scene's compaction, compact vs full objective within 10 %, a
           narrow compact step card vs CPU); one packed 33-frame batch
           against the leaf-by-leaf copy, and a packed loop bitwise the
           unpacked one (deterministic mode); a process group of one rank
           through NCCL: 3 steps through `make_train_step(mesh=...)`
           against the plain step, within the plain step's own rerun spread
           on the fused model and bitwise in deterministic mode, the flat
           all_reduce's ms; `torchrun --nproc_per_node 1` on the train CLI
           with compact sources and packed transfer, its checkpoint loaded
  model_parallel  the UNet sharded over the grid's D axis and the render
           with rays sharded over ranks, in a process group of one rank
           through NCCL: the sharded hydrant UNet against the plain one at
           resol 16 and 64 (ms, peak memory, collectives by kind), one
           sharded DDPM step against the plain step, the sharded 10-step
           sampling loop and a ray-sharded 512^2 frame of its grid (K3
           exactly twice) against the chunked frame; the UNet family
           (2D class-conditional UNet, SuperResModel, EncoderUNetModel with
           the attention and spatial pools, AsymmetricUNetModel) card
           against CPU; the extractor in bfloat16 against float32 on 30
           sources at 256^2
  rehearsal  the release rehearsal (`holo_diffusion_torch/rehearsal.py`) at
           hydrant width on the release tree (3 sequences x 40 frames at
           900 x 1200): 2 epochs of 8 steps, one `Experiment.run` an epoch,
           the second resuming from the first's checkpoint; after each epoch
           the diffusion leg's probe on a fixed 9-frame validation batch, a
           1000-step DDPM sample and its 256^2 render (PNG); s per epoch and
           step, peak and resting memory by epoch (growth bounded); the
           probes of a narrow model card vs CPU
  kernels summary, the card's name and power limit, and the result line.
Twenty-three main paths, each with its launches counted from right before
it to right after it, by the kernels' own counters or, where the path
renders chunked frames on the card (each chunk a graph's replay, which
launches its kernels without a call into their wrappers), by name in a
device trace (`traced_launches`; there K3 also launches once a pass in
each chunk graph's warm-up): C-128 training (K3 and K2 at C 128 alone), serving
(`sample` + `render`, which must launch K1 and K3, and K9 exactly 51
times a UNet forward the card runs: each of the chain's graph replays and
each graph's warm-up), unfused serving (K4, K6
and K7, no K1/K3), training (the 5 timed steps, which must launch K3 and K2,
at C 64 alone), unfused training (K4, K5 and K6,
no K1/K2/K3), the training loop (runs A and B: K2 twice a step, K3
twice a step and 820 times a validation frame, no K1 or K4-K7), the
training loop on CO3D and the whole training step (the same counts for
their steps and frames), and evaluation (K3 twice a chunk of each
target, nothing else); then the fly-around's: sample mode, with the skip
(one more K3 launch: the occupancy probe) and progressive (K3 twice a
chunk of each frame, nothing else), the reconstruction model's training
(K1 and K2 only) and the reconstructions (K1 twice a frame, nothing
else); then sample quality's: the four extractors' sample evaluations
(K3 twice a one-forward frame, nothing else), evaluation with LPIPS (K3
twice a chunk of each target) and the loop with visualizations, whose
own trace leaves no room for a second, by its host's launches (K2 twice a
step, K3 twice a step and once a pass in each chunk graph's warm-up) and
one graph replay a chunk of each validation and video frame; then the compact loop's (K2 twice a step, K3 twice a step and twice
a chunk of each validation frame, nothing else); then the sharded sampling
loop and the ray-sharded frame (K3 exactly twice, nothing else); then the
rehearsal's 2 epochs (K2 twice a step, K3 twice a step and twice a chunk of
each 512^2 validation frame and 256^2 snapshot, nothing else).
Float32 stays full float32 (TF32 off for cuDNN and cuBLAS).
"""
import contextlib
import copy
import gc
import json
import logging
import math
import os
import shutil
import struct
import subprocess
import sys
import time
import zlib

from benchmark.counts.decode import decode_bwd_cost, decode_cost
from benchmark.counts.unet_small_convs import Conv as SmallConv

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 CUDA-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# dense TF32 tensor-core peak (NVIDIA data sheet, H100 SXM)
PEAK_TF32_FLOPS = 495e12
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
# the C-128 backward kernel against the plain backward on a cotangent that
# is zero at the points where the two may take different slopes
# (`slope_safe_cotangent`): relative to each cotangent's largest magnitude.
# Both then compute the same function and differ by summation order alone
# (dA, summed over 393,216 points, reads up to ~2.2e-5); a backward on plain
# TF32 products (no 3 x TF32 split) reads 2.9e-3 and more, and fails it.
KERNEL_BWD_SLOPE_SAFE_TOL = 1e-4
# training step, card vs CPU at a narrow width: objective (absolute) and
# gradients relative to each leaf's largest magnitude; float32 through two
# UNet passes, two render passes and an importance resampling
TRAIN_OBJ_TOL = 1e-4
TRAIN_GRAD_TOL = 2e-3
# card vs CPU, end to end: cuDNN/cuBLAS and CPU kernels sum in other orders;
# a 2-pass render compounds it through the importance resampling
RENDER_TOL = 2e-3
DDPM_TOL = 1e-3

HYDRANT_MODEL = "model_factory_ImplicitronModelFactory_args.model_HoloDiffusionModel_args"
SAMPLER_KEY = f"{HYDRANT_MODEL}.implicit_function_HoloVoxelGridImplicitFunction_args.sampler"
# sampling kernels vs plain versions: 8 float32 products summed in another
# order (forward, absolute); cotangents relative to each one's largest
# magnitude (K5 sums ~100 points per voxel with atomics in no fixed order)
SAMPLE_TOL = 1e-4
SAMPLE_COT_TOL = 1e-4
# the view sampler (K8) vs its plain version: the forward rounds as the
# plain version does, in its order (absolute, unit-scale maps); the maps'
# gradients sum up to ~1000 shares a pixel in point order, the plain
# version corner by corner (of each gradient's largest magnitude)
VIEW_SAMPLE_TOL = 1e-6
VIEW_SAMPLE_GRAD_TOL = 1e-5
# the unfused implicit function against the fused one: the same function,
# with the density net layer by layer or collapsed into one affine map. On
# the same points every output within 2e-3. Over a whole 512^2 frame the
# images and masks too; depths and normals may exceed it on at most this
# share of the pixels: the second pass resamples its points from the first
# pass's weights, so rounding moves fine samples, and the normal of a
# sample that moves across a voxel plane jumps (the trilinear field's
# gradient is discontinuous there)
UNFUSED_VS_FUSED_TOL = 2e-3
UNFUSED_FRAME_SHARE = 1e-4
# shaded depth, card vs CPU on the same rendered depth, per pixel: the
# gradient method is the same float32 arithmetic; the point-cloud method's
# normals come from another eigensolver (cuSOLVER vs LAPACK) and KNN may
# break distance ties otherwise; the mesh method's blend weights
# exp((z_inv - z_inv_max) / 1e-4) scale rounding of a face's depth by 1e4.
# A pixel may also flip across a threshold (outlier mask, coverage): at most
# SHADED_SHARE of the pixels above the tolerance
SHADED_TOL = {"gradient": 1e-4, "pointcloud": 1e-3, "mesh": 1e-3}
SHADED_SHARE = 0.01
# the extractors and LPIPS, card vs CPU on the same weights and inputs, full
# float32: Inception pool3 absolute and relative (the JAX package's own
# tolerance for this 94-conv net, tests/test_inception.py:242); VGG relu5_3
# pooled, of the features' scale; LPIPS of an 800^2 pair, relative
QUALITY_TOL = {"inception": 2e-3, "vgg": 1e-3, "lpips": 1e-4}
# the sharded UNet (world size 1 through NCCL) against the plain forward, of
# the output's scale: the same cuDNN convolutions, the halo's D padding 0
# instead of padding 1, and GroupNorm's two-pass statistics in float32
SHARDED_TOL = 1e-4
# the UNet family, card against CPU, of the output's scale: float32 through
# up to ~40 convolutions summed in other orders
UNET_FAMILY_TOL = 1e-3
# the extractor's features, bfloat16 convolutions against float32, of the
# features' scale: bfloat16 keeps 8 bits of mantissa through 36 convolutions
# (a bound on the drift, not a parity check)
EXTRACTOR_BF16_TOL = 0.1
# the rehearsal's probes on a narrow model, card against CPU, of the pooled
# grid's scale and of each timestep's MSE: the extractor and the UNet, float32
REHEARSAL_PROBE_TOL = 1e-3
# memory growth from the rehearsal's first epoch to its second: its peak
# (a leaked Adam state of hydrant is 1.49 GB, a model copy 0.75 GB) and what
# stays allocated between epochs (the model and its buffers)
REHEARSAL_PEAK_GROWTH_GIB = 0.25
REHEARSAL_REST_GROWTH_GIB = 1 / 64


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


def device_rows(prof):
    """The device rows of a torch.profiler window: kernels, copies and
    fills. The device mirrors of host annotations (the port's `holo.*`
    spans, on while a profiler records) each cover the kernels under them
    and are left out."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def device_ms_per_launch(fn, name_part, iters=20, attempts=3):
    """Device time per launch of the kernel whose name contains `name_part`,
    from torch.profiler over `iters` calls of `fn` (after one warm-up). The
    profiler may drop device events; a window that did not record all
    `iters` launches is discarded and profiled again, up to `attempts`
    times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in device_rows(prof) if name_part in e.key and e.self_device_time_total > 0]
        counts.append(sum(e.count for e in rows))
        if counts[-1] == iters:
            return sum(e.self_device_time_total for e in rows) / 1e3 / iters
    raise AssertionError(f"profiled {counts} launches of {name_part!r} in {attempts} windows, expected {iters}")


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
    # with grad on the forward runs eagerly, each hook once (a no-grad one
    # replays a graph, whose hooks fire at its warm-up and capture alone)
    with torch.enable_grad():
        model.apply_net_3d(torch.zeros((1, r, r, r, C), device=dev),
                           torch.zeros((1,), dtype=torch.long, device=dev))
    for h in handles:
        h.remove()
    return sum(flops), len(convs)


def decode_bounds(n_points, n_rays, grid_shape, hidden, pe_dim, normals):
    """(bytes ms, float32 CUDA-core ops ms, 3 x TF32 tensor-core ops ms) of
    the fused decode: the affine's 2 C (hidden + 1) FLOP per point counted 3
    times at the TF32 peak (the split that keeps float32 accuracy), the rest
    at the float32 peak."""
    n_bytes, flops = decode_cost(n_points, n_rays, grid_shape, hidden, pe_dim, normals)
    affine = n_points * 2 * grid_shape[-1] * (hidden + 1)
    return (1e3 * n_bytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_F32_FLOPS,
            1e3 * (3 * affine / PEAK_TF32_FLOPS + (flops - affine) / PEAK_F32_FLOPS))


def decode_fwd_case(name, args, kw, case, device_name, source, replaces, extra=None):
    """K1 or K3 (`kw` holds g1 for K3) on the operands `args` of
    `fused_sample_decode` against the plain version on the same card: the
    largest error (at most KERNEL_TOL), the kernel's device ms a launch
    (the device kernel whose name holds `device_name`), a wrapper call's
    and the plain version's ms, the bound. Emits the record; returns it."""
    import torch

    from holo_diffusion_torch.ops import fused_decode as fd

    grid, points, pe, hidden = args[0], args[5], args[6], args[8]
    with torch.no_grad():
        out = fd.fused_sample_decode(*args, **kw)
        ref = fd.fused_sample_decode_reference(*args, **kw)
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(out, ref)]
        del out, ref
        wrapper_ms = cuda_time_ms(lambda: fd.fused_sample_decode(*args, **kw))
        ms = device_ms_per_launch(lambda: fd.fused_sample_decode(*args, **kw), device_name)
        plain_ms = cuda_time_ms(lambda: fd.fused_sample_decode_reference(*args, **kw))
    n = points.numel() // 3
    bytes_ms, f32_ms, tf32x3_ms = decode_bounds(n, pe.shape[0], grid.shape, hidden, pe.shape[-1], "g1" in kw)
    # the least time at float32 accuracy: the cheaper of the two ways
    # to do the operations, against the bytes
    ops_ms = min(f32_ms, tf32x3_ms)
    rec = {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes this function
    }
    emit({"phase": "kernels", "case": case, **rec, "wrapper_ms": wrapper_ms, "points": n,
          "bound_f32_cuda_cores_ms": max(bytes_ms, f32_ms), "bound_tf32x3_tensor_cores_ms": max(bytes_ms, tf32x3_ms),
          "lane_errs": dict(zip(("density", "rgb", "normals"), errs)), "tol": KERNEL_TOL, **(extra or {})})
    if not max(errs) <= KERNEL_TOL:
        raise AssertionError(f"{name} ({case}): max_abs_err {max(errs)} > {KERNEL_TOL}")
    return rec


def kernel_phase(model, results):
    """K1 and K3 at both render chunks of the hydrant render (640 rays x 128
    points after the fine pass, x 64 in the coarse pass; the main path
    alternates them) against the plain version on the same card."""
    import torch

    fn = model.implicit_function
    mlp = fn.render_mlp
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    R = 640
    D, C = model.resol, model.feature_size
    grid = torch.tanh(torch.randn((D, D, D, C), generator=gen, device=dev))
    extent = model.volume_extent
    half = 0.6 * extent  # points inside and outside the grid
    chunks = {"fine": model.n_pts_per_ray_evaluation + model.n_pts_per_ray_fine_evaluation,
              "coarse": model.n_pts_per_ray_evaluation}
    all_points = {k: (torch.rand((R, P, 3), generator=gen, device=dev) * 2 - 1) * half for k, P in chunks.items()}
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
        for chunk, points in all_points.items():
            kw = {"g1": g1} if normals else {}
            rec = decode_fwd_case(name, (grid, A, c, Wr, br, points, pe, extent, hidden), kw, chunk,
                                  "fused_decode_kernel", "holo_diffusion_torch/csrc/fused_decode.cu", replaces)
            if chunk == "fine":
                results[name] = rec
            else:  # the second shape of the same entry point
                results[name][chunk] = {k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")}
    kernel_bwd_phase(model, grid, A, c, Wr, br, results)


def ray_ordered_points(gen, R, P, extent):
    """(R, P, 3) points in depth order along R rays, as a training pass
    lays them out: origins at distance `extent` from the centre in random
    directions, each ray aimed at a random point within a quarter extent of
    the centre, P sorted depths uniform over [0.25, 1.75] x extent (most
    points inside the grid, which spans +-extent / 2)."""
    import torch

    dev = gen.device
    o = torch.randn((R, 3), generator=gen, device=dev)
    o = extent * o / o.norm(dim=-1, keepdim=True)
    d = (torch.rand((R, 3), generator=gen, device=dev) * 2 - 1) * 0.25 * extent - o
    d = d / d.norm(dim=-1, keepdim=True)
    t = torch.sort(torch.rand((R, P), generator=gen, device=dev), dim=-1).values * 1.5 * extent + 0.25 * extent
    return o[:, None, :] + t[..., None] * d[:, None, :]


def decode_bwd_bounds(n_points, n_rays, grid_shape, hidden, pe_dim):
    """(bytes ms, float32 CUDA-core ops ms, 3 x TF32 tensor-core ops ms) of
    the decode backward: its three C x (hidden + 1) products per point (the
    recomputed affine, dA and d_s) counted 3 times at the TF32 peak, the
    rest at the float32 peak."""
    n_bytes, flops, _ = decode_bwd_cost(n_points, n_rays, grid_shape, hidden, pe_dim)
    products = n_points * 3 * 2 * grid_shape[-1] * (hidden + 1)
    return (1e3 * n_bytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_F32_FLOPS,
            1e3 * (3 * products / PEAK_TF32_FLOPS + (flops - products) / PEAK_F32_FLOPS))


def decode_bwd_errors(args, got, want):
    """The decode backward's results `got` against its plain version's
    `want` on the operands `args` of `fused_sample_decode_bwd_reference`:
    each cotangent's largest error and that error over the cotangent's
    largest magnitude; the count of nonzero pre-activations within 1e-6 of
    0, where two float32 summation orders may give them opposite signs and
    so different leaky-ReLU slopes (exact zeros, as outside the grid,
    agree); and d_grid's relative error over the cells that no point with a
    nonzero pre-activation within 1e-5 of 0 reaches, where the slopes of
    both agree."""
    import torch

    from holo_diffusion_torch.ops.voxel import hat_corners, sample_voxel_grid_world

    grid, A, c, points, extent = args[0], args[1], args[2], args[5], args[7]
    names = ("d_grid", "dA", "dc", "dWr", "dbr")
    abs_errs = {n: float((a - b).abs().max()) for n, a, b in zip(names, got, want)}
    rel_errs = {n: abs_errs[n] / max(float(b.abs().max()), 1e-30) for n, b in zip(names, want)}
    pts = points.reshape(-1, 3)
    with torch.no_grad():
        pre = sample_voxel_grid_world(grid, pts, extent) @ A + c
        nonzero = pre != 0
        near_zero = int((nonzero & (pre.abs() < 1e-6)).sum())
        flagged = (nonzero & (pre.abs() < 1e-5)).any(dim=-1)
        del pre, nonzero
        cells, _, _ = hat_corners(pts[flagged], *grid.shape[:3], extent)
        apart = torch.ones(grid.shape[:3].numel(), dtype=torch.bool, device=grid.device)
        apart[cells.reshape(-1)] = False
        diff = (got[0] - want[0]).reshape(-1, grid.shape[-1])[apart]
    away = float(diff.abs().max()) if diff.numel() else 0.0
    return abs_errs, rel_errs, near_zero, away / max(float(want[0].abs().max()), 1e-30)


def kernel_bwd_phase(model, grid, A, c, Wr, br, results):
    """K2 at a hydrant training step's fine pass (3 x 1024 rays x 128
    points) against the plain backward on the same card, with a random
    cotangent of the (density, rgb) outputs: on random points (the case
    earlier runs measured) and on the same number of points in depth order
    along rays (`ray_ordered_points`), where neighbours share voxels."""
    import torch

    dev = grid.device
    gen = torch.Generator(device=dev).manual_seed(3)
    R = 3 * model.n_rays_per_image
    P = model.n_pts_per_ray_training + model.n_pts_per_ray_fine_training
    half = 0.6 * model.volume_extent
    random_points = (torch.rand((R, P, 3), generator=gen, device=dev) * 2 - 1) * half
    dirs = torch.randn((R, 3), generator=gen, device=dev)
    g = torch.randn((R, P, 4), generator=gen, device=dev)
    cases = {"random": random_points, "ray_ordered": ray_ordered_points(gen, R, P, model.volume_extent)}
    mlp = model.implicit_function.render_mlp
    hidden = mlp.dnet_hidden_dim
    with torch.no_grad():
        pe = mlp.encode_dirs(dirs / dirs.norm(dim=-1, keepdim=True))
    for case, points in cases.items():
        args = (grid, A, c, Wr, br, points, pe, model.volume_extent, hidden, g)
        rec = decode_bwd_case("fused_decode_bwd", args, case, "fused_decode_bwd_kernel",
                              "holo_diffusion_torch/csrc/fused_decode_bwd.cu", KERNEL_BWD_TOL)
        if case == "random":
            results["fused_decode_bwd"] = rec
        else:  # the second point set of the same entry point
            results["fused_decode_bwd"][case] = {k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")}


def decode_bwd_case(name, args, case, device_name, source, rel_tol, extra=None):
    """K2 on the operands `args` of `fused_sample_decode_bwd_reference`
    against the plain backward on the same card: each cotangent's error
    relative to its largest magnitude (at most `rel_tol`), the kernel's
    device ms a launch (the device kernel whose name holds `device_name`),
    a wrapper call's and the plain version's ms, the bound. Emits the
    record; returns it."""
    from holo_diffusion_torch.ops import fused_decode as fd

    grid, points, pe, hidden = args[0], args[5], args[6], args[8]
    abs_errs, rel_errs, near_zero, away_rel = decode_bwd_errors(
        args, fd._fused_sample_decode_bwd_cuda(*args), fd.fused_sample_decode_bwd_reference(*args))
    wrapper_ms = cuda_time_ms(lambda: fd._fused_sample_decode_bwd_cuda(*args))
    ms = device_ms_per_launch(lambda: fd._fused_sample_decode_bwd_cuda(*args), device_name)
    plain_ms = cuda_time_ms(lambda: fd.fused_sample_decode_bwd_reference(*args), iters=5)
    n, R = points.numel() // 3, pe.shape[0]
    n_bytes, flops, rmw_bytes = decode_bwd_cost(n, R, grid.shape, hidden, pe.shape[-1])
    bytes_ms, f32_ms, tf32x3_ms = decode_bwd_bounds(n, R, grid.shape, hidden, pe.shape[-1])
    # the least time at float32 accuracy: the cheaper of the two ways to
    # do the operations, against the bytes
    ops_ms = min(f32_ms, tf32x3_ms)
    rec = {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": "holo_diffusion_tpu/ops/pallas/fused_decode.py:173",
        "max_abs_err": max(abs_errs.values()),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes this function
    }
    emit({"phase": "kernels", "case": case, **rec, "wrapper_ms": wrapper_ms, "points": n,
          "gflop": flops / 1e9, "bytes": n_bytes, "bytes_with_scatter_rmw": rmw_bytes,
          "bound_f32_cuda_cores_ms": max(bytes_ms, f32_ms),
          "bound_tf32x3_tensor_cores_ms": max(bytes_ms, tf32x3_ms), "abs_errs": abs_errs,
          "rel_errs": rel_errs, "rel_tol": rel_tol, "nonzero_pre_activations_below_1e-6": near_zero,
          "d_grid_rel_err_where_slopes_agree": away_rel, **(extra or {})})
    if not max(rel_errs.values()) <= rel_tol:
        raise AssertionError(f"{name} ({case}): relative error {rel_errs} > {rel_tol}")
    return rec


def slope_safe_cotangent(g, args):
    """`g` (R, P, 4) with zeros at the points that have a nonzero
    pre-activation within 1e-5 of 0, in the density net (s A + c) or in the
    radiance head (its three outputs before their leaky ReLU), on the
    operands `args` of `fused_sample_decode`: two float32 summation orders
    may give such a pre-activation opposite signs, and so the leaky-ReLU
    slopes 1 and 0.2, which move the point's whole contribution to the
    cotangents. With their cotangent zero the kernel and the plain backward
    compute the same function. Returns (the cotangent, the count of zeroed
    points)."""
    import torch

    from holo_diffusion_torch.ops.voxel import sample_voxel_grid_world

    grid, A, c, Wr, br, points, pe, extent, hidden = args
    with torch.no_grad():
        pre = sample_voxel_grid_world(grid, points.reshape(-1, 3), extent) @ A + c
        near = ((pre != 0) & (pre.abs() < 1e-5)).any(dim=-1)
        pe_pts = pe[:, None, :].expand(*points.shape[:-1], pe.shape[-1]).reshape(-1, pe.shape[-1])
        rpre = torch.cat([torch.nn.functional.leaky_relu(pre[:, :hidden], 0.2), pe_pts], dim=-1) @ Wr + br
        near |= ((rpre != 0) & (rpre.abs() < 1e-5)).any(dim=-1)
        del pre, pe_pts, rpre
    g = g.clone()
    g.reshape(-1, 4)[near] = 0.0
    return g, int(near.sum())


C128_SOURCE = "holo_diffusion_torch/csrc/fused_decode_c128.cu"
C128_KERNELS = ("decode_c128_fwd", "decode_c128_fwd_normals", "decode_c128_bwd")


def c128_phase(dev, results):
    """The C-128 kernels on the hydrant_g32c128 model (the reference
    model's 32^3 x 128 grid, hidden 256, seeded random weights): K1 and K3
    at a training step's fine pass (3 x 1024 rays x 128 points, 393,216)
    and at an evaluation chunk (640 rays x 128), on points in depth order
    along rays, against the plain version within KERNEL_TOL; K2 at the fine
    pass on random and on ray-ordered points, within
    KERNEL_BWD_SLOPE_SAFE_TOL on a random cotangent made slope-safe
    (`slope_safe_cotangent`); the shared memory each launch asked for,
    against the layout's and the 232,448 bytes a block may opt into. Then
    the C-128 training main path: 2 timed steps of `make_train_step` on a
    synthetic 33-frame batch at 800^2, which must launch K3 and K2 twice a
    step at C 128 and no other decode or sampling kernel."""
    import torch

    from holo_diffusion_torch.cli import build_model
    from holo_diffusion_torch.config import load_config
    from holo_diffusion_torch.ops import _build
    from holo_diffusion_torch.ops import fused_decode as fd
    from holo_diffusion_torch.ops import fused_render as fr
    from holo_diffusion_torch.ops import kron_sample as ks
    from holo_diffusion_torch.weights import init_weights

    model = build_model("hydrant_g32c128")
    init_weights(model, seed=0)
    model.to(dev).eval()
    mlp = model.implicit_function.render_mlp
    hidden, pe_dim, extent = mlp.dnet_hidden_dim, mlp.pe_dim, model.volume_extent
    D, C = model.resol, model.feature_size
    lib = _build.load("fused_decode_c128")
    gen = torch.Generator(device=dev).manual_seed(5)
    grid = torch.tanh(torch.randn((D, D, D, C), generator=gen, device=dev))
    with torch.no_grad():
        A, c = mlp.density_affine()
        Wr, br = (t.detach() for t in mlp.radiance_linear())
        g1 = torch.einsum("dhwc,c->dhw", grid, A[:, -1])

    def view_rows(R):
        dirs = torch.randn((R, 3), generator=gen, device=dev)
        with torch.no_grad():
            return mlp.encode_dirs(dirs / dirs.norm(dim=-1, keepdim=True))

    def launched_smem(which, want):
        got = lib.decode_c128_smem_bytes(which)
        if got != want or got > fd.SMEM_OPTIN_BYTES:
            raise AssertionError(f"{C128_KERNELS[which]}: launched with {got} bytes of shared memory, layout {want}, "
                                 f"at most {fd.SMEM_OPTIN_BYTES}")
        return got

    R_train = 3 * model.n_rays_per_image
    P_train = model.n_pts_per_ray_training + model.n_pts_per_ray_fine_training
    shapes = {"train_fine": (R_train, P_train),
              "eval_chunk": (640, model.n_pts_per_ray_evaluation + model.n_pts_per_ray_fine_evaluation)}
    for case, (R, P) in shapes.items():
        points, pe = ray_ordered_points(gen, R, P, extent), view_rows(R)
        for which, replaces in enumerate(("holo_diffusion_tpu/ops/pallas/fused_decode.py:122",
                                          "holo_diffusion_tpu/ops/pallas/fused_decode.py:144")):
            name, kw = C128_KERNELS[which], ({"g1": g1} if which else {})
            rec = decode_fwd_case(name, (grid, A, c, Wr, br, points, pe, extent, hidden), kw, case,
                                  "decode_c128_fwd_kernel", C128_SOURCE, replaces)
            rec["smem_bytes"] = launched_smem(which, fd.fwd_smem_bytes(C, hidden, pe_dim))
            if case == "train_fine":
                results[name] = rec
            else:  # the second shape of the same entry point
                results[name][case] = {k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")}

    half = 0.6 * extent
    pe = view_rows(R_train)
    g = torch.randn((R_train, P_train, 4), generator=gen, device=dev)
    cases = {"random": (torch.rand((R_train, P_train, 3), generator=gen, device=dev) * 2 - 1) * half,
             "ray_ordered": ray_ordered_points(gen, R_train, P_train, extent)}
    for case, points in cases.items():
        g_safe, zeroed = slope_safe_cotangent(g, (grid, A, c, Wr, br, points, pe, extent, hidden))
        rec = decode_bwd_case("decode_c128_bwd", (grid, A, c, Wr, br, points, pe, extent, hidden, g_safe), case,
                              "decode_c128_bwd_kernel", C128_SOURCE, KERNEL_BWD_SLOPE_SAFE_TOL,
                              extra={"slope_safe_zeroed_points": zeroed})
        rec["smem_bytes"] = launched_smem(2, fd.bwd_smem_bytes(C, hidden, pe_dim))
        if case == "random":
            results["decode_c128_bwd"] = rec
        else:  # the second point set of the same entry point
            results["decode_c128_bwd"][case] = {k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")}
    del grid, g1, g, g_safe, cases, points, pe

    cfg = load_config("hydrant_g32c128")
    batch = synthetic_batch(cfg, dev)
    steps = 2
    _, counts = train_phase(model, cfg, batch, dev, "train_c128", steps)
    expect_launches(counts, "C-128 training",
                    exactly={"fused_decode_fwd_normals@C128": 2 * steps, "fused_decode_bwd@C128": 2 * steps,
                             "view_sample_fwd": steps, "view_sample_bwd": steps},
                    none=("fused_decode_fwd", "fused_decode_fwd_normals@C64", "fused_decode_bwd@C64",
                          *ks.ENTRY_POINTS, *fr.ENTRY_POINTS))
    results["decode_c128_fwd_normals"]["train_launches"] = counts["fused_decode_fwd_normals@C128"]
    results["decode_c128_bwd"]["train_launches"] = counts["fused_decode_bwd@C128"]


def sample_cost(kind, n, C, grid_cells, active_corners):
    """(bytes, flops) a sampling kernel must move and do: each input read
    once, each output written once; one multiply-add per channel of each
    corner that lies inside the grid (`active_corners`, counted from this
    run's points), plus for d_points the cotangent's product and the three
    slope terms per corner."""
    if kind == "fwd":  # points, grid -> samples
        return 4 * (3 * n + grid_cells * C + n * C), 2 * active_corners * C
    if kind == "dgrid":  # points, cotangent -> grid cotangent
        return 4 * (3 * n + n * C + grid_cells * C), 2 * active_corners * C
    ones = kind == "dpoints_ones"  # points, [cotangent], grid -> (n, 3)
    n_bytes = 4 * (3 * n + (0 if ones else n * C) + grid_cells * C + 3 * n)
    return n_bytes, active_corners * ((1 if ones else 2) * C + 2 * 3)


def grid_sample_yardstick(grid, points, extent, kind, cot):
    """`torch.nn.functional.grid_sample` (5-D input, trilinear,
    align_corners=True, zero padding) set up to compute what a sampling
    kernel computes: the sample ("fwd"), its input gradient ("dgrid") or
    its coordinate gradient ("dpoints"). Coordinates 2 i / (n - 1) - 1 are
    prepared here, outside the timed call. Returns (call, result in the
    kernel's layout)."""
    import torch
    import torch.nn.functional as F

    D, H, W, C = grid.shape
    n = points.shape[0]
    vs = extent / D
    idx = points / vs + torch.tensor([(W - 1) / 2.0, (H - 1) / 2.0, (D - 1) / 2.0], device=points.device)
    scale = torch.tensor([2.0 / (W - 1), 2.0 / (H - 1), 2.0 / (D - 1)], device=points.device)
    coords = (idx * scale - 1.0).reshape(1, 1, 1, n, 3)
    inp = grid.permute(3, 0, 1, 2)[None].contiguous()
    if kind == "fwd":
        def call():
            return F.grid_sample(inp, coords, mode="bilinear", padding_mode="zeros", align_corners=True)
        return call, lambda: call().reshape(C, n).t()
    gout = (torch.ones((n, C), device=grid.device) if cot is None else cot).t().reshape(1, C, 1, 1, n).contiguous()
    if kind == "dgrid":
        inp.requires_grad_(True)
        out = F.grid_sample(inp, coords, mode="bilinear", padding_mode="zeros", align_corners=True)

        def call():
            return torch.autograd.grad(out, inp, gout, retain_graph=True)[0]
        return call, lambda: call()[0].permute(1, 2, 3, 0)
    coords.requires_grad_(True)
    out = F.grid_sample(inp, coords, mode="bilinear", padding_mode="zeros", align_corners=True)

    def call():
        return torch.autograd.grad(out, coords, gout, retain_graph=True)[0]
    # d coords / d world = 2 / (n - 1) / voxel size per axis
    return call, lambda: call().reshape(n, 3) * scale / vs


def sample_kernel_phase(model, results):
    """K4-K7 against their plain versions on the card, at the shapes the
    unfused paths give them: a fine render chunk (640 rays x 128 points)
    for the samples and the normals' field gradient, a training step's fine
    pass (3 x 1024 rays x 128 points) for the cotangents; K5 and K7 also on
    the same counts of ray-ordered points (`ray_ordered_points`), where
    neighbours share cells; beside each, the plain version's time and
    grid_sample's."""
    import torch

    from holo_diffusion_torch.ops import fused_render as fr
    from holo_diffusion_torch.ops import kron_sample as ks
    from holo_diffusion_torch.ops.voxel import hat_corners

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    D, C, extent = model.resol, model.feature_size, model.volume_extent
    hidden = model.implicit_function.render_mlp.dnet_hidden_dim
    n_chunk = 640 * (model.n_pts_per_ray_evaluation + model.n_pts_per_ray_fine_evaluation)
    n_train = 3 * model.n_rays_per_image * (model.n_pts_per_ray_training + model.n_pts_per_ray_fine_training)
    half = 0.6 * extent  # points inside and outside the grid
    grids = {c: torch.tanh(torch.randn((D, D, D, c), generator=gen, device=dev)) for c in (1, C, hidden + 1)}
    pts = {n: (torch.rand((n, 3), generator=gen, device=dev) * 2 - 1) * half for n in (n_chunk, n_train)}
    cots = {n: torch.randn((n, C), generator=gen, device=dev) for n in (n_chunk, n_train)}
    # the same counts of points in depth order along rays, as render chunks
    # and training passes hold them
    ray_pts = {n: ray_ordered_points(gen, n // P, P, extent).reshape(-1, 3).contiguous()
               for n, P in ((n_chunk, model.n_pts_per_ray_evaluation + model.n_pts_per_ray_fine_evaluation),
                            (n_train, model.n_pts_per_ray_training + model.n_pts_per_ray_fine_training))}
    # entry point -> (kernel call, plain call, kernel name, TPU kernel)
    ops = {
        "kron_sample_fwd": (
            lambda g, p, cot: ks.kron_sample_fwd(g, p, extent),
            lambda g, p, cot: ks.kron_sample_fwd_reference(g, p, extent),
            "kron_sample_fwd_kernel", "holo_diffusion_tpu/ops/pallas/kron_sample.py:83"),
        "kron_sample_dgrid": (
            lambda g, p, cot: ks.kron_sample_dgrid(p, cot, g.shape, extent),
            lambda g, p, cot: ks.kron_sample_dgrid_reference(p, cot, g.shape, extent),
            "kron_sample_dgrid_kernel", "holo_diffusion_tpu/ops/pallas/kron_sample.py:100"),
        "kron_sample_dpoints": (
            lambda g, p, cot: ks.kron_sample_dpoints(g, p, cot, extent),
            lambda g, p, cot: ks.kron_sample_dpoints_reference(g, p, cot, extent),
            "kron_sample_dpoints_kernel", "holo_diffusion_tpu/ops/pallas/kron_sample.py:121"),
        "trilinear_sample_onehot": (
            lambda g, p, cot: fr.trilinear_sample_pallas(g, p, extent),
            lambda g, p, cot: fr.trilinear_sample_onehot_reference(g, p, extent),
            "trilinear_sample_onehot_kernel", "holo_diffusion_tpu/ops/pallas/fused_render.py:69"),
    }
    cases = [  # (case, entry point, cost kind, channels, points, ray-ordered, random cotangent)
        ("kron_sample_fwd", "kron_sample_fwd", "fwd", C, n_chunk, False, False),
        ("c257", "kron_sample_fwd", "fwd", hidden + 1, n_chunk, False, False),
        ("kron_sample_dgrid", "kron_sample_dgrid", "dgrid", C, n_train, False, True),
        ("ray_ordered", "kron_sample_dgrid", "dgrid", C, n_train, True, True),
        ("kron_sample_dpoints", "kron_sample_dpoints", "dpoints_ones", 1, n_chunk, False, False),
        ("c64", "kron_sample_dpoints", "dpoints", C, n_train, False, True),
        ("trilinear_sample_onehot", "trilinear_sample_onehot", "fwd", C, n_chunk, False, False),
        ("ray_ordered", "trilinear_sample_onehot", "fwd", C, n_chunk, True, False),
    ]
    for case, name, kind, c, n, ray_ordered, random_cot in cases:
        fn, plain, kernel_name, replaces = ops[name]
        args = (grids[c], (ray_pts if ray_ordered else pts)[n], cots[n] if random_cot else None)
        with torch.no_grad():
            got, want = fn(*args), plain(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            del got
            wrapper_ms = cuda_time_ms(lambda: fn(*args))
            ms = device_ms_per_launch(lambda: fn(*args), kernel_name)
            plain_ms = cuda_time_ms(lambda: plain(*args), iters=5)
            _, hats, _ = hat_corners(args[1], D, D, D, extent)
            active = int((hats.prod(-1) != 0).sum())
        lib_kind = kind.replace("_ones", "")
        lib_call, lib_result = grid_sample_yardstick(args[0], args[1], extent, lib_kind, args[2])
        lib_diff = (lib_result() - want).abs()
        lib_err = float(lib_diff.max())
        # grid_sample rounds its own coordinates: a point within an ulp of a
        # voxel plane can fall in the neighbouring cell, where the field's
        # gradient differs, so the coordinate gradient disagrees at a few
        # points (the entries beyond 1e-3 of the scale, counted here)
        lib_beyond = int((lib_diff > 1e-3 * scale).sum())
        library_ms = cuda_time_ms(lib_call)
        del want
        n_bytes, flops = sample_cost(kind, n, c, D ** 3, active)
        bytes_ms, flops_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_F32_FLOPS
        tol = SAMPLE_TOL if kind == "fwd" else SAMPLE_COT_TOL * scale
        rec = {
            "name": name,
            "route": "cuda",
            "source": "holo_diffusion_torch/csrc/" + ("fused_render.cu" if "onehot" in name else "kron_sample.cu"),
            "replaces": replaces,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms > flops_ms else "operations",
            "library_ms": library_ms,
        }
        emit({"phase": "kernels", "case": case, **rec, "wrapper_ms": wrapper_ms, "points": n, "channels": c,
              "point_order": "ray_ordered" if ray_ordered else "random", "active_corners": active,
              "bytes": n_bytes, "gflop": flops / 1e9, "scale": scale, "tol": tol,
              "library": f"torch.nn.functional.grid_sample ({lib_kind})", "library_max_abs_err": lib_err,
              "library_entries_beyond_1e-3_of_scale": lib_beyond, "ms_below_library_ms": ms < library_ms})
        if not err <= tol:
            raise AssertionError(f"{name} ({case}): max_abs_err {err} > {tol}")
        if case == name:
            results[name] = rec
        else:  # a second shape of the same entry point
            results[name][case] = {k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}


def view_sample_bytes(maps, xy, wanted):
    """(forward bytes, backward bytes) K8 must move: xy read once (8 bytes
    a point), the maps' distinct pixels the points' inside corners touch
    read once, the (S, N, F) rows written once; backward, the rows of the
    maps that take a gradient read once and those gradients written once
    whole."""
    import torch

    S, N = xy.shape[:2]
    fwd = 8 * S * N + 4 * S * N * sum(m.shape[-1] for m in maps)
    for m in maps:
        h, w = m.shape[1:3]
        fx = (-xy[..., 0] + 1.0) * 0.5 * w - 0.5
        fy = (-xy[..., 1] + 1.0) * 0.5 * h - 0.5
        x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
        cells = []
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                view = torch.arange(S, device=xy.device)[:, None].expand(S, N)
                cells.append(((view * h + yi) * w + xi)[inside])
        fwd += 4 * m.shape[-1] * int(torch.unique(torch.cat(cells)).numel())
    bwd = 8 * S * N + sum(4 * S * N * m.shape[-1] + 4 * m.numel() for m, want in zip(maps, wanted) if want)
    return fwd, bwd


def view_sample_kernel_phase(results):
    """K8 (`view_sample_fwd`, `view_sample_bwd`) against its plain version at
    the release pooling shapes: S source views (30, hydrant; 23, teddybear),
    the 16^3 voxel centres' 4096 points on the maps (uniform in NDC
    [-1, 1]), the extractor's six maps (images and masks 256^2 NHWC,
    res_layer_1..4 64^2..8^2 x 16 NHWC views of NCHW memory, the only ones
    taking a gradient). ms by CUDA events and device ms by
    torch.profiler; beside them the bound (bytes at
    3.35 TB/s), the plain version's ms and `grid_sample`'s (one call a map
    on the NCHW memory, then the concatenation)."""
    import torch
    import torch.nn.functional as F

    from holo_diffusion_torch.ops import view_sample as vs

    dev = torch.device("cuda")
    sizes = {"images": (256, 256, 3), "masks": (256, 256, 1), "res_layer_1": (64, 64, 16),
             "res_layer_2": (32, 32, 16), "res_layer_3": (16, 16, 16), "res_layer_4": (8, 8, 16)}
    N = 16 ** 3
    for case, S in (("hydrant", 30), ("teddybear", 23)):
        gen = torch.Generator(device=dev).manual_seed(S)
        maps = []
        for k in sorted(sizes):
            h, w, c = sizes[k]
            m = torch.rand((S, c, h, w), generator=gen, device=dev) * 2 - 1
            maps.append(m.permute(0, 2, 3, 1).requires_grad_() if k.startswith("res") else
                        m.permute(0, 2, 3, 1).contiguous())
        xy = (torch.rand((S, N, 3), generator=gen, device=dev) * 2 - 1)[..., :2]
        wanted = [m.requires_grad for m in maps]
        grad_maps = [m for m in maps if m.requires_grad]
        F_ = sum(m.shape[-1] for m in maps)
        cot = torch.randn((S, N, F_), generator=gen, device=dev)
        offsets = vs.check_operands(maps, xy)
        metas = [torch.empty_like(m, device="meta") for m in maps]
        with torch.no_grad():
            got, want = vs.view_sample(maps, xy), vs.view_sample_reference(maps, xy)
            fwd_err = float((got - want).abs().max())
            fwd_ms = cuda_time_ms(lambda: vs.view_sample(maps, xy))
            fwd_dev_ms = device_ms_per_launch(lambda: vs.view_sample(maps, xy), "view_sample_fwd_kernel")
            plain_fwd_ms = cuda_time_ms(lambda: vs.view_sample_reference(maps, xy), iters=3)
        bwd = lambda: vs._bwd_cuda(metas, offsets, xy, False, cot, wanted)  # noqa: E731
        g_got = [g for g in bwd() if g is not None]
        plain_out = vs.view_sample_reference(maps, xy)
        g_want = torch.autograd.grad(plain_out, grad_maps, cot, retain_graph=True)
        bwd_err = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(g_got, g_want))
        bwd_ms = cuda_time_ms(bwd)
        bwd_dev_ms = device_ms_per_launch(bwd, "view_sample_bwd_kernel")
        plain_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(plain_out, grad_maps, cot, retain_graph=True),
                                    iters=3)
        del plain_out
        # the library: grid_sample on each map's NCHW memory, then the rows
        grid = (-xy)[:, None]
        lib_out = torch.cat([F.grid_sample(m.permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode="zeros",
                                           align_corners=False)[:, :, 0].permute(0, 2, 1) for m in maps], dim=-1)
        with torch.no_grad():
            lib_err = float((lib_out - want).abs().max())
            lib_fwd_ms = cuda_time_ms(lambda: torch.cat(
                [F.grid_sample(m.permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode="zeros",
                               align_corners=False)[:, :, 0].permute(0, 2, 1) for m in maps], dim=-1))
        lib_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(lib_out, grad_maps, cot, retain_graph=True))
        del lib_out
        fwd_bytes, bwd_bytes = view_sample_bytes(maps, xy, wanted)
        for name, err, tol, ms, dev_ms, plain_ms, lib_ms, n_bytes in (
                ("view_sample_fwd", fwd_err, VIEW_SAMPLE_TOL, fwd_ms, fwd_dev_ms, plain_fwd_ms, lib_fwd_ms,
                 fwd_bytes),
                ("view_sample_bwd", bwd_err, VIEW_SAMPLE_GRAD_TOL, bwd_ms, bwd_dev_ms, plain_bwd_ms, lib_bwd_ms,
                 bwd_bytes)):
            rec = {
                "name": name,
                "route": "cuda",
                "source": "holo_diffusion_torch/csrc/view_sample.cu",
                "replaces": "none (the JAX package leaves the view sampling to XLA)",
                "max_abs_err" if name.endswith("fwd") else "max_rel_err": err,
                "ms": ms,
                "device_ms": dev_ms,
                "plain_ms": plain_ms,
                "bound_ms": 1e3 * n_bytes / PEAK_BYTES_PER_S,
                "bound_by": "bytes",
                "library_ms": lib_ms,
            }
            emit({"phase": "kernels", "case": case, **rec, "views": S, "points": N, "channels": F_,
                  "bytes": n_bytes, "tol": tol, "library": "torch.nn.functional.grid_sample, one call a map",
                  "library_max_abs_err": lib_err})
            if not err <= tol:
                raise AssertionError(f"{name} ({case}): error {err} > {tol}")
            if case == "hydrant":
                results[name] = rec
            else:
                results[name][case] = {k: v for k, v in rec.items() if k.endswith(("err", "ms"))}


# the hydrant UNet's calls the route sends to K9 in a no-grad forward at B = 1
HYDRANT_SMALL_CONVS = 51


def small_conv_kernel_phase(model, results):
    """K9 (`small_conv3d`) at every call the route takes in a no-grad
    forward of `model`'s UNet at B = 1 (hydrant: 51, at 1^3, 2^3 and 4^3
    output voxels), inputs from a seeded forward: each bitwise `F.conv3d`
    (cuDNN, TF32 off: K9 sums each output in the order of cuDNN's kernel
    for these shapes, and any other order lands about 1e-7 of scale away)
    and bitwise itself on a rerun; then, by level, the device ms of a
    launch (torch.profiler, the same call repeated, so the L2 cache holds
    what of its weights fits), the bound (`benchmark/counts/
    unet_small_convs`: the used taps' weights, bias, input and output at
    3.35 TB/s, or the in-bounds FLOPs at the float32 peak) and
    `F.conv3d`'s ms by CUDA events, which is both the plain version's and
    the library's."""
    import torch
    import torch.nn.functional as F

    from holo_diffusion_torch.models.unet3d import RoutedConv3d
    from holo_diffusion_torch.ops import small_conv3d as sc

    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(27)
    r, C = model.resol, model.feature_size
    x, t = torch.randn(1, r, r, r, C, generator=g, device=dev), torch.tensor([640], device=dev)
    calls = []

    def grab(conv, args):
        if sc.refusal(args[0].shape, args[0].device, args[0].dtype, conv) is None:
            calls.append((args[0].clone(), conv))

    hooks = [m.register_forward_pre_hook(grab) for m in model.net_3d.modules() if isinstance(m, RoutedConv3d)]
    try:
        with torch.no_grad():
            model.net_3d._forward(x, t)
    finally:
        for h in hooks:
            h.remove()
    if len(calls) != HYDRANT_SMALL_CONVS:
        raise AssertionError(f"small_conv3d: the route took {len(calls)} calls, expected {HYDRANT_SMALL_CONVS}")
    levels = {}
    with torch.no_grad():
        for i, (inp, conv) in enumerate(calls):
            k, stride = conv.kernel_size[0], conv.stride
            k9 = lambda: sc.small_conv3d(inp, conv.weight, conv.bias, stride)  # noqa: E731
            lib = lambda: F.conv3d(inp, conv.weight, conv.bias, stride, k // 2)  # noqa: E731
            got, again, want = k9(), k9(), lib()
            if not (torch.equal(got, want) and torch.equal(got, again)):
                raise AssertionError(f"small_conv3d call {i}: {float((got - want).abs().max())} from F.conv3d, "
                                     f"rerun bitwise {torch.equal(got, again)}")
            n_in, n_out = inp.shape[-1], got.shape[-1]
            cost = SmallConv(conv.in_channels, conv.out_channels, k, stride[0], n_in, n_out, inp.shape[0])
            lv = levels.setdefault(n_out, {"convs": 0, "ms": 0.0, "wrapper_ms": 0.0, "library_ms": 0.0,
                                           "bound_ms": 0.0, "bytes": 0, "gflop": 0.0})
            lv["convs"] += 1
            lv["ms"] += device_ms_per_launch(k9, "small_conv3d_kernel")
            lv["wrapper_ms"] += cuda_time_ms(k9)
            lv["library_ms"] += cuda_time_ms(lib)
            lv["bound_ms"] += 1e3 * cost.least_seconds(PEAK_F32_FLOPS, PEAK_BYTES_PER_S)
            lv["bytes"] += cost.bytes()
            lv["gflop"] += cost.flops() / 1e9
    step = {key: sum(lv[key] for lv in levels.values()) for key in ("ms", "library_ms", "bound_ms")}
    results["small_conv3d"] = {
        "name": "small_conv3d",
        "route": "cuda",
        "source": "holo_diffusion_torch/csrc/small_conv3d.cu",
        "replaces": "none (the JAX package leaves its convolutions to XLA)",
        "max_abs_err": 0.0,
        "ms": step["ms"] / len(calls),
        "plain_ms": step["library_ms"] / len(calls),
        "bound_ms": step["bound_ms"] / len(calls),
        "library_ms": step["library_ms"] / len(calls),
        "ms_a_forward": step["ms"],
        "library_ms_a_forward": step["library_ms"],
        "bound_ms_a_forward": step["bound_ms"],
    }
    for n_out, lv in sorted(levels.items()):
        n = lv["convs"]
        rec = {"name": "small_conv3d", "max_abs_err": 0.0, "ms": lv["ms"] / n, "plain_ms": lv["library_ms"] / n,
               "bound_ms": lv["bound_ms"] / n, "library_ms": lv["library_ms"] / n}
        emit({"phase": "kernels", "case": f"{n_out}^3", **rec, "route": "cuda", "convs": n,
              "wrapper_ms": lv["wrapper_ms"] / n, "ms_a_forward": lv["ms"], "library_ms_a_forward": lv["library_ms"],
              "bound_ms_a_forward": lv["bound_ms"], "bytes": lv["bytes"], "gflop": lv["gflop"], "bitwise": True,
              "library": "torch.nn.functional.conv3d (cuDNN, TF32 off)",
              "ms_below_library_ms": lv["ms"] < lv["library_ms"]})
        results["small_conv3d"][f"{n_out}^3"] = rec


def expect_small_conv_launches(counts, label, steps):
    """Fail unless the window of `counts` (`traced_launches`) launched K9
    exactly 51 times a UNet forward the card ran (each graph replay, each
    eager forward and each capture's warm-up; the capture itself runs
    nothing) and the chain's `steps` forwards were all counted."""
    forwards = counts.get("unet_graphed", 0) + counts.get("unet_eager", 0)
    if forwards != steps:
        raise AssertionError(f"{label}: {forwards} UNet forwards counted, expected {steps}")
    ran = forwards + counts.get("unet_graph_captures", 0)
    expect_launches(counts, label, exactly={"small_conv3d": HYDRANT_SMALL_CONVS * ran})


def sample_main_path(model, dev, conv_flops, n_convs):
    """The serving main path's sample: a 1000-step DDPM chain of `model`
    at B = 1 from a seeded generator, timed, beside the UNet's conv FLOPs
    a forward (`unet_conv_flops`, counted before the path's window: its
    forward runs with grad on) and their float32 bound; returns the grid."""
    import torch

    from holo_diffusion_torch.sampling import sample_random_voxel_features

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
    return v


def unfused_models(model, build_model, dev):
    """The hydrant model's weights in the unfused implicit function
    (fuse_decode="off"): sampler "fused"; collapse_density="on"; sampler
    "pallas"."""
    out = {}
    for label, sampler, extra in (("fused_sampler", "fused", {}), ("collapse", "fused", {"collapse_density": "on"}),
                                  ("pallas_sampler", "pallas", {})):
        m = build_model("hydrant", [f"{SAMPLER_KEY}={sampler}"], fuse_decode="off", **extra)
        m.load_state_dict(model.state_dict())
        out[label] = m.to(dev).eval()
    return out


class traced_launches:
    """The hand-written kernels the device runs from here to `counts()`,
    counted by name (`_build.traced_launch_counts`) in a torch.profiler
    trace of the device alone, with the program's chunk and UNet counters
    over the same window (`chunk_graph_captures`, `chunks_graphed`,
    `chunks_eager`, `unet_graph_captures`, `unet_graphed`, `unet_eager`,
    and the 3D convolutions' routes `conv3d_small`, `conv3d_cudnn`).
    A chunk graph's replay (render_eval.py) launches its kernels without a
    call into their wrappers, so the host's launch counters
    (`_build.launch_counts`) count a graphed frame's warm-ups and not its
    chunks; the trace counts every launch, the warm-ups' too
    (`graph_warmup_launches`). Wall times taken inside include the trace's
    cost."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        from holo_diffusion_torch.utils.profiling import reset_counters

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        reset_counters()

    def counts(self):
        import torch

        from holo_diffusion_torch.ops import _build
        from holo_diffusion_torch.utils.profiling import counters

        torch.cuda.synchronize()
        chunks = {k: n for k, n in counters().items() if k.startswith(("chunk", "unet_", "conv3d_"))}
        self.prof.stop()
        return {**_build.traced_launch_counts(e.name() for e in self.prof.profiler.kineto_results.events()
                                              if "CUDA" in str(e.device_type())), **chunks}


def graph_warmup_launches(counts, passes=2):
    """K3's launches in the chunk graphs' warm-ups of a `traced_launches`
    window: each capture first renders its chunk by its own launches, K3
    once a pass (hydrant's 2), and the capture itself launches nothing."""
    return passes * counts.get("chunk_graph_captures", 0)


def serve_unfused_phase(models, v, out_dir, dev, results):
    """The unfused serving main path on the sampled grid `v`: 2 poses with
    sampler "fused" (K4, normals by K6), 1 with collapse_density="on" (K4
    at C 257), 1 with sampler "pallas" (K7); none may launch K1/K2/K3."""
    import torch

    from holo_diffusion_torch.utils.flyaround import render_flyaround

    launches = traced_launches()
    for label, poses in (("fused_sampler", 2), ("collapse", 1), ("pallas_sampler", 1)):
        m = models[label]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_flyaround(m, os.path.join(out_dir, f"unfused_{label}"), n_flyaround_poses=poses,
                         voxel_features=v, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        emit({"phase": "serve_unfused", "variant": label, "poses": poses,
              "size": [m.render_image_height, m.render_image_width], "s_per_frame": dt / poses})
    counts = launches.counts()
    emit({"phase": "main_path", "path": "serve_unfused", "launches": counts})
    launched = ("kron_sample_fwd", "kron_sample_dpoints", "trilinear_sample_onehot")
    expect_launches(counts, "unfused serving", some=launched,
                    none=("fused_decode_fwd", "fused_decode_fwd_normals", "fused_decode_bwd", "kron_sample_dgrid"))
    for name in launched:
        results[name]["launches"] = counts[name]


def check_unfused_phase(model, unfused, v, dev):
    """The unfused model (sampler "fused") against the fused model of the
    same weights and grid, both on the card: the implicit functions on the
    same points (the coarse points of 640 rays of a 512^2 frame), and the
    whole 512^2 frame; then the unfused model on the card against the CPU
    at 48 px."""
    import torch

    from holo_diffusion_torch.ops import fused_decode as fd
    from holo_diffusion_torch.ops import kron_sample as ks
    from holo_diffusion_torch.render_eval import render_image_chunked
    from holo_diffusion_torch.utils.flyaround import CANONICAL_CO3D_UP_AXIS, simple_360_cameras

    cams = simple_360_cameras(2, up=CANONICAL_CO3D_UP_AXIS)
    tol = UNFUSED_VS_FUSED_TOL
    with torch.no_grad():
        bundle = model.full_grid_rays(cams[:1].to(dev))
        rays = bundle.slice_rays(slice(bundle.origins.shape[1] // 2, bundle.origins.shape[1] // 2 + 640))
        pts = rays.origins[..., None, :] + rays.directions[..., None, :] * rays.lengths[..., None]
        fused_out = model.implicit_function(v[0], pts, rays.directions)
        unfused_out = unfused.implicit_function(v[0], pts, rays.directions)
        same_points = {k: float((a - b).abs().max()) for k, a, b in zip(
            ("densities", "rgb"), fused_out[:2], unfused_out[:2])}
        # the normals' source, before normalising: K3's field-gradient lanes
        # against K6's field gradient
        mlp = model.implicit_function.render_mlp
        A, c = mlp.density_affine()
        Wr, br = mlp.radiance_linear()
        g1 = torch.einsum("dhwc,c->dhw", v[0], A[:, -1])
        pe = mlp.encode_dirs(rays.directions / rays.directions.norm(dim=-1, keepdim=True))
        k3 = fd.fused_sample_decode(v[0], A, c, Wr, br, pts, pe, model.volume_extent, mlp.dnet_hidden_dim, g1=g1)[2]
        k6 = ks.trilinear_point_gradient(g1[..., None], pts, model.volume_extent)
        grad_scale = float(k3.abs().max())
        same_points["field_gradient_rel"] = float((k3 - k6).abs().max()) / grad_scale

        a = render_image_chunked(unfused, cams[0], v[0], device=dev)
        b = render_image_chunked(model, cams[0], v[0], device=dev)
        frame = {}
        for k in b:
            diff = (a[k] - b[k]).abs().amax(dim=-1)
            frame[k] = {"max": float(diff.max()), "share_above_tol": float((diff > tol).float().mean()),
                        "p99_99": float(torch.quantile(diff.flatten().float(), 0.9999))}
        small = dict(image_height=48, image_width=48)
        c48 = render_image_chunked(unfused, cams[1], v[0], device=dev, **small)
        d48 = render_image_chunked(copy.deepcopy(unfused).cpu(), cams[1], v[0].cpu(), device="cpu", **small)
        vs_cpu = {k: float((c48[k].cpu() - d48[k]).abs().max()) for k in d48}
    finite = all(bool(torch.isfinite(x).all()) for x in a.values())
    emit({"phase": "check", "variant": "unfused", "same_points_vs_fused": same_points, "points": pts.numel() // 3,
          "frame_512px_vs_fused": frame, "card_vs_cpu_48px": vs_cpu, "finite": finite,
          "tol": {"vs_fused": tol, "frame_share": UNFUSED_FRAME_SHARE, "vs_cpu": RENDER_TOL}})
    if not finite or set(a) != set(b):
        raise AssertionError("unfused frame: non-finite values or other streams than the fused frame")
    if max(same_points.values()) > tol:
        raise AssertionError(f"unfused implicit function disagrees with the fused one: {same_points}")
    if any(frame[k]["max"] > tol for k in ("images_render", "masks_render")) or \
            any(f["share_above_tol"] > UNFUSED_FRAME_SHARE for f in frame.values()):
        raise AssertionError(f"unfused frame disagrees with the fused frame: {frame}")
    if max(vs_cpu.values()) > RENDER_TOL:
        raise AssertionError(f"unfused frame: card and CPU disagree: {vs_cpu}")


def profile_phase(model, unfused, v, dev, train_step_fn, unfused_train_step_fn):
    """Where the time goes: device time by kernel, and the device's idle
    share (1 - device busy / host wall time of an unprofiled run of the same
    work), over one 512^2 fly-around frame of the fused and of the unfused
    (sampler "fused") model, over 10 DDPM steps and over one hydrant
    training step of each (`train_step_fn`, `unfused_train_step_fn`), with
    the port's kernels' share of the busy time. Returns the device busy ms
    by window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from holo_diffusion_torch.render_eval import render_image_chunked
    from holo_diffusion_torch.sampling import sample_random_voxel_features
    from holo_diffusion_torch.utils.flyaround import simple_360_cameras

    cam = simple_360_cameras(1)
    busy = {}
    windows = {
        "render_frame": lambda: render_image_chunked(model, cam, v[0], device=dev),
        "render_frame_unfused": lambda: render_image_chunked(unfused, cam, v[0], device=dev),
        "ddpm_10_steps": lambda: sample_random_voxel_features(
            model, torch.Generator(device=dev).manual_seed(2), max_iter=10, device=dev),
        "train_step": train_step_fn,
        "train_step_unfused": unfused_train_step_fn,
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
            ((e.key, e.self_device_time_total / 1e3, e.count) for e in device_rows(prof)
             if e.self_device_time_total > 0),
            key=lambda r: -r[1],
        )
        busy_ms = sum(r[1] for r in rows)
        decode = {}
        for part in ("fused_decode_kernel", "fused_decode_bwd_kernel", "kron_sample_fwd_kernel",
                     "kron_sample_dgrid_kernel", "kron_sample_dpoints_kernel", "trilinear_sample_onehot_kernel"):
            ms = sum(r[1] for r in rows if part in r[0])
            if ms > 0:
                decode[part] = {"ms": ms, "count": sum(r[2] for r in rows if part in r[0]),
                                "share_of_busy": ms / busy_ms}
        emit({"phase": "profile", "window": label, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
              "idle_share": 1.0 - busy_ms / wall_ms, "device_launches": sum(r[2] for r in rows),
              "port_kernels": decode,
              "top": [{"kernel": k[:90], "ms": ms, "count": n} for k, ms, n in rows[:10]]})
        busy[label] = busy_ms
    return busy


def synthetic_batch(cfg, dev):
    """A synthetic batch of the config's size: 33 frames at 800^2."""
    from holo_diffusion_torch.data.synthetic import make_synthetic_scene

    data = cfg["data_source_ImplicitronDataSource_args"]
    n_frames = data["data_loader_map_provider_SequenceDataLoaderMapProvider_args"]["batch_size"]
    size = data["dataset_map_provider_JsonIndexDatasetMapProviderV2_args"]["dataset_JsonIndexDataset_args"]["image_height"]
    return make_synthetic_scene(n_views=n_frames, image_size=size, radius=2.0, dist=8.0, seed=0, device=dev)


def train_phase(model, cfg, batch, dev, label, steps):
    """Hydrant training at full width: the config's optimizer, one warm-up
    step, then `steps` timed steps of `make_train_step`: a training main
    path, with the launch counters zeroed right before it and read right
    after. Returns (a function that runs one more step, for the profile;
    the launch counts)."""
    import torch

    from holo_diffusion_torch.config import optimizer_args_from_config
    from holo_diffusion_torch.ops import _build
    from holo_diffusion_torch.parallel.train_step import TrainState, make_train_step
    from holo_diffusion_torch.train.optimizer import make_lr_schedule, make_optimizer

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

    _build.reset_launch_counts()
    secs, objectives = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        objectives.append(metrics["objective"].item())
        secs.append(time.perf_counter() - t0)
    counts = _build.launch_counts()
    changed = {n for n, p in model.named_parameters() if not torch.equal(p.detach(), before[n])}
    modules = {n.split(".")[0] for n, _ in model.named_parameters()}
    emit({"phase": "train", "variant": label, "frames": batch.image_rgb.shape[0],
          "image_size": batch.image_rgb.shape[1], "rays": 3 * model.n_rays_per_image,
          "params": sum(p.numel() for p in model.parameters()), "warmup_s": warm_s,
          "warmup_objective": warm_obj, "s_per_step": secs, "median_s_per_step": sorted(secs)[len(secs) // 2],
          "objectives": objectives, "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "params_changed": len(changed), "params_total": len(before), "lr": opt.optimizer.param_groups[0]["lr"],
          "launches": counts})
    emit({"phase": "main_path", "path": label, "launches": counts})
    if not all(math.isfinite(o) for o in objectives + [warm_obj]):
        raise AssertionError(f"{label}: non-finite training objective: {objectives}")
    if {n.split(".")[0] for n in changed} != modules:
        raise AssertionError(f"{label}: parameters of {sorted(modules - {n.split('.')[0] for n in changed})} "
                             "did not change")
    return (lambda: step(state, batch, gen)), counts


def expect_launches(counts, label, exactly=None, some=(), none=()):
    """Fail unless each kernel of `exactly` ({name: n}) was launched n times,
    each of `some` at least once and each of `none` never."""
    for name, n in (exactly or {}).items():
        if counts.get(name, 0) != n:
            raise AssertionError(f"kernel {name}: {counts.get(name, 0)} launches on the {label} path, expected {n}")
    for name in some:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {label} path")
    for name in none:
        if counts.get(name, 0) != 0:
            raise AssertionError(f"kernel {name} was launched on the {label} path")


def narrow_model_args(feature_size=32, **model_args):
    """A narrow model (C `feature_size`, UNet 32 channels, resnet18 stages
    1-2, 2 x 128 rays of 16 + 16 points, normals on) for card-vs-CPU checks."""
    return dict(
        resol=8, volume_extent=4.0, feature_size=feature_size, n_train_target_views=2, n_rays_per_image=128,
        n_pts_per_ray_training=16, n_pts_per_ray_fine_training=16, scene_extent=2.0, render_normals=True,
        net_3d_args=dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=(2,)),
        image_feature_extractor_args=dict(name_arch="resnet18", stages=(1, 2), proj_dim=8, image_rescale=0.5),
        view_pooler_args=dict(aggregator_class_type="MLPMeanFeatureAggregator",
                              aggregator_args=dict(n_hidden=32, dim_out=32)),
        render_mlp_args=dict(dnet_hidden_dim=64, rnet_hidden_dim=16), **model_args,
    )


def narrow_draws(rs, feature_size, timesteps=(400, 90), take_boot=True):
    """Every draw of one training step of `narrow_model_args`' model, from
    the numpy RandomState `rs`."""
    import numpy as np

    B, N, P, F = 2, 128, 16, 16
    return {
        "timesteps": np.array(timesteps), "take_boot": take_boot,
        "noise": rs.randn(1, 8, 8, 8, feature_size), "noise2": rs.randn(1, 8, 8, 8, feature_size),
        "ray_pixel_u": rs.rand(B, N), "ray_length_u": rs.rand(B, N, P), "density_noise_0": rs.randn(B, N, P),
        "refine_u_1": rs.rand(B, N, F), "density_noise_1": rs.randn(B, N, P + F),
    }


def warm_loss_history(T, H=10, seed=21):
    """A full (T, H) loss history, uneven across timesteps, from a seed."""
    import numpy as np

    rs = np.random.RandomState(seed)
    return (rs.rand(T, H) * np.linspace(0.2, 2.0, T)[:, None]).astype(np.float32)


def train_check_phase(dev, variant, feature_size=32, scene=None, loss_aware_ema=False, compact=False,
                      **model_args):
    """One training step of a narrow model (`narrow_model_args`; `model_args`
    such as fuse_decode="off") on the card and on the CPU with the same
    weights and the same injected draws, on `scene` (a CPU batch; 6
    synthetic views at 48 px when None): the objective and the gradients of
    the UNet's last conv, the pooled-feature mapper, the density net's first
    layer and the extractor's stem (each relative to its largest magnitude);
    then a 24 px frame of a random grid through the same model on both.
    With `loss_aware_ema` the step is `make_train_step`'s whole step
    instead: the loss-second-moment sampler from a warmed state, the EMA at
    rate 0.9 and two SGD steps in one call (the second on the scene's frames
    reversed, without the bootstrap pass); the gradients are the second
    step's, and the EMA's change and the sampler's state are held too.
    With `compact` the scene is compacted first (the model's
    `SourceCompactor`, native C++), and the step pools the host-resized
    sources. Returns the launch counts of the card's run."""
    import numpy as np
    import torch

    from holo_diffusion_torch.data.frame_data import FrameData
    from holo_diffusion_torch.data.synthetic import make_synthetic_scene
    from holo_diffusion_torch.models import diffusion as gd
    from holo_diffusion_torch.models.holo_model import HoloDiffusionModel
    from holo_diffusion_torch.ops import _build
    from holo_diffusion_torch.parallel.train_step import TrainState, make_train_step
    from holo_diffusion_torch.render_eval import render_image_chunked
    from holo_diffusion_torch.train.optimizer import make_optimizer
    from holo_diffusion_torch.utils.flyaround import simple_360_cameras
    from holo_diffusion_torch.weights import init_weights

    cpu_model = init_weights(HoloDiffusionModel(**narrow_model_args(feature_size, **model_args)), seed=1)
    card_model = copy.deepcopy(cpu_model).to(dev)
    if scene is None:
        scene = make_synthetic_scene(n_views=6, image_size=48, seed=2, device="cpu")
    if compact:
        from holo_diffusion_torch.data.compact import SourceCompactor

        scene = SourceCompactor.from_model(cpu_model)(scene)
    rs = np.random.RandomState(3)
    draws = narrow_draws(rs, feature_size)
    if loss_aware_ema:
        draws = [draws, narrow_draws(rs, feature_size, timesteps=(700, 5), take_boot=False)]
        scene = FrameData.stack_steps([scene, scene[torch.arange(scene.batch_size - 1, -1, -1)]])
        hist = warm_loss_history(cpu_model.schedule.num_timesteps)
        before = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}
    objs, states = {}, {}
    _build.reset_launch_counts()
    for label, m, b in (("card", card_model, scene.to(dev)), ("cpu", cpu_model, scene)):
        if loss_aware_ema:
            d = next(m.parameters()).device
            opt = make_optimizer(m.named_parameters(), breed="SGD", lr=0.05, momentum=0.0)
            sampler = gd.LossSecondMomentState(torch.from_numpy(hist).to(d), torch.full(
                (hist.shape[0],), hist.shape[1], dtype=torch.int64, device=d))
            step = make_train_step(m, opt, schedule_sampler="loss-second-moment", ema_rate=0.9, steps_per_call=2)
            states[label], metrics = step(TrainState.create(m, opt, sampler_state=sampler, ema=True), b, draws)
            objs[label] = metrics["objective"].item()
        else:
            preds = m(camera=b.camera, image_rgb=b.image_rgb, fg_probability=b.fg_probability,
                      mask_crop=b.mask_crop, depth_map=b.depth_map, training=True, draws=draws,
                      src_image_rgb=b.src_image_rgb, src_fg_probability=b.src_fg_probability,
                      src_mask_crop=b.src_mask_crop)
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
    extra, ok = {}, True
    if loss_aware_ema:
        # the EMA's change from the initial weights, relative to its scale,
        # above the rounding of float32 parameters
        ema_rel = {}
        for n in gated:
            got = states["card"].ema[n].cpu() - before[n]
            want = states["cpu"].ema[n] - before[n]
            floor = 2 * torch.finfo(torch.float32).eps * float(states["cpu"].ema[n].abs().max())
            ema_rel[n] = float((got - want).abs().max()) / max(float(want.abs().max()), floor / TRAIN_GRAD_TOL)
        sc, ss = states["card"].sampler_state, states["cpu"].sampler_state
        counts_equal = torch.equal(sc.loss_counts.cpu(), ss.loss_counts)
        hist_err = float((sc.loss_history.cpu() - ss.loss_history).abs().max())
        # step 0 credits both timesteps, step 1 (no bootstrap pass) its main one
        credited = sorted(np.nonzero((ss.loss_history.numpy() != hist).any(1))[0].tolist())
        extra = {"ema_change_rel_errs": ema_rel, "sampler_counts_equal": counts_equal,
                 "sampler_history_abs_err": hist_err, "sampler_on_card": sc.loss_history.device.type,
                 "credited_timesteps": credited}
        ok = (max(ema_rel.values()) <= TRAIN_GRAD_TOL and counts_equal and hist_err <= TRAIN_OBJ_TOL
              and sc.loss_history.device.type == torch.device(dev).type and credited == [90, 400, 700])
    grid = torch.tanh(torch.from_numpy(rs.randn(8, 8, 8, feature_size).astype(np.float32)))
    cam = simple_360_cameras(1, dist=6.0)
    with torch.no_grad():
        frame = render_image_chunked(card_model.eval(), cam, grid.to(dev), device=dev, image_height=24,
                                     image_width=24)
        want = render_image_chunked(cpu_model.eval(), cam, grid, device="cpu", image_height=24, image_width=24)
    counts = _build.launch_counts()
    render_err = {k: float((frame[k].cpu() - want[k]).abs().max()) for k in want}
    finite = all(bool(torch.isfinite(x).all()) for x in frame.values())
    emit({"phase": "check", "variant": variant, "channels": feature_size, "card_launches": counts,
          "objective": objs, "objective_abs_err": obj_err,
          "grad_rel_errs": {n: rel[n] for n in gated}, "worst_leaf_above_1e-6_of_largest_grad": [worst, rel[worst]],
          **extra, "render_24px_abs_err": render_err, "finite": finite,
          "tol": {"objective": TRAIN_OBJ_TOL, "grad_rel": TRAIN_GRAD_TOL, "render": RENDER_TOL}})
    if obj_err > TRAIN_OBJ_TOL or max(rel[n] for n in gated) > TRAIN_GRAD_TOL or not ok:
        raise AssertionError(f"{variant}: card and CPU disagree beyond tolerance")
    if not finite or set(frame) != set(want) or max(render_err.values()) > RENDER_TOL:
        raise AssertionError(f"{variant}: the 24 px frame is not finite or disagrees with the CPU: {render_err}")
    return counts


class _Records(logging.Handler):
    """Keeps the log records of one logger (the checkpoint module logs each
    save's bytes and seconds and each restore's seconds)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def read_png_rgb(path):
    """An (H, W, 3) uint8 frame from a PNG of `utils/video.py:write_png`
    (8-bit RGB, filter 0 on every row)."""
    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    pos, idat, size = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            size = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: a PNG row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def state_differences(a, b):
    """The names of whatever differs between TrainStates `a` and `b`,
    bitwise: the model's state_dict, Adam's moments and step counts, and
    the EMA and the sampler state where `a` holds them."""
    import torch

    sd_b = b.model.state_dict()
    differ = [k for k, v in a.model.state_dict().items() if not torch.equal(v, sd_b[k])]
    moments_a = a.optimizer.optimizer.state_dict()["state"]
    moments_b = b.optimizer.optimizer.state_dict()["state"]
    if not moments_a or set(moments_a) != set(moments_b):
        differ.append("adam state keys")
    differ += [f"adam {i} {n}" for i, m in moments_a.items() for n in ("exp_avg", "exp_avg_sq", "step")
               if i in moments_b and not torch.equal(m[n], moments_b[i][n])]
    if a.ema is not None:
        if b.ema is None or set(a.ema) != set(b.ema):
            differ.append("ema keys")
        else:
            differ += [f"ema {n}" for n, v in a.ema.items() if not torch.equal(v, b.ema[n])]
    if a.sampler_state is not None and not (
            b.sampler_state is not None
            and torch.equal(a.sampler_state.loss_history, b.sampler_state.loss_history)
            and torch.equal(a.sampler_state.loss_counts, b.sampler_state.loss_counts)):
        differ.append("sampler state")
    return differ


def train_loop_phase(here, dev, train_step_busy_ms, results):
    """The training loop at hydrant width through its entry points: run A
    (`Experiment(cfg).run(max_epochs=2)`), a new Experiment whose restored
    state must equal run A's final state bitwise, run B (`run(max_epochs=3)`,
    which must resume and run epoch 2 only), then `generate_samples_main
    exp_dir=...` from the checkpoint, whose frame must match the same grid
    rendered by run B's model. The launch counters are zeroed before run A
    and read after run B (the loop's main path), and again around sampling."""
    import numpy as np
    import torch

    from holo_diffusion_torch import cli
    from holo_diffusion_torch.config import load_config
    from holo_diffusion_torch.experiment import Experiment
    from holo_diffusion_torch.ops import fused_decode as fd
    from holo_diffusion_torch.ops import fused_render as fr
    from holo_diffusion_torch.ops import kron_sample as ks
    from holo_diffusion_torch.render_eval import render_image_chunked
    from holo_diffusion_torch.train.checkpoint import list_checkpoints, restore_checkpoint
    from holo_diffusion_torch.utils.flyaround import CANONICAL_CO3D_UP_AXIS, simple_360_cameras

    exp_dir = os.path.join(here, "build", "chip_smoke", "exp")
    shutil.rmtree(exp_dir, ignore_errors=True)
    ds = "data_source_ImplicitronDataSource_args."
    syn = ds + "dataset_map_provider_SyntheticDataProvider_args."
    dl = ds + "data_loader_map_provider_SequenceDataLoaderMapProvider_args."
    cfg = load_config("hydrant", [
        ds + "dataset_map_provider_class_type=SyntheticDataProvider",
        syn + "n_scenes=2", syn + "n_views_per_scene=33", syn + "image_size=800",
        dl + "batch_size=33", dl + "dataset_length_train=66", dl + "dataset_length_val=1",
        "disable_validation=false", "training_loop_ImplicitronTrainingLoop_args.visualize_interval=0",
        f"exp_dir={exp_dir}"])
    ck_log = logging.getLogger("holo_diffusion_torch.train.checkpoint")
    ck_log.setLevel(logging.INFO)
    records = _Records()
    ck_log.addHandler(records)

    launches = traced_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    exp_a = Experiment(cfg)
    state_a, stats_a = exp_a.run(max_epochs=2)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0

    # the state a resumed run starts from, before any step: bitwise run A's
    exp_b = Experiment(cfg)
    probe, epoch = restore_checkpoint(exp_dir, exp_b.init_state())
    if epoch != 1 or probe.step != 4 or probe.optimizer.steps != 4:
        raise AssertionError(f"restored epoch {epoch}, step {probe.step}, schedule {probe.optimizer.steps}")
    differ = state_differences(state_a, probe)
    n_moments = len(probe.optimizer.optimizer.state_dict()["state"])
    if differ:
        raise AssertionError(f"restored state differs from run A's: {differ[:5]}")
    del state_a, exp_a, probe
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    state_b, stats = exp_b.run(max_epochs=3)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    counts = launches.counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    model = state_b.model
    left = [e for e, _ in list_checkpoints(exp_dir)]
    if left != [2] or state_b.step != 6 or state_b.optimizer.steps != 6 or stats.epoch != 2:
        raise AssertionError(f"run B: checkpoints {left}, step {state_b.step}, "
                             f"schedule {state_b.optimizer.steps}, epoch {stats.epoch}")
    if [e["epoch"] for e in stats.history] != [0, 1, 2] or any("val" not in e for e in stats.history):
        raise AssertionError(f"stats history: {[sorted(e) for e in stats.history]}")
    steps = state_b.step
    frame_launches = model.num_passes * math.ceil(
        model.render_image_height * model.render_image_width
        / (model.chunk_size_grid // model.n_pts_per_ray_evaluation))
    emit({"phase": "main_path", "path": "train_loop", "launches": counts})
    expect_launches(counts, "training loop",
                    exactly={"fused_decode_bwd": 2 * steps,
                             "fused_decode_fwd_normals": 2 * steps + 3 * frame_launches
                             + graph_warmup_launches(counts, model.num_passes)},
                    none=("fused_decode_fwd", *ks.ENTRY_POINTS, *fr.ENTRY_POINTS))
    results["fused_decode_bwd"]["train_loop_launches"] = counts["fused_decode_bwd"]
    results["fused_decode_fwd_normals"]["train_loop_launches"] = counts["fused_decode_fwd_normals"]

    # serve from the checkpoint
    out_dir = os.path.join(here, "build", "chip_smoke", "serve_checkpoint")
    shutil.rmtree(out_dir, ignore_errors=True)
    launches = traced_launches()
    t0 = time.perf_counter()
    # at hydrant's 512^2 (the exp_dir= path defaults to the JAX CLI's 256^2)
    paths = cli.generate_samples_main([f"exp_dir={exp_dir}", "num_samples=1", "n_flyaround_poses=1",
                                       "render_size=[512,512]", "use_ddim=true", "max_iter=10",
                                       f"output_directory={out_dir}", "save_voxel_features=true"])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_counts = launches.counts()
    emit({"phase": "main_path", "path": "serve_checkpoint", "launches": serve_counts})
    expect_launches(serve_counts, "serving from the checkpoint",
                    exactly={"fused_decode_fwd_normals": frame_launches + graph_warmup_launches(serve_counts)},
                    none=("fused_decode_bwd", "fused_decode_fwd", *ks.ENTRY_POINTS, *fr.ENTRY_POINTS))
    grid = torch.from_numpy(np.load(os.path.join(out_dir, "sample_00000", "voxel_features.npy"))).to(dev)
    png = read_png_rgb(os.path.join(out_dir, "sample_00000", "images_render_frames", "frame_00000.png"))
    with torch.no_grad():
        cam = simple_360_cameras(1, up=CANONICAL_CO3D_UP_AXIS)
        frame = render_image_chunked(model.eval(), cam, grid[0], device=dev)["images_render"].cpu().numpy()
    finite = bool(np.isfinite(frame).all())
    in_range = finite and float(frame.min()) >= 0.0 and float(frame.max()) <= 1.0
    png_err = int(np.abs(png.astype(np.int32) - (frame * 255).astype(np.int32)).max()) if finite else None
    ck = {"saves": [{"bytes": r.args[1], "s": r.args[2]} for r in records.records if r.msg.startswith("saved")],
          "restores_s": [r.args[1] for r in records.records if r.msg.startswith("restored")]}
    ck_log.removeHandler(records)
    sec_per_it = [e["train"]["sec/it"] for e in stats.history]
    emit({"phase": "train_loop", "epochs": 3, "steps": steps, "frames": 33, "image_size": 800,
          "params": sum(p.numel() for p in model.parameters()), "adam_tensors": n_moments,
          "s_per_step_stats": sec_per_it, "run_wall_s": {"A_epochs_0_1": wall_a, "B_epoch_2": wall_b},
          "val_frame_s": [e["val"]["sec/it"] for e in stats.history],
          "train_loss_rgb_psnr": [e["train"]["loss_rgb_psnr"] for e in stats.history],
          "val_loss_rgb_psnr": [e["val"]["loss_rgb_psnr"] for e in stats.history],
          "checkpoint": ck, "max_memory_allocated_gib": peak_gib,
          "train_step_busy_ms_profile": train_step_busy_ms,
          "idle_share_steps": [1.0 - train_step_busy_ms / (1e3 * s) for s in sec_per_it],
          "serve_checkpoint": {"s": serve_s, "ddim_steps": 10, "streams": sorted(paths["sample_00000"]),
                               "frame_finite": finite, "frame_in_0_1": in_range, "png_vs_rerender_max": png_err}})
    if not in_range or png_err is None or png_err > 1:
        raise AssertionError(f"frame from the checkpoint: finite {finite}, in [0, 1] {in_range}, png {png_err}")
    if not all(math.isfinite(x) for e in stats.history for x in e["train"].values()):
        raise AssertionError("non-finite training metrics")
    if len(ck["saves"]) != 3 or len(ck["restores_s"]) != 3:
        raise AssertionError(f"checkpoint log: {ck}")


def frame_bytes(batch):
    """The bytes of every tensor of a FrameData, its cameras included."""
    import dataclasses

    tensors = [getattr(batch.camera, f.name) for f in dataclasses.fields(batch.camera)]
    tensors += [getattr(batch, f.name) for f in dataclasses.fields(batch)[1:] if getattr(batch, f.name) is not None]
    return sum(t.numel() * t.element_size() for t in tensors)


def same_bits(a, b):
    """Every tensor of FrameData `a` equals `b`'s, bitwise (on the host)."""
    import dataclasses

    import torch

    pairs = [(getattr(a.camera, f.name), getattr(b.camera, f.name)) for f in dataclasses.fields(a.camera)]
    pairs += [(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a)[1:]]
    return all((x is None and y is None) or (x is not None and y is not None and x.dtype == y.dtype
                                             and torch.equal(x.cpu(), y.cpu())) for x, y in pairs)


def co3d_phase(here, dev, results):
    """The hydrant training loop fed by CO3D-format data, through the port's
    own loader: a release-format tree from `data/synthetic_co3d.py` (2
    sequences x 36 frames at 900 x 1200, the last 2 of each for val); cold
    scene loads with hydrant's load arguments (800^2, box crop 0.4/0.3,
    depths, compact cache) and one 33-frame batch's pinned copy to the card
    (bitwise); `Experiment(cfg).run(max_epochs=2)` on `hydrant.yaml` with
    the CO3D provider (2 steps an epoch, a 512^2 validation frame an epoch:
    the main path, launch counters zeroed right before and read right
    after); one profiled step on a CO3D batch (idle share); 6 steps from a
    dataset that caches one scene, so a scene switch decodes cold (the
    loader's wait per step); one narrow step card vs CPU on a 6-frame
    uint8/float16 batch at 800^2."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from holo_diffusion_torch.config import data_source_args_from_config, load_config
    from holo_diffusion_torch.data import co3d
    from holo_diffusion_torch.data.source import AsyncLoader, epoch_loader
    from holo_diffusion_torch.data.synthetic_co3d import write_synthetic_co3d
    from holo_diffusion_torch.experiment import Experiment
    from holo_diffusion_torch.ops import fused_render as fr
    from holo_diffusion_torch.ops import kron_sample as ks
    from holo_diffusion_torch.parallel.train_step import make_train_step

    root = os.path.join(here, "build", "chip_smoke", "co3d")
    exp_dir = os.path.join(here, "build", "chip_smoke", "co3d_exp")
    for d in (root, exp_dir):
        shutil.rmtree(d, ignore_errors=True)
    n_seq, n_frames, n_val = 2, 36, 2
    t0 = time.perf_counter()
    write_synthetic_co3d(root, n_seq=n_seq, n_frames=n_frames, H=900, W=1200, seed=0, n_val_frames=n_val)
    write_s = time.perf_counter() - t0

    ds = "data_source_ImplicitronDataSource_args."
    prov = ds + "dataset_map_provider_JsonIndexDatasetMapProviderV2_args."
    dl = ds + "data_loader_map_provider_SequenceDataLoaderMapProvider_args."
    cfg = load_config("hydrant", [
        ds + "dataset_map_provider_class_type=JsonIndexDatasetMapProviderV2",
        prov + f"dataset_root={root}", prov + "category=synthball",
        dl + "dataset_length_train=66", dl + "dataset_length_val=1",
        "disable_validation=false", "training_loop_ImplicitronTrainingLoop_args.visualize_interval=0",
        f"exp_dir={exp_dir}"])
    data_args = data_source_args_from_config(cfg)
    batch_size = data_args["batch_size"]

    # ---- cold loads from an empty cache, one batch's pinned copy
    provider = co3d.CO3DDataProvider(**data_args)
    cold_s = []
    for i in range(len(provider.train)):
        t0 = time.perf_counter()
        provider.train.get_scene(i)
        cold_s.append(time.perf_counter() - t0)
    train_frames = n_frames - n_val
    batch = provider.train.sample_batch(np.random.RandomState(0), batch_size)
    nbytes = frame_bytes(batch)
    # the first pin allocates page-locked memory; the second reuses the
    # first's freed buffer, as the loader's steady state does
    pin_s, pinned = [], None
    for _ in range(2):
        pinned = None
        t0 = time.perf_counter()
        pinned = batch.pin_memory()
        pin_s.append(time.perf_counter() - t0)
    copy_ms, pageable_ms = [], []
    for src, out in ((pinned, copy_ms), (batch, pageable_ms)) * 3:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        on_card = src.to(dev, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    copy_bitwise = same_bits(on_card, batch) and on_card.device.type == "cuda"
    dtypes = {f: str(getattr(batch, f).dtype) for f in ("image_rgb", "fg_probability", "mask_crop", "depth_map")}
    del provider, pinned, on_card

    # ---- the training loop (the main path)
    exp = Experiment(cfg)
    init = {n: p.detach().clone() for n, p in exp.init_state().model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    launches = traced_launches()
    t0 = time.perf_counter()
    state, stats = exp.run(max_epochs=2)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launches.counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    emit({"phase": "main_path", "path": "train_co3d", "launches": counts})
    model = state.model
    steps = state.step
    frame_launches = model.num_passes * math.ceil(
        model.render_image_height * model.render_image_width
        / (model.chunk_size_grid // model.n_pts_per_ray_evaluation))
    expect_launches(counts, "CO3D training loop",
                    exactly={"fused_decode_bwd": 2 * steps,
                             "fused_decode_fwd_normals": 2 * steps + 2 * frame_launches
                             + graph_warmup_launches(counts, model.num_passes)},
                    none=("fused_decode_fwd", *ks.ENTRY_POINTS, *fr.ENTRY_POINTS))
    results["fused_decode_bwd"]["train_co3d_launches"] = counts["fused_decode_bwd"]
    results["fused_decode_fwd_normals"]["train_co3d_launches"] = counts["fused_decode_fwd_normals"]
    changed = {n.split(".")[0] for n, p in model.named_parameters() if not torch.equal(p.detach(), init[n])}
    unmoved = sorted({n.split(".")[0] for n in init} - changed)
    del init
    if steps != 4 or [e["epoch"] for e in stats.history] != [0, 1] or unmoved:
        raise AssertionError(f"CO3D loop: {steps} steps, history {stats.history}, unmoved {unmoved}")
    if not all(math.isfinite(x) for e in stats.history for s in ("train", "val") for x in e[s].values()):
        raise AssertionError(f"CO3D loop: non-finite metrics {stats.history}")

    # ---- one profiled step on a CO3D batch: the device's idle share
    step = make_train_step(model, state.optimizer)
    gen = torch.Generator(device=dev).manual_seed(5)
    b = exp._to_device(exp.data.train.sample_batch(np.random.RandomState(1), batch_size))
    model.train()
    state, _ = step(state, b, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, b, gen)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, b, gen)
        torch.cuda.synchronize()
    busy_ms = sum(e.self_device_time_total for e in device_rows(prof)) / 1e3
    del b

    # ---- a cache of one scene: every scene switch decodes cold
    cold_ds = co3d.CO3DDataProvider(**data_args, max_cached_scenes=1).train
    it = iter(AsyncLoader(epoch_loader(cold_ds, batch_size, 6, seed=123), transfer=exp._to_device))
    walls, waits, scenes = [], [], []
    for _ in range(6):
        t0 = time.perf_counter()
        b = next(it)
        t1 = time.perf_counter()
        state, _ = step(state, b, gen)
        scenes.append(int(b.sequence_id[0]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        waits.append(t1 - t0)
    for _ in it:  # the loader's thread ends
        pass
    del b, cold_ds

    # ---- card against CPU on CO3D dtypes: a narrow step on 6 frames at 800^2
    scene6 = exp.data.train.sample_batch(np.random.RandomState(2), 6)
    if scene6.image_rgb.dtype != torch.uint8 or scene6.depth_map.dtype != torch.float16:
        raise AssertionError(f"CO3D batch dtypes {scene6.image_rgb.dtype}, {scene6.depth_map.dtype}")
    small_bitwise = same_bits(scene6.pin_memory().to(dev, non_blocking=True), scene6)
    del exp, state, model, step
    gc.collect()
    torch.cuda.empty_cache()
    train_check_phase(dev, "train_co3d_card_vs_cpu", scene=scene6)

    hist = stats.history
    emit({"phase": "co3d",
          "tree": {"sequences": n_seq, "frames": n_seq * n_frames, "size": [900, 1200], "write_s": write_s,
                   "write_s_per_frame": write_s / (n_seq * n_frames)},
          "cold_load": {"s_per_scene": cold_s, "frames_per_scene": train_frames,
                        "frames_per_s": n_seq * train_frames / sum(cold_s),
                        "pool_width": co3d._decode_pool_width(data_args["num_workers"]),
                        "cpus_affinity": len(os.sched_getaffinity(0)), "cpu_count": os.cpu_count()},
          "batch": {"frames": batch_size, "dtypes": dtypes, "bytes": nbytes, "pin_s": pin_s,
                    "h2d_pinned_ms": copy_ms, "h2d_pageable_ms": pageable_ms,
                    "h2d_pinned_gb_per_s": nbytes / 1e6 / min(copy_ms), "bitwise_on_card": copy_bitwise,
                    "bitwise_on_card_6_frames": small_bitwise},
          "loop": {"epochs": 2, "steps": steps, "run_s": run_s, "s_per_step_stats": [e["train"]["sec/it"] for e in hist],
                   "val_frame_s": [e["val"]["sec/it"] for e in hist],
                   "train_loss_rgb_psnr": [e["train"]["loss_rgb_psnr"] for e in hist],
                   "val_loss_rgb_psnr": [e["val"]["loss_rgb_psnr"] for e in hist],
                   "max_memory_allocated_gib": peak_gib, "launches": counts},
          "profiled_step": {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms},
          "cold_cache": {"max_cached_scenes": 1, "scenes": scenes, "wall_s": walls, "wait_s": waits,
                         "mean_wall_s": sum(walls) / len(walls), "mean_wait_s": sum(waits) / len(waits)}})
    if not copy_bitwise or not small_bitwise:
        raise AssertionError("a CO3D batch on the card differs from the host batch")
    return [e["train"]["sec/it"] for e in hist]


def profiled_device_ms(fn, n):
    """(device busy ms per call, kernel launches per call) of `fn` over n
    calls, from torch.profiler; the device's idle gaps are not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = device_rows(prof)
    return sum(e.self_device_time_total for e in events) / 1e3 / n, sum(e.count for e in events) / n


def train_full_phase(here, dev, results, co3d_s_per_step):
    """The whole training step and its use at inference, at hydrant width on
    the CO3D tree the `co3d` phase wrote (build/chip_smoke/co3d, with its
    eval batches): `hydrant.yaml` with `ema_rate` 0.9999, the
    loss-second-moment sampler and 2 optimizer steps per dispatch. Run A
    (`Experiment(cfg).run(max_epochs=1)`: 2 dispatches, a 512^2 validation
    frame, a checkpoint); a new Experiment's restored state, bitwise run A's
    (model, Adam, EMA, sampler state); run B resumes for epoch 1 (the main
    path `train_full`: counters zeroed before run A, read after run B: K2
    twice an optimizer step, K3 twice a step and once a chunk of each
    validation frame, nothing else). Then the EMA update's and the sampler
    update's device time; a sampler warmed on the card from a seeded loss
    history, whose 20,000 draws follow its weights; `run_eval_only` through
    the EMA over the tree's eval batches at 800^2 (the main path
    `eval_only`: K3 twice a chunk of each target, nothing else);
    `generate_samples_main exp_dir=... use_ema=true`; and the narrow
    loss-aware + EMA step card vs CPU."""
    import torch

    from holo_diffusion_torch import cli
    from holo_diffusion_torch.config import load_config
    from holo_diffusion_torch.experiment import Experiment
    from holo_diffusion_torch.models import diffusion as gd
    from holo_diffusion_torch.ops import fused_render as fr
    from holo_diffusion_torch.ops import kron_sample as ks
    from holo_diffusion_torch.parallel.train_step import ts_validity_mask
    from holo_diffusion_torch.random_draws import Draws
    from holo_diffusion_torch.train.checkpoint import restore_checkpoint

    root = os.path.join(here, "build", "chip_smoke", "co3d")
    exp_dir = os.path.join(here, "build", "chip_smoke", "full_exp")
    shutil.rmtree(exp_dir, ignore_errors=True)
    ds = "data_source_ImplicitronDataSource_args."
    prov = ds + "dataset_map_provider_JsonIndexDatasetMapProviderV2_args."
    dl = ds + "data_loader_map_provider_SequenceDataLoaderMapProvider_args."
    k = 2
    cfg = load_config("hydrant", [
        ds + "dataset_map_provider_class_type=JsonIndexDatasetMapProviderV2",
        prov + f"dataset_root={root}", prov + "category=synthball",
        dl + "dataset_length_train=132", dl + "dataset_length_val=1",
        "disable_validation=false", "training_loop_ImplicitronTrainingLoop_args.visualize_interval=0",
        "ema_rate=0.9999", f"{HYDRANT_MODEL}.diffusion_args.schedule_sampler_type=loss-second-moment",
        f"steps_per_dispatch={k}", "eval_use_ema=true", f"exp_dir={exp_dir}"])
    ck_log = logging.getLogger("holo_diffusion_torch.train.checkpoint")
    ck_log.setLevel(logging.INFO)
    records = _Records()
    ck_log.addHandler(records)

    # ---- the main path: run A, a bitwise restore, run B
    launches = traced_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    exp_a = Experiment(cfg)
    state_a, _ = exp_a.run(max_epochs=1)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    exp_b = Experiment(cfg)
    probe, epoch = restore_checkpoint(exp_dir, exp_b.init_state())
    if epoch != 0 or probe.step != 2 * k or probe.optimizer.steps != 2 * k:
        raise AssertionError(f"restored epoch {epoch}, step {probe.step}, schedule {probe.optimizer.steps}")
    differ = state_differences(state_a, probe)
    n_ema = len(probe.ema)
    if differ or set(probe.ema) != {n for n, _ in probe.model.named_parameters()}:
        raise AssertionError(f"restored state differs from run A's: {differ[:5]}")
    del state_a, exp_a, probe
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    state, stats = exp_b.run(max_epochs=2)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    counts = launches.counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    emit({"phase": "main_path", "path": "train_full", "launches": counts})
    model = state.model
    steps = state.step
    frame_launches = model.num_passes * math.ceil(
        model.render_image_height * model.render_image_width
        / (model.chunk_size_grid // model.n_pts_per_ray_evaluation))
    expect_launches(counts, "full training loop",
                    exactly={"fused_decode_bwd": 2 * steps,
                             "fused_decode_fwd_normals": 2 * steps + 2 * frame_launches
                             + graph_warmup_launches(counts, model.num_passes)},
                    none=("fused_decode_fwd", *ks.ENTRY_POINTS, *fr.ENTRY_POINTS))
    results["fused_decode_bwd"]["train_full_launches"] = counts["fused_decode_bwd"]
    results["fused_decode_fwd_normals"]["train_full_launches"] = counts["fused_decode_fwd_normals"]
    credited = int(state.sampler_state.loss_counts.sum())
    ema_lags = sum(not torch.equal(p.detach(), state.ema[n]) for n, p in model.named_parameters())
    if steps != 4 * k or [e["epoch"] for e in stats.history] != [0, 1] or not steps <= credited <= 2 * steps:
        raise AssertionError(f"full loop: {steps} steps, history {stats.history}, {credited} credits")
    if state.sampler_state.loss_history.device.type != torch.device(dev).type or not ema_lags:
        raise AssertionError("the sampler state left the card, or the EMA equals the parameters")
    if not all(math.isfinite(x) for e in stats.history for s in ("train", "val") for x in e[s].values()):
        raise AssertionError(f"full loop: non-finite metrics {stats.history}")

    # ---- the EMA update and the sampler update, alone
    params = dict(model.named_parameters())
    ema_ms, ema_launches = profiled_device_ms(lambda: gd.update_ema(state.ema, params, 0.9999), 5)
    sched = model.schedule
    T = sched.num_timesteps
    ts = torch.tensor([T // 50, 9 * T // 10], device=dev)
    losses = torch.tensor([0.25, 0.25], device=dev)
    mask = ts_validity_mask(True)
    sampler_ms, sampler_launches = profiled_device_ms(
        lambda: gd.loss_aware_update(state.sampler_state, ts, losses, mask), 20)
    rays_per_chunk = model.chunk_size_grid // model.n_pts_per_ray_evaluation
    del state, exp_b, model, params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- a sampler warmed on the card from a seeded history, then drawn
    hist = warm_loss_history(T)
    H = hist.shape[1]
    t0 = time.perf_counter()
    warm = gd.loss_aware_update(gd.LossSecondMomentState.create(T, H, device=dev),
                                torch.arange(T, device=dev).repeat_interleave(H),
                                torch.from_numpy(hist.reshape(-1)).to(dev))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    n_draws, n_bins = 20000, (10 if T % 10 == 0 else T)
    drawn, weights = gd.loss_aware_sample_timesteps(
        sched, warm, n_draws, Draws(generator=torch.Generator(device=dev).manual_seed(7)))
    w = gd.loss_aware_weights(warm).double().cpu().numpy()
    freq = torch.bincount(drawn, minlength=T).double().cpu().numpy() / n_draws
    # over ten bins of T / 10 timesteps: on 1,000 single timesteps the
    # sampling noise of 20,000 draws alone is a total variation of ~0.09
    tv = 0.5 * float(abs(freq.reshape(n_bins, -1).sum(1) - w.reshape(n_bins, -1).sum(1)).sum())
    warm_ok = (torch.equal(warm.loss_history.cpu(), torch.from_numpy(hist))
               and bool((warm.loss_counts == H).all()) and bool(torch.isfinite(weights).all()))
    sampler_check = {"warm_s": warm_s, "history_bitwise": warm_ok, "draws": n_draws, "bins": n_bins,
                     "total_variation": tv, "weights_min_max": [float(weights.min()), float(weights.max())]}
    if not warm_ok or tv >= 0.02:
        raise AssertionError(f"the warmed sampler: {sampler_check}")

    # ---- evaluation through the EMA (the eval_only main path)
    launches = traced_launches()
    timings = {}
    t0 = time.perf_counter()
    exp_e = Experiment(cfg)
    res = exp_e.run_eval_only(timings=timings)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    n_targets = len(exp_e.data.eval_batches)
    eval_hw = [exp_e.data_args["image_height"], exp_e.data_args["image_width"]]
    del exp_e
    eval_counts = launches.counts()
    emit({"phase": "main_path", "path": "eval_only", "launches": eval_counts})
    chunks = math.ceil(eval_hw[0] * eval_hw[1] / rays_per_chunk)
    expect_launches(eval_counts, "evaluation",
                    exactly={"fused_decode_fwd_normals": res["n_evals"] * 2 * chunks
                             + graph_warmup_launches(eval_counts)},
                    none=("fused_decode_bwd", "fused_decode_fwd", *ks.ENTRY_POINTS, *fr.ENTRY_POINTS))
    results["fused_decode_fwd_normals"]["eval_only_launches"] = eval_counts["fused_decode_fwd_normals"]
    dumped = os.path.join(exp_dir, "eval_results_epoch_00000001.json")
    with open(dumped) as f:
        keys = sorted(json.load(f))
    overall = res["overall"]
    if (res["protocol"] != "eval_batches" or res["n_evals"] != n_targets or keys != sorted(res)
            or not all(math.isfinite(overall[m]) for m in ("psnr", "psnr_fg", "ssim", "mask_iou"))):
        raise AssertionError(f"eval_only: {res['protocol']}, {res['n_evals']} targets, {overall}, keys {keys}")

    # ---- sampling through the EMA from the checkpoint
    out_dir = os.path.join(here, "build", "chip_smoke", "serve_full")
    shutil.rmtree(out_dir, ignore_errors=True)
    launches = traced_launches()
    t0 = time.perf_counter()
    paths = cli.generate_samples_main([f"exp_dir={exp_dir}", "num_samples=1", "n_flyaround_poses=1",
                                       "render_size=[512,512]", "use_ddim=true", "max_iter=10", "use_ema=true",
                                       f"output_directory={out_dir}"])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_counts = launches.counts()
    expect_launches(serve_counts, "sampling through the EMA",
                    exactly={"fused_decode_fwd_normals": frame_launches + graph_warmup_launches(serve_counts)},
                    none=("fused_decode_bwd", "fused_decode_fwd", *ks.ENTRY_POINTS, *fr.ENTRY_POINTS))
    png = read_png_rgb(os.path.join(out_dir, "sample_00000", "images_render_frames", "frame_00000.png"))

    counts_check = train_check_phase(dev, "train_full_card_vs_cpu", loss_aware_ema=True)
    ck = {"saves": [{"bytes": r.args[1], "s": r.args[2]} for r in records.records if r.msg.startswith("saved")],
          "restores_s": [r.args[1] for r in records.records if r.msg.startswith("restored")]}
    ck_log.removeHandler(records)
    per_call = [e["train"]["sec/it"] for e in stats.history]
    emit({"phase": "train_full", "epochs": 2, "steps_per_dispatch": k, "optimizer_steps": steps,
          "ema_rate": 0.9999, "ema_tensors": n_ema, "schedule_sampler": "loss-second-moment",
          "s_per_dispatch_stats": per_call, "s_per_optimizer_step": [x / k for x in per_call],
          "co3d_s_per_step_same_run": co3d_s_per_step, "run_wall_s": {"A_epoch_0": wall_a, "B_epoch_1": wall_b},
          "val_frame_s": [e["val"]["sec/it"] for e in stats.history], "sampler_credits": credited,
          "ema_update": {"device_ms": ema_ms, "launches": ema_launches},
          "sampler_update": {"device_ms": sampler_ms, "launches": sampler_launches, "pairs": 2},
          "warm_sampler": sampler_check, "checkpoint": ck, "max_memory_allocated_gib": peak_gib,
          "eval_only": {"s": eval_s, "targets": res["n_evals"], "size": eval_hw, "protocol": res["protocol"],
                        "pool_s": timings["pool_s"], "render_s": timings["render_s"],
                        "metrics_s": timings["metrics_s"], "overall": overall, "json_keys": keys},
          "serve_ema": {"s": serve_s, "ddim_steps": 10, "streams": sorted(paths["sample_00000"]),
                        "frame_shape": list(png.shape)},
          "card_vs_cpu_launches": counts_check})
    if len(ck["saves"]) != 2 or len(ck["restores_s"]) < 3:
        raise AssertionError(f"checkpoint log: {ck}")


def psnr(a, b):
    """PSNR in dB between two images in [0, 1] (any array-likes)."""
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0.0 else -10.0 * math.log10(mse)


def timed(fn):
    """(result, seconds) of `fn()`, the card synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def flyaround_full_phase(here, dev, results):
    """The fly-around's modes and the reconstruction entry point at hydrant
    width (random weights from seed 0), on the CO3D tree the `co3d` phase
    wrote. Sample mode through `generate_samples_main config=hydrant`: a grid
    by 10 DDIM steps, 4 poses at 512^2 with the four streams (the main path
    `flyaround_sample`: K3 2 x 410 chunks a frame, nothing else); the same
    with `empty_space_skip` (`flyaround_skip`: one more K3 launch, the
    probe's 64^3 + 1 rays of one point) with the probe's time, the occupied
    share, s per frame with and without the skip on one grid, the PSNR
    between the two renders and the invariance gates on the card;
    progressive sampling (10 DDPM steps, 2 a pose, `flyaround_progressive`).
    Reconstruction: `unet_with_no_diffusion.yaml` trained 2 steps on the tree
    (`reconstruction_train`: K1 and K2 only), then
    `visualize_reconstruction_main` renders 2 sequences x 4 poses at 256^2
    along a fitted circle and 1 sequence along a trefoil knot, and one
    512^2 frame through the forward (`reconstruction`: K1 twice a frame,
    no K2). The three shaded-depth methods on one rendered 128^2 depth,
    each against the CPU on the same depth; one 512^2 frame with stratified
    evaluation sampling."""
    import numpy as np
    import torch

    from holo_diffusion_torch import cli
    from holo_diffusion_torch.config import load_config
    from holo_diffusion_torch.experiment import Experiment
    from holo_diffusion_torch.ops import _build
    from holo_diffusion_torch.ops import fused_render as fr
    from holo_diffusion_torch.ops import kron_sample as ks
    from holo_diffusion_torch.ops.occupancy import tighten_ray_bundle
    from holo_diffusion_torch.render_eval import compute_occupancy, render_image_chunked
    from holo_diffusion_torch.utils.checkpoint_utils import load_experiment
    from holo_diffusion_torch.utils.flyaround import CANONICAL_CO3D_UP_AXIS, simple_360_cameras
    from holo_diffusion_torch.utils.shaded_depth import depth_to_shaded
    from holo_diffusion_torch.weights import init_weights

    out_root = os.path.join(here, "build", "chip_smoke", "flyaround")
    shutil.rmtree(out_root, ignore_errors=True)
    others = ("fused_decode_bwd", *ks.ENTRY_POINTS, *fr.ENTRY_POINTS)
    poses, size = 4, 512
    frame_launches = 2 * math.ceil(size * size / (40960 // 64))
    sample_args = ["config=hydrant", "seed=0", "num_samples=1", f"n_flyaround_poses={poses}",
                   f"render_size=[{size},{size}]"]
    streams = ["depths_render", "images_render", "masks_render", "shaded_depth_render"]
    report = {}

    # ---- sample mode, then the same with the skip, then progressive
    for label, extra, steps in (("flyaround_sample", ["use_ddim=true", "max_iter=10", "save_voxel_features=true"], 10),
                                ("flyaround_skip", ["use_ddim=true", "max_iter=10", "empty_space_skip=true"], 10),
                                ("flyaround_progressive", ["max_iter=10", "progressive_sampling_steps_per_render=2"],
                                 1 + 2 * (poses - 1))):
        out_dir = os.path.join(out_root, label)
        launches = traced_launches()
        torch.cuda.reset_peak_memory_stats()
        paths, wall = timed(lambda: cli.generate_samples_main([*sample_args, *extra, f"output_directory={out_dir}"]))
        counts = launches.counts()
        emit({"phase": "main_path", "path": label, "launches": counts})
        k3 = poses * frame_launches + (1 if label == "flyaround_skip" else 0)
        expect_launches(counts, label, exactly={"fused_decode_fwd_normals": k3 + graph_warmup_launches(counts)},
                        none=("fused_decode_fwd", *others))
        got = sorted(paths["sample_00000"])
        frames = [read_png_rgb(os.path.join(out_dir, "sample_00000", f"{s}_frames", f"frame_{i:05d}.png"))
                  for s in streams for i in range(poses)]
        if got != streams or any(f.shape != (size, size, 3) for f in frames):
            raise AssertionError(f"{label}: streams {got}, frames {[f.shape for f in frames]}")
        report[label] = {"s": wall, "unet_steps": steps, "poses": poses, "k3_launches": counts["fused_decode_fwd_normals"],
                         "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    results["fused_decode_fwd_normals"]["flyaround_launches"] = sum(
        report[p]["k3_launches"] for p in ("flyaround_sample", "flyaround_skip", "flyaround_progressive"))

    # ---- the skip on one grid: probe, occupied share, s per frame, PSNR, gates
    model = cli.build_model("hydrant", render_size=(size, size))
    init_weights(model, 0)
    model.to(dev).eval()
    grid = torch.from_numpy(np.load(os.path.join(out_root, "flyaround_sample", "sample_00000",
                                                 "voxel_features.npy")))[0].to(dev)
    cams = simple_360_cameras(poses, up=CANONICAL_CO3D_UP_AXIS)
    with torch.no_grad():
        compute_occupancy(model, grid)  # warm-up
        probe_s = [timed(lambda: compute_occupancy(model, grid))[1] for _ in range(3)]
        occ, outside = compute_occupancy(model, grid)
        dense, dense_s = zip(*(timed(lambda c=cams[i]: render_image_chunked(model, c, grid, device=dev))
                               for i in range(2)))
        skip, skip_s = zip(*(timed(lambda c=cams[i]: render_image_chunked(model, c, grid, device=dev,
                                                                           occupancy=(occ, outside)))
                             for i in range(2)))
        skip_psnr = [psnr(a["images_render"].cpu(), b["images_render"].cpu()) for a, b in zip(dense, skip)]
        gates = {}
        r = occ.shape[0]
        for name, o in (("all_occupied", (torch.ones((r,) * 3, dtype=torch.bool, device=dev),
                                          torch.tensor(True, device=dev))),
                        ("no_hit", (torch.zeros((r,) * 3, dtype=torch.bool, device=dev),
                                    torch.tensor(False, device=dev)))):
            g = render_image_chunked(model, cams[0], grid, device=dev, occupancy=o)
            gates[name] = {k: float((g[k] - dense[0][k]).abs().max()) for k in ("images_render", "depths_render")}
        # the share of rays whose last sample, which the raymarcher gives the
        # background interval, lies in positive density: dense and tightened
        bundle = model.full_grid_rays(cams[0].to(dev), size, size)
        last_in_density = {}
        for name, b in (("dense", bundle), ("skip", tighten_ray_bundle(bundle, occ, model.volume_extent,
                                                                       outside_occupied=outside))):
            last = b.origins + b.lengths[..., -1:] * b.directions
            last_in_density[name] = float((model.query_density(grid, last) > 0).float().mean())
    report["skip"] = {"probe_points": r ** 3 + 1, "probe_ms": [1e3 * s for s in probe_s],
                      "occupied_share": float(occ.float().mean()), "outside_occupied": bool(outside),
                      "dense_s_per_frame": list(dense_s), "skip_s_per_frame": list(skip_s),
                      "psnr_skip_vs_dense_db": skip_psnr, "gates_max_abs": gates,
                      "last_sample_in_density_share": last_in_density}
    if any(v["images_render"] > 1e-4 or v["depths_render"] > 1e-3 for v in gates.values()):
        raise AssertionError(f"empty-space skip invariance gates on the card: {gates}")

    # ---- stratified evaluation sampling: one 512^2 frame through the forward
    strat = cli.build_model("hydrant", [f"{HYDRANT_MODEL}.raysampler_AdaptiveRaySampler_args."
                                        "stratified_point_sampling_evaluation=true"], render_size=(size, size))
    strat.load_state_dict(model.state_dict())
    strat.to(dev).eval()
    _build.reset_launch_counts()
    with torch.no_grad():
        gen = torch.Generator(device=dev).manual_seed(0)
        strat_out, strat_s = timed(lambda: strat(cams[0].to(dev), voxel_features=grid[None], draws=gen))
        plain_out = strat(cams[0].to(dev), voxel_features=grid[None])
    strat_counts = _build.launch_counts()
    strat_img = strat_out["images_render"][0]
    report["stratified_eval"] = {"s": strat_s, "psnr_vs_unstratified_db": psnr(strat_img.cpu(),
                                                                               plain_out["images_render"][0].cpu()),
                                 "k3_launches": strat_counts["fused_decode_fwd_normals"]}
    if not bool(torch.isfinite(strat_img).all()) or strat_counts["fused_decode_fwd_normals"] != 4:
        raise AssertionError(f"stratified evaluation frame: {report['stratified_eval']}")

    # ---- the three shaded-depth methods on one rendered 128^2 depth
    nonorm = cli.build_model("hydrant", [f"{HYDRANT_MODEL}.implicit_function_HoloVoxelGridImplicitFunction_args."
                                         "render_normals=false"])
    nonorm.load_state_dict(model.state_dict())
    nonorm.to(dev).eval()
    with torch.no_grad():
        small = render_image_chunked(nonorm, cams[1], grid, image_height=128, image_width=128, device=dev)
    depth, mask = small["depths_render"][..., 0], small["masks_render"][..., 0]
    cam = cams[1]
    shaded = {"mask_share": float((mask > 0.5).float().mean())}
    for method in ("gradient", "pointcloud", "mesh"):
        depth_to_shaded(depth, mask, cam, method=method)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        on_card, s = timed(lambda: depth_to_shaded(depth, mask, cam, method=method))
        # above what the models and the grid hold
        peak = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
        on_cpu = depth_to_shaded(depth.cpu(), mask.cpu(), cam, method=method)
        err = (on_card.cpu() - on_cpu).abs().amax(dim=-1)
        share = float((err > SHADED_TOL[method]).float().mean())
        shaded[method] = {"s_per_frame": s, "peak_added_gib": peak, "max_abs_err": float(err.max()),
                          "share_above_tol": share, "tol": SHADED_TOL[method]}
        if not bool(torch.isfinite(on_card).all()) or share > SHADED_SHARE:
            raise AssertionError(f"shaded depth {method}, card vs CPU: {shaded[method]}")
    report["shaded_depth_128"] = shaded
    del model, strat, nonorm, grid
    gc.collect()
    torch.cuda.empty_cache()

    # ---- reconstruction: train unet_with_no_diffusion 2 steps, then visualize
    root = os.path.join(here, "build", "chip_smoke", "co3d")
    exp_dir = os.path.join(here, "build", "chip_smoke", "recon_exp")
    shutil.rmtree(exp_dir, ignore_errors=True)
    ds = "data_source_ImplicitronDataSource_args."
    prov = ds + "dataset_map_provider_JsonIndexDatasetMapProviderV2_args."
    dl = ds + "data_loader_map_provider_SequenceDataLoaderMapProvider_args."
    cfg = load_config("unet_with_no_diffusion", [
        prov + f"dataset_root={root}", prov + "category=synthball", dl + "dataset_length_train=32",
        f"exp_dir={exp_dir}"])
    _build.reset_launch_counts()
    (state, _), train_s = timed(lambda: Experiment(cfg).run(max_epochs=1))
    train_counts = _build.launch_counts()
    emit({"phase": "main_path", "path": "reconstruction_train", "launches": train_counts})
    if state.step != 2:
        raise AssertionError(f"reconstruction training: {state.step} steps, expected 2")
    expect_launches(train_counts, "reconstruction training", exactly={"fused_decode_bwd": 2 * state.step},
                    some=("fused_decode_fwd",), none=("fused_decode_fwd_normals", *ks.ENTRY_POINTS, *fr.ENTRY_POINTS))
    # the CLI logs each sequence's paths when it is done: its time
    rec_log = logging.getLogger()
    rec_level = rec_log.level
    rec_log.setLevel(logging.INFO)
    records = _Records()
    rec_log.addHandler(records)
    _build.reset_launch_counts()
    runs = {}
    for label, extra, n_seq, n_poses, hw in (
            ("circular_lsq_fit", ["n_eval_sequences=2"], 2, poses, 256),
            ("trefoil_knot", ["n_eval_sequences=1", "trajectory_type=trefoil_knot"], 1, poses, 256),
            ("forward_512", ["n_eval_sequences=1", "render_size=[512,512]", "n_flyaround_poses=1"], 1, 1, 512)):
        out_dir = os.path.join(out_root, f"recon_{label}")
        del records.records[:]
        torch.cuda.reset_peak_memory_stats()
        t0, t0_epoch = time.perf_counter(), time.time()
        paths = cli.visualize_reconstruction_main([f"exp_dir={exp_dir}", f"n_flyaround_poses={n_poses}",
                                                   *extra, f"output_directory={out_dir}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        done = [r.created for r in records.records
                if isinstance(r.args, tuple) and r.args and str(r.args[0]).startswith("sequence_")]
        # the first sequence's time includes loading the checkpoint
        per_seq = [b - a for a, b in zip([t0_epoch, *done[:-1]], done)]
        frames = [read_png_rgb(os.path.join(out_dir, s, f"{k}_frames", f"frame_{i:05d}.png"))
                  for s in paths for k in streams for i in range(n_poses)]
        if sorted(paths) != [f"sequence_{i:03d}" for i in range(n_seq)] or any(
                sorted(p) != streams for p in paths.values()) or any(f.shape != (hw, hw, 3) for f in frames):
            raise AssertionError(f"reconstruction {label}: {paths}")
        runs[label] = {"s": wall, "s_per_sequence": per_seq, "sequences": n_seq, "poses": n_poses, "size": hw,
                       "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                       "mask_mean": float(np.mean([f.mean() / 255 for f in frames[2 * n_poses:3 * n_poses]]))}
    rec_log.removeHandler(records)
    rec_log.setLevel(rec_level)
    rec_counts = _build.launch_counts()
    emit({"phase": "main_path", "path": "reconstruction", "launches": rec_counts})
    n_frames = sum(r["sequences"] * r["poses"] for r in runs.values())
    expect_launches(rec_counts, "reconstruction", exactly={"fused_decode_fwd": 2 * n_frames},
                    none=("fused_decode_fwd_normals", *others))
    results["fused_decode_fwd"]["reconstruction_launches"] = rec_counts["fused_decode_fwd"]
    results["fused_decode_fwd"]["reconstruction_train_launches"] = train_counts["fused_decode_fwd"]
    results["fused_decode_bwd"]["reconstruction_train_launches"] = train_counts["fused_decode_bwd"]
    # the 512^2 forward's own memory, above the restored state's
    del state
    gc.collect()
    torch.cuda.empty_cache()
    recon = load_experiment(exp_dir, render_size=(size, size))[1].model.eval()
    v = torch.tanh(torch.randn((1, 16, 16, 16, 64), generator=torch.Generator().manual_seed(0))).to(dev)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    with torch.no_grad():
        _, fwd_s = timed(lambda: recon(cams[0].to(dev), voxel_features=v))
    fwd_gib = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
    report["reconstruction"] = {"train_s": train_s, "train_steps": train_counts["fused_decode_bwd"] // 2,
                                "k2_launches": train_counts["fused_decode_bwd"], "runs": runs,
                                "forward_512": {"s": fwd_s, "peak_added_gib": fwd_gib}}
    emit({"phase": "flyaround_full", **report})


def conv2d_flops(model, fn):
    """2 x multiply-adds of `model`'s 2D convolutions in one call of `fn`,
    counted from the shapes they see (forward hooks); as for the UNet, the
    convolutions are nearly all of the extractors' arithmetic."""
    import torch

    flops = []

    def hook(mod, inputs, out):
        o, i, kh, kw = mod.weight.shape
        flops.append(2 * out.numel() * i * kh * kw)

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        fn()
    for h in handles:
        h.remove()
    return sum(flops)


def quality_phase(here, dev, results):
    """Sample quality and the loop's outputs at hydrant width. On
    `train_full`'s EMA checkpoint (build/chip_smoke/full_exp, the CO3D tree
    under build/chip_smoke/co3d): `evaluate_samples_main num_samples=2
    poses_per_sample=4 max_iter=10 use_ema=true` at 512^2 with each of the
    four extractors, `inception` and `vgg` reading random torchvision- /
    pytorch-fid-layout weights this phase writes (the main path
    `sample_eval_<extractor>`: K3 twice a frame, 16 in all, nothing else);
    the extractors and LPIPS on the card against the CPU, and their ms per
    image against a float32 bound from their conv FLOPs; `run_eval_only`
    with `lpips_vgg_weights_path` over the tree's eval batches (`lpips_eval`:
    K3 twice a chunk of each 800^2 target). Then `Experiment.run` on
    synthetic scenes, 1 epoch of 2 steps with validation, visualizations,
    the denoising video (a 250-step schedule, cut from hydrant's 1000 to
    keep the script's time; a 512^2 chunked frame every 50 steps) and the
    profiler on (`vis_loop`: K2 twice a step, K3 twice a step and
    820 times a validation or video frame), and the files it leaves."""
    import importlib.util

    import numpy as np
    import torch

    from holo_diffusion_torch import cli
    from holo_diffusion_torch.config import load_config
    from holo_diffusion_torch.evaluation_fid import inception_pooled_feature_fn, vgg_pooled_feature_fn
    from holo_diffusion_torch.experiment import Experiment
    from holo_diffusion_torch.models.inception import FIDInceptionV3, random_inception
    from holo_diffusion_torch.models.lpips import load_lpips_model, make_lpips_fn, random_vgg_features
    from holo_diffusion_torch.ops import _build
    from holo_diffusion_torch.ops import fused_render as fr
    from holo_diffusion_torch.ops import kron_sample as ks
    from holo_diffusion_torch.utils.vis import write_dashboard_html

    full_exp = os.path.join(here, "build", "chip_smoke", "full_exp")
    out = os.path.join(here, "build", "chip_smoke", "quality")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    others = ("fused_decode_fwd", "fused_decode_bwd", *ks.ENTRY_POINTS, *fr.ENTRY_POINTS)

    # ---- random weights in the published files' layouts
    inc_path = os.path.join(out, "pt_inception_random.pth")
    vgg_path = os.path.join(out, "vgg16_random.pth")
    torch.save(random_inception(1).state_dict(), inc_path)
    torch.save({f"features.{k}": v for k, v in random_vgg_features(1).state_dict().items()}, vgg_path)

    # ---- FID/KID of 2 samples x 4 poses through the CLI, each extractor
    runs = {}
    for extractor in ("random_inception", "random_vgg", "inception", "vgg"):
        args = [f"exp_dir={full_exp}", "num_samples=2", "poses_per_sample=4", "max_iter=10", "use_ema=true",
                f"extractor={extractor}", f"dump_path={os.path.join(out, extractor + '.json')}"]
        if extractor in ("inception", "vgg"):
            args.append(f"weights_path={inc_path if extractor == 'inception' else vgg_path}")
        launches = traced_launches()
        timings = {}
        res, wall = timed(lambda: cli.evaluate_samples_main(args, timings=timings))
        counts = launches.counts()
        emit({"phase": "main_path", "path": f"sample_eval_{extractor}", "launches": counts})
        expect_launches(counts, f"sample evaluation ({extractor})",
                        exactly={"fused_decode_fwd_normals": 2 * 2 * 4 + graph_warmup_launches(counts)},
                        none=others)
        scores = [res[f"{extractor}_{k}"] for k in ("fid", "kid_mean", "kid_std")]
        if (not all(math.isfinite(x) for x in scores) or res["n_generated"] != 8
                or res["comparable_to_inception_fid"] is not (extractor == "inception")):
            raise AssertionError(f"sample evaluation ({extractor}): {res}")
        runs[extractor] = {"s": wall, **timings, "fid": scores[0], "kid_mean": scores[1], "kid_std": scores[2],
                           "n_generated": res["n_generated"], "n_real": res["n_real"],
                           "k3_launches": counts["fused_decode_fwd_normals"]}
        gc.collect()
        torch.cuda.empty_cache()
    results["fused_decode_fwd_normals"]["sample_eval_launches"] = runs["inception"]["k3_launches"]
    emit({"phase": "quality", "item": "sample_eval", "samples": 2, "poses": 4, "ddpm_steps": 10, "runs": runs})

    # ---- the extractors and LPIPS: card against CPU, then time and bound
    rs = np.random.RandomState(11)
    x512 = rs.rand(2, 512, 512, 3).astype(np.float32)
    a800 = rs.rand(800, 800, 3).astype(np.float32)
    b800 = np.clip(a800 + 0.1 * rs.randn(800, 800, 3), 0, 1).astype(np.float32)
    inc_cpu = FIDInceptionV3()
    inc_cpu.load_state_dict(torch.load(inc_path, weights_only=True))
    inc_card = copy.deepcopy(inc_cpu).to(dev).eval()
    vgg_cpu = random_vgg_features(1)
    vgg_card = copy.deepcopy(vgg_cpu).to(dev).eval()
    lp_cpu = load_lpips_model(vgg_path)
    lp_card = copy.deepcopy(lp_cpu)
    want = inception_pooled_feature_fn(inc_cpu)(x512)
    got = inception_pooled_feature_fn(inc_card)(x512)
    inc_err = float(np.abs(got - want).max())
    inc_ok = bool(np.allclose(got, want, atol=QUALITY_TOL["inception"], rtol=QUALITY_TOL["inception"]))
    want = vgg_pooled_feature_fn(vgg_cpu)(x512)
    got = vgg_pooled_feature_fn(vgg_card)(x512)
    vgg_rel = float(np.abs(got - want).max() / np.abs(want).max())
    lp_want = make_lpips_fn(lp_cpu, "cpu")(a800, b800)
    lp_got = make_lpips_fn(lp_card, dev)(a800, b800)
    lp_rel = abs(lp_got - lp_want) / abs(lp_want)
    check = {"inception_512_b2": {"max_abs_err": inc_err, "ok": inc_ok},
             "vgg_512_b2": {"max_err_of_scale": vgg_rel}, "lpips_800": {"card": lp_got, "cpu": lp_want, "rel": lp_rel},
             "tol": QUALITY_TOL}
    emit({"phase": "check", "variant": "quality_card_vs_cpu", **check})
    if not inc_ok or vgg_rel > QUALITY_TOL["vgg"] or lp_rel > QUALITY_TOL["lpips"]:
        raise AssertionError(f"extractors: card and CPU disagree beyond tolerance: {check}")
    del inc_cpu, vgg_cpu, lp_cpu
    x299 = torch.rand((32, 299, 299, 3), generator=torch.Generator().manual_seed(12)).to(dev)
    x512 = torch.from_numpy(rs.rand(8, 512, 512, 3).astype(np.float32)).to(dev).permute(0, 3, 1, 2).contiguous()
    ta = torch.from_numpy(a800).to(dev)[None]
    tb = torch.from_numpy(b800).to(dev)[None]
    with torch.no_grad():
        timing = {
            "inception_b32_299": (32, conv2d_flops(inc_card, lambda: inc_card(x299)),
                                  cuda_time_ms(lambda: inc_card(x299), iters=5)),
            "vgg_relu5_3_b8_512": (8, conv2d_flops(vgg_card, lambda: vgg_card.taps_nchw(x512)),
                                   cuda_time_ms(lambda: vgg_card.taps_nchw(x512), iters=5)),
            "lpips_800_pair": (1, conv2d_flops(lp_card, lambda: lp_card(ta, tb)),
                               cuda_time_ms(lambda: lp_card(ta, tb), iters=5)),
        }
    emit({"phase": "quality", "item": "extractors", "gpu_ms": {k: {"ms_per_image" if n > 1 else "ms_per_pair": ms / n, "batch": n,
                                "conv_gflop_per_call": flops / 1e9,
                                "f32_bound_ms_per_image" if n > 1 else "f32_bound_ms_per_pair":
                                    1e3 * flops / PEAK_F32_FLOPS / n,
                                "share_of_bound": 1e3 * flops / PEAK_F32_FLOPS / ms}
                                  for k, (n, flops, ms) in timing.items()}})
    del inc_card, vgg_card, lp_card, x299, x512, ta, tb
    gc.collect()
    torch.cuda.empty_cache()

    # ---- LPIPS in the evaluation, over the tree's eval batches
    cfg = load_config(os.path.join(full_exp, "expconfig.yaml"), [f"lpips_vgg_weights_path={vgg_path}"])
    launches = traced_launches()
    timings = {}
    exp = Experiment(cfg)
    res, eval_s = timed(lambda: exp.run_eval_only(timings=timings))
    n_targets = len(exp.data.eval_batches)
    hw = (exp.data_args["image_height"], exp.data_args["image_width"])
    model = exp.model
    chunks = math.ceil(hw[0] * hw[1] / (model.chunk_size_grid // model.n_pts_per_ray_evaluation))
    del exp, model
    counts = launches.counts()
    emit({"phase": "main_path", "path": "lpips_eval", "launches": counts})
    expect_launches(counts, "evaluation with LPIPS",
                    exactly={"fused_decode_fwd_normals": 2 * chunks * n_targets + graph_warmup_launches(counts)},
                    none=others)
    results["fused_decode_fwd_normals"]["lpips_eval_launches"] = counts["fused_decode_fwd_normals"]
    lpips = [r["lpips"] for r in res["records"]]
    if len(lpips) != n_targets or not all(v is not None and math.isfinite(v) for v in lpips):
        raise AssertionError(f"evaluation with LPIPS: {lpips}")
    emit({"phase": "quality", "item": "lpips_eval", "s": eval_s, "targets": n_targets, "size": list(hw),
          "lpips": lpips, "lpips_s": timings["lpips_s"], "render_s": timings["render_s"],
          "metrics_s": timings["metrics_s"], "pool_s": timings["pool_s"]})
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the loop's outputs: 1 epoch of 2 steps with everything on
    exp_dir = os.path.join(out, "loop_exp")
    ds = "data_source_ImplicitronDataSource_args."
    syn = ds + "dataset_map_provider_SyntheticDataProvider_args."
    dl = ds + "data_loader_map_provider_SequenceDataLoaderMapProvider_args."
    loop = "training_loop_ImplicitronTrainingLoop_args."
    cfg = load_config("hydrant", [
        ds + "dataset_map_provider_class_type=SyntheticDataProvider",
        syn + "n_scenes=2", syn + "n_views_per_scene=33", syn + "image_size=800",
        dl + "batch_size=33", dl + "dataset_length_train=66", dl + "dataset_length_val=1",
        "disable_validation=false", loop + "validation_interval=1", loop + "visualize_interval=1",
        "visualize_denoising_video=true", loop + "profile=true", loop + "profile_steps=2", f"exp_dir={exp_dir}",
        f"{HYDRANT_MODEL}.diffusion_args.num_steps=250"])
    records = _Records()
    loggers = [logging.getLogger(n) for n in ("holo_diffusion_torch.experiment", "holo_diffusion_torch.utils.profiling")]
    for lg in loggers:
        lg.setLevel(logging.INFO)
        lg.addHandler(records)
    _build.reset_launch_counts()
    with counted_chunk_graphs() as graphed:
        (state, stats), loop_s = timed(lambda: Experiment(cfg).run(max_epochs=1))
    for lg in loggers:
        lg.removeHandler(records)
    counts = _build.launch_counts()
    emit({"phase": "main_path", "path": "vis_loop", "launches": counts, "chunk_graphs": graphed})
    model = state.model
    chunks = math.ceil(model.render_image_height * model.render_image_width
                       / (model.chunk_size_grid // model.n_pts_per_ray_evaluation))
    video_frames = math.ceil(model.schedule.num_timesteps / 50)
    steps = state.step
    # the loop's own trace (profile=true) leaves no room for a second one,
    # so these are the host's launches: K3 and K2 twice a step, and K3 once
    # a pass in each chunk graph's warm-up; every chunk of every frame
    # replays a graph, whose kernels launch without a call
    if graphed["replays"] != chunks * (1 + video_frames):
        raise AssertionError(f"loop with visualizations: {graphed}, expected {chunks * (1 + video_frames)} replays")
    expect_launches(counts, "loop with visualizations",
                    exactly={"fused_decode_bwd": 2 * steps,
                             "fused_decode_fwd_normals": 2 * steps + model.num_passes * graphed["captures"]},
                    none=("fused_decode_fwd", *ks.ENTRY_POINTS, *fr.ENTRY_POINTS))
    results["fused_decode_fwd_normals"]["vis_loop_launches"] = counts["fused_decode_fwd_normals"]
    has_matplotlib = importlib.util.find_spec("matplotlib") is not None
    if not has_matplotlib:
        emit({"phase": "quality", "note": "no matplotlib on this machine: the loop wrote no train_stats.pdf; "
              "write_dashboard_html called on the run's stats"})
        write_dashboard_html(stats, exp_dir)
    files = sorted(os.path.relpath(os.path.join(r, f), exp_dir) for r, _, fs in os.walk(exp_dir) for f in fs)
    video = [f for f in files if f.startswith("visuals/denoising_00000000")]
    wanted = ["dashboard.html"] + [f"visuals/val_00000000_{k}_render.png" for k in ("images", "masks", "depths")]
    if has_matplotlib:
        wanted.append("train_stats.pdf")
    traces = [f for f in files if f.startswith("traces/") and os.path.getsize(os.path.join(exp_dir, f)) > 0]
    missing = [f for f in wanted if f not in files]
    if missing or not traces or not (video == ["visuals/denoising_00000000.mp4"] or len(video) == video_frames):
        raise AssertionError(f"the loop's outputs: missing {missing}, traces {traces}, video {video[:3]}...")

    def logged(prefix):  # the seconds an INFO record of the run gives last
        return [r.args[-1] for r in records.records if r.levelno == logging.INFO and r.msg.startswith(prefix)]

    emit({
        "phase": "quality", "item": "vis_loop", "s": loop_s, "steps": steps, "s_per_step_profiled": stats.history[0]["train"]["sec/it"],
        "val_frame_s": stats.history[0]["val"]["sec/it"], "denoising_video_s": logged("denoising video"),
        "video_frames": video_frames, "video": video[0] if len(video) == 1 else f"{len(video)} PNG frames",
        "stats_plot_and_dashboard_s": logged("stats plot"), "traced_dispatches_s": logged("traced dispatches"),
        "matplotlib": has_matplotlib, "traces": traces, "trace_bytes": [os.path.getsize(os.path.join(exp_dir, f))
                                                                        for f in traces],
        "visuals": [f for f in files if f.startswith("visuals/") and f not in video],
        "x_t_png": any(f.endswith("_x_t.png") for f in files)})


def _tensor_diff(a, b):
    """(bitwise equal, max abs difference) of two lists of tensors."""
    import torch

    same = len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    diff = max((float((x.double() - y.double()).abs().max()) for x, y in zip(a, b) if x.numel()), default=0.0)
    return same, diff


def scale_out_phase(here, dev, results):
    """Compact sources, packed transfer and data parallelism at hydrant
    width, on the CO3D tree the `co3d` phase wrote:
    (1) `Experiment.run` 2 epochs of 2 steps (a 512^2 validation frame an
    epoch, no checkpoints) with `compact_sources` and without: s per step,
    K3/K2 launches per step (the main path `scale_out_compact`), the scene
    cache's hits and misses; a batch's bytes and pinned copy both ways; the
    native compaction of a scene; one batch's objective compact vs full
    (JAX's 10 % bound); a narrow compact step card vs CPU;
    (2) packed transfer of one 33-frame batch (one pinned buffer against the
    leaf-by-leaf copy; the unpacked leaves bitwise) and 1 epoch of 2 steps
    with `packed_transfer` against the same run without, bitwise, in
    `deterministic` mode;
    (3) a process group of one rank through NCCL (FileStore) and 3 steps of
    `make_train_step(..., mesh=...)` (loss-second-moment sampler) against
    the plain step from the same state and generator, and the plain step
    run again: on the fused model (K3, K2) within the plain step's own
    run-to-run spread (K2 sums with atomics, so the card's step is not
    bitwise reproducible), and in `deterministic` mode bitwise; the flat
    gradient all_reduce's and the sampler all_gather's device ms;
    (4) `torchrun --nproc_per_node 1` on the train CLI with compact sources
    and packed transfer, 1 epoch of 2 steps: exit 0, a checkpoint that
    `load_experiment` reads."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from holo_diffusion_torch.config import load_config, optimizer_args_from_config
    from holo_diffusion_torch.data.packing import BatchPacker, packed_transfer
    from holo_diffusion_torch.experiment import Experiment
    from holo_diffusion_torch.models import diffusion as gd
    from holo_diffusion_torch.ops import _build
    from holo_diffusion_torch.ops import fused_render as fr
    from holo_diffusion_torch.ops import kron_sample as ks
    from holo_diffusion_torch.parallel.collectives import gathered_loss_aware_update, mean_over_ranks
    from holo_diffusion_torch.parallel.mesh import _state_tensors, make_mesh
    from holo_diffusion_torch.parallel.train_step import TrainState, make_train_step
    from holo_diffusion_torch.train.optimizer import make_lr_schedule, make_optimizer
    from holo_diffusion_torch.utils.checkpoint_utils import load_experiment
    from holo_diffusion_torch.weights import init_weights

    root = os.path.join(here, "build", "chip_smoke", "co3d")
    work = os.path.join(here, "build", "chip_smoke", "scale_out")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ds = "data_source_ImplicitronDataSource_args."
    prov = ds + "dataset_map_provider_JsonIndexDatasetMapProviderV2_args."
    dl = ds + "data_loader_map_provider_SequenceDataLoaderMapProvider_args."
    loop = "training_loop_ImplicitronTrainingLoop_args."
    co3d_args = [ds + "dataset_map_provider_class_type=JsonIndexDatasetMapProviderV2", prov + f"dataset_root={root}",
                 prov + "category=synthball", dl + "dataset_length_train=66", dl + "dataset_length_val=1"]
    report = {}

    def cfg(name, *extra):
        return load_config("hydrant", [*co3d_args, loop + "visualize_interval=0", loop + "store_checkpoints=false",
                                       f"exp_dir={os.path.join(work, name)}", *extra])

    # ---- (1) compact sources against full batches, 2 epochs of 2 steps
    runs = {}
    for label, extra in (("full", ()), ("compact", ("compact_sources=true",))):
        exp = Experiment(cfg(label, "disable_validation=false", *extra))
        launches = traced_launches()
        t0 = time.perf_counter()
        state, stats = exp.run(max_epochs=2)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = launches.counts()
        if label == "compact":
            emit({"phase": "main_path", "path": "scale_out_compact", "launches": counts})
        model = state.model
        frame_launches = model.num_passes * math.ceil(
            model.render_image_height * model.render_image_width
            / (model.chunk_size_grid // model.n_pts_per_ray_evaluation))
        expect_launches(counts, f"{label} loop",
                        exactly={"fused_decode_bwd": 2 * state.step,
                                 "fused_decode_fwd_normals": 2 * state.step + 2 * frame_launches
                                 + graph_warmup_launches(counts, model.num_passes)},
                        none=("fused_decode_fwd", *ks.ENTRY_POINTS, *fr.ENTRY_POINTS))
        hist = stats.history
        if state.step != 4 or not all(math.isfinite(x) for e in hist for sp in ("train", "val")
                                      for x in e[sp].values()):
            raise AssertionError(f"{label} loop: {state.step} steps, history {hist}")
        runs[label] = {"run_s": run_s, "s_per_step_stats": [e["train"]["sec/it"] for e in hist],
                       "val_frame_s": [e["val"]["sec/it"] for e in hist],
                       "train_objective": [e["train"]["objective"] for e in hist],
                       "K2_per_step": counts["fused_decode_bwd"] / state.step,
                       "K3_per_step": (counts["fused_decode_fwd_normals"] - 2 * frame_launches) / state.step}
        if label == "compact":
            results["fused_decode_bwd"]["scale_out_compact_launches"] = counts["fused_decode_bwd"]
            results["fused_decode_fwd_normals"]["scale_out_compact_launches"] = counts["fused_decode_fwd_normals"]
            runs[label]["scene_cache"] = {"hits": exp._train_data.hits, "misses": exp._train_data.misses,
                                          "val_hits": exp._val_data.hits, "val_misses": exp._val_data.misses}
            if exp._train_data.misses < 1 or exp._val_data.misses < 1:
                raise AssertionError(f"the compact scene cache was not used: {runs[label]['scene_cache']}")
            compact_exp, compact_state = exp, state
        else:
            del exp, state
    report["loops"] = runs

    exp, state = compact_exp, compact_state
    comp, model = exp.compactor, state.model
    batch = exp.data.train.sample_batch(np.random.RandomState(3), exp.batch_size)
    cbatch = comp(batch)
    scene = exp.data.train.get_scene(0)
    t0 = time.perf_counter()
    comp.compact_frames(scene.image_rgb, scene.fg_probability, scene.mask_crop)
    compact_scene_ms = 1e3 * (time.perf_counter() - t0)

    def pinned_copy_ms(b):
        pinned = b.pin_memory()
        out = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            on_card = pinned.to(dev, non_blocking=True)
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return out, on_card

    full_ms, _ = pinned_copy_ms(batch)
    compact_ms, compact_on_card = pinned_copy_ms(cbatch)
    if not same_bits(compact_on_card, cbatch):
        raise AssertionError("a compact batch on the card differs from the host batch")
    # one batch, the same weights and draws, compact against full
    model.train()
    objs = {}
    for label, b in (("full", batch), ("compact", cbatch)):
        b = b.pin_memory().to(dev, non_blocking=True)
        with torch.no_grad():
            preds = model(camera=b.camera, image_rgb=b.image_rgb, fg_probability=b.fg_probability,
                          mask_crop=b.mask_crop, depth_map=b.depth_map, src_image_rgb=b.src_image_rgb,
                          src_fg_probability=b.src_fg_probability, src_mask_crop=b.src_mask_crop, training=True,
                          draws=torch.Generator(device=dev).manual_seed(17))
        objs[label] = preds["objective"].item()
    rel = abs(objs["compact"] - objs["full"]) / (abs(objs["full"]) + 1e-3)
    report["compact"] = {"frames": exp.batch_size, "targets": comp.n_targets(exp.batch_size),
                         "src_size": list(cbatch.src_image_rgb.shape[1:3]), "drop_depth": comp.drop_depth,
                         "frame_bytes": {"full": frame_bytes(batch), "compact": frame_bytes(cbatch)},
                         "h2d_pinned_ms": {"full": full_ms, "compact": compact_ms},
                         "compact_scene_ms": compact_scene_ms, "scene_frames": scene.batch_size,
                         "objective": objs, "objective_rel_diff": rel, "tol": 0.1}
    if rel > 0.1:
        raise AssertionError(f"compact and full objectives differ by {rel:.3f} of the full one")
    del exp, state, compact_exp, compact_state, model, compact_on_card
    gc.collect()
    torch.cuda.empty_cache()
    train_check_phase(dev, "scale_out_compact_card_vs_cpu", compact=True)

    # ---- (2) packed transfer: one 33-frame batch, then a loop with and without
    packer = BatchPacker()
    host_ms, packed_ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        buf = packer.pack(batch, pin=True)
        host_ms.append(1e3 * (time.perf_counter() - t0))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        on_card = buf.to(dev, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        packed_ms.append(start.elapsed_time(end))
    leaf_ms, _ = pinned_copy_ms(batch)
    unpacked_bitwise = same_bits(packer.unpack(on_card), batch)
    del buf, on_card
    finals = {}
    with deterministic():
        for label, extra in (("unpacked", ()), ("packed", ("packed_transfer=true",))):
            exp = Experiment(cfg(label, "disable_validation=true", f"{SAMPLER_KEY}=gather", *extra))
            unfuse(exp.model)
            t0 = time.perf_counter()
            state, stats = exp.run(max_epochs=1)
            torch.cuda.synchronize()
            finals[label] = (_state_tensors(state), time.perf_counter() - t0, stats.history[0]["train"]["sec/it"])
            del state, exp
    loop_same, loop_diff = _tensor_diff(finals["unpacked"][0], finals["packed"][0])
    report["packed"] = {"bytes": packer.nbytes, "leaves": len(packer.structure), "pack_host_ms": host_ms,
                        "h2d_packed_ms": packed_ms, "h2d_leaf_by_leaf_ms": leaf_ms,
                        "unpacked_bitwise": unpacked_bitwise,
                        "loop_s": {k: v[1] for k, v in finals.items()},
                        "loop_s_per_step": {k: v[2] for k, v in finals.items()},
                        "loop_state_bitwise": loop_same, "loop_state_max_abs_diff": loop_diff}
    del finals
    gc.collect()
    torch.cuda.empty_cache()
    if not unpacked_bitwise or not loop_same:
        raise AssertionError(f"packed transfer changed bits: {report['packed']}")

    # ---- (3) one rank through NCCL against the plain step
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(work, "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh(dev)
        hcfg = load_config("hydrant")
        sbatch = synthetic_batch(hcfg, dev)
        oa = optimizer_args_from_config(hcfg)

        def three_steps(model, initial, m):
            model.load_state_dict(initial)
            opt = make_optimizer(model.named_parameters(), **oa["optimizer"],
                                 schedule=make_lr_schedule(oa["optimizer"]["lr"], **oa["schedule"]))
            st = TrainState.create(model, opt, sampler_state=gd.LossSecondMomentState.create(
                model.schedule.num_timesteps, device=dev))
            step = make_train_step(model, opt, schedule_sampler="loss-second-moment", mesh=m)
            gen = torch.Generator(device=dev).manual_seed(29)
            secs, metrics = [], []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, mt = step(st, sbatch, gen)
                metrics.append(torch.stack(list(mt.values())))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            return [t.clone() for t in _state_tensors(st)] + metrics, secs

        def against_plain(model):
            model = model.to(dev).train()
            initial = {k: v.clone() for k, v in model.state_dict().items()}
            plain, plain_s = three_steps(model, initial, None)
            nccl, nccl_s = three_steps(model, initial, mesh)
            again, again_s = three_steps(model, initial, None)
            (nccl_same, nccl_diff), (rerun_same, rerun_diff) = _tensor_diff(plain, nccl), _tensor_diff(plain, again)
            return {"s_per_step": {"plain": plain_s, "nccl": nccl_s, "plain_again": again_s},
                    "nccl_vs_plain_bitwise": nccl_same, "nccl_vs_plain_max_abs_diff": nccl_diff,
                    "plain_rerun_bitwise": rerun_same, "plain_rerun_max_abs_diff": rerun_diff}

        model = init_weights(build_hydrant(hcfg), seed=0)
        _build.reset_launch_counts()
        fused = against_plain(model)
        counts = _build.launch_counts()
        expect_launches(counts, "NCCL steps", exactly={"fused_decode_bwd": 18, "fused_decode_fwd_normals": 18})
        with deterministic():
            det_model = unfuse(init_weights(build_hydrant(load_config("hydrant", [f"{SAMPLER_KEY}=gather"])), seed=0))
            det = against_plain(det_model)
        del det_model
        # the collectives alone: a hydrant-sized gradient list, the sampler's pairs
        grads = [torch.randn_like(p) for p in model.parameters()]
        nbytes = sum(g.numel() * g.element_size() for g in grads)
        flat = torch.cat([g.reshape(-1) for g in grads])

        all_reduce_ms = events_ms(lambda: dist.all_reduce(flat))
        mean_ms = events_ms(lambda: mean_over_ranks(grads))
        sampler = gd.LossSecondMomentState.create(model.schedule.num_timesteps, device=dev)
        ts, loss = torch.tensor([400, 90], device=dev), torch.tensor(0.5, device=dev)
        gather_ms = events_ms(lambda: gathered_loss_aware_update(sampler, ts, loss, [True, True]))
        report["nccl_world_1"] = {
            "backend": dist.get_backend(), "steps": 3, "fused": fused, "deterministic_unfused": det,
            "grad_bytes": nbytes, "grad_tensors": len(grads), "all_reduce_ms": all_reduce_ms,
            "mean_over_ranks_ms": mean_ms, "loss_aware_gather_update_ms": gather_ms}
        del grads, flat, model, sbatch
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    # the fused step within 4 x the plain step's own spread; bitwise where
    # the plain step reruns bitwise
    if not (det["plain_rerun_bitwise"] and det["nccl_vs_plain_bitwise"]) or not (
            fused["nccl_vs_plain_bitwise"] or fused["nccl_vs_plain_max_abs_diff"]
            <= 4 * fused["plain_rerun_max_abs_diff"]):
        raise AssertionError(f"NCCL at world size 1 differs from the plain step: {report['nccl_world_1']}")

    # ---- (4) torchrun on the train CLI, compact sources and packed transfer
    exp_dir = os.path.join(work, "torchrun")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           "-m", "holo_diffusion_torch.cli", "train", "--config-name", "hydrant", "--max-epochs", "1",
           *co3d_args, "compact_sources=true", "packed_transfer=true", f"exp_dir={exp_dir}"]
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=here, env=env, capture_output=True, text=True, timeout=300)
    torchrun_s = time.perf_counter() - t0
    with open(os.path.join(work, "torchrun.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"torchrun exited {proc.returncode}")
    _, loaded = load_experiment(exp_dir, device=dev)
    ckpt_epochs = sorted(os.listdir(exp_dir))
    report["torchrun"] = {"returncode": proc.returncode, "s": torchrun_s, "loaded_step": loaded.step,
                          "exp_dir": [n for n in ckpt_epochs if n.startswith("model_epoch_")]}
    if loaded.step != 2:
        raise AssertionError(f"the torchrun checkpoint holds step {loaded.step}, expected 2")
    del loaded
    emit({"phase": "scale_out", **report})
    gc.collect()
    torch.cuda.empty_cache()


def events_ms(fn, n=5):
    """CUDA-event ms of each of `n` calls of `fn`, after one warm-up call."""
    import torch

    fn()
    out = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def scale_diff(a, b):
    """max |a - b| over max |b|."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)


@contextlib.contextmanager
def captured_decodes():
    """Every fused decode the render path calls while inside, as (its
    arguments by name, cloned outputs) in call order; the wrapper itself
    runs (and counts) as ever."""
    import inspect

    from holo_diffusion_torch.models import implicit

    real = implicit.fused_sample_decode
    signature = inspect.signature(real)
    calls = []

    def capture(*args, **kw):
        out = real(*args, **kw)
        bound = signature.bind(*args, **kw)
        bound.apply_defaults()
        calls.append((dict(bound.arguments), tuple(o.clone() for o in out)))
        return out

    implicit.fused_sample_decode = capture
    try:
        yield calls
    finally:
        implicit.fused_sample_decode = real


@contextlib.contextmanager
def captured_graph_decodes(model):
    """The fused decodes of `model`'s graphed chunk loop (render_eval.py),
    chunk by chunk, as `captured_decodes` gives them (points and cloned
    outputs): the model's chunk graphs are captured anew inside, the decode
    calls of each capture held (their points and outputs stay in the
    graph's memory, which each replay rewrites) and cloned after each
    replay of that graph."""
    import inspect

    import torch

    from holo_diffusion_torch import render_eval
    from holo_diffusion_torch.models import implicit

    graphs = render_eval._ChunkGraphs
    real = implicit.fused_sample_decode, graphs._capture, graphs.replay
    signature = inspect.signature(real[0])
    capturing, held, calls = [], {}, []

    def decode(*args, **kw):
        out = real[0](*args, **kw)
        if torch.cuda.is_current_stream_capturing():
            capturing.append((signature.bind(*args, **kw).arguments["points"], out))
        return out

    def capture(self, *args, **kw):
        del capturing[:]
        entry = real[1](self, *args, **kw)
        held[id(entry[2])] = list(capturing)
        return entry

    def replay(self, *args, **kw):
        out = real[2](self, *args, **kw)
        calls.extend(({"points": points.clone()}, tuple(o.clone() for o in outs)) for points, outs in held[id(out)])
        return out

    graphs._of.pop(model, None)
    implicit.fused_sample_decode, graphs._capture, graphs.replay = decode, capture, replay
    try:
        yield calls
    finally:
        implicit.fused_sample_decode, graphs._capture, graphs.replay = real


@contextlib.contextmanager
def counted_chunk_graphs():
    """{"captures": n, "replays": n}: the chunk graphs (render_eval.py)
    captured and replayed while inside."""
    from holo_diffusion_torch import render_eval

    graphs = render_eval._ChunkGraphs
    real = graphs._capture, graphs.replay
    counted = {"captures": 0, "replays": 0}

    def capture(self, *args, **kw):
        counted["captures"] += 1
        return real[0](self, *args, **kw)

    def replay(self, *args, **kw):
        counted["replays"] += 1
        return real[1](self, *args, **kw)

    graphs._capture, graphs.replay = capture, replay
    try:
        yield counted
    finally:
        graphs._capture, graphs.replay = real


def decode_against_plain(args, out, rays_per_slice=8192):
    """A fused decode's outputs `out` against the plain version on the same
    inputs (`args`, by name), the plain version run over slices of rays so
    that its per-point intermediates fit: (max abs error by lane, CUDA-event
    ms of the sliced plain pass)."""
    import torch

    from holo_diffusion_torch.ops import fused_decode as fd

    P = args["points"].shape[-2]
    points, pe = args["points"].reshape(-1, P, 3), args["pe_dirs"].reshape(-1, args["pe_dirs"].shape[-1])
    out = [o.reshape(-1, P, o.shape[-1]) for o in out]
    errs = [torch.zeros((), device=points.device) for _ in out]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    with torch.no_grad():
        for s in range(0, points.shape[0], rays_per_slice):
            ref = fd.fused_sample_decode_reference(**{**args, "points": points[s:s + rays_per_slice],
                                                      "pe_dirs": pe[s:s + rays_per_slice]})
            errs = [torch.maximum(e, (o[s:s + rays_per_slice] - r).abs().max()) for e, o, r in zip(errs, out, ref)]
    end.record()
    torch.cuda.synchronize()
    return [float(e) for e in errs], start.elapsed_time(end)


def decode_pass_differences(one, chunked):
    """Where a frame rendered in one forward and the same frame in chunks
    part: for the coarse and the fine pass (the calls alternate, coarse
    first), the max abs difference of the decode's points and of each of
    its outputs, the chunks' calls joined in ray order."""
    import torch

    diffs = {}
    for k, name in enumerate(("coarse", "fine")):
        (args, out), parts = one[k], chunked[k::2]
        P = args["points"].shape[-2]
        joined = [torch.cat([a["points"].reshape(-1, P, 3) for a, _ in parts])]
        joined += [torch.cat([o[i].reshape(-1, P, o[i].shape[-1]) for _, o in parts]) for i in range(len(out))]
        mine = [args["points"].reshape(-1, P, 3)] + [o.reshape(-1, P, o.shape[-1]) for o in out]
        diffs[name] = {lane: float((x - y).abs().max())
                       for lane, x, y in zip(("points", "density", "rgb", "normals"), mine, joined)}
    return diffs


def model_parallel_phase(here, dev, results):
    """The UNet sharded over the grid, the ray-sharded render, the rest of
    the UNet family and the bfloat16 extractor, in a process group of one
    rank through NCCL (FileStore):
    (1) `make_sharded_denoiser` on the hydrant model (seeded random weights)
    at resol 16 against the plain `apply_net_3d`: max abs diff within
    SHARDED_TOL of the output's scale, ms per evaluation for both, the
    collectives of one forward by kind; the same at resol 64 (3 evaluations
    each, ms and peak memory);
    (2) one sharded `p_sample` step against the plain step (SHARDED_TOL of
    scale);
    (3) the main path `model_parallel`: `sample_random_voxel_features_sharded`
    cut to 10 steps (in [-1, 1], finite, s) and `render_image_sharded` of
    its grid at 512^2: K3 exactly twice, nothing else; both launches
    captured and held against the plain decode on their own inputs
    (KERNEL_TOL), with K3's time at that shape (CUDA events); then
    `render_image_chunked` of the same grid (RENDER_TOL), the two frames'
    decode inputs and outputs compared pass by pass (the chunks' decodes
    read from their graphs after each replay), and s per frame for both (3
    frames each after a warm-up);
    (4) card against CPU on one narrow instance of each new model at the
    JAX package's default widths (UNET_FAMILY_TOL of scale);
    (5) the extractor in bfloat16 against float32 on hydrant's 30 sources
    at 256^2: ms forward and forward + backward, the features' max
    difference relative to their scale."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from holo_diffusion_torch.config import load_config, model_args_from_config
    from holo_diffusion_torch.models import diffusion as gd
    from holo_diffusion_torch.models.feature_extractor import ResNetFeatureExtractor
    from holo_diffusion_torch.models.unet3d import UNetModel3D
    from holo_diffusion_torch.models.unet_gigagan import AsymmetricUNetModel
    from holo_diffusion_torch.models.unet_variants import EncoderUNetModel, SuperResModel
    from holo_diffusion_torch.ops import _build
    from holo_diffusion_torch.ops import fused_decode as fd
    from holo_diffusion_torch.parallel import spatial
    from holo_diffusion_torch.parallel.mesh import make_mesh
    from holo_diffusion_torch.render_eval import render_image_chunked, render_image_sharded
    from holo_diffusion_torch.utils.flyaround import CANONICAL_CO3D_UP_AXIS, simple_360_cameras
    from holo_diffusion_torch.weights import init_weights

    report = {}
    work = os.path.join(here, "build", "chip_smoke", "model_parallel")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(work, "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh(dev)
        model = init_weights(build_hydrant(load_config("hydrant")), seed=0).to(dev).eval()
        report["params_m"] = sum(p.numel() for p in model.parameters()) / 1e6
        gen = torch.Generator(device=dev).manual_seed(0)
        t = torch.tensor([500], device=dev)
        sharded = spatial.make_sharded_denoiser(model, mesh)
        with torch.no_grad():
            for resol in (16, 64):
                x = torch.randn(1, resol, resol, resol, model.feature_size, generator=gen, device=dev)
                spatial.reset_counts()
                got = sharded(x, t)
                counts = dict(spatial.COUNTS)
                want = model.apply_net_3d(x, t)
                torch.cuda.reset_peak_memory_stats()
                sharded_ms = events_ms(lambda: sharded(x, t), n=3)
                sharded_peak = torch.cuda.max_memory_allocated() / 2 ** 30
                torch.cuda.reset_peak_memory_stats()
                plain_ms = events_ms(lambda: model.apply_net_3d(x, t), n=3)
                plain_peak = torch.cuda.max_memory_allocated() / 2 ** 30
                report[f"unet_{resol}"] = {
                    "max_abs_diff_of_scale": scale_diff(got, want), "collectives_per_forward": counts,
                    "sharded_ms": sharded_ms, "plain_ms": plain_ms,
                    "sharded_peak_gib": sharded_peak, "plain_peak_gib": plain_peak}
                del x, got, want
            # one sharded p_sample step against the plain step, the same noise
            x = torch.randn(1, 16, 16, 16, model.feature_size, generator=gen, device=dev)
            noise = torch.randn(x.shape, generator=gen, device=dev)
            ts = torch.tensor([700], device=dev)
            a = gd.p_sample(model.schedule, sharded, x, ts, noise=noise)["sample"]
            b = gd.p_sample(model.schedule, model.apply_net_3d, x, ts, noise=noise)["sample"]
            report["p_sample_step_max_abs_diff_of_scale"] = scale_diff(a, b)

        # ---- main path: the sharded 10-step loop, then the ray-sharded frame
        # (its two decode launches captured for the checks below)
        cam = simple_360_cameras(1, up=CANONICAL_CO3D_UP_AXIS)[0]
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = spatial.sample_random_voxel_features_sharded(model, torch.Generator(device=dev).manual_seed(1),
                                                           mesh, max_iter=10)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        with captured_decodes() as one:
            frame = render_image_sharded(model, cam, grid[0], mesh)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        emit({"phase": "main_path", "path": "model_parallel", "launches": counts})
        expect_launches(counts, "model parallel", exactly={"fused_decode_fwd_normals": 2},
                        none=("fused_decode_fwd", "fused_decode_bwd", "kron_sample_fwd", "kron_sample_dgrid",
                              "kron_sample_dpoints", "trilinear_sample_onehot"))
        k3 = results["fused_decode_fwd_normals"]
        k3["model_parallel_launches"] = counts["fused_decode_fwd_normals"]
        with captured_graph_decodes(model) as chunked:
            ref = render_image_chunked(model, cam, grid[0], device=dev)
        render_err = {k: float((frame[k] - ref[k]).abs().max()) for k in frame}
        # K3 at the main path's shape: its two launches against the plain
        # version on their own inputs, and its device time there
        k3_main = {}
        for name, (args, out) in zip(("coarse", "fine"), one):
            errs, plain_ms = decode_against_plain(args, out)
            P = args["points"].shape[-2]
            R = args["points"].numel() // (3 * P)
            # CUDA events, not the profiler: this late in the run torch.profiler
            # records no device events, and a launch of this size dwarfs the
            # wrapper's own work
            with torch.no_grad():
                ms = cuda_time_ms(lambda: fd.fused_sample_decode(**args), iters=5)
            bytes_ms, f32_ms, tf32x3_ms = decode_bounds(R * P, R, args["grid"].shape, args["hidden"],
                                                        args["pe_dirs"].shape[-1], True)
            k3_main[name] = {"rays": R, "points_per_ray": P, "max_abs_err": max(errs), "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": max(bytes_ms, min(f32_ms, tf32x3_ms))}
            emit({"phase": "kernels", "case": f"model_parallel_{name}", "name": "fused_decode_fwd_normals",
                  **k3_main[name], "lane_errs": dict(zip(("density", "rgb", "normals"), errs)), "tol": KERNEL_TOL})
            if not max(errs) <= KERNEL_TOL:
                raise AssertionError(f"fused_decode_fwd_normals (model_parallel {name}): "
                                     f"max_abs_err {max(errs)} > {KERNEL_TOL}")
        k3["model_parallel"] = k3_main
        trace = decode_pass_differences(one, chunked)
        del one, chunked
        # s per frame, after the frames above warmed both paths
        sharded_s = [ms / 1e3 for ms in events_ms(lambda: render_image_sharded(model, cam, grid[0], mesh), n=3)]
        chunked_s = [ms / 1e3 for ms in events_ms(lambda: render_image_chunked(model, cam, grid[0], device=dev),
                                                  n=3)]
        report["sharded_loop"] = {"steps": 10, "s": loop_s, "finite": bool(torch.isfinite(grid).all()),
                                  "min": float(grid.min()), "max": float(grid.max())}
        report["render_512"] = {"sharded_s_per_frame": sharded_s, "chunked_s_per_frame": chunked_s,
                                "max_abs_diff": render_err, "decode_pass_differences": trace,
                                "k3_launches": counts["fused_decode_fwd_normals"]}
        del model, sharded, grid, frame, ref
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the UNet family, card against CPU at the JAX defaults' widths
    rs = np.random.RandomState(0)
    family = {
        "unet_2d_class_conditional": (
            UNetModel3D(in_channels=3, out_channels=3, dims=2, num_classes=10),
            (rs.randn(2, 32, 32, 3).astype(np.float32), np.array([10, 900])), {"y": np.array([1, 7])}),
        "super_res": (SuperResModel(in_channels=6, out_channels=3, dims=2),
                      (rs.randn(1, 32, 32, 3).astype(np.float32), np.array([5]),
                       rs.randn(1, 16, 16, 3).astype(np.float32)), {}),
        "encoder_attention": (EncoderUNetModel(image_size=32, pool="attention"),
                              (rs.randn(2, 32, 32, 3).astype(np.float32), np.array([3, 300])), {}),
        "encoder_spatial": (EncoderUNetModel(pool="spatial"),
                            (rs.randn(2, 32, 32, 3).astype(np.float32), np.array([3, 300])), {}),
        "asymmetric_gigagan": (AsymmetricUNetModel(), (rs.randn(1, 64, 64, 3).astype(np.float32),), {}),
    }
    fam = {}
    for name, (m, args, kwargs) in family.items():
        m = init_weights(m, seed=1).eval()
        ta = [torch.from_numpy(a) for a in args]
        tk = {k: torch.from_numpy(v) for k, v in kwargs.items()}
        with torch.no_grad():
            want = m(*ta, **tk)
            m.to(dev)
            da, dk = [a.to(dev) for a in ta], {k: v.to(dev) for k, v in tk.items()}
            got = m(*da, **dk)
            ms = events_ms(lambda: m(*da, **dk), n=3)
        fam[name] = {"params_m": sum(p.numel() for p in m.parameters()) / 1e6,
                     "max_abs_diff_of_scale": scale_diff(got.cpu(), want), "ms": ms}
        del m
    report["unet_family_card_vs_cpu"] = fam

    # ---- the extractor in bfloat16 against float32, hydrant's sources
    fe_args = model_args_from_config(load_config("hydrant"))["image_feature_extractor_args"]
    images = torch.rand(30, 256, 256, 3, generator=torch.Generator().manual_seed(2)).to(dev)
    masks = (images[..., :1] > 0.5).float()
    ext, feats = {}, {}
    for dtype in ("float32", "bfloat16"):
        fe = init_weights(ResNetFeatureExtractor(**{**fe_args, "dtype": dtype}), seed=0).to(dev)

        def fwd():
            with torch.no_grad():
                return fe(images, masks, rescale_done=True)

        def fwd_bwd():
            out = fe(images, masks, rescale_done=True)
            sum(v.sum() for k, v in out.items() if k.startswith("res_layer")).backward()

        feats[dtype] = fwd()
        ext[dtype] = {"forward_ms": events_ms(fwd), "forward_backward_ms": events_ms(fwd_bwd)}
        del fe
    ext["max_diff_of_scale"] = {k: scale_diff(feats["bfloat16"][k], feats["float32"][k])
                                for k in feats["float32"] if k.startswith("res_layer")}
    report["extractor_bf16"] = ext
    del images, masks, feats
    emit({"phase": "model_parallel", **report})
    gc.collect()
    torch.cuda.empty_cache()
    fails = [k for k in ("unet_16", "unet_64") if report[k]["max_abs_diff_of_scale"] > SHARDED_TOL]
    if report["p_sample_step_max_abs_diff_of_scale"] > SHARDED_TOL:
        fails.append("p_sample")
    loop = report["sharded_loop"]
    if not (loop["finite"] and -1.0 <= loop["min"] and loop["max"] <= 1.0):
        fails.append("sharded_loop")
    if max(render_err.values()) > RENDER_TOL:
        fails.append("render_512")
    fails += [k for k, v in fam.items() if v["max_abs_diff_of_scale"] > UNET_FAMILY_TOL]
    if max(ext["max_diff_of_scale"].values()) > EXTRACTOR_BF16_TOL:
        fails.append("extractor_bf16")
    if fails:
        raise AssertionError(f"model_parallel: {fails} beyond tolerance")


def rehearsal_phase(here, dev, results):
    """The release rehearsal (`holo_diffusion_torch/rehearsal.py`) at
    hydrant width on the release tree (3 sequences x 40 frames at 900 x
    1200, written first; random weights from the config's seed), cut to 2
    epochs x 8 steps with the probes after each epoch: one `Experiment.run`
    an epoch on one `Experiment`, the second resuming from the first's
    checkpoint; after each, the diffusion leg's probe on a fixed 9-frame
    validation batch, a 1000-step DDPM sample and its 256^2 render. Main
    path `rehearsal`: K2 exactly twice a step, K3 twice a step, twice a
    chunk of each 512^2 validation frame and of each 256^2 snapshot, no
    K1 or K4-K7. Checks: the curve finite, the second epoch resumed (the
    loop's log and the step count), each PNG 256 x 256 x 3 and not
    constant, peak and resting memory growth from epoch 0 to epoch 1
    within REHEARSAL_*_GROWTH_GIB; then `pooled_grid` and `denoise_leg_mse`
    on a narrow model, card against CPU (REHEARSAL_PROBE_TOL)."""
    import numpy as np
    import torch

    from holo_diffusion_torch.config import load_config, model_args_from_config
    from holo_diffusion_torch.data.synthetic import make_synthetic_scene
    from holo_diffusion_torch.data.synthetic_co3d import RELEASE_ROOT, ensure_release_tree
    from holo_diffusion_torch.models.holo_model import HoloDiffusionModel
    from holo_diffusion_torch.ops import fused_render as fr
    from holo_diffusion_torch.ops import kron_sample as ks
    from holo_diffusion_torch.rehearsal import PROBE_TS, denoise_leg_mse, pooled_grid, run_rehearsal
    from holo_diffusion_torch.weights import init_weights

    t_phase = time.perf_counter()
    existed = os.path.exists(os.path.join(RELEASE_ROOT, ".done"))
    t0 = time.perf_counter()
    ensure_release_tree()
    tree_s = time.perf_counter() - t0
    out_dir = os.path.join(here, "build", "chip_smoke", "rehearsal")
    exp_dir = os.path.join(here, "build", "chip_smoke", "rehearsal_exp")
    shutil.rmtree(out_dir, ignore_errors=True)
    epochs_n, steps_n = 2, 8
    exp_log = logging.getLogger("holo_diffusion_torch.experiment")
    exp_log.setLevel(logging.INFO)
    records = _Records()
    exp_log.addHandler(records)
    launches = traced_launches()
    t0 = time.perf_counter()
    try:
        summary, epochs = run_rehearsal(epochs_n, out_dir, exp_dir, steps_per_epoch=steps_n, device=dev)
    finally:
        exp_log.removeHandler(records)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launches.counts()
    emit({"phase": "main_path", "path": "rehearsal", "launches": counts})
    # K3 launches a chunked frame: 2 passes a chunk of 640 rays (hydrant's
    # chunk_size_grid 40960 over 64 points a ray)
    margs = model_args_from_config(load_config("hydrant"))
    rays_per_chunk = margs["chunk_size_grid"] // margs["n_pts_per_ray_evaluation"]
    val_frame = margs["num_passes"] * math.ceil(
        margs["render_image_height"] * margs["render_image_width"] / rays_per_chunk)
    snapshot = margs["num_passes"] * math.ceil(256 * 256 / rays_per_chunk)
    steps = epochs_n * steps_n
    expected = {"fused_decode_bwd": 2 * steps,
                "fused_decode_fwd_normals": 2 * steps + epochs_n * (val_frame + snapshot)
                + graph_warmup_launches(counts, margs["num_passes"])}
    expect_launches(counts, "rehearsal", exactly=expected,
                    none=("fused_decode_fwd", *ks.ENTRY_POINTS, *fr.ENTRY_POINTS))
    results["fused_decode_bwd"]["rehearsal_launches"] = counts["fused_decode_bwd"]
    results["fused_decode_fwd_normals"]["rehearsal_launches"] = counts["fused_decode_fwd_normals"]

    curve = summary["curve"]
    finite = all(math.isfinite(x) for rec in curve for x in
                 [v for v in rec.values() if isinstance(v, float)] + list(rec["denoise_mse_per_t"].values()))
    resumed = [r.getMessage() for r in records.records if r.getMessage().startswith("resumed from epoch")]
    pngs = {}
    for rec in curve:
        img = read_png_rgb(rec["sample_png"])
        pngs[os.path.basename(rec["sample_png"])] = {"shape": list(img.shape), "std": float(img.std()),
                                                     "mean": float(img.mean())}
    with open(os.path.join(exp_dir, "train_stats.json")) as f:
        hist = json.load(f)["history"]
    growth = {"peak_gib": epochs[1]["peak_gib"] - epochs[0]["peak_gib"],
              "resting_gib": epochs[1]["resting_gib"] - epochs[0]["resting_gib"]}
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the probes on a narrow model: card against CPU
    cpu_model = init_weights(HoloDiffusionModel(**narrow_model_args()), seed=1)
    card_model = copy.deepcopy(cpu_model).to(dev)
    scene = make_synthetic_scene(n_views=6, image_size=48, seed=2, device="cpu")
    grids = {label: pooled_grid(m, scene) for label, m in (("card", card_model), ("cpu", cpu_model))}
    grid_err = scale_diff(grids["card"].cpu(), grids["cpu"])
    noise = torch.from_numpy(np.random.RandomState(4).randn(1, *grids["cpu"].shape).astype(np.float32))
    mses = {label: denoise_leg_mse(m, m.schedule, grids["cpu"][None].to(d), noise.to(d)).cpu()
            for label, m, d in (("card", card_model, dev), ("cpu", cpu_model, "cpu"))}
    mse_rel = float(((mses["card"] - mses["cpu"]).abs() / mses["cpu"].abs()).max())
    del cpu_model, card_model, grids
    phase_s = time.perf_counter() - t_phase

    emit({"phase": "rehearsal", "tree": {"written": not existed, "write_s": tree_s},
          "epochs": epochs_n, "steps_per_epoch": steps_n, "run_s": run_s, "phase_s": phase_s,
          "phase_s_without_tree": phase_s - tree_s, "resumed": resumed,
          "per_epoch": epochs, "s_per_step_stats": [h["train"]["sec/it"] for h in hist],
          "val_s_per_batch": [h["val"]["sec/it"] for h in hist], "memory_growth": growth,
          "curve": [{k: v for k, v in rec.items() if k != "sample_png"} for rec in curve], "pngs": pngs,
          "launches": counts, "launches_expected": expected, "finite": finite,
          "card_vs_cpu": {"pooled_grid_of_scale": grid_err, "denoise_mse_rel": mse_rel,
                          "denoise_mse": {k: v.tolist() for k, v in mses.items()}, "timesteps": list(PROBE_TS)},
          "tol": {"probe": REHEARSAL_PROBE_TOL, "peak_growth_gib": REHEARSAL_PEAK_GROWTH_GIB,
                  "resting_growth_gib": REHEARSAL_REST_GROWTH_GIB}})
    fails = []
    if not finite:
        fails.append("non-finite curve")
    if [e["step"] for e in epochs] != [steps_n, 2 * steps_n] or resumed != ["resumed from epoch 0"]:
        fails.append(f"resume: steps {[e['step'] for e in epochs]}, log {resumed}")
    if any(p["shape"] != [256, 256, 3] or p["std"] == 0.0 for p in pngs.values()) or len(pngs) != epochs_n:
        fails.append(f"pngs {pngs}")
    if growth["peak_gib"] > REHEARSAL_PEAK_GROWTH_GIB or growth["resting_gib"] > REHEARSAL_REST_GROWTH_GIB:
        fails.append(f"memory growth {growth}")
    if grid_err > REHEARSAL_PROBE_TOL or mse_rel > REHEARSAL_PROBE_TOL:
        fails.append(f"probes card vs cpu {grid_err}, {mse_rel}")
    if fails:
        raise AssertionError(f"rehearsal: {fails}")


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms (PyTorch's sort-based index accumulation,
    cuDNN's deterministic convolutions) for runs that must repeat bitwise;
    the earlier settings come back after."""
    import torch

    prev = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev[2], prev[3]


def unfuse(model):
    """`model` decoding layer by layer from its plain sampler (no kernel
    with atomics in its backward); returns it."""
    model.implicit_function.fuse_decode = "off"
    model.implicit_function.collapse_density = "off"
    return model


def build_hydrant(cfg):
    from holo_diffusion_torch.config import model_args_from_config
    from holo_diffusion_torch.models.holo_model import HoloDiffusionModel

    return HoloDiffusionModel(**model_args_from_config(cfg))


def main(argv=None):
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Drive the PyTorch/CUDA port on one GPU.")
    parser.add_argument("--only", choices=("c128", "sample"),
                        help="c128: the build, the C-128 kernels and their training main path alone; "
                             "sample: the build, K9's kernel case and the DDPM sample's main path alone")
    opts = parser.parse_args(argv)
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
    from holo_diffusion_torch.ops import fused_render as fr
    from holo_diffusion_torch.ops import kron_sample as ks
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
    # each kernel's (mangled) name, then its registers and spills
    ptxas = {name: [ln.strip().split("'")[1] if "Compiling entry" in ln else ln.strip()
                    for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
             for name in _build.SOURCES}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "compiled": compiled,
          "ptxas": ptxas})

    results = {}
    if opts.only == "c128":
        c128_phase(dev, results)
        emit({"kernels": [results[n] for n in C128_KERNELS]})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    # ---- the hydrant model, seeded random weights
    model = build_model("hydrant")
    init_weights(model, seed=0)
    model.to(dev).eval()
    model_k1 = build_model("hydrant", [f"{HYDRANT_MODEL}.implicit_function_HoloVoxelGridImplicitFunction_args.render_normals=false"])
    model_k1.load_state_dict(model.state_dict())
    model_k1.to(dev).eval()

    if opts.only == "sample":
        small_conv_kernel_phase(model, results)
        conv_flops, n_convs = unet_conv_flops(model, dev)
        launches = traced_launches()
        sample_main_path(model, dev, conv_flops, n_convs)
        counts = launches.counts()
        emit({"phase": "main_path", "path": "sample", "launches": counts})
        expect_small_conv_launches(counts, "sampling", model.schedule.num_timesteps)
        results["small_conv3d"]["launches"] = counts["small_conv3d"]
        emit({"kernels": [results["small_conv3d"]]})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    kernel_phase(model, results)
    sample_kernel_phase(model, results)
    view_sample_kernel_phase(results)
    small_conv_kernel_phase(model, results)
    c128_phase(dev, results)
    gc.collect()
    torch.cuda.empty_cache()

    conv_flops, n_convs = unet_conv_flops(model, dev)

    # ---- main path: sample, then render (launch counts read after)
    launches = traced_launches()
    v = sample_main_path(model, dev, conv_flops, n_convs)

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
    counts = launches.counts()
    emit({"phase": "main_path", "path": "serve", "launches": counts})
    expect_launches(counts, "serving", some=("fused_decode_fwd", "fused_decode_fwd_normals"),
                    none=("fused_decode_bwd", *ks.ENTRY_POINTS, *fr.ENTRY_POINTS))
    # the render runs no UNet: K9's launches are the sample's
    expect_small_conv_launches(counts, "serving", model.schedule.num_timesteps)
    for name in ("fused_decode_fwd", "fused_decode_fwd_normals", "small_conv3d"):
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
          "tol": {"render": RENDER_TOL, "sample": DDPM_TOL}})
    if max(render_err.values()) > RENDER_TOL or sample_err > DDPM_TOL:
        raise AssertionError("card and CPU disagree beyond tolerance")

    # ---- unfused serving main path, then its checks
    unfused = unfused_models(model, build_model, dev)
    serve_unfused_phase(unfused, v, out_dir, dev, results)
    unfused = unfused["fused_sampler"]
    check_unfused_phase(model, unfused, v, dev)

    # ---- training main paths, fused then unfused, then the card against the CPU
    cfg = load_config("hydrant")
    batch = synthetic_batch(cfg, dev)
    steps = 5
    train_step_fn, counts = train_phase(model, cfg, batch, dev, "train", steps)
    # one pooling a step: K8 once each way
    expect_launches(counts, "training", exactly={"fused_decode_fwd_normals": 2 * steps, "fused_decode_bwd": 2 * steps,
                                                 "fused_decode_fwd_normals@C64": 2 * steps,
                                                 "fused_decode_bwd@C64": 2 * steps,
                                                 "view_sample_fwd": steps, "view_sample_bwd": steps},
                    none=("fused_decode_fwd", "fused_decode_fwd_normals@C128", "fused_decode_bwd@C128",
                          *ks.ENTRY_POINTS, *fr.ENTRY_POINTS))
    results["fused_decode_bwd"]["launches"] = counts["fused_decode_bwd"]
    for name in ("view_sample_fwd", "view_sample_bwd"):
        results[name]["train_launches"] = counts[name]
    results["fused_decode_fwd_normals"]["train_launches"] = counts["fused_decode_fwd_normals"]
    steps = 3
    unfused_step_fn, counts = train_phase(unfused, cfg, batch, dev, "train_unfused", steps)
    # per step and render pass: K4 forward, K6 for the normals, K5 backward
    expect_launches(counts, "unfused training",
                    exactly={**{name: 2 * steps for name in ks.ENTRY_POINTS},
                             "view_sample_fwd": steps, "view_sample_bwd": steps},
                    none=(*fd.ENTRY_POINTS, *fr.ENTRY_POINTS))
    results["kron_sample_dgrid"]["launches"] = counts["kron_sample_dgrid"]
    for name in ("kron_sample_fwd", "kron_sample_dpoints"):
        results[name]["train_launches"] = counts[name]
    train_check_phase(dev, "train_card_vs_cpu")
    train_check_phase(dev, "train_unfused_card_vs_cpu", sampler="fused", fuse_decode="off")
    # the goldens' toy width, C 8, with default arguments: "auto" must pick
    # the unfused decode, which the card takes at any C
    counts = train_check_phase(dev, "train_c8_auto_card_vs_cpu", feature_size=8)
    expect_launches(counts, "C 8 check", some=("kron_sample_fwd", "kron_sample_dgrid"), none=fd.ENTRY_POINTS)

    model.eval()
    unfused.eval()
    busy = profile_phase(model, unfused, v, dev, train_step_fn, unfused_step_fn)

    # ---- the training loop main path, on a card freed of the models above
    del model, model_k1, unfused, batch, train_step_fn, unfused_step_fn
    gc.collect()
    torch.cuda.empty_cache()
    train_loop_phase(here, dev, busy["train_step"], results)

    # ---- the training loop on CO3D-format data, after the models above are freed
    gc.collect()
    torch.cuda.empty_cache()
    co3d_s_per_step = co3d_phase(here, dev, results)

    # ---- the whole training step and its use at inference, on the same tree
    gc.collect()
    torch.cuda.empty_cache()
    train_full_phase(here, dev, results, co3d_s_per_step)

    # ---- the fly-around's modes and the reconstruction entry point
    gc.collect()
    torch.cuda.empty_cache()
    flyaround_full_phase(here, dev, results)

    # ---- sample quality and the loop's outputs, on train_full's checkpoint
    gc.collect()
    torch.cuda.empty_cache()
    quality_phase(here, dev, results)

    # ---- compact sources, packed transfer, NCCL and torchrun, on the CO3D tree
    gc.collect()
    torch.cuda.empty_cache()
    scale_out_phase(here, dev, results)

    # ---- the UNet sharded over the grid, the ray-sharded render, the UNet family
    gc.collect()
    torch.cuda.empty_cache()
    model_parallel_phase(here, dev, results)

    # ---- the release rehearsal: 2 epochs of 8 steps with the probes, on the release tree
    gc.collect()
    torch.cuda.empty_cache()
    rehearsal_phase(here, dev, results)

    emit({"kernels": [results[n] for n in (*fd.ENTRY_POINTS, *ks.ENTRY_POINTS, *fr.ENTRY_POINTS,
                                           "view_sample_fwd", "view_sample_bwd", "small_conv3d",
                                           *C128_KERNELS)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
