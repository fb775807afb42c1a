#!/usr/bin/env python3
"""Layout, locality and cost-split sweeps of the port's kernels on one GPU.

    python3 kernel_sweep.py [--only k4,k2,k6,decode,k5,k7,samplers,k9]

Each section runs in a process of its own.

Prints one JSON line per measurement, then the card's name and power limit:
  k4      the trilinear sample K4 (`kron_sample_fwd`) over a fine render
          chunk (81,920 points) at C 64 and at C 257 (the collapsed density
          affine), on random points and on ray-ordered points (640 rays x
          128 depths), at every lanes-per-point G in 1..32 (the kernel
          takes any G; the port launches `sample_layout`'s)
  k2      the decode backward K2 (`fused_decode_bwd`) over a hydrant
          training fine pass (3 x 1024 rays x 128 points, C 64, hidden 256)
          on random points and on ray-ordered points, with d_grid's error
          apart from the cells of points whose pre-activations lie near 0
          (`chip_smoke.decode_bwd_errors`)
  k6      the points cotangent K6 (`kron_sample_dpoints`) at C 64 with a
          random cotangent over a hydrant training fine pass (393,216
          points), at every lanes-per-point G in 2..32 (the kernel takes any
          G; the port launches `dpoints_layout`'s), on random points and on
          the same points in grid-cell order
  decode  the fused decode K1/K3 at both render chunks (640 rays x 64 and
          x 128 points) on random points and in grid-cell order: how much of
          its time the gather's locality sets
  k5      the grid cotangent K5 (`kron_sample_dgrid`) at C 64 over a
          hydrant training fine pass (3 x 1024 rays x 128 points), random
          and ray-ordered, at every tile of 32..256 points and run of 8..32
          (the kernel takes any; the port launches `DGRID_TILE_LOG2`/`_RUN_LOG2`)
  k7      the one-hot-formulation sample K7 (`trilinear_sample_onehot`) at
          C 64 over a fine render chunk (640 x 128 points), random and
          ray-ordered, at every lanes-per-point G in 1..32 (the port
          launches `sample_layout`'s)
  samplers  K5 and K7 through their wrappers (`kron_sample_dgrid`,
          `trilinear_sample_pallas`) on both point sets at those shapes:
          the section to run in a copy of an earlier version of the port,
          beside this one, to time two designs in one call
  k9      the small-volume convolution K9 (`small_conv3d`) at each of
          the hydrant UNet's 51 routed calls (inputs and weights of the
          benchmark's hydrant model from a seed), checked bitwise against
          `F.conv3d` (cuDNN, TF32 off), with the L2 cache flushed before
          each call as in a step, whose 180 MB of used weights pass
          through it: ms a call by CUDA events (a CUDA graph of the flush
          and the call, replayed, less the flush's own) beside
          `F.conv3d`'s and the bound (`benchmark/counts/unet_small_convs`:
          used weights, bias, input and output at 3.35 TB/s or in-bounds
          FLOPs at 495 TFLOP/s), a line a call and a line a level; then a
          graphed UNet forward's device ms by kernel family
Each result is checked against the plain version (K4 and K7 1e-4
absolute, K5 and K6 1e-4 of their scale, K1/K3 1e-4 absolute, K2 1e-3 of
each cotangent's scale, as `chip_smoke.py`) after its line is printed;
device time per launch from torch.profiler
(`chip_smoke.device_ms_per_launch`). Needs a CUDA device.
"""
import argparse
import subprocess
import sys

SOURCES = ["kron_sample", "fused_decode", "fused_decode_bwd", "fused_render", "small_conv3d"]


def main():
    import torch

    if not torch.cuda.is_available():
        print("kernel_sweep.py: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--only", default="k4,k2,k6,decode,k5,k7,samplers,k9")
    opts = parser.parse_args()
    sections = opts.only.split(",")
    if len(sections) > 1:
        # one process per section: after some thirty profiling windows in
        # one process torch.profiler recorded 17 of 20 launches, every time
        from holo_diffusion_torch.ops import _build

        _build.build(SOURCES)
        for section in sections:
            rc = subprocess.run([sys.executable, __file__, "--only", section]).returncode
            if rc != 0:
                return rc
        return 0
    only = set(sections)
    from chip_smoke import (KERNEL_BWD_TOL, KERNEL_TOL, SAMPLE_COT_TOL, SAMPLE_TOL, decode_bwd_errors,
                            device_ms_per_launch, emit, ray_ordered_points)
    from holo_diffusion_torch.device import set_full_precision
    from holo_diffusion_torch.ops import _build
    from holo_diffusion_torch.ops import fused_decode as fd
    from holo_diffusion_torch.ops import fused_render as fr
    from holo_diffusion_torch.ops import kron_sample as ks
    from holo_diffusion_torch.ops.voxel import hat_corners

    set_full_precision()
    _build.build(SOURCES)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    D, C, hidden, extent = 16, 64, 256, 8.0
    grid = torch.tanh(torch.randn((D, D, D, C), generator=gen, device=dev))

    # ---- K4 at C 64 and C 257: lanes per point, random and ray-ordered points
    if "k4" in only:
        gen4 = torch.Generator(device=dev).manual_seed(6)
        R, P = 640, 128
        point_sets = {"random": (torch.rand((R * P, 3), generator=gen4, device=dev) * 2 - 1) * 0.6 * extent,
                      "ray_ordered": ray_ordered_points(gen4, R, P, extent).reshape(-1, 3).contiguous()}
        for c in (C, hidden + 1):
            g_c = torch.tanh(torch.randn((D, D, D, c), generator=gen4, device=dev))
            for label, pts in point_sets.items():
                want = ks.kron_sample_fwd_reference(g_c, pts, extent)
                for lanes_log2 in range(0, 6):
                    def call():
                        out = torch.empty((R * P, c), device=dev)
                        ks._launch("kron_sample_fwd", (pts.data_ptr(), g_c.data_ptr(), out.data_ptr()),
                                   g_c.shape, R * P, extent, device=dev, layout_log2=lanes_log2)
                        return out
                    err = float((call() - want).abs().max())
                    ms = device_ms_per_launch(call, "kron_sample_fwd_kernel")
                    emit({"sweep": "k4", "points": label, "n": R * P, "channels": c, "lanes": 1 << lanes_log2,
                          "port_layout": lanes_log2 == ks.sample_layout(c)[0], "ms": ms, "max_abs_err": err,
                          "tol": SAMPLE_TOL})
                    if not err <= SAMPLE_TOL:
                        raise AssertionError(f"K4 at C {c}, G {1 << lanes_log2} ({label}): {err}")

    # ---- K2 on random and ray-ordered points
    if "k2" in only:
        gen2 = torch.Generator(device=dev).manual_seed(7)
        R, P = 3 * 1024, 128
        A = torch.randn((C, hidden + 1), generator=gen2, device=dev) / C ** 0.5
        c_ = 0.1 * torch.randn((hidden + 1,), generator=gen2, device=dev)
        Wr = torch.randn((hidden + 27, 3), generator=gen2, device=dev) / (hidden + 27) ** 0.5
        br = 0.1 * torch.randn((3,), generator=gen2, device=dev)
        pe = torch.randn((R, 27), generator=gen2, device=dev)
        g = torch.randn((R, P, 4), generator=gen2, device=dev)
        point_sets = {"random": (torch.rand((R, P, 3), generator=gen2, device=dev) * 2 - 1) * 0.6 * extent,
                      "ray_ordered": ray_ordered_points(gen2, R, P, extent)}
        for label, pts in point_sets.items():
            args = (grid, A, c_, Wr, br, pts, pe, extent, hidden, g)
            _, rel, near_zero, away_rel = decode_bwd_errors(
                args, fd._fused_sample_decode_bwd_cuda(*args), fd.fused_sample_decode_bwd_reference(*args))
            ms = device_ms_per_launch(lambda: fd._fused_sample_decode_bwd_cuda(*args), "fused_decode_bwd_kernel")
            emit({"sweep": "k2", "points": label, "n": R * P, "ms": ms, "rel_errs": rel, "rel_tol": KERNEL_BWD_TOL,
                  "nonzero_pre_activations_below_1e-6": near_zero, "d_grid_rel_err_where_slopes_agree": away_rel})
            if not max(rel.values()) <= KERNEL_BWD_TOL:
                raise AssertionError(f"K2 ({label}): {rel}")

    def cell_order(pts):
        cells, _, _ = hat_corners(pts, D, D, D, extent)
        return torch.argsort(cells[:, 0])

    # ---- K6 at C 64: lanes per point
    if "k6" in only:
        n = 3 * 1024 * 128
        pts = (torch.rand((n, 3), generator=gen, device=dev) * 2 - 1) * 0.6 * extent
        cot = torch.randn((n, C), generator=gen, device=dev)
        order = cell_order(pts)
        for label, p, g in (("random", pts, cot), ("cell_order", pts[order], cot[order])):
            want = ks.kron_sample_dpoints_reference(grid, p, g, extent)
            scale = float(want.abs().max())
            for lanes_log2 in range(1, 6):
                def call():
                    out = torch.empty_like(p)
                    ks._launch("kron_sample_dpoints", (p.data_ptr(), g.data_ptr(), grid.data_ptr(), out.data_ptr()),
                               grid.shape, n, extent, D / extent, device=dev, layout_log2=lanes_log2)
                    return out
                err = float((call() - want).abs().max())
                ms = device_ms_per_launch(call, "kron_sample_dpoints_kernel")
                emit({"sweep": "k6", "points": label, "n": n, "channels": C, "lanes": 1 << lanes_log2,
                      "port_layout": lanes_log2 == ks.dpoints_layout(C)[0], "ms": ms, "max_abs_err": err,
                      "tol": SAMPLE_COT_TOL * scale})
                if not err <= SAMPLE_COT_TOL * scale:
                    raise AssertionError(f"K6 at G {1 << lanes_log2}: {err}")

    # ---- K1/K3: gather locality at both render chunks
    if "decode" in only:
        A = torch.randn((C, hidden + 1), generator=gen, device=dev) / C ** 0.5
        c = 0.1 * torch.randn((hidden + 1,), generator=gen, device=dev)
        Wr = torch.randn((hidden + 27, 3), generator=gen, device=dev) / (hidden + 27) ** 0.5
        br = 0.1 * torch.randn((3,), generator=gen, device=dev)
        g1 = torch.einsum("dhwc,c->dhw", grid, A[:, -1])
        R = 640
        pe = torch.randn((R, 27), generator=gen, device=dev)
        for P in (64, 128):
            pts = (torch.rand((R * P, 3), generator=gen, device=dev) * 2 - 1) * 0.6 * extent
            for label, p in (("random", pts), ("cell_order", pts[cell_order(pts)])):
                p = p.reshape(R, P, 3)
                for normals in (False, True):
                    kw = {"g1": g1} if normals else {}
                    args = (grid, A, c, Wr, br, p, pe, extent, hidden)
                    with torch.no_grad():
                        got = fd.fused_sample_decode(*args, **kw)
                        want = fd.fused_sample_decode_reference(*args, **kw)
                        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
                        ms = device_ms_per_launch(lambda: fd.fused_sample_decode(*args, **kw), "fused_decode_kernel")
                    emit({"sweep": "decode", "kernel": fd.ENTRY_POINTS[int(normals)], "points": label, "n": R * P,
                          "ms": ms, "max_abs_err": err, "tol": KERNEL_TOL})
                    if not err <= KERNEL_TOL:
                        raise AssertionError(f"decode ({label}, P {P}): {err}")

    # ---- K5 and K7 on random and ray-ordered points: their layouts, and
    # the wrappers alone (the section an earlier version runs too)
    if only & {"k5", "k7", "samplers"}:
        gen5 = torch.Generator(device=dev).manual_seed(8)
        sets = {}
        for label, R, P in (("train", 3 * 1024, 128), ("chunk", 640, 128)):
            sets[label] = {
                "random": (torch.rand((R * P, 3), generator=gen5, device=dev) * 2 - 1) * 0.6 * extent,
                "ray_ordered": ray_ordered_points(gen5, R, P, extent).reshape(-1, 3).contiguous()}
        cot = torch.randn((3 * 1024 * 128, C), generator=gen5, device=dev)

        def check_dgrid(label, pts, got, want, **rec):
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            emit({"points": label, "n": pts.shape[0], "channels": C, "max_abs_err": err,
                  "tol": SAMPLE_COT_TOL * scale, **rec})
            if not err <= SAMPLE_COT_TOL * scale:
                raise AssertionError(f"K5 ({label}, {rec}): {err}")

        def check_sample(label, pts, got, want, **rec):
            err = float((got - want).abs().max())
            emit({"points": label, "n": pts.shape[0], "channels": C, "max_abs_err": err, "tol": SAMPLE_TOL, **rec})
            if not err <= SAMPLE_TOL:
                raise AssertionError(f"K7 ({label}, {rec}): {err}")

        for label, pts in sets["train"].items():
            want = ks.kron_sample_dgrid_reference(pts, cot, grid.shape, extent)
            if "samplers" in only:
                call = lambda: ks.kron_sample_dgrid(pts, cot, grid.shape, extent)  # noqa: E731
                ms = device_ms_per_launch(call, "kron_sample_dgrid_kernel")
                check_dgrid(label, pts, call(), want, sweep="samplers", kernel="kron_sample_dgrid", ms=ms)
            if "k5" in only:
                for tile_log2 in range(5, 9):
                    for run_log2 in range(3, 6):
                        def call():
                            out = torch.zeros(grid.shape, device=dev)
                            ks._launch("kron_sample_dgrid", (pts.data_ptr(), cot.data_ptr(), out.data_ptr()),
                                       grid.shape, pts.shape[0], extent, tile_log2, device=dev,
                                       layout_log2=run_log2)
                            return out
                        ms = device_ms_per_launch(call, "kron_sample_dgrid_kernel")
                        check_dgrid(label, pts, call(), want, sweep="k5", tile=1 << tile_log2, run=1 << run_log2,
                                    port_layout=(tile_log2, run_log2) == (ks.DGRID_TILE_LOG2, ks.DGRID_RUN_LOG2),
                                    ms=ms)
        for label, pts in sets["chunk"].items():
            want = fr.trilinear_sample_onehot_reference(grid, pts, extent)
            if "samplers" in only:
                call = lambda: fr.trilinear_sample_pallas(grid, pts, extent)  # noqa: E731
                ms = device_ms_per_launch(call, "trilinear_sample_onehot_kernel")
                check_sample(label, pts, call(), want, sweep="samplers", kernel="trilinear_sample_onehot", ms=ms)
            if "k7" in only:
                for lanes_log2 in range(0, 6):
                    def call():
                        out = torch.empty((pts.shape[0], C), device=dev)
                        _build.launch("trilinear_sample_onehot", pts.data_ptr(), grid.data_ptr(), out.data_ptr(),
                                      pts.shape[0], D, D, D, C, lanes_log2, extent / D, device=dev)
                        return out
                    ms = device_ms_per_launch(call, "trilinear_sample_onehot_kernel")
                    check_sample(label, pts, call(), want, sweep="k7", lanes=1 << lanes_log2,
                                 port_layout=lanes_log2 == ks.sample_layout(C)[0], ms=ms)

    if "k9" in only:
        small_conv_sweep(dev, emit)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


def small_conv_sweep(dev, emit, seed=2 ** 31 + 27, iters=20):
    """K9 against `F.conv3d` at the hydrant UNet's routed calls (module
    docstring, `k9`)."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from benchmark.counts.unet_small_convs import Conv
    from benchmark.harness.manifest import Manifest
    from benchmark.harness.program import Context, program_model
    from chip_smoke import device_rows
    from holo_diffusion_torch.models.unet3d import RoutedConv3d
    from holo_diffusion_torch.ops import small_conv3d as sc

    man = Manifest()
    ctx = Context(man.config("hydrant"), man.mix("sample"), man.limits("hydrant.sample"), seed, dev)
    model = program_model(ctx, ctx.weights()).eval()
    unet = model.net_3d
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(1, model.resol, model.resol, model.resol, model.feature_size, generator=g, device=dev)
    t = torch.tensor([500], device=dev)
    calls = []

    def grab(conv, args):
        if sc.refusal(args[0].shape, args[0].device, args[0].dtype, conv) is None:
            calls.append((args[0].clone(), conv))

    hooks = [m.register_forward_pre_hook(grab) for m in unet.modules() if isinstance(m, RoutedConv3d)]
    with torch.no_grad():
        unet._forward(x, t)
    for h in hooks:
        h.remove()
    flush = torch.empty(256 * 2 ** 20 // 4, device=dev)

    def replay_ms(*fns):
        """ms of one replay of a CUDA graph of a 256 MB fill (the L2 cache
        flushed, as in a step whose weights pass through it) and fns, by
        CUDA events over `iters` replays."""
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for fn in fns:
                fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            flush.zero_()
            for fn in fns:
                fn()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    levels = {}
    with torch.no_grad():
        fill_ms = replay_ms()
        for i, (inp, conv) in enumerate(calls):
            k, stride = conv.kernel_size[0], conv.stride
            n_in = inp.shape[-1]
            n_out = sc.output_extent(n_in, k, stride[0], k // 2)
            count = Conv(conv.in_channels, conv.out_channels, k, stride[0], n_in, n_out, inp.shape[0])
            walk = sc.kind(inp.shape[2:], k, stride, len(sc.used_taps(inp.shape[2:], k, stride)))
            ref = lambda: F.conv3d(inp, conv.weight, conv.bias, stride, k // 2)  # noqa: E731
            k9 = lambda: sc.small_conv3d(inp, conv.weight, conv.bias, stride)  # noqa: E731
            got, want, again = k9(), ref(), k9()
            err = float((got - want).abs().max())
            bound = count.least_seconds(495e12, 3.35e12) * 1e3
            ms_k9, ms_lib = replay_ms(k9) - fill_ms, replay_ms(ref) - fill_ms
            emit({"sweep": "k9", "call": i, "cin": count.cin, "cout": count.cout, "k": k, "stride": stride[0],
                  "n_in": n_in, "n_out": n_out, "walk": walk,
                  "ms": ms_k9, "library_ms": ms_lib, "bound_ms": bound, "max_abs_err": err,
                  "bitwise_rerun": bool(torch.equal(got, again))})
            if not (err == 0 and torch.equal(got, again)):
                raise AssertionError(f"K9 call {i}: {err} from cuDNN, rerun bitwise {torch.equal(got, again)}")
            lv = levels.setdefault(n_out, {"convs": 0, "ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "used_mb": 0.0})
            lv["convs"] += 1
            lv["ms"] += ms_k9
            lv["library_ms"] += ms_lib
            lv["bound_ms"] += bound
            lv["used_mb"] += 4 * count.used_weights / 1e6
    for n_out, lv in sorted(levels.items()):
        emit({"sweep": "k9_level", "voxels": f"{n_out}^3", **lv, "k9_launches": lv["convs"]})

    # a graphed forward's device time by kernel family
    n_fwd = 10
    with torch.no_grad():
        for _ in range(3):
            unet(x, t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n_fwd):
                unet(x, t)
            torch.cuda.synchronize()
    fam = {}
    for e in device_rows(prof):
        if e.self_device_time_total > 0:
            key = ("k9" if "small_conv3d" in e.key else "library_conv" if "conv" in e.key.lower()
                   or "implicit_gemm" in e.key else "other")
            fam[key] = fam.get(key, 0.0) + e.self_device_time_total / 1e3 / n_fwd
    emit({"sweep": "k9_forward", "device_ms_a_forward": fam, "routed_calls": len(calls)})


if __name__ == "__main__":
    sys.exit(main())
