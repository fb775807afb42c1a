#!/usr/bin/env python3
"""Layout and locality sweeps of two port kernels on one GPU.

    python3 kernel_sweep.py

Prints one JSON line per measurement, then the card's name and power limit:
  k6      the points cotangent K6 (`kron_sample_dpoints`) at C 64 with a
          random cotangent over a hydrant training fine pass (393,216
          points), at every lanes-per-point G in 2..32 (the kernel takes any
          G; the port launches `dpoints_layout`'s), on random points and on
          the same points in grid-cell order
  decode  the fused decode K1/K3 at both render chunks (640 rays x 64 and
          x 128 points) on random points and in grid-cell order: how much of
          its time the gather's locality sets
Each result is checked against the plain version (K6 1e-4 of its scale,
K1/K3 1e-4 absolute, as `chip_smoke.py`); device time per launch from
torch.profiler (`chip_smoke.device_ms_per_launch`). Needs a CUDA device.
"""
import json
import subprocess
import sys


def main():
    import torch

    if not torch.cuda.is_available():
        print("kernel_sweep.py: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import KERNEL_TOL, SAMPLE_COT_TOL, device_ms_per_launch, emit
    from holo_diffusion_torch.device import set_full_precision
    from holo_diffusion_torch.ops import _build
    from holo_diffusion_torch.ops import fused_decode as fd
    from holo_diffusion_torch.ops import kron_sample as ks
    from holo_diffusion_torch.ops.voxel import hat_corners

    set_full_precision()
    _build.build(["kron_sample", "fused_decode"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    D, C, hidden, extent = 16, 64, 256, 8.0
    grid = torch.tanh(torch.randn((D, D, D, C), generator=gen, device=dev))

    def cell_order(pts):
        cells, _, _ = hat_corners(pts, D, D, D, extent)
        return torch.argsort(cells[:, 0])

    # ---- K6 at C 64: lanes per point
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
                           grid.shape, n, extent, D / extent, device=dev, lanes_log2=lanes_log2)
                return out
            err = float((call() - want).abs().max())
            ms = device_ms_per_launch(call, "kron_sample_dpoints_kernel")
            emit({"sweep": "k6", "points": label, "n": n, "channels": C, "lanes": 1 << lanes_log2,
                  "port_layout": lanes_log2 == ks.dpoints_layout(C)[0], "ms": ms, "max_abs_err": err,
                  "tol": SAMPLE_COT_TOL * scale})
            if not err <= SAMPLE_COT_TOL * scale:
                raise AssertionError(f"K6 at G {1 << lanes_log2}: {err}")

    # ---- K1/K3: gather locality at both render chunks
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

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
