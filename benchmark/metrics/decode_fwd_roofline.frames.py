"""The decode forward's share of its roofline in a frame: the least time of
the decode (with normals) that the frame's chunks need, pass by pass
(`counts.decode.decode_cost`, one launch a chunk and pass: the larger of
bytes at 3.35 TB/s and FLOPs at 495 TFLOP/s), over the device time of the
kernels named below in the traced window. Layer: kernels
(`ops/fused_decode.py` -> `csrc/fused_decode.cu`). Moves frame_s. A
kernel that replaces this one gets a metric file of its own."""
from benchmark.counts import decode as dc
from benchmark.harness.peaks import PEAK_BYTES_PER_S, PEAK_FLOPS

UNIT = "%"
KERNELS = ("fused_decode_kernel",)


def read(run):
    if run.trace is None or run.units == 0:
        return None
    seconds = run.trace.device_seconds(*KERNELS)
    if seconds <= 0:
        return None
    s = run.spec
    hidden, pe = int(s.mlp["dnet_hidden_dim"]), dc.pe_dim(s)
    n_rays = dc.frame_rays(s)
    chunk = max(s.chunk_size_grid // s.n_pts_eval, 1) if s.chunk_size_grid else n_rays
    least = 0.0
    for start in range(0, n_rays, chunk):
        for pts, rays in dc.render_passes(s, min(chunk, n_rays - start), False):
            n_bytes, flops = dc.decode_cost(pts, rays, dc.grid_shape(s), hidden, pe, s.render_normals)
            least += dc.least_seconds(n_bytes, flops, PEAK_FLOPS, PEAK_BYTES_PER_S)
    return 100.0 * least * run.units / seconds
