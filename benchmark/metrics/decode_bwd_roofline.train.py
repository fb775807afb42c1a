"""The decode backward's share of its roofline in a training step: the
least time of the backward that the step's two render passes need
(`counts.decode.decode_bwd_cost`, one launch a pass: the larger of bytes at
3.35 TB/s and FLOPs at 495 TFLOP/s) over the device time of the kernels
named below in the traced window. Layer: kernels (`ops/fused_decode.py` ->
`csrc/fused_decode_bwd.cu`). Moves train_step_s. A kernel that replaces
this one gets a metric file of its own."""
from benchmark.counts import decode as dc
from benchmark.harness.peaks import PEAK_BYTES_PER_S, PEAK_FLOPS

UNIT = "%"
KERNELS = ("fused_decode_bwd_kernel",)


def read(run):
    if run.trace is None or run.units == 0:
        return None
    seconds = run.trace.device_seconds(*KERNELS)
    if seconds <= 0:
        return None
    s = run.spec
    hidden, pe = int(s.mlp["dnet_hidden_dim"]), dc.pe_dim(s)
    least = 0.0
    for pts, rays in dc.render_passes(s, dc.train_rays(s, run.config["data"]["frames"]), True):
        n_bytes, flops, _ = dc.decode_bwd_cost(pts, rays, dc.grid_shape(s), hidden, pe)
        least += dc.least_seconds(n_bytes, flops, PEAK_FLOPS, PEAK_BYTES_PER_S)
    return 100.0 * least * run.units / seconds
