"""The DiT's fused attention's share of its roofline in a training step: the
least time of the attention products (q.k and w.v, 4 x d x T^2 a block,
`counts/net3d_DiT3D.py`) that the traced window's DiT passes need, each
forward's at 495 TFLOP/s and its backward at twice that, over the device
time of the memory-efficient attention's kernels named below. The passes are
the program's counter `dit_forwards` over the window (a step takes one or,
when its bootstrap coin comes up, two). Layer: denoiser (`models/dit3d.py`
`attention`). Moves train_step_s. None without a DiT, without such kernels
in the trace, or from a program without the counter."""
from benchmark.counts.model import net_3d_forward
from benchmark.harness.peaks import PEAK_FLOPS

UNIT = "%"
KERNELS = ("fmha_cutlassF", "fmha_cutlassB")


def read(run):
    if run.trace is None or run.units == 0 or run.spec.net_3d_type != "DiT3D":
        return None
    seconds = run.trace.device_seconds(*KERNELS)
    if seconds <= 0:
        return None
    try:
        from holo_diffusion_torch.utils.profiling import counters
    except ImportError:
        return None
    passes = counters().get("dit_forwards", 0)
    if not passes:
        return None
    least = 3.0 * net_3d_forward(run.spec)["attention"] * passes / PEAK_FLOPS
    return 100.0 * least / seconds
