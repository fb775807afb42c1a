"""The whole training step's share of the card's peak: model FLOPs per step
(`counts.model.train_step`: forward and backward, no recompute, the
denoiser's FLOPs from `counts/net3d_<net_3d_class_type>.py` with the
bootstrap pass at its probability; every category summed) over the traced
window's seconds per step, against 495 TFLOP/s (dense TF32,
`harness/peaks.py`). Layer: the whole step. Moves train_step_s."""
from benchmark.harness.peaks import PEAK_FLOPS

UNIT = "%"


def read(run):
    if run.trace is None or run.units == 0:
        return None
    return 100.0 * sum(run.flops_per_unit.values()) / (run.trace.window_s / run.units) / PEAK_FLOPS
