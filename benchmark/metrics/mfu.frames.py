"""The whole frame's share of the card's peak: model FLOPs per frame
(`counts.model.frame`: the decode of both passes, normals included) over
the traced window's seconds per frame, against 495 TFLOP/s (dense TF32,
`harness/peaks.py`). Layer: the whole frame. Moves frame_s."""
from benchmark.harness.peaks import PEAK_FLOPS

UNIT = "%"


def read(run):
    if run.trace is None or run.units == 0:
        return None
    return 100.0 * sum(run.flops_per_unit.values()) / (run.trace.window_s / run.units) / PEAK_FLOPS
