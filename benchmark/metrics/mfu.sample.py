"""The DDPM step's share of the card's peak: the UNet's FLOPs per
evaluation from the configuration's layer shapes (`counts.model.ddpm_step`:
convolutions, linear layers, GroupNorm, attention products) over the traced
window's seconds per step, against 495 TFLOP/s (dense TF32,
`harness/peaks.py`). Layer: sampler and denoiser (`sampling.py`,
`models/diffusion.py`, `models/unet3d.py`). Moves sample_grid_s."""
from benchmark.harness.peaks import PEAK_FLOPS

UNIT = "%"


def read(run):
    if run.trace is None or run.units == 0:
        return None
    return 100.0 * sum(run.flops_per_unit.values()) / (run.trace.window_s / run.units) / PEAK_FLOPS
