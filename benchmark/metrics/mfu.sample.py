"""The DDPM step's share of the card's peak: the FLOPs of one evaluation
of the denoiser the configuration names, from its layer shapes
(`counts.model.ddpm_step` through `counts/net3d_<net_3d_class_type>.py`:
for the UNet, convolutions, linear layers, GroupNorm, attention products;
every category summed) over the traced window's seconds per step, against
495 TFLOP/s (dense TF32, `harness/peaks.py`). Layer: sampler and denoiser
(`sampling.py`, `models/diffusion.py`, `models/unet3d.py`). Moves
sample_grid_s."""
from benchmark.harness.peaks import PEAK_FLOPS

UNIT = "%"


def read(run):
    if run.trace is None or run.units == 0:
        return None
    return 100.0 * sum(run.flops_per_unit.values()) / (run.trace.window_s / run.units) / PEAK_FLOPS
