"""The small-volume convolution kernel's share of its roofline in a DDPM
step: the least time of the UNet's 3D convolutions whose output has at
most 64 positions (`counts/unet_small_convs.py`, from the configuration's
shapes alone: each convolution's used weights, bias, input and output at
3.35 TB/s or its in-bounds FLOPs at 495 TFLOP/s, the larger), over the
device time of the kernel named below a traced step. None where the trace
holds none of them (a program without the kernel) or the denoiser is not
the UNet. Layer: kernels (`ops/small_conv3d.py` -> `csrc/small_conv3d.cu`,
K9). Moves sample_grid_s."""
from benchmark.counts import unet_small_convs as sc
from benchmark.harness.peaks import PEAK_BYTES_PER_S, PEAK_FLOPS

UNIT = "%"
KERNELS = ("small_conv3d_kernel",)


def read(run):
    if run.trace is None or run.units == 0 or run.spec.net_3d_type != "SimpleUnet3D":
        return None
    seconds = run.trace.device_seconds(*KERNELS)
    if seconds <= 0:
        return None
    least = sum(c.least_seconds(PEAK_FLOPS, PEAK_BYTES_PER_S) for c in sc.small_convs(run.spec))
    return 100.0 * least * run.units / seconds
