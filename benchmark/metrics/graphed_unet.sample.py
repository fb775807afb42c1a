"""The share of the DDPM steps' UNet forwards replayed from a CUDA graph:
the program's counters `unet_graphed` and `unet_eager`
(`models/unet3d.py` `UNetModel3D.forward`: each forward adds 1 to the one
of the path it took) over the traced steps, read after the traced window,
as `graphed_chunks.frames` reads its pair. None from a program without the
counters. Layer: sampler and denoiser (`sampling.py`,
`models/diffusion.py`, `models/unet3d.py`). Moves sample_grid_s: a
replayed forward costs the host a copy of each input, one replay and a
copy of the output in place of the UNet's launches."""
UNIT = "%"


def read(run):
    if run.trace is None or run.units == 0:
        return None
    try:
        from holo_diffusion_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    graphed, eager = c.get("unet_graphed", 0), c.get("unet_eager", 0)
    if graphed + eager == 0:
        return None
    return 100.0 * graphed / (graphed + eager)
