"""Decode calls a training step that took the layer-by-layer route: the
program's counter `decodes_layer` (`models/implicit.py`, beside
`decodes_fused`: each decode call adds 1 to the one of its route) over the
traced steps, read after the traced window. The counters count only while a
torch profiler records, and the window's profiler is the one a run starts,
so they hold the window's calls alone. 0 where every decode runs on the
fused-decode kernels; None from a program without the counters. Layer:
implicit function (`models/implicit.py` `decode_route`). Moves
train_step_s: a layer-by-layer decode samples the C channels and runs the
RenderMLP layer by layer, its normals by autograd through the sampler."""
UNIT = "calls"


def read(run):
    if run.trace is None or run.units == 0:
        return None
    try:
        from holo_diffusion_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    if "decodes_fused" not in c and "decodes_layer" not in c:
        return None
    return c.get("decodes_layer", 0) / run.units
