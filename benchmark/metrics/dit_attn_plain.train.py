"""DiT attention calls a training step that took the plain route, the T x T
scores written out: the program's counter `dit_attn_plain`
(`models/dit3d.py` `attention`, beside `dit_attn_fused`: each call adds 1
to the one of its route) over the traced steps, read after the traced
window. The counters count only while a torch profiler records, and the
window's profiler is the one a run starts, so they hold the window's calls
alone. 0 where every attention call runs the fused kernel; None from a
program without the counters. Layer: denoiser. Moves train_step_s: the
plain route holds 16 x 4,096^2 scores a block and pass."""
UNIT = "calls"


def read(run):
    if run.trace is None or run.units == 0:
        return None
    try:
        from holo_diffusion_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    if "dit_attn_fused" not in c and "dit_attn_plain" not in c:
        return None
    return c.get("dit_attn_plain", 0) / run.units
