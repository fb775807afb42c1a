"""Megabytes a training batch copies from the host to the card: the
program's counters `h2d_bytes` over `h2d_batches`
(`holo_diffusion_torch/utils/profiling.py`; `Experiment._to_device` adds
each host batch it pins and copies, in the loader's thread), read after the
traced window. The counters count only while a torch profiler records, and
the window's profiler is the one a run starts, so they hold the window's
batches alone. None from a program without them. Layer: loop and data feed
(`experiment.py` `_to_device`, `data/source.py` `AsyncLoader`). Moves
train_step_s only through the batch's size: the figure is set by what a
batch carries and in which dtypes, so it reads the same in every run and
moves only when that transfer format changes; the copy itself overlaps the
step in the loader's thread."""
UNIT = "MB"


def read(run):
    if run.trace is None:
        return None
    try:
        from holo_diffusion_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("h2d_batches"):
        return None
    return c["h2d_bytes"] / c["h2d_batches"] / 1e6
