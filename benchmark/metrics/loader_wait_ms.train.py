"""Host milliseconds per training step spent blocked in the loader's
`next()` (AsyncLoader's queue), timed by the benchmark around the call.
Layer: loop and data feed (`experiment.py` `_to_device`, `data/source.py`
`AsyncLoader`). Moves train_step_s."""
UNIT = "ms"


def read(run):
    waits = run.host.get("loader_wait_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
