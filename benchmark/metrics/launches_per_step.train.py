"""Device operations (kernels, copies, sets) in the traced window per
training step. Layer: the train step (`parallel/train_step.py`,
`models/holo_model.py`, `train/optimizer.py`). Moves train_step_s."""
UNIT = "launches"


def read(run):
    if run.trace is None or run.units == 0 or run.trace.launches == 0:
        return None
    return run.trace.launches / run.units
