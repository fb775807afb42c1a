"""The device's idle share of the traced window: 1 - (the union of its
kernel, copy and set intervals) / (the window's host wall time), both from
the same window. Layer: the device. Moves train_step_s."""
UNIT = "%"


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
