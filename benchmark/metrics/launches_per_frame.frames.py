"""Device operations (kernels, copies, sets) in the traced window per
512^2 frame. Layer: the chunk loop (`render_eval.py`
`render_image_chunked`, `models/renderer.py`). Moves frame_s."""
UNIT = "launches"


def read(run):
    if run.trace is None or run.units == 0 or run.trace.launches == 0:
        return None
    return run.trace.launches / run.units
