"""The share of a frame's chunks replayed from a CUDA graph: the program's
counters `chunks_graphed` and `chunks_eager` (`render_eval.py`
`render_image_chunked`: each chunk adds 1 to the one of the path it took)
over the traced frames, read after the traced window, as
`layer_decodes.train` reads its counters. None from a program without the
counters. Layer: the chunk loop (`render_eval.py`). Moves frame_s: a
replayed chunk costs the host two copies and one replay in place of the
render's launches."""
UNIT = "%"


def read(run):
    if run.trace is None or run.units == 0:
        return None
    try:
        from holo_diffusion_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    graphed, eager = c.get("chunks_graphed", 0), c.get("chunks_eager", 0)
    if graphed + eager == 0:
        return None
    return 100.0 * graphed / (graphed + eager)
