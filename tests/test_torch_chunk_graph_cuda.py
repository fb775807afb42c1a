"""The chunk loop's CUDA graphs (holo_diffusion_torch/render_eval.py) on the
card, at the hydrant release config and at the reference model's 32^3 x
128 grid (K3 at C 128), each built with the benchmark's weights from a
seed: a graphed 512^2 frame against the eager chunk-by-chunk render of the
same pose, the tail chunk included; outputs of poses replayed back to back
that do not alias each other or the graphs' memory; a new capture for
moved weights and for a new grid shape; the skip path against its eager
render; and the graph's K3 launches in a torch.profiler trace. Every test
here is marked `cuda` and skips without a CUDA device. The file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_chunk_graph_cuda.py -m cuda -q
"""
import pytest
import torch

from holo_diffusion_torch import render_eval
from holo_diffusion_torch.ops import fused_decode as fd
from holo_diffusion_torch.utils.profiling import counters, reset_counters

# a graphed chunk and an eager one launch the same kernels on the same
# inputs; the packed rays are strided views where the eager chunk's are not
TOL = 1e-6
# K3's kernel at C 64 and at C 128 (a frame renders normals, so K3 alone)
K3_BY_CONFIG = {"hydrant": "fused_decode_kernel", "hydrant_g32c128": "decode_c128_fwd_kernel"}


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


_cells = {}


def _cell(config):
    """The benchmark's frames cell of `config`, set up (its frame 0
    rendered, so its graphs captured): model, grid and the orbit's poses."""
    if config not in _cells:
        from benchmark.harness.kinds import frames
        from benchmark.harness.manifest import Manifest
        from benchmark.harness.program import Context

        man = Manifest()
        cell = frames.Cell(Context(man.config(config), man.mix("frames"), man.limits("hydrant.frames"),
                                   2 ** 31 + 2203, _device()))
        cell.setup()
        _cells[config] = cell
    return _cells[config]


def _eager(model, camera, grid, occupancy=None):
    """The chunks of `render_image_chunked`, each rendered on the card by
    its own launches (`render_eval.render_packed`, what a graph captures)."""
    H, W = model.render_image_height, model.render_image_width
    step = model.chunk_size_grid // model.n_pts_per_ray_evaluation
    rays = render_eval.pack_rays(model.full_grid_rays(camera, H, W))
    with torch.no_grad():
        frame = torch.cat([render_eval.render_packed(model, grid, rays[s:s + step], occupancy, 128)
                           for s in range(0, H * W, step)])
    return render_eval.unpack_frame(frame, H, W)


def _assert_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        err = float((got[k] - want[k]).abs().max())
        assert err <= TOL, f"{k}: {err:.3e}"


def _graphs(model, dev):
    return render_eval._ChunkGraphs._of[model][torch.device(dev.type, torch.cuda.current_device())]


@pytest.mark.cuda
@pytest.mark.parametrize("config", list(K3_BY_CONFIG))
def test_graphed_frame_matches_the_eager_render(config):
    """410 chunks, the last of 384 rays, each replayed, against the same
    chunks rendered by their own launches: images, depths, masks, normals."""
    dev = _device()
    cell = _cell(config)
    model, grid = cell.model, cell.grid
    assert model.render_image_height * model.render_image_width % 640 == 384
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        reset_counters()
        got = render_eval.render_image_chunked(model, cell.cams[3], grid, device=dev)
        counted = counters()
    assert counted["chunks_graphed"] == 410 and "chunks_eager" not in counted
    assert "chunk_graph_captures" not in counted  # captured in the set-up's frame
    assert sorted(got) == ["depths_render", "images_render", "masks_render", "normals_render"]
    _assert_close(got, _eager(model, cell.cams[3], grid))


@pytest.mark.cuda
def test_poses_replayed_back_to_back_do_not_alias():
    dev = _device()
    cell = _cell("hydrant")
    a = render_eval.render_image_chunked(cell.model, cell.cams[5], cell.grid, device=dev)
    a_copy = {k: v.clone() for k, v in a.items()}
    b = render_eval.render_image_chunked(cell.model, cell.cams[25], cell.grid, device=dev)
    for k in a:
        assert torch.equal(a[k], a_copy[k]), k
        assert not torch.equal(a[k], b[k]), k
    frames = {x["images_render"].untyped_storage().data_ptr() for x in (a, b)}
    static = {entry[2].untyped_storage().data_ptr() for entry in _graphs(cell.model, dev).graphs.values()}
    assert len(frames) == 2 and not frames & static


@pytest.mark.cuda
def test_moved_weights_and_a_new_grid_shape_capture_anew():
    """The weights moved off the card and back (their old storage held, so
    the new one lies elsewhere), then a grid of another shape: two new
    graphs each, 640 rays and the tail's 384, whose warm-ups alone add to
    the launch counter (K3 once a pass), not their captures."""
    dev = _device()
    cell = _cell("hydrant")
    model = cell.model
    render_eval.render_image_chunked(model, cell.cams[0], cell.grid, device=dev)
    before = dict(_graphs(model, dev).graphs)
    assert len(before) == 2
    want = _eager(model, cell.cams[0], cell.grid)
    held = list(model.state_dict().values())
    model.to("cpu").to(dev)
    fd.reset_launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        reset_counters()
        got = render_eval.render_image_chunked(model, cell.cams[0], cell.grid, device=dev)
        small = cell.grid[::2, ::2, ::2].contiguous()
        render_eval.render_image_chunked(model, cell.cams[0], small, device=dev)
        counted = counters()
    del held
    after = _graphs(model, dev).graphs
    assert counted["chunk_graph_captures"] == 4 and len(after) == 4
    assert fd.launch_counts()["fused_decode_fwd_normals"] == 4 * model.num_passes
    assert not any(g[0] is b[0] for g in after.values() for b in before.values())
    _assert_close(got, want)


@pytest.mark.cuda
def test_skip_path_matches_its_eager_render():
    dev = _device()
    cell = _cell("hydrant")
    occ = render_eval.compute_occupancy(cell.model, cell.grid)
    got = render_eval.render_image_chunked(cell.model, cell.cams[7], cell.grid, device=dev, occupancy=occ)
    _assert_close(got, _eager(cell.model, cell.cams[7], cell.grid, occupancy=occ))
    mask_only = render_eval.render_image_chunked(cell.model, cell.cams[7], cell.grid, device=dev,
                                                 occupancy=occ[0])
    _assert_close(mask_only, _eager(cell.model, cell.cams[7], cell.grid, occupancy=(occ[0], False)))


@pytest.mark.cuda
@pytest.mark.parametrize("config", list(K3_BY_CONFIG))
def test_profiler_sees_the_graphs_kernels(config):
    """A frame replayed from graphs captured before the profiler started:
    the trace holds K3 twice a chunk, as the benchmark's metrics read it,
    and the launch counters, which count the host's launches, none."""
    dev = _device()
    cell = _cell(config)
    fd.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        render_eval.render_image_chunked(cell.model, cell.cams[11], cell.grid, device=dev)
        torch.cuda.synchronize()
    k3 = [e for e in prof.profiler.kineto_results.events()
          if "CUDA" in str(e.device_type()) and K3_BY_CONFIG[config] in e.name()]
    assert len(k3) == 820
    assert sum(fd.launch_counts().values()) == 0
