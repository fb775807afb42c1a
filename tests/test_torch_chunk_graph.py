"""The chunk loop (holo_diffusion_torch/render_eval.py) on the CPU, where its
CUDA graphs do not engage: the packed whole-frame rays and the packed
frame that every chunk, eager or graphed, reads and writes give exactly
the chunk-by-chunk render of the ray bundle's slices, with and without
normals and the empty-space skip; the CPU's eager loop counts its chunks;
and the graphs' cache key follows where the weights are stored, not their
values.
The card's side is tests/test_torch_chunk_graph_cuda.py."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import pytest
import torch

from holo_diffusion_torch import render_eval
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel
from holo_diffusion_torch.ops.occupancy import tighten_ray_bundle
from holo_diffusion_torch.utils.flyaround import simple_360_cameras
from holo_diffusion_torch.utils.profiling import counters, reset_counters

# a serving-only model small enough for a 512^2 frame on the CPU; its 20 x
# 20 frame is 8 chunks of 48 rays and a tail chunk of 16
TINY = dict(
    resol=4, volume_extent=3.0, feature_size=32, n_pts_per_ray_evaluation=8, n_pts_per_ray_fine_evaluation=4,
    render_image_height=20, render_image_width=20, scene_extent=1.2, chunk_size_grid=8 * 48,
    net_3d_enabled=False, diffusion_enabled=False, view_pooler_enabled=False,
    render_mlp_args=dict(dnet_hidden_dim=16, rnet_hidden_dim=16),
)


def _model(**changes):
    torch.manual_seed(0)
    return HoloDiffusionModel(**{**TINY, **changes}).eval()


def _grid():
    return torch.tanh(2.0 * torch.randn(4, 4, 4, 32, generator=torch.Generator().manual_seed(2)))


def _camera():
    return simple_360_cameras(3, dist=3.0, up=(0.0, 1.0, 0.0))[1:2]


def _chunk_by_chunk(model, cam, grid, occupancy):
    """The chunk loop without packing: each chunk a slice of the ray bundle,
    tightened, rendered by `make_chunk_render_fn`, its four outputs joined
    at the end."""
    H, W = TINY["render_image_height"], TINY["render_image_width"]
    step = TINY["chunk_size_grid"] // TINY["n_pts_per_ray_evaluation"]
    bundle, render = model.full_grid_rays(cam, H, W), render_eval.make_chunk_render_fn(model)
    parts = {"images_render": [], "depths_render": [], "masks_render": [], "normals_render": []}
    for s in range(0, H * W, step):
        chunk = bundle.slice_rays(slice(s, s + step))
        if occupancy is not None:
            chunk = tighten_ray_bundle(chunk, occupancy[0], model.volume_extent, n_probe=128,
                                       outside_occupied=occupancy[1])
        out = render(grid, chunk)
        parts["images_render"].append(out.features[0, :, :3])
        parts["depths_render"].append(out.depths[0])
        parts["masks_render"].append(out.masks[0])
        if out.normals is not None:
            parts["normals_render"].append(out.normals[0])
    return {k: torch.cat(v).reshape(H, W, -1) for k, v in parts.items() if v}


@pytest.mark.parametrize("skip", [False, True], ids=["dense", "skip"])
@pytest.mark.parametrize("normals", [False, True], ids=["rgb", "normals"])
def test_packed_rays_and_frame_unpack_to_the_chunked_render(normals, skip):
    """The loop's packed rays unpack to the bundle, and its packed frame to
    exactly the chunk-by-chunk render of the bundle's slices, as views of
    one (H * W, 5 or 8) tensor."""
    model, grid, cam = _model(render_normals=normals), _grid(), _camera()
    occupancy = render_eval.compute_occupancy(model, grid, resolution=8) if skip else None
    got = render_image_chunked_cpu(model, cam, grid, occupancy=occupancy)

    H, W = TINY["render_image_height"], TINY["render_image_width"]
    bundle = model.full_grid_rays(cam, H, W)
    rays = render_eval.pack_rays(bundle)
    assert rays.shape == (H * W, 8 + TINY["n_pts_per_ray_evaluation"])
    for name, x in vars(render_eval.unpack_rays(rays)).items():
        assert torch.equal(x, getattr(bundle, name)), name

    want = _chunk_by_chunk(model, cam, grid, occupancy)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    frame = got["images_render"].untyped_storage()
    assert frame.nbytes() == H * W * (8 if normals else 5) * 4
    assert all(x.untyped_storage().data_ptr() == frame.data_ptr() for x in got.values())


def render_image_chunked_cpu(model, cam, grid, **kw):
    return render_eval.render_image_chunked(model, cam, grid, device="cpu", **kw)


def test_cpu_renders_each_chunk_eagerly_and_counts_it():
    """A 512^2 frame in chunks of 640 rays: 410 chunks (the last of 384
    rays), each counted `chunks_eager` while a profiler records; nothing is
    captured or replayed off the card."""
    model = _model(n_pts_per_ray_evaluation=4, n_pts_per_ray_fine_evaluation=2, chunk_size_grid=4 * 640,
                   render_image_height=512, render_image_width=512)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        reset_counters()
        out = render_image_chunked_cpu(model, _camera(), _grid())
        counted = counters()
    assert out["images_render"].shape == (512, 512, 3)
    assert counted["chunks_eager"] == 410 == -(-512 * 512 // 640)
    assert "chunks_graphed" not in counted and "chunk_graph_captures" not in counted


def test_graph_key_follows_the_weights_storage_not_their_values():
    """Weights updated in place (an optimizer step, `load_state_dict`) keep
    the key, so a graph reads them live; weights stored anew, or another
    render mode, change it, so the graphs are captured again."""
    model = _model(render_normals=True)
    key = render_eval._graph_key(model)
    w = model.implicit_function.render_mlp._radiance_net.linear(0).weight
    with torch.no_grad():
        w.add_(1.0)
    model.load_state_dict(_model(render_normals=True).state_dict())
    assert render_eval._graph_key(model) == key

    w.data = w.data.clone()
    moved = render_eval._graph_key(model)
    assert moved != key
    model.implicit_function.render_normals = False
    assert render_eval._graph_key(model) not in (key, moved)
