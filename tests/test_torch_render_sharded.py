"""`render_eval.render_image_sharded` at world size 1, in this process (a gloo
group of one rank on a file store), against `render_image_chunked` and JAX's
`render_image_sharded` over 8 host devices at JAX's bounds (images 1e-5,
depths 1e-4; tests/test_render_eval.py:107-128); 2 and 4 ranks run in
tests/test_torch_spatial.py's spawns. Also `make_chunk_renderer`, which
renders through the weights it is given."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(__file__))

from torch_render_case import TINY, H, W, assert_render_close, jax_renders, render_case  # noqa: E402

from holo_diffusion_torch.models.holo_model import HoloDiffusionModel  # noqa: E402
from holo_diffusion_torch.parallel.mesh import make_mesh  # noqa: E402
from holo_diffusion_torch.render_eval import (  # noqa: E402
    make_chunk_render_fn,
    make_chunk_renderer,
    render_image_chunked,
    render_image_sharded,
)


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        yield make_mesh("cpu")
    finally:
        dist.destroy_process_group()


def _model():
    _, _, _, grid, sd, cam = render_case()
    model = HoloDiffusionModel(**TINY).eval()
    model.load_state_dict(sd, strict=True)
    return model, cam, torch.from_numpy(grid)


def test_one_rank_matches_chunked_and_jax(one_rank):
    model, cam, grid = _model()
    got = {k: v.numpy() for k, v in render_image_sharded(model, cam, grid, one_rank, H, W).items()}
    assert sorted(got) == ["depths_render", "images_render", "masks_render"]
    chunked = {k: v.numpy() for k, v in render_image_chunked(model, cam, grid, H, W, device="cpu").items()}
    j_sharded, j_chunked = jax_renders()
    for want in (chunked, j_sharded, j_chunked):
        assert_render_close(got, want)


def test_sharded_render_needs_a_mesh():
    model, cam, grid = _model()
    with pytest.raises(ValueError, match="needs a mesh"):
        render_image_sharded(model, cam, grid, None, H, W)


def test_chunk_renderer_renders_through_the_weights_it_is_given():
    """Bound weights render as a model holding them; the model's own
    parameters stay as they were."""
    model, cam, grid = _model()
    other = HoloDiffusionModel(**TINY).eval()
    before = {k: v.clone() for k, v in other.state_dict().items()}
    bundle = model.full_grid_rays(cam[:1], 4, 4)
    want = make_chunk_render_fn(model)(grid, bundle)
    got = make_chunk_renderer(other, model.state_dict())(grid, bundle)
    for a, b in ((got.features, want.features), (got.depths, want.depths), (got.masks, want.masks)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert all(torch.equal(v, before[k]) for k, v in other.state_dict().items())
    with pytest.raises(KeyError, match="out_layer"):
        make_chunk_renderer(other, {**model.state_dict(), "out_layer.weight": torch.zeros(1)})
