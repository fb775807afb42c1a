"""The ray-sharded render's test case, shared by tests/test_torch_spatial.py
(2 and 4 gloo ranks) and tests/test_torch_render_sharded.py (one rank): JAX
`tests/test_render_eval.py`'s TINY model with seeded random variables, the
same weights in the port's model, one camera and a grid. The image is
11 x 11, so 121 rays pad to a multiple of 2, 4 and 8 ranks."""
import functools

import jax.numpy as jnp
import numpy as np
import torch

from holo_diffusion_tpu.data import make_synthetic_scene
from holo_diffusion_tpu.models.holo_model import HoloDiffusionModel as JModel
from holo_diffusion_torch.geometry.cameras import PerspectiveCameras
from holo_diffusion_torch.weights import state_dict_from_jax
from torch_jax_params import random_variables

TINY = dict(resol=4, volume_extent=3.0, feature_size=32, num_passes=2, net_3d_enabled=False,
            diffusion_enabled=False, view_pooler_enabled=False, n_pts_per_ray_evaluation=8,
            n_pts_per_ray_fine_evaluation=4, render_image_height=12, render_image_width=12,
            scene_extent=1.2, render_mlp_args=dict(dnet_hidden_dim=16, rnet_hidden_dim=16))
H = W = 11
# JAX's own bounds (tests/test_render_eval.py:107-128)
IMAGE_ATOL, DEPTH_ATOL = 1e-5, 1e-4


@functools.lru_cache(maxsize=None)
def render_case():
    """(JAX model, its variables, JAX camera, grid (4, 4, 4, 32), the port's
    state_dict, the port's camera)."""
    scene = make_synthetic_scene(n_views=1, image_size=12)
    grid = np.clip(np.random.RandomState(0).randn(4, 4, 4, 32), -1, 1).astype(np.float32)
    jm = JModel(**TINY)
    flat, variables = random_variables(jm, camera=scene.camera[:1], voxel_features=jnp.asarray(grid)[None],
                                       training=False)
    sd = state_dict_from_jax(flat["params"])
    cam = PerspectiveCameras(*(torch.from_numpy(np.array(x)) for x in (
        scene.camera.R, scene.camera.T, scene.camera.focal_length, scene.camera.principal_point)))
    return jm, variables, scene.camera, grid, sd, cam


@functools.lru_cache(maxsize=None)
def jax_renders():
    """JAX's render_image_sharded over the 8 host devices and its
    render_image_chunked, {key: ndarray}."""
    from holo_diffusion_tpu.parallel import make_mesh
    from holo_diffusion_tpu.render_eval import render_image_chunked, render_image_sharded

    jm, variables, jcam, grid, _, _ = render_case()
    g = jnp.asarray(grid)
    sharded = render_image_sharded(jm, variables, jcam, g, make_mesh(), H, W)
    chunked = render_image_chunked(jm, variables, jcam, g, H, W)
    keys = ("images_render", "depths_render", "masks_render")
    return {k: np.asarray(sharded[k]) for k in keys}, {k: np.asarray(chunked[k]) for k in keys}


def assert_render_close(got, want):
    np.testing.assert_allclose(got["images_render"], want["images_render"], atol=IMAGE_ATOL)
    np.testing.assert_allclose(got["depths_render"], want["depths_render"], atol=DEPTH_ATOL)
    np.testing.assert_allclose(got["masks_render"], want["masks_render"], atol=IMAGE_ATOL)

