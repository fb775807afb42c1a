"""The UNet sharded over the grid's D axis (parallel/spatial.py) and the
ray-sharded render on gloo ranks on the CPU, against the port's unsharded
forward and the JAX package.

ONE `torch.multiprocessing` spawn per world size (2 and 4) serves the module
(tests/torch_spatial_worker.py, no JAX; torchrun's variables set, so the
ranks join through `initialize_distributed("cpu")`; a timeout kills them).
Each rank saves what it computed; the parent holds it against what it
computes itself, once:

  * two sharded UNets, at JAX's tolerance (atol 2e-5, rtol 1e-5;
    tests/test_parallel.py:306-327), against the port's unsharded forward
    and JAX's unsharded `UNetModel3D` with the same weights: JAX's test
    model (16^3, 32 channels, mult (1, 2), attention at 2), and a narrow
    model with hydrant's five levels (mult (1, 1, 2, 4, 8), attention at 4
    and 8), whose 1-plane level (and at 4 ranks its 2-plane one too) is
    replicated; the slab form equals the rank's slab of the gathered one;
    the collectives counted by kind;
  * one sharded `p_sample` step against the port's and JAX's unsharded step
    with JAX's draw (atol 5e-5, rtol 1e-4; tests/test_parallel.py:330-380);
  * the sharded loop: finite, in [-1, 1], the same grid on every rank, and
    the one-device sampler's for the same generator;
  * `render_image_sharded` against `render_image_chunked` and JAX's
    `render_image_sharded` (images 1e-5, depths 1e-4).
"""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import datetime
import os
import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(__file__))

import torch_spatial_worker as W  # noqa: E402
from torch_jax_params import random_variables  # noqa: E402
from torch_render_case import TINY, H, W as WIDTH, assert_render_close, jax_renders, render_case  # noqa: E402

from holo_diffusion_torch.models import diffusion as gd  # noqa: E402
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel  # noqa: E402
from holo_diffusion_torch.models.unet3d import UNetModel3D  # noqa: E402
from holo_diffusion_torch.render_eval import render_image_chunked  # noqa: E402
from holo_diffusion_torch.sampling import sample_random_voxel_features  # noqa: E402
from holo_diffusion_torch.weights import state_dict_from_jax  # noqa: E402
from holo_diffusion_tpu.models import diffusion as jgd  # noqa: E402
from holo_diffusion_tpu.models.holo_model import HoloDiffusionModel as JModel  # noqa: E402
from holo_diffusion_tpu.models.unet3d import UNetModel3D as JUNet  # noqa: E402
from holo_diffusion_tpu.sampling import _schedule as j_schedule  # noqa: E402

SPAWN_TIMEOUT_S = 240
FWD = dict(atol=2e-5, rtol=1e-5)
STEP = dict(atol=5e-5, rtol=1e-4)
UNETS = {
    "jax_test": dict(in_channels=32, model_channels=32, out_channels=32, num_res_blocks=1, channel_mult=(1, 2),
                     attention_resolutions=(2,), num_heads=2),
    "hydrant_levels": dict(in_channels=32, model_channels=32, out_channels=32, num_res_blocks=1,
                           channel_mult=(1, 1, 2, 4, 8), attention_resolutions=(4, 8), num_heads=2),
}
HOLO = dict(resol=8, feature_size=32, view_pooler_enabled=False,
            net_3d_args=dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=(2,)),
            diffusion_args=dict(num_steps=8, beta_start_unscaled=8e-7, beta_end_unscaled=1.6e-4),
            render_mlp_args=dict(dnet_hidden_dim=16, rnet_hidden_dim=8))
LOOP_SEED = 3


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The ranks' inputs (written to inputs.pt) and what the parent computes
    from them: JAX's and the port's unsharded outputs."""
    work = str(tmp_path_factory.mktemp("spatial"))
    inputs, ref = {}, {}
    for i, (name, kw) in enumerate(UNETS.items()):
        rs = np.random.RandomState(10 + i)
        x, t = rs.randn(1, 16, 16, 16, 32).astype(np.float32), np.array([7])
        jm = JUNet(use_remat=False, **kw)
        flat, variables = random_variables(jm, jnp.asarray(x), jnp.asarray(t), seed=i)
        ref[name + "_jax"] = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x), jnp.asarray(t)))
        sd = state_dict_from_jax(flat["params"], kind="unet")
        unet = UNetModel3D(**kw).eval()
        unet.load_state_dict(sd, strict=True)
        with torch.no_grad():
            ref[name] = unet(torch.from_numpy(x), torch.from_numpy(t)).numpy()
        inputs[name] = dict(kwargs=kw, sd=sd, x=torch.from_numpy(x), t=torch.from_numpy(t))

    # one p_sample step: JAX's test model, JAX's draw for PRNGKey(4)
    jm = JModel(**dict(HOLO, net_3d_args=dict(HOLO["net_3d_args"], use_remat=False)))
    x = np.array(jax.random.normal(jax.random.PRNGKey(2), (1, 8, 8, 8, 32)))
    t = np.array([5])
    flat, variables = random_variables(jm, jnp.zeros((1, 8, 8, 8, 32)), jnp.zeros((1,), jnp.int32), seed=7,
                                       method=JModel.apply_net_3d)
    fwd = lambda xx, tt: jm.apply(variables, xx, tt, method=JModel.apply_net_3d)  # noqa: E731
    key = jax.random.PRNGKey(4)
    ref["p_sample_jax"] = np.asarray(jgd.p_sample(j_schedule(jm), fwd, jnp.asarray(x), jnp.asarray(t), key)["sample"])
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
    model = HoloDiffusionModel(**HOLO).eval()
    net_sd = {k[len("net_3d."):]: v for k, v in state_dict_from_jax(flat["params"]).items()}
    model.net_3d.load_state_dict(net_sd, strict=True)
    tx, tt, tn = torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(noise)
    with torch.no_grad():
        ref["p_sample"] = gd.p_sample(model.schedule, model.apply_net_3d, tx, tt, noise=tn)["sample"].numpy()
    ref["loop"] = sample_random_voxel_features(model, torch.Generator().manual_seed(LOOP_SEED), device="cpu").numpy()
    inputs["p_sample"] = dict(kwargs=HOLO, sd=net_sd, x=tx, t=tt, noise=tn, loop_seed=LOOP_SEED)

    _, _, _, grid, sd, cam = render_case()
    model = HoloDiffusionModel(**TINY).eval()
    model.load_state_dict(sd, strict=True)
    tgrid = torch.from_numpy(grid)
    ref["render_chunked"] = {k: v.numpy() for k, v in render_image_chunked(
        model, cam, tgrid, H, WIDTH, device="cpu").items()}
    # the ranks render at the model's own size: 11 x 11
    inputs["render"] = dict(kwargs=dict(TINY, render_image_height=H, render_image_width=WIDTH), sd=sd,
                            camera=cam, grid=tgrid)
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    return work, ref


@pytest.fixture(scope="module", params=[2, 4], ids=["2_ranks", "4_ranks"])
def ranks(request, reference):
    """Every rank's saved outputs, one spawn of `world` gloo ranks."""
    world = request.param
    base, ref = reference
    work = os.path.join(base, f"world{world}")
    os.makedirs(work)
    os.link(os.path.join(base, "inputs.pt"), os.path.join(work, "inputs.pt"))
    ctx = mp.start_processes(W.run_rank, args=(world, _free_port(), work), nprocs=world, join=False,
                             start_method="spawn")
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=SPAWN_TIMEOUT_S)
    while not ctx.join(timeout=5):
        if datetime.datetime.now() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {world} ranks did not finish within {SPAWN_TIMEOUT_S} s")
    return world, ref, [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False) for r in range(world)]


@pytest.mark.parametrize("name", list(UNETS))
def test_sharded_unet_matches_the_unsharded_forward_and_jax(ranks, name):
    world, ref, out = ranks
    for o in out:
        got = o[name].numpy()
        np.testing.assert_allclose(got, ref[name], **FWD)
        np.testing.assert_allclose(got, ref[name + "_jax"], **FWD)
        # the slab form is the rank's slab of the gathered output
        n = 16 // world
        assert torch.equal(o[name + "_slab"], o[name][:, o["rank"] * n:(o["rank"] + 1) * n])


def test_sharded_unet_counts_its_collectives(ranks):
    """One halo exchange per 3^3 conv of a sharded level (the downsample's
    included), two all_reduces per GroupNorm there, one key/value gather per
    sharded attention block, one slab gather per replicated level entered
    plus the output's; nothing for the replicated levels' modules."""
    world, _, out = ranks
    # 16^3 and 8^3 sharded: 20 convs, 21 GroupNorms, 4 attention blocks
    assert out[0]["jax_test_counts"] == {"halo": 20, "group_norm": 42, "attention": 4, "gather": 1}
    # 2 ranks: the 1-plane level replicated (the middle block and 2 output
    # ResBlocks); 4 ranks: the 2-plane one too (and its attention blocks)
    assert out[0]["hydrant_levels_counts"] == {
        2: {"halo": 32, "group_norm": 62, "attention": 6, "gather": 2},
        4: {"halo": 24, "group_norm": 44, "attention": 3, "gather": 2}}[world]


def test_sharded_p_sample_step_matches(ranks):
    _, ref, out = ranks
    for o in out:
        np.testing.assert_allclose(o["p_sample"].numpy(), ref["p_sample"], **STEP)
        np.testing.assert_allclose(o["p_sample"].numpy(), ref["p_sample_jax"], **STEP)


def test_sharded_loop_stays_in_range_and_matches_one_device(ranks):
    _, ref, out = ranks
    for o in out:
        arr = o["loop"].numpy()
        assert arr.shape == (1, 8, 8, 8, 32) and np.isfinite(arr).all()
        assert arr.min() >= -1.0 and arr.max() <= 1.0
        assert torch.equal(o["loop"], out[0]["loop"])
        # 8 steps of tiny betas: rounding does not grow past 1e-4
        np.testing.assert_allclose(arr, ref["loop"], atol=1e-4, rtol=0)


def test_ray_sharded_render_matches_chunked_and_jax(ranks):
    _, ref, out = ranks
    j_sharded, j_chunked = jax_renders()
    for o in out:
        got = {k: v.numpy() for k, v in o["render"].items()}
        assert sorted(got) == ["depths_render", "images_render", "masks_render"]
        assert got["images_render"].shape == (H, WIDTH, 3)
        assert_render_close(got, ref["render_chunked"])
        assert_render_close(got, j_sharded)
        assert_render_close(got, j_chunked)
