"""The AngleWeighted pooling path and the release category configs of the
port, on the CPU.

  (a) tests/goldens/holo_aw_goldens.npz (the reference torch forward with
      the AVG+STD aggregator the apple/donut/teddybear configs select, on the
      MLPMean golden's other weights): the evaluation forward and the pooled
      grid within 1e-4, the training forward under the golden's draws
      within 2e-4 (objective 2e-5 and 2e-4): the bounds the JAX package
      holds itself to in tests/test_holo_aw_parity.py;
  (b) apple.yaml, donut.yaml, teddybear.yaml and unet_with_no_diffusion.yaml
      ship as package data, translate to the JAX translators' model, loop,
      data and optimizer arguments, and take one narrow training step."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_holo_forward_parity import GOLD  # noqa: E402
from test_torch_train_step import _batch_kwargs, _cams, _golden_draws  # noqa: E402
from torch_tiny_config import MODEL, TINY_OVERRIDES  # noqa: E402
from torch_toy_model import TOY  # noqa: E402

from holo_diffusion_torch.config import (  # noqa: E402
    data_source_args_from_config, load_config, model_args_from_config, optimizer_args_from_config,
    training_loop_args_from_config)
from holo_diffusion_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel  # noqa: E402
from holo_diffusion_torch.models.metrics import preprocess_input  # noqa: E402
from holo_diffusion_torch.parallel.train_step import TrainState, make_train_step  # noqa: E402
from holo_diffusion_torch.train.optimizer import make_optimizer  # noqa: E402
from holo_diffusion_torch.weights import init_weights, state_dict_from_reference  # noqa: E402
from holo_diffusion_tpu.config import config as jcfg  # noqa: E402

AW = np.load(os.path.join(os.path.dirname(__file__), "goldens", "holo_aw_goldens.npz"))
AW_POOLER = dict(aggregator_class_type="AngleWeightedReductionFeatureAggregator",
                 aggregator_args=dict(reduction_functions=("AVG", "STD"), weight_by_ray_angle_gamma=1.0,
                                      min_ray_angle_weight=0.1))
RELEASE = ["apple", "donut", "teddybear", "unet_with_no_diffusion"]


@pytest.fixture(scope="module")
def aw_model():
    tm = HoloDiffusionModel(**{**TOY, "view_pooler_args": AW_POOLER})
    sd = {k[4:]: GOLD[k] for k in GOLD.files if k.startswith("sd::")}
    sd.update({k[4:]: AW[k] for k in AW.files if k.startswith("sd::")})
    sd = state_dict_from_reference(sd)
    # the parameter-free AVG+STD aggregator takes none of the MLPMean's weights
    mlp_mean = {k for k in sd if k.startswith("view_pooler.feature_aggregator.")}
    assert mlp_mean and not any(k.startswith("view_pooler.feature_aggregator.") for k in tm.state_dict())
    tm.load_state_dict({k: v for k, v in sd.items() if k not in mlp_mean}, strict=True)
    return tm


def test_aw_eval_forward_matches_golden(aw_model):
    with torch.no_grad():
        preds = aw_model(_cams(), training=False, **_batch_kwargs())
    np.testing.assert_allclose(preds["images_render"].numpy(), AW["eval_image"], atol=1e-4)
    np.testing.assert_allclose(preds["masks_render"].numpy(), AW["eval_mask"], atol=1e-4)
    np.testing.assert_allclose(float(preds["objective"]), float(AW["eval_objective"]), atol=2e-5)


def test_aw_pooled_grid_matches_golden(aw_model):
    img, fg, _ = preprocess_input(torch.from_numpy(GOLD["image_rgb"]), torch.from_numpy(GOLD["fg_probability"]),
                                  None, True, True, 0.5, (1.0, 1.0, 1.0))
    with torch.no_grad():
        grid = aw_model.pool_features(img[1:], _cams()[1:], fg[1:], None)
    np.testing.assert_allclose(grid.numpy(), AW["eval_grid_pooled"], atol=1e-4)


def test_aw_training_forward_matches_golden(aw_model):
    with torch.no_grad():
        preds = aw_model(_cams(), training=True, draws=_golden_draws(), **_batch_kwargs())
    assert bool(preds["diffusion_take_boot"])
    np.testing.assert_allclose(preds["voxel_features"].numpy(), AW["train_voxel_features"], atol=2e-4)
    np.testing.assert_allclose(preds["images_render"].numpy(), AW["train_images_render"], atol=2e-4)
    np.testing.assert_allclose(float(preds["objective"]), float(AW["train_objective"]), atol=2e-4)


def _same(t, j):
    return t == (tuple(j) if isinstance(j, list) else j)


@pytest.mark.parametrize("config", RELEASE)
def test_release_config_translates_as_jax(config):
    cfg, jc = load_config(config), jcfg.load_config(config)
    t, j = model_args_from_config(cfg), jcfg.model_args_from_config(jc)
    for k, v in t.items():
        if k in ("net_3d_args", "diffusion_args"):
            assert v == {kk: j[k][kk] for kk in v}, k
        else:
            assert v == j[k], k
    assert training_loop_args_from_config(cfg) == jcfg.training_loop_args_from_config(jc)
    assert data_source_args_from_config(cfg) == jcfg.data_source_args_from_config(jc)
    jo = {**jcfg.optimizer_args_from_config(jc), "clip_grad": jcfg.training_loop_args_from_config(jc)["clip_grad"]}
    for part in optimizer_args_from_config(cfg).values():
        for k, v in part.items():
            if k != "max_epochs":
                assert _same(v, jo[k]), k
    if config == "unet_with_no_diffusion":
        assert not t["diffusion_enabled"] and not t["enable_bootstrap"]
    else:
        assert t["view_pooler_args"]["aggregator_class_type"] == AW_POOLER["aggregator_class_type"]
        assert (t["render_image_height"], t["n_train_target_views"]) == (256, 10)


@pytest.mark.parametrize("config", RELEASE)
def test_release_config_takes_a_narrow_step(config):
    """The config's model at the tiny experiment's widths, one step on a
    synthetic scene of 12 views: a finite objective, the parameters moved."""
    narrow = [o for o in TINY_OVERRIDES if o.startswith(MODEL)]
    tm = init_weights(HoloDiffusionModel(**model_args_from_config(load_config(config, narrow))), seed=0)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt = make_optimizer(tm.named_parameters(), breed="Adam", lr=1e-3)
    scene = make_synthetic_scene(n_views=12, image_size=16, seed=0, device="cpu")
    state, metrics = make_train_step(tm, opt)(TrainState.create(tm, opt), scene, torch.Generator().manual_seed(0))
    assert state.step == 1 and np.isfinite(float(metrics["objective"]))
    assert any(not torch.equal(p.detach(), before[n]) for n, p in tm.named_parameters())
