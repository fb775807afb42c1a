"""The rest of the JAX package's surface in the port, against JAX on the
CPU: `train/optimizer.py:with_discriminator_optimizer` (JAX
tests/test_parallel.py:281-302, plus a checkpoint round trip), the
extractor's `dtype: bfloat16` (the config reaches it, the convolutions run in
bfloat16 and BatchNorm in float32, the features within a bfloat16 bound of
JAX's bfloat16 extractor), `PerspectiveCameras.identity` / `join_cameras`
and `data/packing.py:make_packer_for_groups`."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from torch_jax_params import random_variables  # noqa: E402

from holo_diffusion_torch.config import load_config, model_args_from_config  # noqa: E402
from holo_diffusion_torch.data.frame_data import FrameData  # noqa: E402
from holo_diffusion_torch.data.packing import BatchPacker, make_packer_for_groups  # noqa: E402
from holo_diffusion_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from holo_diffusion_torch.geometry.cameras import PerspectiveCameras, join_cameras  # noqa: E402
from holo_diffusion_torch.models.feature_extractor import ResNetFeatureExtractor  # noqa: E402
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel  # noqa: E402
from holo_diffusion_torch.parallel.train_step import TrainState  # noqa: E402
from holo_diffusion_torch.train.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from holo_diffusion_torch.train.optimizer import make_optimizer, with_discriminator_optimizer  # noqa: E402
from holo_diffusion_torch.weights import state_dict_from_jax  # noqa: E402
from holo_diffusion_tpu.geometry import cameras as jcams  # noqa: E402
from holo_diffusion_tpu.models.feature_extractor import ResNetFeatureExtractor as JExtractor  # noqa: E402


class _GAN(torch.nn.Module):
    def __init__(self, n=3):
        super().__init__()
        self.net = torch.nn.Linear(n, 1, bias=False)
        self.discriminator = torch.nn.Linear(n, 1, bias=False)


def test_discriminator_optimizer_split_matches_jax():
    """JAX: optax.sgd(1.0) for the rest, SGD lr 0.1 for the discriminator,
    ones and unit gradients -> 0.0 and 0.9."""
    m = _GAN()
    with torch.no_grad():
        for p in m.parameters():
            p.fill_(1.0)
    make = with_discriminator_optimizer(functools.partial(make_optimizer, breed="SGD", lr=1.0, momentum=0.0),
                                        functools.partial(make_optimizer, breed="SGD", lr=0.1, momentum=0.0))
    opt = make(m.named_parameters())
    for p in m.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    np.testing.assert_allclose(m.net.weight.detach().numpy(), 0.0)
    np.testing.assert_allclose(m.discriminator.weight.detach().numpy(), 0.9)
    assert len(opt.params()) == 2


def test_discriminator_optimizer_states_survive_a_checkpoint(tmp_path):
    """Adam for the rest, Adagrad for the discriminator: both states go into
    the checkpoint and come back; the restored run steps bitwise as the
    straight one."""
    make = with_discriminator_optimizer(functools.partial(make_optimizer, breed="Adam", lr=1e-2),
                                        functools.partial(make_optimizer, breed="Adagrad", lr=0.1))

    def run(state, k):
        gen = torch.Generator().manual_seed(k)
        x = torch.randn(4, 3, generator=gen)
        state.optimizer.zero_grad()
        (state.model.net(x).pow(2).mean() + state.model.discriminator(x).abs().mean()).backward()
        state.optimizer.step()

    def fresh():
        torch.manual_seed(0)
        m = _GAN()
        return TrainState.create(m, make(m.named_parameters()))

    a = fresh()
    for k in range(2):
        run(a, k)
    save_checkpoint(str(tmp_path), 0, a)
    b, _ = restore_checkpoint(str(tmp_path), fresh())
    assert b.optimizer.steps == a.optimizer.steps == 2
    for st in (a, b):
        run(st, 5)
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)
    assert b.optimizer.disc.optimizer.state[b.model.discriminator.weight]["sum"].abs().sum() > 0


def test_extractor_dtype_reaches_the_extractor():
    cfg = load_config("synthetic_debug.yaml", [
        "model_factory_ImplicitronModelFactory_args.model_HoloDiffusionModel_args."
        "image_feature_extractor_ResNetFeatureExtractor_args.dtype=bfloat16"])
    args = model_args_from_config(cfg)
    assert args["image_feature_extractor_args"]["dtype"] == "bfloat16"
    model = HoloDiffusionModel(**args)
    assert model.image_feature_extractor.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="float16"):
        ResNetFeatureExtractor(dtype="float16")


def test_bfloat16_extractor_matches_jax(monkeypatch):
    """resnet18, stages 1-2, 64 x 64 images: every convolution of the port
    computes in bfloat16, every BatchNorm in float32, the outputs are
    float32; the l2-normalised features agree with JAX's bfloat16 extractor
    within 0.03 (bfloat16's 2^-8 relative rounding through 9 convolutions
    in different summation orders, on unit-norm features)."""
    kw = dict(name_arch="resnet18", stages=(1, 2), proj_dim=8, image_rescale=0.5)
    rs = np.random.RandomState(0)
    images = rs.rand(2, 64, 64, 3).astype(np.float32)
    masks = (rs.rand(2, 64, 64, 1) > 0.5).astype(np.float32)
    jm = JExtractor(dtype=jnp.bfloat16, **kw)
    flat, variables = random_variables(jm, jnp.asarray(images), jnp.asarray(masks))
    y_j = jm.apply(variables, jnp.asarray(images), jnp.asarray(masks))
    sd = state_dict_from_jax({"feature_extractor/" + k: v for k, v in flat["params"].items()},
                             {"feature_extractor/" + k: v for k, v in flat["batch_stats"].items()})
    tm = ResNetFeatureExtractor(dtype="bfloat16", **kw).eval()
    tm.load_state_dict({k[len("image_feature_extractor."):]: v for k, v in sd.items()}, strict=True)
    convs, norms = set(), set()
    for mod in tm.modules():
        if isinstance(mod, torch.nn.Conv2d):
            mod.register_forward_hook(lambda m, i, o: convs.add(o.dtype))
    batch_norm = torch.nn.functional.batch_norm

    def spy(x, *args, **kwargs):
        norms.add(x.dtype)
        return batch_norm(x, *args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "batch_norm", spy)
    with torch.no_grad():
        y_t = tm(torch.from_numpy(images), torch.from_numpy(masks))
    assert convs == {torch.bfloat16} and norms == {torch.float32}
    for k in ("res_layer_1", "res_layer_2"):
        assert y_t[k].dtype == torch.float32
        np.testing.assert_allclose(y_t[k].numpy(), np.asarray(y_j[k], np.float32), atol=0.03, rtol=0)


def test_identity_and_join_cameras_match_jax():
    t = PerspectiveCameras.identity(3, focal=2.5)
    j = jcams.PerspectiveCameras.identity(3, focal=2.5)
    joined, jjoined = join_cameras([t, t[1]]), jcams.join_cameras([j, j[1]])
    for a, b in ((t, j), (joined, jjoined)):
        for name in ("R", "T", "focal_length", "principal_point"):
            np.testing.assert_array_equal(getattr(a, name).numpy(), np.asarray(getattr(b, name)))
    assert joined.batch_size == 4


@pytest.mark.parametrize("steps_per_call", [1, 3])
def test_make_packer_for_groups(steps_per_call):
    """Without an example the layout comes from the first pack; with one it
    is the example's, stacked per step, and a stacked batch round-trips
    bitwise."""
    assert make_packer_for_groups().structure is None
    batch = make_synthetic_scene(n_views=3, image_size=8, device="cpu")
    packer = make_packer_for_groups(batch, steps_per_call)
    assert isinstance(packer, BatchPacker)
    group = batch if steps_per_call == 1 else FrameData.stack_steps([batch] * steps_per_call)
    assert packer._shapes[0] == tuple(group.camera.R.shape)
    out = packer.unpack(packer.pack(group))
    assert torch.equal(out.image_rgb, group.image_rgb) and torch.equal(out.camera.T, group.camera.T)
