"""Compact sources, packed transfer and data parallelism of the port on the
card: training steps through NCCL at world size 1 bitwise the plain steps;
a compact training forward on the card against the CPU; a packed batch
copied to the card and unpacked, bitwise, and a packed step bitwise the
unpacked one. The bitwise step comparisons run in PyTorch's deterministic
mode on a model that decodes layer by layer from the plain sampler: the
fused decode's backward (K2) and the sampling kernels' grid cotangent (K5)
sum with atomics, so with them two runs of one step differ in the last
bits. Every test is marked `cuda` and skips without a CUDA device;
the file imports neither JAX nor the JAX package:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_scale_out_cuda.py -m cuda -q
"""
import copy
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from torch_toy_model import TOY  # noqa: E402

from holo_diffusion_torch.data.compact import SourceCompactor  # noqa: E402
from holo_diffusion_torch.data.packing import BatchPacker, packed_transfer  # noqa: E402
from holo_diffusion_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from holo_diffusion_torch.device import set_full_precision  # noqa: E402
from holo_diffusion_torch.models import diffusion as gd  # noqa: E402
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel  # noqa: E402
from holo_diffusion_torch.parallel.train_step import TrainState, make_train_step  # noqa: E402
from holo_diffusion_torch.train.optimizer import make_optimizer  # noqa: E402
from holo_diffusion_torch.weights import init_weights  # noqa: E402

# the toy model at C 32, which the fused decode kernels (K3, K2) take
NARROW = dict(TOY, feature_size=32, render_normals=True)
# the same decoding layer by layer from the plain gather sampler
UNFUSED = dict(NARROW, sampler="gather", fuse_decode="off", collapse_density="off")
OBJ_TOL, GRID_TOL = 1e-4, 1e-3


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_full_precision()
    return torch.device("cuda", 0)


@pytest.fixture
def deterministic():
    prev = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    yield
    torch.use_deterministic_algorithms(prev[0])
    torch.backends.cudnn.deterministic = prev[1]


def _state(dev, loss_aware=True, args=UNFUSED):
    model = init_weights(HoloDiffusionModel(**args), seed=3).to(dev)
    opt = make_optimizer(model.named_parameters(), lr=1e-3)
    sampler = gd.LossSecondMomentState.create(model.schedule.num_timesteps, device=dev) if loss_aware else None
    return TrainState.create(model, opt, sampler_state=sampler, ema=True)


def _draws(seed, take_boot=True):
    rs = np.random.RandomState(seed)
    return {"timesteps": np.array([400, 90]), "take_boot": take_boot, "noise": rs.randn(1, 8, 8, 8, 32),
            "noise2": rs.randn(1, 8, 8, 8, 32), "ray_pixel_u": rs.rand(2, 64)}


def _tensors(state):
    from holo_diffusion_torch.parallel.mesh import _state_tensors

    return _state_tensors(state)


@pytest.mark.cuda
def test_nccl_world_size_one_step_is_bitwise_the_plain_step(tmp_path, deterministic):
    import torch.distributed as dist

    from holo_diffusion_torch.parallel.mesh import make_mesh

    dev = _device()
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh(dev)
        scene = make_synthetic_scene(n_views=5, image_size=16, seed=0, device=dev)
        runs = []
        for m in (None, mesh, None):
            state = _state(dev)
            step = make_train_step(state.model, state.optimizer, schedule_sampler="loss-second-moment",
                                   ema_rate=0.9, mesh=m)
            gen = torch.Generator(device=dev).manual_seed(11)
            for _ in range(3):
                state, metrics = step(state, scene, gen)
            runs.append((_tensors(state), metrics))
        (plain, m0), (nccl, m1), (again, _) = runs
        # the plain step reruns bitwise here, so the comparison can be bitwise
        assert all(torch.equal(a, b) for a, b in zip(plain, again))
        assert len(plain) == len(nccl) and all(torch.equal(a, b) for a, b in zip(plain, nccl))
        assert all(torch.equal(m0[k], m1[k]) for k in m0)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_compact_training_forward_card_vs_cpu():
    dev = _device()
    cpu_model = init_weights(HoloDiffusionModel(**NARROW), seed=5)
    card_model = copy.deepcopy(cpu_model).to(dev)
    scene = make_synthetic_scene(n_views=6, image_size=16, seed=1, device="cpu")
    batch = SourceCompactor.from_model(cpu_model)(scene)
    outs = {}
    for label, m, b in (("cpu", cpu_model, batch), ("card", card_model, batch.to(dev))):
        with torch.no_grad():
            outs[label] = m(camera=b.camera, image_rgb=b.image_rgb, fg_probability=b.fg_probability,
                            mask_crop=b.mask_crop, src_image_rgb=b.src_image_rgb,
                            src_fg_probability=b.src_fg_probability, src_mask_crop=b.src_mask_crop,
                            training=True, draws=_draws(2))
    assert abs(float(outs["card"]["objective"]) - float(outs["cpu"]["objective"])) <= OBJ_TOL
    err = float((outs["card"]["voxel_features"].cpu() - outs["cpu"]["voxel_features"]).abs().max())
    assert err <= GRID_TOL


@pytest.mark.cuda
def test_packed_transfer_on_the_card_is_bitwise(deterministic):
    dev = _device()
    scene = make_synthetic_scene(n_views=6, image_size=16, seed=2, device="cpu")
    batch = SourceCompactor.from_model(HoloDiffusionModel(**NARROW))(scene)
    packer = BatchPacker()
    buf = packed_transfer(packer, dev)(batch)
    assert buf.device == dev and buf.dtype == torch.uint8 and buf.ndim == 1
    out = packer.unpack(buf)
    for name in ("image_rgb", "fg_probability", "mask_crop", "src_image_rgb", "src_fg_probability",
                 "src_mask_crop"):
        got, want = getattr(out, name), getattr(batch, name)
        assert got.device == dev and got.dtype == want.dtype and torch.equal(got.cpu(), want), name
    assert torch.equal(out.camera.R.cpu(), batch.camera.R)
    # a packed step on the card is bitwise the unpacked one
    finals = []
    for packed in (False, True):
        state = _state(dev, loss_aware=False)
        p = BatchPacker() if packed else None
        step = make_train_step(state.model, state.optimizer, packer=p)
        b = packed_transfer(p, dev)(batch) if packed else batch.to(dev)
        state, metrics = step(state, b, _draws(3, take_boot=False))
        finals.append((_tensors(state), metrics))
    assert all(torch.equal(a, b) for a, b in zip(finals[0][0], finals[1][0]))
    assert all(torch.equal(finals[0][1][k], finals[1][1][k]) for k in finals[0][1])
