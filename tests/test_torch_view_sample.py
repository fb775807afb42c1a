"""The view pooler's sampler (`ops/view_sample.py`) on the CPU: the plain
version that CPU tensors take is bitwise the per-view, per-map loop of
`bilinear_sample_ndc` calls that `sample_view_features` made before it,
values and gradients; it launches nothing; and the checks that guard the
CUDA kernels (K8, `csrc/view_sample.cu`) refuse what the kernels do not
take, with no card needed. The kernels themselves are checked on the card
by `tests/test_torch_view_sample_cuda.py`."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)

import pytest
import torch

from holo_diffusion_torch.geometry.cameras import PerspectiveCameras, look_at_view_transform, project_points_ndc
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel
from holo_diffusion_torch.models.view_pooler import sample_view_features
from holo_diffusion_torch.ops import view_sample as vs
from holo_diffusion_torch.ops.image import bilinear_sample_ndc
from holo_diffusion_torch.weights import init_weights
from torch_toy_model import TOY


def _per_view_loop(feats, xy):
    """`sample_view_features`' sampling as it was: one call a view and a map."""
    S = xy.shape[0]
    return torch.cat([torch.stack([bilinear_sample_ndc(feats[k][s], xy[s]) for s in range(S)])
                      for k in sorted(feats)], dim=-1)


def _cams(S):
    R, T = look_at_view_transform(dist=2.5, elev=torch.linspace(-20.0, 40.0, S),
                                  azim=torch.linspace(0.0, 300.0, S))
    return PerspectiveCameras(R=R, T=T, focal_length=torch.full((S, 2), 2.2),
                              principal_point=torch.full((S, 2), 0.05))


def _feats(S, seed, nchw):
    """The extractor's key set at small sizes; with `nchw` the res layers
    are NHWC views of NCHW memory, as the extractor makes them."""
    g = torch.Generator().manual_seed(seed)
    feats = {"images": torch.rand((S, 20, 24, 3), generator=g), "masks": torch.rand((S, 20, 24, 1), generator=g)}
    for i, (h, w) in enumerate(((10, 12), (5, 6)), 1):
        x = torch.randn((S, 4, h, w), generator=g)
        feats[f"res_layer_{i}"] = x.permute(0, 2, 3, 1) if nchw else x.permute(0, 2, 3, 1).contiguous()
    return feats


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("nchw", [False, True], ids=["nhwc", "nhwc_over_nchw"])
def test_sample_view_features_is_bitwise_the_per_view_loop(nchw, masked):
    """Points in front of, beside and behind the cameras (2.5 from the
    origin, points out to 3): values, validity and every map's gradient
    bitwise equal to the loop's."""
    S = 4
    cams = _cams(S)
    pts = (torch.rand((60, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1) * 3.0
    feats = {k: v.detach().requires_grad_(k.startswith("res")) for k, v in _feats(S, 2, nchw).items()}
    masks = feats["masks"].detach()
    cot = torch.randn((S, 60, 3 + 1 + 8), generator=torch.Generator().manual_seed(3))
    got, valid = sample_view_features(feats, cams, pts, masks, masked_sampling=masked)
    got_grads = torch.autograd.grad((got * cot).sum(), [feats["res_layer_1"], feats["res_layer_2"]])
    ndc = project_points_ndc(cams, pts[None].expand(S, *pts.shape))
    want = _per_view_loop(feats, ndc[..., :2])
    want_grads = torch.autograd.grad((want * cot).sum(), [feats["res_layer_1"], feats["res_layer_2"]])
    in_front = (ndc[..., 2:3] > 0.0).to(torch.float32)
    if masked:
        m = torch.stack([bilinear_sample_ndc(masks[s], ndc[s, :, :2]) for s in range(S)])
        in_front = (m > 0.5).to(torch.float32) * in_front
    assert 0 < float(in_front.sum()) < in_front.numel()
    assert torch.equal(got, want) and torch.equal(valid, in_front)
    for a, b in zip(got_grads, want_grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("channels", [1, 3, 5, 16])
def test_plain_version_is_the_loop_by_channels(channels, align_corners):
    """Off-map points included (|xy| up to 1.4)."""
    g = torch.Generator().manual_seed(channels)
    maps = [torch.rand((3, 7, 9, channels), generator=g), torch.rand((3, 4, 5, 2), generator=g)]
    xy = (torch.rand((3, 50, 2), generator=g) * 2 - 1) * 1.4
    got = vs.view_sample(maps, xy, align_corners)
    want = torch.cat([torch.stack([bilinear_sample_ndc(m[s], xy[s], align_corners) for s in range(3)])
                      for m in maps], dim=-1)
    assert got.shape == (3, 50, channels + 2)
    assert torch.equal(got, want)


def test_cpu_tensors_launch_nothing():
    """A training pass of the goldens' toy through `pool_features` on the
    CPU: the plain version runs and the launch counts stay 0."""
    model = HoloDiffusionModel(**TOY)
    init_weights(model, seed=0)
    S = 3
    g = torch.Generator().manual_seed(0)
    imgs, fg = torch.rand((S, 32, 32, 3), generator=g), (torch.rand((S, 32, 32, 1), generator=g) > 0.5).float()
    vs.reset_launch_counts()
    grid = model.pool_features(imgs, _cams(S), fg)
    grid.sum().backward()
    assert vs.launch_counts() == {"view_sample_fwd": 0, "view_sample_bwd": 0}
    assert any(p.grad is not None and bool(p.grad.abs().sum() > 0)
               for p in model.image_feature_extractor.parameters())


def _good():
    return [torch.zeros((2, 4, 5, 3)), torch.zeros((2, 16, 3, 3)).permute(0, 2, 3, 1)], \
        torch.zeros((2, 7, 2))


BAD = {
    "no_maps": lambda maps, xy: ([], xy),
    "nine_maps": lambda maps, xy: (maps * 4 + maps[:1], xy),
    "xy_not_pairs": lambda maps, xy: (maps, torch.zeros((2, 7, 3))),
    "xy_flat": lambda maps, xy: (maps, torch.zeros((14, 2))),
    "xy_float64": lambda maps, xy: (maps, xy.double()),
    "xy_needs_grad": lambda maps, xy: (maps, xy.requires_grad_()),
    "map_float64": lambda maps, xy: ([maps[0].double(), maps[1]], xy),
    "map_bfloat16": lambda maps, xy: ([maps[0], maps[1].bfloat16()], xy),
    "map_other_views": lambda maps, xy: ([maps[0][:1], maps[1]], xy),
    "map_three_dims": lambda maps, xy: ([maps[0][0], maps[1]], xy),
    "map_empty": lambda maps, xy: ([maps[0][:, :0], maps[1]], xy),
    "map_other_device": lambda maps, xy: ([maps[0].to("meta"), maps[1]], xy),
}


@pytest.mark.parametrize("case", list(BAD))
def test_kernel_checks_refuse_what_the_kernels_do_not_take(case):
    """The checks a CUDA request passes before any launch, on CPU tensors."""
    maps, xy = BAD[case](*_good())
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        vs.check_operands(maps, xy)


def test_kernel_checks_take_the_extractor_layout():
    """Rows of 3 + 16 channels; the first channel of each map."""
    maps, xy = _good()
    assert vs.check_operands(maps, xy) == [0, 3, 19]
    with torch.no_grad():  # a gradient of xy is refused only where one could be taken
        assert vs.check_operands(maps, xy.requires_grad_()) == [0, 3, 19]


def test_a_device_without_the_kernel_raises():
    maps, xy = _good()
    with pytest.raises(NotImplementedError):
        vs.view_sample([m.to("meta") for m in maps], xy.to("meta"))


def test_backward_buffers_keep_the_maps_layout():
    """The gradients' one buffer (zeros and no launch at N = 0): each map's
    part has the map's strides where those are dense (NHWC over NCHW), the
    parts lie one after the other, and maps that need no gradient get none."""
    S = 2
    nchw = torch.zeros((S, 3, 3, 5)).permute(0, 2, 3, 1)  # 90 floats
    maps = [torch.zeros((S, 4, 5, 3)), nchw, torch.zeros((S, 2, 2, 1))]
    metas = [torch.empty_like(m, device="meta") for m in maps]
    grads = vs._bwd_cuda(metas, [0, 3, 6, 7], torch.zeros((S, 0, 2)), False, torch.zeros((S, 0, 7)),
                         (False, True, True))
    assert grads[0] is None
    assert grads[1].shape == nchw.shape and grads[1].stride() == nchw.stride()
    assert grads[2].shape == maps[2].shape and grads[2].stride() == maps[2].stride()
    assert grads[2].storage_offset() == 90 and grads[1].untyped_storage().data_ptr() == \
        grads[2].untyped_storage().data_ptr()
    assert all(float(g.abs().sum()) == 0 for g in grads[1:])
    assert vs.launch_counts()["view_sample_bwd"] == 0
