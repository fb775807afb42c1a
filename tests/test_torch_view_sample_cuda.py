"""The view pooler's sampler K8 (`csrc/view_sample.cu`: `view_sample_fwd`,
`view_sample_bwd`) against its plain version `view_sample_reference` on the
card: the release shapes with the extractor's NHWC-over-NCHW strides,
channel counts 1, 3, 5 and 16 in both layouts, points off the map and
behind the camera, both `align_corners`; and one launch each way for a
`pool_features` under grad. Every test here is marked `cuda` and skips
without a CUDA device. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_view_sample_cuda.py -m cuda -q

Tolerances: the forward rounds each product and sum as the plain version
does, in its order, so 1e-6 absolute on unit-scale maps holds with room
(it is expected bitwise). The backward sums each pixel's shares in point
order, where the plain version sums each corner's index scatter apart and
then the four: 1e-5 of the gradient's largest entry. It reruns bitwise.
"""
import pytest
import torch

from holo_diffusion_torch.geometry.cameras import PerspectiveCameras, look_at_view_transform, project_points_ndc
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel
from holo_diffusion_torch.models.view_pooler import sample_view_features
from holo_diffusion_torch.ops import _build
from holo_diffusion_torch.ops import view_sample as vs
from holo_diffusion_torch.weights import init_weights

FWD_ATOL = 1e-6
GRAD_REL = 1e-5
# the release configs' maps: images, masks, res_layer_1..4 (proj_dim 16),
# extractor input 256^2 (800^2 frames at image_rescale 0.32)
RELEASE_MAPS = {"images": (256, 256, 3), "masks": (256, 256, 1), "res_layer_1": (64, 64, 16),
                "res_layer_2": (32, 32, 16), "res_layer_3": (16, 16, 16), "res_layer_4": (8, 8, 16)}


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _view_launches():
    counts = _build.launch_counts()
    return {k: counts[k] for k in ("view_sample_fwd", "view_sample_bwd")}


def _map(S, h, w, c, gen, dev, nchw):
    """Uniform in [-1, 1); with `nchw` an NHWC view of NCHW memory, as the
    extractor's res layers come."""
    if nchw:
        return (torch.rand((S, c, h, w), generator=gen, device=dev) * 2 - 1).permute(0, 2, 3, 1)
    return torch.rand((S, h, w, c), generator=gen, device=dev) * 2 - 1


def _xy(S, N, gen, dev):
    """NDC points on and off the map (|xy| up to 1.3), every 50th far off,
    as the projections of points near a camera's plane are; as a slice of
    (S, N, 3) rows, as the projection gives them."""
    ndc = (torch.rand((S, N, 3), generator=gen, device=dev) * 2 - 1) * 1.3
    ndc[:, ::50, :2] *= 1e4
    return ndc[..., :2]


def _compare(maps, xy, align_corners, cot):
    """Kernel against plain: forward, then the gradient of every map that
    requires one."""
    _build.reset_launch_counts()
    got = vs.view_sample(maps, xy, align_corners)
    want = vs.view_sample_reference(maps, xy, align_corners)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    err = float((got - want).detach().abs().max())
    assert err <= FWD_ATOL, err
    wanting = [m for m in maps if m.requires_grad]
    if wanting:
        g_got = torch.autograd.grad((got * cot).sum(), wanting)
        g_want = torch.autograd.grad((want * cot).sum(), wanting)
        torch.cuda.synchronize()
        for j, (a, b) in enumerate(zip(g_got, g_want)):
            scale = float(b.abs().max())
            assert scale > 0
            assert float((a - b).abs().max()) <= GRAD_REL * scale, (j, float((a - b).abs().max()), scale)
    assert _view_launches() == {"view_sample_fwd": 1, "view_sample_bwd": int(bool(wanting))}


@pytest.mark.cuda
@pytest.mark.parametrize("S", [30, 23], ids=["hydrant", "teddybear"])
def test_kernel_matches_plain_at_release_shapes(S):
    """S source views, the 16^3 voxel centres' 4096 points, the six release
    maps (68 channels), the res layers NHWC over NCHW and needing a
    gradient, images and masks not."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(S)
    maps = [_map(S, *RELEASE_MAPS[k], gen, dev, nchw=k.startswith("res")).requires_grad_(k.startswith("res"))
            for k in sorted(RELEASE_MAPS)]
    N = 16 ** 3
    cot = torch.randn((S, N, 68), generator=gen, device=dev)
    _compare(maps, _xy(S, N, gen, dev), False, cot)


@pytest.mark.cuda
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("nchw", [False, True], ids=["nhwc", "nhwc_over_nchw"])
@pytest.mark.parametrize("channels", [1, 3, 5, 16])
def test_kernel_matches_plain_by_channels(channels, nchw, align_corners):
    """A map of `channels` beside one of 4, both needing a gradient: float4
    units and single floats as the strides allow; 17 x 23 pixels, so the
    backward's 16 x 16 tiles are ragged."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(channels)
    S, N = 3, 1000
    maps = [_map(S, 17, 23, channels, gen, dev, nchw).requires_grad_(),
            _map(S, 9, 6, 4, gen, dev, nchw).requires_grad_()]
    cot = torch.randn((S, N, channels + 4), generator=gen, device=dev)
    _compare(maps, _xy(S, N, gen, dev), align_corners, cot)


@pytest.mark.cuda
def test_backward_reruns_bitwise_with_more_than_16_channels():
    """Two backward launches on the same cotangent give the same bits; 40
    channels take three channel passes; 300 points on a 3 x 2 map put ~200
    shares on each pixel."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(12)
    S, N = 6, 300
    maps = [_map(S, 3, 2, 40, gen, dev, nchw=True).requires_grad_(), _map(S, 70, 90, 16, gen, dev, nchw=True)
            .requires_grad_()]
    xy = _xy(S, N, gen, dev)
    cot = torch.randn((S, N, 56), generator=gen, device=dev)
    _compare(maps, xy, True, cot)
    out = vs.view_sample(maps, xy, True)
    first = torch.autograd.grad(out, maps, cot, retain_graph=True)
    again = torch.autograd.grad(out, maps, cot)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_kernel_takes_unaligned_strided_and_empty_input():
    """A map starting off a 16-byte boundary, one that is a strided slice,
    contiguous xy; no points: an empty result and no launch."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(7)
    S, N = 4, 500
    base = torch.rand((S * 8 * 8 * 4 + 1,), generator=gen, device=dev)
    unaligned = base[1:].reshape(S, 8, 8, 4).requires_grad_()
    sliced = torch.rand((S, 12, 10, 8), generator=gen, device=dev)[:, ::2, :, 1:6].requires_grad_()
    xy = _xy(S, N, gen, dev).contiguous()
    _compare([unaligned, sliced], xy, False, torch.randn((S, N, 9), generator=gen, device=dev))
    _build.reset_launch_counts()
    empty = vs.view_sample([unaligned.detach()], xy[:, :0])
    assert empty.shape == (S, 0, 4) and _build.launch_counts()["view_sample_fwd"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_sample_view_features_behind_the_camera(masked):
    """Cameras 2.5 from the origin, points out to 3: some behind a camera.
    The card's `sample_view_features` against the plain version on the
    same card tensors."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(9)
    S = 5
    R, T = look_at_view_transform(dist=2.5, elev=torch.linspace(-20.0, 40.0, S), azim=torch.linspace(0.0, 300.0, S))
    cams = PerspectiveCameras(R=R.to(dev), T=T.to(dev), focal_length=torch.full((S, 2), 2.2, device=dev),
                              principal_point=torch.full((S, 2), 0.05, device=dev))
    pts = (torch.rand((800, 3), generator=gen, device=dev) * 2 - 1) * 3.0
    feats = {k: _map(S, *RELEASE_MAPS[k], gen, dev, nchw=k.startswith("res"))
             for k in RELEASE_MAPS}
    masks = (feats["masks"] * 0.5 + 0.5).contiguous()
    got, valid = sample_view_features(feats, cams, pts, masks, masked_sampling=masked)
    ndc = project_points_ndc(cams, pts[None].expand(S, *pts.shape))
    assert 0 < int((ndc[..., 2] <= 0).sum()) < ndc[..., 2].numel()
    want = vs.view_sample_reference([feats[k] for k in sorted(feats)], ndc[..., :2])
    assert float((got - want).abs().max()) <= FWD_ATOL
    in_front = (ndc[..., 2:3] > 0.0).float()
    if masked:
        in_front = (vs.view_sample_reference([masks], ndc[..., :2]) > 0.5).float() * in_front
    assert torch.equal(valid, in_front)


@pytest.mark.cuda
def test_pool_features_launches_one_forward_and_one_backward():
    """The goldens' toy (resnet18 stage 1, images and masks added) pools 4
    views under grad: one `view_sample_fwd`, one `view_sample_bwd`, and the
    extractor gets its gradient; under no grad one forward only."""
    from torch_toy_model import TOY

    dev = _device()
    model = HoloDiffusionModel(**TOY)
    init_weights(model, seed=0)
    model.to(dev)
    S = 4
    gen = torch.Generator(device=dev).manual_seed(3)
    imgs = torch.rand((S, 32, 32, 3), generator=gen, device=dev)
    fg = (torch.rand((S, 32, 32, 1), generator=gen, device=dev) > 0.5).float()
    R, T = look_at_view_transform(dist=2.5, elev=torch.linspace(-20.0, 40.0, S), azim=torch.linspace(0.0, 300.0, S))
    cams = PerspectiveCameras(R=R.to(dev), T=T.to(dev), focal_length=torch.full((S, 2), 2.2, device=dev),
                              principal_point=torch.full((S, 2), 0.05, device=dev))
    _build.reset_launch_counts()
    grid = model.pool_features(imgs, cams, fg)
    grid.square().sum().backward()
    torch.cuda.synchronize()
    assert _view_launches() == {"view_sample_fwd": 1, "view_sample_bwd": 1}
    assert any(p.grad is not None and bool(p.grad.abs().sum() > 0)
               for p in model.image_feature_extractor.parameters())
    _build.reset_launch_counts()
    with torch.no_grad():
        model.pool_features(imgs, cams, fg)
    assert _view_launches() == {"view_sample_fwd": 1, "view_sample_bwd": 0}
