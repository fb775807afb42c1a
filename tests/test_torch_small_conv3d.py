"""The small-volume 3D convolutions' route and cut on the CPU
(holo_diffusion_torch/ops/small_conv3d.py, the UNet's `RoutedConv3d`): the
route's reason for each refusal and its None at the hydrant UNet's 51
convolutions of at most 64 output positions; the used taps against a
brute-force count; the tiling and chunks of every routed call of
hydrant's and the 32^3 x 128 model's UNets; each box walk's offsets (the
constants of the kernel's `chain_box`) against each position's in-bounds
taps; the plain version bitwise `F.conv3d`; and the subclass's state_dict
and CPU forward those of `nn.Conv3d`. The kernel itself runs on the card
(`test_torch_small_conv3d_cuda.py`)."""
import contextlib
import itertools

import pytest
import torch
import torch.nn.functional as F

import tests.torch_threads  # noqa: F401
from holo_diffusion_torch.models import unet3d
from holo_diffusion_torch.models.holo_model import NET_3D
from holo_diffusion_torch.ops import small_conv3d as sc
from holo_diffusion_torch.utils.profiling import counters, reset_counters

CUDA = torch.device("cuda")  # a device object only: no card is touched


def _conv(cin=8, cout=8, k=3, stride=1, **kw):
    return torch.nn.Conv3d(cin, cout, k, stride=stride, padding=kw.pop("padding", k // 2), device="meta", **kw)


@pytest.mark.parametrize("case, shape, device, dtype, conv, why", [
    ("cpu", (1, 8, 2, 2, 2), torch.device("cpu"), torch.float32, _conv(), "lies on cpu"),
    ("grad", (1, 8, 2, 2, 2), CUDA, torch.float32, _conv(), "grad is enabled"),
    ("bfloat16", (1, 8, 2, 2, 2), CUDA, torch.bfloat16, _conv(), "torch.bfloat16"),
    ("p65", (65, 8, 1, 1, 1), CUDA, torch.float32, _conv(), "65 output positions"),
    ("kernel2", (1, 8, 2, 2, 2), CUDA, torch.float32, _conv(k=2, padding=1), "kernel (2, 2, 2)"),
    ("groups2", (1, 8, 2, 2, 2), CUDA, torch.float32, _conv(groups=2), "groups 2"),
    ("ragged", (3, 8, 2, 3, 2), CUDA, torch.float32, _conv(stride=(1, 2, 1)), "no box walk"),
    ("2x4x4", (1, 8, 2, 4, 4), CUDA, torch.float32, _conv(), "no box walk"),
], ids=lambda v: v if isinstance(v, str) else "")
def test_refusal_reasons(case, shape, device, dtype, conv, why):
    with torch.set_grad_enabled(case == "grad"):
        got = sc.refusal(shape, device, dtype, conv)
    assert got is not None and why in got, got
    with torch.no_grad():
        assert sc.refusal((1, 8, 2, 2, 2), CUDA, torch.float32, _conv()) is None


def _hydrant_calls(resol=16, feature_size=64):
    """(input shape, conv) of every RoutedConv3d call of a no-grad forward
    of the hydrant UNet at B = 1, on the meta device (autocast, which the
    meta device lacks, is off in float32 anyway)."""
    calls = []
    with torch.device("meta"):
        unet = NET_3D["SimpleUnet3D"][1](feature_size, resol, dict(NET_3D["SimpleUnet3D"][0]({})))
    unet.autocast = lambda device_type: contextlib.nullcontext()
    hooks = [m.register_forward_pre_hook(lambda m, a: calls.append((tuple(a[0].shape), m)))
             for m in unet.modules() if isinstance(m, unet3d.RoutedConv3d)]
    with torch.no_grad():
        unet(torch.empty(1, resol, resol, resol, feature_size, device="meta"), torch.zeros(1, device="meta"))
    for h in hooks:
        h.remove()
    return calls


def test_route_takes_hydrants_51_small_convs():
    calls = _hydrant_calls()
    assert len(calls) == 82
    with torch.no_grad():
        why = [sc.refusal(shape, CUDA, torch.float32, conv) for shape, conv in calls]
    taken = [(shape, conv) for (shape, conv), w in zip(calls, why) if w is None]
    assert len(taken) == 51
    by_voxels = {}
    for shape, conv in taken:
        P = sc.positions(shape, conv.kernel_size[0], conv.stride)
        by_voxels[P] = by_voxels.get(P, 0) + 1
    assert by_voxels == {1: 19, 8: 16, 64: 16}
    assert all("output positions" in w for w in why if w is not None)


def _brute_taps(spatial, k, stride):
    pad = k // 2
    outs = [range(sc.output_extent(n, k, s, pad)) for n, s in zip(spatial, stride)]
    used = set()
    for tap in itertools.product(range(k), repeat=3):
        for o in itertools.product(*outs):
            if all(0 <= oi * s + d - pad < n for oi, s, d, n in zip(o, stride, tap, spatial)):
                used.add(tap[0] * k * k + tap[1] * k + tap[2])
    return tuple(sorted(used))


@pytest.mark.parametrize("k, s, n", list(itertools.product((1, 3), (1, 2), (1, 2, 4))))
def test_used_taps_against_brute_force(k, s, n):
    for spatial in ((n, n, n), (n, 1, 2 * n)):
        for stride in ((s, s, s), (1, s, s)):
            assert sc.used_taps(spatial, k, stride) == _brute_taps(spatial, k, stride)
    if k == 3 and s == 1:
        assert len(sc.used_taps((n, n, n), k, (s,) * 3)) == (1 if n == 1 else 27)


def _routed_shapes():
    out = []
    for resol, C in ((16, 64), (32, 128)):
        with torch.no_grad():
            out += [(shape, conv) for shape, conv in _hydrant_calls(resol, C)
                    if sc.refusal(shape, CUDA, torch.float32, conv) is None]
    return out


def _walk(shape, k, stride):
    T = len(sc.used_taps(shape[2:], k, stride))
    walk = sc.kind(shape[2:], k, stride, T)
    return T, walk, sc.channel_floats(walk, shape[0], shape[2:])


def test_plan_of_every_routed_call():
    """Every routed call of hydrant's (51) and the 32^3 x 128 model's (35)
    UNets gets a box walk, a tiling whose blocks hold every position once
    and a chunk of input channels whose ring fits the shared memory, in
    steps of 4 where every tap is used, and at most its input channels."""
    shapes = _routed_shapes()
    assert len(shapes) == 51 + 35
    walks = {}
    for shape, conv in shapes:
        k = conv.kernel_size[0]
        T, walk, xp = _walk(shape, k, conv.stride)
        walks[walk] = walks.get(walk, 0) + 1
        P = sc.positions(shape, k, conv.stride)
        co_tile, chains = sc.tiling(P)
        assert co_tile in (4, 8) and 1 <= chains <= 2 and chains * 32 // co_tile <= max(P, 8), (P, co_tile, chains)
        vec = T == k ** 3 and shape[1] * k ** 3 % 4 == 0
        cc = sc.plan(shape[1], T, xp, vec, co_tile)
        assert sc.shared_bytes(cc, T, xp, co_tile) <= sc.MAX_SHARED_BYTES, (shape, conv)
        assert 1 <= cc <= -(-shape[1] // 4) * 4 and (not vec or cc % 4 == 0), (shape, conv, cc)
        assert sc._wstride(cc, T) >= cc * T and sc._wstride(cc, T) // 4 % 2 == 1
    assert set(walks) == {sc.BOX1, sc.BOX2, sc.BOX2S, sc.HALO6, sc.HALO10}, walks


# each walk's box as the kernel's `chain_box` instantiations hold it: its
# extents, a tap's step in a weight row's channel of used taps along z and
# y, and a voxel's step in a channel's stage along z and y (x steps by 1)
BOXES = {sc.BOX1: ((1, 1, 1), (0, 0), (0, 0)), sc.BOX2: ((2, 2, 2), (9, 3), (4, 2)),
         sc.BOX2S: ((2, 2, 2), (4, 2), (4, 2)), sc.HALO6: ((3, 3, 3), (9, 3), (36, 6)),
         sc.HALO10: ((3, 3, 3), (9, 3), (100, 10))}


def _stage_slot(shape, halo, b, z, y, x):
    """Where voxel (z, y, x) of grid b lies in a channel's stage: inside a
    halo of one, or packed."""
    _, _, D, H, W = shape
    if halo:
        return ((b * (D + 2) + z + 1) * (H + 2) + y + 1) * (W + 2) + x + 1
    return ((b * D + z) * H + y) * W + x


@pytest.mark.parametrize("shape, k, stride, walk", [
    ((1, 12, 1, 1, 1), 3, (1, 1, 1), sc.BOX1),
    ((1, 12, 2, 2, 2), 3, (2, 2, 2), sc.BOX2S),
    ((1, 8, 2, 2, 2), 3, (1, 1, 1), sc.BOX2),
    ((2, 8, 4, 4, 4), 3, (2, 2, 2), sc.HALO6),
    ((1, 6, 4, 4, 4), 3, (1, 1, 1), sc.HALO6),
    ((1, 5, 8, 8, 8), 3, (2, 2, 2), sc.HALO10),
    ((1, 20, 4, 4, 4), 1, (1, 1, 1), sc.BOX1),
    ((4, 10, 4, 4, 2), 1, (1, 2, 2), sc.BOX1),
], ids=["1^3", "2^3-s2", "2^3", "b2-4^3-s2", "4^3", "8^3-s2", "4^3-k1", "k1-s2"])
def test_box_walk_meets_each_positions_in_bounds_taps(shape, k, stride, walk):
    """At every output position, the box walk from the position's first tap
    (the kernel's `wb`, `xb`) visits the position's in-bounds taps in
    increasing order, each at its index among the used taps and at the
    stage slot of the voxel it meets; in a halo walk the box's other taps
    fall on the halo, which no voxel fills."""
    T, got_walk, xp = _walk(shape, k, stride)
    assert got_walk == walk
    taps, pad, halo = sc.used_taps(shape[2:], k, stride), k // 2, walk in (sc.HALO6, sc.HALO10)
    B, _, D, H, W = shape
    filled = {_stage_slot(shape, halo, *v) for v in itertools.product(range(B), range(D), range(H), range(W))}
    assert max(filled) < xp
    (nz, ny, nx), (wz, wy), (xz, xy) = BOXES[walk]
    out_sp = [sc.output_extent(n, k, s, pad) for n, s in zip(shape[2:], stride)]
    for b, *o in itertools.product(range(B), *map(range, out_sp)):
        want = []
        for t, tap in enumerate(taps):
            i = [oi * s + d - pad for oi, s, d in zip(o, stride, (tap // (k * k), tap // k % k, tap % k))]
            if all(0 <= ii < n for ii, n in zip(i, shape[2:])):
                want.append((t, _stage_slot(shape, halo, b, *i)))
        if halo:
            wb, xb = 0, ((b * (D + 2) + o[0] * stride[0]) * (H + 2) + o[1] * stride[1]) * (W + 2) + o[2] * stride[2]
        else:
            d = [max(0, pad - oi * s) for oi, s in zip(o, stride)]
            xb = _stage_slot(shape, False, b, *(oi * s + di - pad for oi, s, di in zip(o, stride, d)))
            wb = taps.index((d[0] * k + d[1]) * k + d[2])
        box = [(wb + a * wz + bb * wy + e, xb + a * xz + bb * xy + e)
               for a in range(nz) for bb in range(ny) for e in range(nx)]
        assert all(0 <= w_ < T and 0 <= x_ < xp for w_, x_ in box), (b, o)
        assert [p for p in box if p[1] in filled] == want, (b, o)


@pytest.mark.parametrize("k, stride", [(3, 1), (3, 2), (1, 1)])
def test_plain_version_is_conv3d_bitwise(k, stride):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 6, 4, 4, 4, generator=g)
    w = torch.randn(5, 6, k, k, k, generator=g)
    b = torch.randn(5, generator=g)
    for bias in (b, None):
        got = sc.small_conv3d(x, w, bias, (stride,) * 3)
        assert torch.equal(got, F.conv3d(x, w, bias, stride, k // 2))


def test_routed_conv3d_is_an_nn_conv3d():
    """The same state_dict keys and shapes as nn.Conv3d, loads its state,
    and on the CPU computes its output bitwise, counted by neither route
    counter (they count the card's calls)."""
    routed = unet3d.conv_nd(3, 6, 5, k=3, stride=2)
    plain = torch.nn.Conv3d(6, 5, 3, stride=2, padding=1)
    assert isinstance(routed, unet3d.RoutedConv3d) and isinstance(routed, torch.nn.Conv3d)
    assert {k: v.shape for k, v in routed.state_dict().items()} == {k: v.shape for k, v in plain.state_dict().items()}
    routed.load_state_dict(plain.state_dict())
    x = torch.randn(1, 6, 4, 4, 4)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        reset_counters()
        with torch.no_grad():
            got = routed(x)
        seen = counters()
    assert seen == {}
    assert torch.equal(got, plain(x).detach())
