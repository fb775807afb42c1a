"""The count behind `small_conv_roofline.sample` (`counts/unet_small_convs.py`)
at the hydrant configuration: the 51 convolutions of at most 64 output
positions, their used weights and activations, and the same list of calls,
in the same order, as the program's route (`ops/small_conv3d.refusal`)
takes in a no-grad forward of the program's UNet at those shapes (built on
the meta device; the route is asked for a CUDA input)."""
import contextlib

import pytest
import torch

from benchmark.counts import unet_small_convs as sc
from benchmark.harness.manifest import Manifest
from benchmark.reference.spec import Spec


@pytest.fixture(scope="module")
def spec():
    return Spec.from_config(Manifest().config("hydrant")["program_config"])


def test_hydrant_small_convs(spec):
    convs = sc.small_convs(spec)
    assert len(convs) == 51
    by = {}
    for c in convs:
        by[c.n_out] = by.get(c.n_out, 0) + 4 * c.used_weights
    assert {n: round(b / 1e6, 1) for n, b in by.items()} == {1: 25.2, 2: 123.9, 4: 31.0}
    assert round(sum(by.values()) / 1e6, 2) == 180.08
    acts = sum(4 * c.batch * (c.cin * c.n_in ** 3 + c.cout * c.n_out ** 3) for c in convs)
    assert round(acts / 1e6, 2) == 1.83
    assert len(sc.convs(spec)) == 82


def test_hydrant_least_time_is_the_bytes(spec):
    """Every routed convolution's least time is its bytes at 3.35 TB/s
    (at most 32 FLOPs a weight byte, under the 148 of 495 TFLOP/s over
    3.35 TB/s); 54.3 us a step."""
    convs = sc.small_convs(spec)
    for c in convs:
        assert c.least_seconds(495e12, 3.35e12) == c.bytes() / 3.35e12
    assert round(sum(c.least_seconds(495e12, 3.35e12) for c in convs) * 1e6, 1) == 54.3


def test_list_is_the_programs_route(spec):
    from holo_diffusion_torch.models.holo_model import NET_3D
    from holo_diffusion_torch.models.unet3d import RoutedConv3d
    from holo_diffusion_torch.ops import small_conv3d as route

    args, build = NET_3D[spec.net_3d_type]
    with torch.device("meta"):
        unet = build(spec.feature_size, spec.resol, dict(args(spec.net_3d)))
    unet.autocast = lambda device_type: contextlib.nullcontext()  # the meta device has none; off in float32
    taken = []

    def grab(conv, inputs):
        shape = tuple(inputs[0].shape)
        if route.refusal(shape, torch.device("cuda"), torch.float32, conv) is None:
            k, s = conv.kernel_size[0], conv.stride[0]
            taken.append(sc.Conv(conv.in_channels, conv.out_channels, k, s, shape[-1],
                                 route.output_extent(shape[-1], k, s, k // 2), shape[0]))

    hooks = [m.register_forward_pre_hook(grab) for m in unet.modules() if isinstance(m, RoutedConv3d)]
    r, C = spec.resol, spec.feature_size
    with torch.no_grad():
        unet(torch.empty(1, r, r, r, C, device="meta"), torch.zeros(1, device="meta"))
    for h in hooks:
        h.remove()
    assert taken == sc.small_convs(spec)
