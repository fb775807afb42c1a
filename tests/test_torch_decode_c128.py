"""The reference model's 32^3 x 128 grid on the CPU: the "auto" routes
(`models/implicit.py` `decode_route`, `sampler_route`) as pure functions of
the device and the grid's shape; the fused decode's plain version and its
backward at C 128 against the layer-by-layer decode; and a small training
step of `hydrant_g32c128` (C 128) against the benchmark's plain float32
reference. Seeded random weights; float32 with TF32 off. No JAX."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import math

import pytest
import torch

from holo_diffusion_torch.models.implicit import (DEFAULT_MAX_GC, KERNEL_MAX_GC, VoxelGridImplicitFunction,
                                                  decode_route, sampler_route)
from holo_diffusion_torch.ops import fused_decode as fd

PE_DIM = 27  # dir_emb_dims 4: every repo config


# ---- the routes

@pytest.mark.parametrize("device, shape, fusable, hidden, want", [
    ("cuda", (32, 32, 32, 128), True, 256, "fused"),
    ("cpu", (32, 32, 32, 128), True, 256, "layer"),
    ("cuda", (16, 16, 16, 64), True, 256, "fused"),
    ("cpu", (16, 16, 16, 64), True, 256, "fused"),
    ("cuda", (32, 32, 32, 128), True, 272, "layer"),
    ("cuda", (32, 32, 32, 128), False, 256, "layer"),
    ("cuda", (8, 8, 8, 8), True, 256, "layer"),
    ("cuda", (1024, 1024, 1024, 32), True, 256, "layer"),
], ids=["g32c128_card", "g32c128_cpu", "hydrant_card", "hydrant_cpu", "c128_h272", "not_fusable", "C8",
        "past_32_bit_offsets"])
def test_decode_route(device, shape, fusable, hidden, want):
    """"auto" takes the fused decode on the card for the 32^3 x 128 grid
    (the kernels take C 128 at hidden 256, and nothing but their 32-bit
    offsets limits the grid's size there), and keeps the TPU's 16^3 x 64
    limit off the card, where the JAX package is the yardstick; hydrant
    routes alike on both; a width the kernels refuse, an unfusable decoder
    or a grid past 2^31 - 1 values decode layer by layer."""
    assert decode_route(device, shape, fusable, hidden, PE_DIM) == want


@pytest.mark.parametrize("device, shape, want", [
    ("cuda", (32, 32, 32, 128), "fused"), ("cpu", (32, 32, 32, 128), "packed"),
    ("cuda", (16, 16, 16, 64), "fused"), ("cpu", (16, 16, 16, 64), "fused"),
    ("cuda", (1024, 1024, 1024, 32), "packed"),
], ids=["g32c128_card", "g32c128_cpu", "hydrant_card", "hydrant_cpu", "past_32_bit_offsets"])
def test_sampler_route(device, shape, want):
    """The sampler "auto" takes: K4-K6 on the card up to their 32-bit
    offsets, the TPU's limit off the card."""
    assert sampler_route(device, shape) == want
    assert DEFAULT_MAX_GC == 16 ** 3 * 64 and KERNEL_MAX_GC == 2 ** 31 - 1


def test_c128_layouts_fit_a_block():
    """`kernels_take` holds at C 128 from hidden 1 to 271 at pe_dim 27
    (K2's dA accumulators cover 272 columns), and both C-128 layouts fit the
    232,448 bytes a block may opt into, 212,736 and 216,304 at hidden 256."""
    assert fd.fwd_smem_bytes(128, 256, PE_DIM) == 212_736
    assert fd.bwd_smem_bytes(128, 256, PE_DIM) == 216_304
    assert [h for h in range(1, 400) if fd.kernels_take(128, h, PE_DIM)] == list(range(1, 272))
    assert all(fd.fwd_smem_bytes(128, h, PE_DIM) <= fd.SMEM_OPTIN_BYTES
               and fd.bwd_smem_bytes(128, h, PE_DIM) <= fd.SMEM_OPTIN_BYTES for h in range(1, 272))


# ---- the plain fused decode at C 128 against the layer-by-layer decode

D, EXTENT = 6, 4.0
MLP = dict(feat_emb_dims=0, dir_emb_dims=4, dnet_num_layers=4, dnet_hidden_dim=64, dnet_input_skips=[2],
           rnet_num_layers=1, rnet_hidden_dim=16, activation_fn="LEAKYRELU")


def _implicit(fuse):
    torch.manual_seed(0)
    fn = VoxelGridImplicitFunction(resol=D, volume_extent=EXTENT, n_hidden=128, render_normals=True,
                                   render_mlp_args=MLP, sampler="gather", fuse_decode=fuse)
    with torch.no_grad():  # biases away from 0, so every path of the decoder carries a gradient
        for p in fn.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    return fn


def _decode_inputs():
    g = torch.Generator().manual_seed(7)
    grid = torch.tanh(torch.randn((D, D, D, 128), generator=g))
    # 12 rays of 10 points, some beyond the grid
    pts = (torch.rand((12, 10, 3), generator=g) * 2 - 1) * 0.6 * EXTENT
    dirs = torch.randn((12, 3), generator=g)
    return grid, pts, dirs


def test_c128_plain_decode_and_backward_match_the_layer_by_layer_decode():
    """The fused decode's plain version at C 128 (`fused_sample_decode_reference`,
    with the normals' field gradient) and its backward
    (`fused_sample_decode_bwd_reference`, through `FusedSampleDecode`)
    against the RenderMLP layer by layer with autograd, float32 on the CPU:
    densities, colours and normals 1e-5; the grid's and every parameter's
    gradient 1e-4 of its largest magnitude (the collapsed affine sums the
    four density layers in another order)."""
    assert fd.kernels_take(128, MLP["dnet_hidden_dim"], PE_DIM)
    grid, pts, dirs = _decode_inputs()
    outs, grads = {}, {}
    for fuse in ("on", "off"):
        fn = _implicit(fuse)
        g = grid.clone().requires_grad_(True)
        dens, rgb, aux = fn(g, pts, dirs)
        (dens.square().sum() + (rgb * torch.linspace(0.5, 1.5, 3)).sum()).backward()
        outs[fuse] = (dens.detach(), rgb.detach(), aux["normals"])
        grads[fuse] = [g.grad] + [p.grad for p in fn.parameters()]
    for a, b in zip(outs["on"], outs["off"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert len(grads["on"]) == len(grads["off"])
    for a, b in zip(grads["on"], grads["off"]):
        scale = float(b.abs().max())
        assert scale > 0 and float((a - b).abs().max()) <= 1e-4 * scale


def test_c128_plain_backward_against_autograd_of_the_plain_forward():
    """`fused_sample_decode_bwd_reference` at C 128, hidden 64, step by step,
    against autograd through `fused_sample_decode_reference`: the five
    cotangents within 1e-5 of scale (the same float32 arithmetic)."""
    g = torch.Generator().manual_seed(9)
    hidden, C = 64, 128
    grid = torch.tanh(torch.randn((D, D, D, C), generator=g))
    A = torch.randn((C, hidden + 1), generator=g) / math.sqrt(C)
    c = torch.randn((hidden + 1,), generator=g) * 0.1
    Wr = torch.randn((hidden + PE_DIM, 3), generator=g) / math.sqrt(hidden + PE_DIM)
    br = torch.randn((3,), generator=g) * 0.1
    pts = (torch.rand((5, 9, 3), generator=g) * 2 - 1) * 0.6 * EXTENT
    pe = torch.randn((5, PE_DIM), generator=g)
    cot = torch.randn((5, 9, 4), generator=g)
    leaves = [t.clone().requires_grad_(True) for t in (grid, A, c, Wr, br)]
    dens, rgb = fd.fused_sample_decode_reference(*leaves, pts, pe, EXTENT, hidden)
    want = torch.autograd.grad((torch.cat([dens, rgb], -1) * cot).sum(), leaves)
    got = fd.fused_sample_decode_bwd_reference(grid, A, c, Wr, br, pts, pe, EXTENT, hidden, cot)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


# ---- a small C-128 training step against the benchmark's reference

# float32 on the CPU, the same arithmetic in other orders: the objective to
# 1e-5 of itself, the first gradient's leaves to 1e-4 of their norms, the
# change after 3 Adam steps to 1e-3 (Adam's first steps move each weight by
# about lr whatever its gradient, so the change amplifies a gradient gap of
# a leaf whose gradient is near 0: the benchmark's CPU tolerances)
TRAIN_TOL = {"loss1_gap": 1e-5, "loss_gap": 1e-5, "grad_gap": 1e-4, "grad_median_gap": 1e-4,
             "change_gap": 1e-3, "change_median_gap": 1e-3}


def test_small_c128_training_step_matches_the_reference():
    """`hydrant_g32c128`'s benchmark configuration cut to an 8^3 x 128 grid
    (C stays 128), a 2-level UNet and 2 frames of 32^2 (one target): three
    program training steps (`make_train_step`, the fused decode's plain
    version at C 128) against `benchmark/reference/` from the same weights,
    batches and draws, by the training cell's readings. Every decode takes
    the fused route."""
    from benchmark.harness.kinds import train
    from benchmark.harness.manifest import Manifest
    from benchmark.harness.program import Context
    from benchmark.tests.tiny import tiny_program_config
    from holo_diffusion_torch.utils.profiling import counters, reset_counters

    conf = Manifest().config("hydrant_g32c128")
    m = conf["program_config"]["model_factory_ImplicitronModelFactory_args"]["model_HoloDiffusionModel_args"]
    assert (m["resol"], m["feature_size"]) == (32, 128)
    conf["program_config"] = tiny_program_config(conf["program_config"], 1)
    m = conf["program_config"]["model_factory_ImplicitronModelFactory_args"]["model_HoloDiffusionModel_args"]
    m["feature_size"] = 128
    conf["data"] = {"frames": 2, "image_size": 32}
    mix = {"kind": "train", "pool_batches": 3, "check_steps": 3, "trace_units": 3}
    cell = train.Cell(Context(conf, mix, {}, 2 ** 31 + 5, torch.device("cpu")))
    reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        cell.setup()
    counted = counters()
    cell.release()
    assert counted.get("decodes_layer", 0) == 0 and counted["decodes_fused"] == 2 * 3
    readings = cell.check()["program"]
    assert set(readings) == set(TRAIN_TOL)
    for name, value in readings.items():
        assert math.isfinite(value) and value <= TRAIN_TOL[name], (name, value)
