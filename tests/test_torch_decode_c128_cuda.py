"""The fused decode's kernels at C 128 (`csrc/fused_decode_c128.cu`: K1, K3
and K2 at the reference model's default grid, 32^3 x 128, hidden 256)
against their plain PyTorch versions on the card, the shared memory their
launches ask for, and one training step of `hydrant_g32c128.yaml` with every
decode on those kernels. Every test here is marked `cuda` and skips without
a CUDA device. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_decode_c128_cuda.py -m cuda -q
"""
import numpy as np
import pytest
import torch

from holo_diffusion_torch.ops import _build
from holo_diffusion_torch.ops import fused_decode as fd

EXTENT, PE_DIM, D, C, HIDDEN = 8.0, 27, 32, 128, 256
# a hydrant_g32c128 training step's fine pass (3 targets x 1024 rays x
# (64 + 64) points, 393,216 points) and an evaluation chunk (640 rays x 128)
POINT_SETS = {"train_fine": (3 * 1024, 128), "eval_chunk": (640, 128)}
# K2 against the plain backward on a slope-safe cotangent, relative to each
# cotangent's largest magnitude: the two differ by summation order alone
# (atomics against cuBLAS; dA, a sum over 393,216 points, reads up to
# ~2e-5), and a K2 on plain TF32 products, without the 3 x TF32 split's lo
# terms, reads 2.9e-3 and more and fails it (PERF.md gives both readings)
BWD_SLOPE_SAFE_TOL = 1e-4


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed, R, P, hidden=HIDDEN):
    """A 32^3 x 128 grid in [-1, 1], decoder weights at their fan-in scale,
    and points along R rays through the volume (P a ray, in order, as a
    render pass holds them), some of them beyond the grid."""
    rs = np.random.RandomState(seed)
    grid = np.tanh(rs.randn(D, D, D, C))
    A = rs.randn(C, hidden + 1) / np.sqrt(C)
    c = rs.randn(hidden + 1) * 0.1
    Wr = rs.randn(hidden + PE_DIM, 3) / np.sqrt(hidden + PE_DIM)
    br = rs.randn(3) * 0.1
    origin = rs.randn(R, 3)
    origin *= 1.2 * EXTENT / np.linalg.norm(origin, axis=-1, keepdims=True)
    target = rs.uniform(-0.3 * EXTENT, 0.3 * EXTENT, (R, 3))
    t = np.sort(rs.uniform(0.0, 2.0, (R, P)), axis=-1)
    pts = origin[:, None] + t[..., None] * (target - origin)[:, None]
    pe = rs.randn(R, PE_DIM)
    return [torch.from_numpy(x.astype(np.float32)) for x in (grid, A, c, Wr, br, pts, pe)]


def _g1(grid, A):
    return torch.einsum("dhwc,c->dhw", grid, A[:, -1])


def _assert_cotangents_close(got, want, rel):
    for name, a, b in zip(("d_grid", "dA", "dc", "dWr", "dbr"), got, want):
        assert a.shape == b.shape, name
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= rel * scale, f"{name}: max|diff| {err:.3e} > {rel} x {scale:.3e}"


def _launches_at_c128(name):
    return _build.launch_counts().get(f"{name}@C128", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("points", list(POINT_SETS))
@pytest.mark.parametrize("normals", [False, True], ids=["K1", "K3"])
def test_c128_forward_matches_plain(points, normals):
    """K1/K3 at C 128 against the plain version, float32 on both sides: the
    3 x TF32 split holds the C-64 kernels' 1e-5."""
    dev = _device()
    grid, A, c, Wr, br, pts, pe = (x.to(dev) for x in _inputs(31, *POINT_SETS[points]))
    kw = {"g1": _g1(grid, A)} if normals else {}
    name = fd.ENTRY_POINTS[int(normals)]
    before = _launches_at_c128(name)
    out = fd.fused_sample_decode(grid, A, c, Wr, br, pts, pe, EXTENT, HIDDEN, **kw)
    ref = fd.fused_sample_decode_reference(grid, A, c, Wr, br, pts, pe, EXTENT, HIDDEN, **kw)
    torch.cuda.synchronize()
    assert _launches_at_c128(name) == before + 1
    assert len(out) == len(ref) == (3 if normals else 2)
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _slope_safe_cotangent(seed, grid, A, c, Wr, br, pts, pe):
    """A random (R, P, 4) cotangent, zero at the points with a nonzero
    pre-activation within 1e-5 of 0, in the density net or in the radiance
    head. Two float32 summation orders may give such a pre-activation
    opposite signs, and so leaky-ReLU slopes 1 and 0.2 that move the point's
    whole contribution (about 1e-3 of d_grid's scale at the training pass:
    123 of its 393,216 points); with their cotangent zero both sides
    compute the same function."""
    from holo_diffusion_torch.ops.voxel import sample_voxel_grid_world

    R, P = pts.shape[:2]
    g = torch.from_numpy(np.random.RandomState(seed).randn(R, P, 4).astype(np.float32)).to(pts.device)
    with torch.no_grad():
        pre = sample_voxel_grid_world(grid, pts.reshape(-1, 3), EXTENT) @ A + c
        near = ((pre != 0) & (pre.abs() < 1e-5)).any(dim=-1)
        pe_pts = pe[:, None, :].expand(R, P, PE_DIM).reshape(-1, PE_DIM)
        rpre = torch.cat([torch.nn.functional.leaky_relu(pre[:, :HIDDEN], 0.2), pe_pts], dim=-1) @ Wr + br
        near |= ((rpre != 0) & (rpre.abs() < 1e-5)).any(dim=-1)
    g.reshape(-1, 4)[near] = 0.0
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("points", list(POINT_SETS))
def test_c128_backward_matches_plain(points):
    """K2 at C 128: the five cotangents against the plain backward within
    BWD_SLOPE_SAFE_TOL of each one's largest magnitude, on a cotangent that
    leaves out the points where the two may take different leaky-ReLU
    slopes (`_slope_safe_cotangent`)."""
    dev = _device()
    R, P = POINT_SETS[points]
    grid, A, c, Wr, br, pts, pe = (x.to(dev) for x in _inputs(32, R, P))
    g = _slope_safe_cotangent(33, grid, A, c, Wr, br, pts, pe)
    before = _launches_at_c128("fused_decode_bwd")
    args = (grid, A, c, Wr, br, pts, pe, EXTENT, HIDDEN, g)
    got = fd._fused_sample_decode_bwd_cuda(*args)
    want = fd.fused_sample_decode_bwd_reference(*args)
    torch.cuda.synchronize()
    assert _launches_at_c128("fused_decode_bwd") == before + 1
    _assert_cotangents_close(got, want, BWD_SLOPE_SAFE_TOL)


@pytest.mark.cuda
def test_c128_launches_ask_for_the_layouts_shared_memory():
    """Each C-128 launch at hidden 256 asks for the bytes `fwd_smem_bytes` /
    `bwd_smem_bytes` give, at most the 232,448 a block may opt into; at
    hidden 271 K2 still launches, at 272 (280 columns, past its dA
    accumulators) it refuses, as `kernels_take` says."""
    dev = _device()
    grid, A, c, Wr, br, pts, pe = (x.to(dev) for x in _inputs(34, 64, 16))
    g = torch.ones((64, 16, 4), device=dev)
    fd.fused_sample_decode(grid, A, c, Wr, br, pts, pe, EXTENT, HIDDEN)
    fd.fused_sample_decode(grid, A, c, Wr, br, pts, pe, EXTENT, HIDDEN, g1=_g1(grid, A))
    fd._fused_sample_decode_bwd_cuda(grid, A, c, Wr, br, pts, pe, EXTENT, HIDDEN, g)
    torch.cuda.synchronize()
    lib = _build.load("fused_decode_c128")
    want = [fd.fwd_smem_bytes(C, HIDDEN, PE_DIM)] * 2 + [fd.bwd_smem_bytes(C, HIDDEN, PE_DIM)]
    assert [lib.decode_c128_smem_bytes(k) for k in range(3)] == want
    assert max(want) <= fd.SMEM_OPTIN_BYTES
    assert fd.kernels_take(C, HIDDEN, PE_DIM)
    for hidden in (271, 272):
        grid, A, c, Wr, br, pts, pe = (x.to(dev) for x in _inputs(35, 64, 16, hidden))
        args = (grid, A, c, Wr, br, pts, pe, EXTENT, hidden, g)
        assert fd.kernels_take(C, hidden, PE_DIM) == (hidden == 271)
        if hidden == 271:
            _assert_cotangents_close(fd._fused_sample_decode_bwd_cuda(*args),
                                     fd.fused_sample_decode_bwd_reference(*args), 1e-3)
            assert lib.decode_c128_smem_bytes(2) == fd.bwd_smem_bytes(C, hidden, PE_DIM) <= fd.SMEM_OPTIN_BYTES
        else:
            with pytest.raises(RuntimeError, match="fused_decode_bwd launch failed"):
                fd._fused_sample_decode_bwd_cuda(*args)


@pytest.mark.cuda
def test_g32c128_training_step_decodes_only_on_the_fused_kernels():
    """One training step of `hydrant_g32c128.yaml` (release widths, a
    32^3 x 128 grid; 5 synthetic 96^2 frames, 3 of them targets) through
    `make_train_step`: both render passes decode on the C-128 kernels (the
    route counter has no layer-by-layer decode; K3 and K2 twice each at C
    128), no sampling kernel runs, and the objective is finite."""
    from holo_diffusion_torch.config import load_config, model_args_from_config, optimizer_args_from_config
    from holo_diffusion_torch.data.synthetic import make_synthetic_scene
    from holo_diffusion_torch.device import set_full_precision
    from holo_diffusion_torch.models.holo_model import HoloDiffusionModel
    from holo_diffusion_torch.ops import kron_sample as ks
    from holo_diffusion_torch.parallel.train_step import TrainState, make_train_step
    from holo_diffusion_torch.train.optimizer import make_optimizer
    from holo_diffusion_torch.utils.profiling import counters, reset_counters

    dev = _device()
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    set_full_precision()
    try:
        cfg = load_config("hydrant_g32c128")
        args = model_args_from_config(cfg)
        assert (args["resol"], args["feature_size"]) == (32, 128)
        torch.manual_seed(0)
        with torch.device(dev):
            model = HoloDiffusionModel(**args)
        model.train()
        opt = make_optimizer(model.named_parameters(), **optimizer_args_from_config(cfg)["optimizer"])
        step = make_train_step(model, opt)
        state = TrainState.create(model, opt)
        batch = make_synthetic_scene(n_views=5, image_size=96, device=dev)
        _build.reset_launch_counts()
        reset_counters()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            state, metrics = step(state, batch, torch.Generator(device=dev).manual_seed(1))
            objective = float(metrics["objective"])
        counted = counters()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert np.isfinite(objective)
    assert counted.get("decodes_layer", 0) == 0 and counted["decodes_fused"] == 2
    counts = _build.launch_counts()
    assert {k: n for k, n in counts.items() if "@" in k} == {"fused_decode_fwd_normals@C128": 2, "fused_decode_bwd@C128": 2}
    assert sum(counts[k] for k in ks.ENTRY_POINTS) == 0


@pytest.mark.cuda
def test_g32c128_frame_and_ddpm_steps_match_the_reference():
    """At 32^3 x 128, through the benchmark's cells (one seed, float32):
    one 512^2 fly-around frame through `render_eval.render_image_chunked`
    (820 K3 launches at C 128) and 20 DDPM steps of a chain through
    `models/diffusion.py`, each against `benchmark/reference/` from the same
    weights, grid and draws, within the limits the benchmark holds hydrant's
    frames and DDPM steps to (`benchmark/limits/hydrant.frames.json`,
    `hydrant.sample.json`), which TF32 fails."""
    from benchmark.harness.kinds import frames, sample
    from benchmark.harness.manifest import Manifest
    from benchmark.harness.program import Context
    from benchmark.harness.runner import run_units
    from benchmark.harness import compare

    dev = _device()
    man = Manifest()
    conf = man.config("hydrant_g32c128")
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        cell = frames.Cell(Context(conf, {**man.mix("frames"), "check_frames": 1}, man.limits("hydrant.frames"),
                                   2 ** 31 + 1001, dev))
        cell.setup()
        # the frame replays the chunk graphs its set-up captured: its K3
        # launches show in a device trace, not in the host's launch counters
        _build.reset_launch_counts()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            run_units(cell, 1)
            torch.cuda.synchronize()
        kernels = [e.name() for e in prof.profiler.kineto_results.events() if "CUDA" in str(e.device_type())]
        assert sum("decode_c128_fwd_kernel<true>" in k for k in kernels) == 820
        assert not any("fused_decode" in k or "decode_c128_fwd_kernel<false>" in k for k in kernels)
        assert not any(_build.launch_counts()[k] for k in fd.ENTRY_POINTS)
        cell.release()
        ok, table = compare.verdict(cell.check()["program"], cell.ctx.limits)
        assert ok, table
        cell = sample.Cell(Context(conf, man.mix("sample"), man.limits("hydrant.sample"), 2 ** 31 + 1002, dev))
        cell.setup()
        run_units(cell, 20 - man.mix("sample")["start_steps"])
        cell.release()
        ok, table = compare.verdict(cell.check()["program"], cell.ctx.limits)
        assert ok, table
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
