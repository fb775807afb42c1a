"""The yardstick's FLOP and byte counts: against hand counts at a tiny size,
and against forward-hook counts on the program's own modules there."""
import pytest
import torch

from benchmark.counts import decode as dc
from benchmark.counts import model as counts
from benchmark.harness.program import Context, program_model
from benchmark.reference.spec import Spec
from benchmark.tests.tiny import make_tiny_root
from benchmark.harness.manifest import Manifest


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(2)
    man = Manifest(make_tiny_root(tmp_path_factory.mktemp("tiny")))
    return {name: man.config(name) for name in ("hydrant", "teddybear")}


def hook_flops(model, run):
    """conv, linear and groupnorm FLOPs of `run()` from forward hooks on
    the modules: 2 x out x (in / groups) x kernel, 2 x in x out a row, 7 an
    element."""
    f = {"conv": 0, "linear": 0, "groupnorm": 0}

    def hook(mod, inputs, out):
        if isinstance(mod, (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.Conv3d)):
            k = mod.weight[0].numel()
            f["conv"] += 2 * out.numel() * k
        elif isinstance(mod, torch.nn.Linear):
            f["linear"] += 2 * mod.in_features * out.numel()
        elif isinstance(mod, torch.nn.GroupNorm):
            f["groupnorm"] += counts.GN_PER_ELEMENT * out.numel()

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.Linear,
                                 torch.nn.GroupNorm))]
    with torch.no_grad():
        run()
    for h in handles:
        h.remove()
    return f


def test_unet_by_hand():
    """A one-level UNet at 2^3 by hand: in conv, a ResBlock, the middle
    (two ResBlocks, attention), two output ResBlocks, out."""
    spec = type("S", (), {})()
    spec.net_3d_type = "SimpleUnet3D"
    spec.net_3d = dict(model_channels=32, channel_mult=[1], num_res_blocks=1, attention_resolutions=[])
    spec.feature_size, spec.resol = 8, 2
    n, c, emb = 8, 32, 128
    conv3 = lambda a, b: 2 * a * b * 27 * n  # noqa: E731
    res = lambda a, b: conv3(a, b) + conv3(b, b) + 2 * emb * 2 * b + (2 * a * b * n if a != b else 0)  # noqa
    gn = lambda a: 7 * a * n  # noqa: E731
    attn = gn(c) + 2 * c * 3 * c * n + 2 * c * c * n + 4 * c * n * n
    want = (2 * 32 * 128 + 2 * 128 * 128 + conv3(8, c) + res(c, c) + gn(2 * c)
            + 2 * res(c, c) + attn + 2 * gn(2 * c)
            + 2 * res(2 * c, c) + 2 * gn(3 * c) + gn(c) + conv3(c, 8))
    assert sum(counts.net_3d_forward(spec).values()) == want


def test_decode_by_hand():
    # one point, one ray, a 1^3 x 2 grid, hidden 3, pe 4, normals on
    n_bytes, flops = dc.decode_cost(1, 1, (1, 1, 1, 2), 3, 4, True)
    assert flops == 2 * 8 * 2 + 2 * 2 * 4 + 2 * 7 * 3 + 2 * 8 * 3
    assert n_bytes == 4 * (3 + 4 + 2 + 8 + 4 + 21 + 3 + 1 + 7)
    assert dc.decode_bwd_only_flops(1, 2, 3, 4) == 2 * 7 * 3 + 2 * 3 * 3 + 4 * 2 * 4 + 2 * 8 * 2
    assert dc.least_seconds(3.35e12, 0.0, 495e12, 3.35e12) == 1.0


def test_render_passes_of_the_release_config(tiny):
    spec = Spec.from_config(Manifest().config("hydrant")["program_config"])
    assert dc.render_passes(spec, 3 * 1024, True) == [(3 * 1024 * 64, 3072), (3 * 1024 * 128, 3072)]
    assert dc.frame_rays(spec) == 512 * 512 and spec.chunk_size_grid // spec.n_pts_eval == 640


@pytest.mark.parametrize("name", ["hydrant", "teddybear"])
def test_counts_match_hooks_on_the_program(tiny, name):
    ctx = Context(tiny[name], {}, {}, 0, torch.device("cpu"))
    model = program_model(ctx, ctx.weights())
    s = ctx.spec
    r, C = s.resol, s.feature_size
    unet = hook_flops(model.net_3d, lambda: model.apply_net_3d(torch.zeros(1, r, r, r, C),
                                                               torch.zeros(1, dtype=torch.long)))
    mine = counts.net_3d_forward(s)
    assert {k: mine[k] for k in unet} == unet
    size, frames = ctx.config["data"]["image_size"], ctx.config["data"]["frames"]
    imgs = torch.rand(frames, size, size, 3)
    ext = hook_flops(model.image_feature_extractor,
                     lambda: model.image_feature_extractor(imgs, torch.ones(frames, size, size, 1)))
    assert ext["conv"] == counts.extractor_forward(s, frames, size, size)[0]["conv"]
    from holo_diffusion_torch.geometry.cameras import PerspectiveCameras

    cams = PerspectiveCameras(torch.eye(3).expand(frames, 3, 3), torch.tensor([[0.0, 0.0, 9.0]]).expand(frames, 3),
                              torch.full((frames, 2), 2.5), torch.zeros(frames, 2))
    pool = {**hook_flops(model.view_pooler, lambda: model.pool_features(imgs, cams, torch.ones(frames, size, size, 1)))}
    mapper = hook_flops(model.pooled_feature_mapper,
                        lambda: model.pooled_feature_mapper(torch.zeros(r ** 3, model.view_pooler.out_dim)))
    assert pool["linear"] + mapper["linear"] == counts.pooling_forward(s, frames)["linear"]
