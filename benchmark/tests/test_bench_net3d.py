"""The denoiser as a plug-in, found by the configuration's
`net_3d_class_type`: the UNet's counts, state-dict shapes and tiny cuts
pinned to what they were before it became one; a toy denoiser landed as two
new files in a directory of its own and driven through the spec, the
reference model, the weights, the counts and the tiny cut; and a class type
with no plug-in refused."""
import copy
import hashlib
import json

import pytest
import torch

import benchmark.reference as reference
from benchmark.counts import model as counts
from benchmark.harness.manifest import BENCH_DIR, Manifest
from benchmark.harness.scenes import make_batch
from benchmark.harness.weights import make_state_dict, shapes_of
from benchmark.reference import diffusion as diff
from benchmark.reference.model import Model
from benchmark.reference.spec import Spec
from benchmark.tests.tiny import make_tiny_root, tiny_program_config

# computed with the counts, the reference and tiny.py as they stood before
# the denoiser became a plug-in (train_step at each config's data frames and
# image size; sha256 of the sorted (name, shape, dtype) list as JSON, and of
# the tiny config file's bytes)
PINS = {
    "hydrant": {
        "train": {"attention": 48669696.0, "conv": 937388998656.0, "decode": 62353833984.0,
                  "groupnorm": 136136448.0, "linear": 33068630016.0},
        "ddpm": {"attention": 10815488.0, "conv": 18663211008.0, "groupnorm": 30252544.0, "linear": 6455296.0},
        "frame": {"decode": 1795128557568.0},
        "shapes": (642, "70941c82362f0134e15c6f3acf4d8589cab2db0dcce6292f4f7c3df3897fb0dc"),
        "tiny": "dc15c1950c33222d1a20b00912b4d45794804ae23a1884e3d60d7395f7811500",
    },
    "teddybear": {
        "train": {"attention": 48669696.0, "conv": 738261270528.0, "decode": 207846113280.0,
                  "groupnorm": 136136448.0, "linear": 242958336.0},
        "ddpm": {"attention": 10815488.0, "conv": 18663211008.0, "groupnorm": 30252544.0, "linear": 6455296.0},
        "frame": {"decode": 448782139392.0},
        "shapes": (634, "4fae2b1ed168c6c2810b98b1403e4ffa28b7c0edc2c46ffdf01f230e2e885c4c"),
        "tiny": "9676da622a14be8a6a19d03ba5e9be53771737db6756247f56f6cc9b89f43255",
    },
    "hydrant_g32c128": {
        "train": {"attention": 3114860544.0, "conv": 1590509961216.0, "decode": 121770344448.0,
                  "groupnorm": 1089091584.0, "linear": 265956311040.0},
        "ddpm": {"attention": 692191232.0, "conv": 163801202688.0, "groupnorm": 242020352.0,
                 "linear": 6455296.0},
        "frame": {"decode": 3502378057728.0},
        "shapes": (642, "7cbafbac57d68efa30ae04839aea5cd5853a5a17129a138bc4347ad4d8238dfe"),
        "tiny": "39b3962c3a852d7da9e8a9066aad416c45f0784bb6ea4248493097959663b5c8",
    },
}

TOY_REFERENCE = '''
import math

import torch
from torch import nn


def check(args):
    if args.get("kernel", 3) != 3:
        raise NotImplementedError(f"the reference covers kernel=3, not {args['kernel']!r}")


class ToyNet3D(nn.Module):
    """One 3^3 convolution C -> C plus a bias from the timestep's embedding."""

    def __init__(self, channels, emb_dim):
        super().__init__()
        self.emb_dim = emb_dim
        self.conv = nn.Conv3d(channels, channels, 3, padding=1)
        self.time_bias = nn.Linear(emb_dim, channels)

    def forward(self, x, t):
        half = self.emb_dim // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
        e = t.float()[:, None] * freqs[None]
        emb = torch.cat([torch.cos(e), torch.sin(e)], dim=-1)
        h = self.conv(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        return h + self.time_bias(emb)[:, None, None, None]


def build(feature_size, args):
    return ToyNet3D(feature_size, args["emb_dim"])


def tiny(args):
    return {**args, "emb_dim": 8}
'''

TOY_COUNTS = '''
from collections import Counter

from benchmark.counts.model import conv, linear


def forward(spec, batch=1):
    C, r, e = spec.feature_size, spec.resol, spec.net_3d["emb_dim"]
    return Counter(conv=conv(C, C, 3, batch * r ** 3, 3), linear=linear(e, C, batch))
'''


def _model_args(cfg):
    return cfg["model_factory_ImplicitronModelFactory_args"]["model_HoloDiffusionModel_args"]


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("name", sorted(PINS))
def test_unet_plugin_moves_nothing(tiny_root, name):
    man = Manifest()
    pin = PINS[name]
    conf = man.config(name)
    spec = Spec.from_config(conf["program_config"])
    assert spec.net_3d_type == "SimpleUnet3D"
    size = conf["data"]["image_size"]
    assert counts.train_step(spec, conf["data"]["frames"], size, size) == pin["train"]
    assert counts.ddpm_step(spec) == pin["ddpm"]
    assert counts.frame(spec) == pin["frame"]
    with torch.device("meta"):
        shapes = shapes_of(Model(spec))
    blob = json.dumps(sorted((k, list(s), str(dt)) for k, (s, dt) in shapes.items()))
    assert (len(shapes), hashlib.sha256(blob.encode()).hexdigest()) == pin["shapes"]
    file = next(c["file"] for c in man.data["configs"] if c["name"] == name)
    assert hashlib.sha256((tiny_root / file).read_bytes()).hexdigest() == pin["tiny"]


def _files_under(path):
    return sorted((str(p), p.stat().st_mtime_ns) for p in path.rglob("*")
                  if p.is_file() and "__pycache__" not in p.parts)


@pytest.fixture()
def toy_dir(tmp_path, monkeypatch):
    """A directory holding the toy denoiser's two plug-in files, and the
    finder pointed at it."""
    (tmp_path / "reference").mkdir()
    (tmp_path / "counts").mkdir()
    (tmp_path / "reference" / "net3d_ToyNet3D.py").write_text(TOY_REFERENCE)
    (tmp_path / "counts" / "net3d_ToyNet3D.py").write_text(TOY_COUNTS)
    monkeypatch.setattr(reference, "BENCH_DIR", tmp_path)
    return tmp_path


def _toy_config():
    cfg = copy.deepcopy(Manifest().config("hydrant")["program_config"])
    m = _model_args(cfg)
    del m[f"net_3d_{m['net_3d_class_type']}_args"]  # the UNet's: nothing may read it
    m["net_3d_class_type"] = "ToyNet3D"
    m["net_3d_ToyNet3D_args"] = {"emb_dim": 16}
    return cfg


def _draws(spec, gen):
    """Every draw the reference objective takes, at its shape."""
    nt, n, p, f = spec.n_train_target_views, spec.n_rays_train, spec.n_pts_train, spec.n_fine_train
    grid = (1, spec.resol, spec.resol, spec.resol, spec.feature_size)
    d = {"timesteps": torch.randint(0, spec.num_steps, (2,), generator=gen),
         "noise": torch.randn(grid, generator=gen), "noise2": torch.randn(grid, generator=gen),
         "take_boot": torch.tensor(True), "ray_pixel_u": torch.rand(nt, n, generator=gen),
         "ray_length_u": torch.rand(nt, n, p, generator=gen)}
    for k in range(spec.num_passes):
        if k:
            d[f"refine_u_{k}"] = torch.rand(nt, n, f, generator=gen)
            p = f + (p if spec.append_coarse else 0)
        d[f"density_noise_{k}"] = torch.randn(nt, n, p, generator=gen)
    return d


def test_a_toy_denoiser_lands_as_two_new_files(toy_dir):
    torch.set_num_threads(2)
    before = _files_under(BENCH_DIR)
    cfg = tiny_program_config(_toy_config(), 2)
    m = _model_args(cfg)
    assert m["net_3d_ToyNet3D_args"] == {"emb_dim": 8}
    spec = Spec.from_config(cfg)
    assert (spec.net_3d_type, spec.net_3d) == ("ToyNet3D", {"emb_dim": 8})
    refused = copy.deepcopy(cfg)
    _model_args(refused)["net_3d_ToyNet3D_args"]["kernel"] = 5
    with pytest.raises(NotImplementedError, match="kernel=3"):
        Spec.from_config(refused)

    with torch.device("meta"):
        shapes = shapes_of(Model(spec))
    C, r = spec.feature_size, spec.resol
    assert {k: v[0] for k, v in shapes.items() if k.startswith("net_3d.")} == {
        "net_3d.conv.weight": (C, C, 3, 3, 3), "net_3d.conv.bias": (C,),
        "net_3d.time_bias.weight": (C, 8), "net_3d.time_bias.bias": (C,)}
    sd = make_state_dict(shapes, 7, "cpu")
    model = Model(spec)
    model.load_state_dict(sd, strict=True)
    assert torch.equal(model.net_3d.conv.weight, sd["net_3d.conv.weight"])

    gen = torch.Generator().manual_seed(5)
    sched = diff.Schedule(spec.num_steps, spec.beta_start, spec.beta_end, "cpu")
    x, t = torch.randn(1, r, r, r, C, generator=gen), torch.tensor([37])
    with torch.no_grad():
        out = model.p_sample(sched, x, t, torch.randn(1, r, r, r, C, generator=gen))
        want = torch.clamp(model.net_3d(x, t), -1.0, 1.0)
    assert out["sample"].shape == x.shape and torch.isfinite(out["sample"]).all()
    torch.testing.assert_close(out["pred_xstart"], want, atol=0, rtol=0)

    batch = make_batch(gen, 5, 32, "cpu")
    loss = model.objective(batch, _draws(spec, gen), sched)
    assert torch.isfinite(loss)
    loss.backward()
    assert model.net_3d.conv.weight.grad.abs().sum() > 0

    assert counts.ddpm_step(spec) == {"conv": 2.0 * C * C * 27 * r ** 3, "linear": 2.0 * 8 * C}
    assert counts.train_step(spec, 5, 32, 32)["conv"] > 3 * counts.ddpm_step(spec)["conv"]
    assert _files_under(BENCH_DIR) == before


@pytest.mark.parametrize("part", ["reference", "counts"])
def test_an_unknown_denoiser_is_refused_by_name(tmp_path, part):
    want = str(tmp_path / part / "net3d_NoSuchNet.py")
    with pytest.raises(NotImplementedError, match="NoSuchNet") as err:
        reference.net3d_plugin(part, "NoSuchNet", tmp_path)
    assert want in str(err.value)


def test_a_configuration_with_an_unknown_denoiser_is_refused():
    cfg = _toy_config()
    _model_args(cfg)["net_3d_class_type"] = "NoSuchNet"
    with pytest.raises(NotImplementedError) as err:
        Spec.from_config(cfg)
    assert str(BENCH_DIR / "reference" / "net3d_NoSuchNet.py") in str(err.value)
