"""The reference `.pth` import: `python -m
holo_diffusion_torch.import_reference_checkpoint` on a reference-layout
state_dict built here (no weights needed) writes a checkpoint that
`load_experiment` serves, equal to `state_dict_from_reference` +
`load_state_dict`; a missing or unexpected key raises and is named. And the
torchvision ResNet trunk (`weights.load_resnet_state_dict`, read through
`pretrained: true` + `weights_path`) against JAX
`utils/torch_import.py:convert_resnet_state_dict` through
`state_dict_from_jax`."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

sys.path.insert(0, os.path.dirname(__file__))

from torch_tiny_config import MODEL, TINY_OVERRIDES, tiny_cfg  # noqa: E402

from holo_diffusion_torch.experiment import Experiment  # noqa: E402
from holo_diffusion_torch.geometry.cameras import PerspectiveCameras, look_at_view_transform  # noqa: E402
from holo_diffusion_torch.import_reference_checkpoint import main as import_main  # noqa: E402
from holo_diffusion_torch.models.feature_extractor import ResNetFeatureExtractor  # noqa: E402
from holo_diffusion_torch.render_eval import render_image_chunked  # noqa: E402
from holo_diffusion_torch.sampling import sample_random_voxel_features  # noqa: E402
from holo_diffusion_torch.utils.checkpoint_utils import load_experiment  # noqa: E402
from holo_diffusion_torch.weights import load_resnet_state_dict, state_dict_from_jax, state_dict_from_reference  # noqa: E402
from holo_diffusion_tpu.utils.torch_import import convert_resnet_state_dict  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FE = MODEL + "image_feature_extractor_ResNetFeatureExtractor_args."


def _reference_sd(tmp_path):
    """The tiny model's state_dict with seeded random values, in the
    reference's layout: `net_3d._net.`, `_implicit_functions.0._fn.`, and
    the harmonic embeddings' `_frequencies`."""
    exp = Experiment(tiny_cfg(tmp_path / "init"), device="cpu")
    gen = torch.Generator().manual_seed(0)
    sd = {}
    for k, v in exp.init_state().model.state_dict().items():
        v = torch.randn(v.shape, generator=gen).to(v.dtype) if v.is_floating_point() else v
        k = k.replace("net_3d.", "net_3d._net.", 1) if k.startswith("net_3d.") else k
        k = k.replace("implicit_function.", "_implicit_functions.0._fn.", 1)
        sd[k] = v
    sd["_implicit_functions.0._fn.render_mlp._dir_encoder._frequencies"] = torch.ones(4)
    return sd


@pytest.mark.parametrize("wrapped", [True, False], ids=["model_key", "bare"])
def test_import_writes_a_checkpoint_that_load_experiment_serves(tmp_path, wrapped):
    sd = _reference_sd(tmp_path)
    pth = str(tmp_path / "ref.pth")
    torch.save({"model": sd, "epoch": 350} if wrapped else sd, pth)
    exp_dir = str(tmp_path / "imported")
    import_main(["--pth", pth, "--config-name", "synthetic_debug.yaml", "--exp-dir", exp_dir, "--epoch", "350",
                 "--device", "cpu", *TINY_OVERRIDES])
    assert os.path.isfile(os.path.join(exp_dir, "expconfig.yaml"))
    exp, state = load_experiment(exp_dir, device="cpu")
    want = state_dict_from_reference(sd)
    got = state.model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)
    # it serves: a short DDPM sample, rendered
    grid = sample_random_voxel_features(state.model, torch.Generator().manual_seed(1), max_iter=2, device="cpu")
    R, T = look_at_view_transform(dist=4.0, elev=torch.tensor([20.0]), azim=torch.tensor([30.0]))
    cam = PerspectiveCameras(R, T, torch.full((1, 2), 2.0), torch.zeros(1, 2))
    frame = render_image_chunked(state.model, cam, grid[0], 8, 8, device="cpu")
    assert frame["images_render"].shape == (8, 8, 3) and torch.isfinite(frame["images_render"]).all()


@pytest.mark.parametrize("fault", ["missing", "unexpected"])
def test_import_names_a_missing_or_unexpected_key(tmp_path, fault):
    sd = _reference_sd(tmp_path)
    name = "net_3d._net.out.2.weight" if fault == "missing" else "net_3d._net.label_emb.weight"
    if fault == "missing":
        del sd[name]
    else:
        sd[name] = torch.zeros(3, 4)
    pth = str(tmp_path / "ref.pth")
    torch.save({"model": sd}, pth)
    port_name = name.replace("net_3d._net.", "net_3d.")
    with pytest.raises(KeyError, match=port_name.replace(".", r"\.")):
        import_main(["--pth", pth, "--config-name", "synthetic_debug.yaml", "--exp-dir", str(tmp_path / "x"),
                     "--device", "cpu", *TINY_OVERRIDES])
    assert not os.path.exists(tmp_path / "x" / "model_epoch_00000000")


def test_import_runs_as_a_module_and_needs_the_card_unless_asked(tmp_path, monkeypatch):
    out = subprocess.run([sys.executable, "-m", "holo_diffusion_torch.import_reference_checkpoint", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--pth" in out.stdout and "--epoch" in out.stdout
    pth = str(tmp_path / "ref.pth")
    torch.save({}, pth)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        import_main(["--pth", pth, "--config-name", "synthetic_debug.yaml", "--exp-dir", str(tmp_path / "x")])


def _torchvision_sd(layers_arch="resnet18", seed=0):
    """A torchvision-layout ResNet state_dict (every stage, fc) with seeded
    random values."""
    net = ResNetFeatureExtractor(name_arch=layers_arch, stages=(1, 2, 3, 4)).net
    gen = torch.Generator().manual_seed(seed)
    sd = {k: (torch.rand(v.shape, generator=gen) + 0.5 if "running_var" in k else
              torch.randn(v.shape, generator=gen)) if v.is_floating_point() else v
          for k, v in net.state_dict().items()}
    sd["fc.weight"], sd["fc.bias"] = torch.randn(1000, 512, generator=gen), torch.zeros(1000)
    return sd


def test_resnet_mapping_matches_jax_convert_resnet_state_dict():
    sd = _torchvision_sd()
    stages = (1, 2)
    ext = ResNetFeatureExtractor(name_arch="resnet18", stages=stages, proj_dim=4)
    proj = {k: v.clone() for k, v in ext.proj_layers.state_dict().items()}
    load_resnet_state_dict(ext, sd)
    j = convert_resnet_state_dict({k: v.numpy() for k, v in sd.items()}, layers=(2, 2, 2, 2), stages=stages)
    via_jax = state_dict_from_jax(
        {"feature_extractor/" + k: v for k, v in flatten_dict(j["params"], sep="/").items()},
        {"feature_extractor/" + k: v for k, v in flatten_dict(j["batch_stats"], sep="/").items()})
    got = ext.state_dict()
    for k, v in via_jax.items():
        name = k[len("image_feature_extractor."):]
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got[name].numpy(), v.numpy(), err_msg=k)
    trunk = {k for k in got if k.startswith("net.") and not k.endswith("num_batches_tracked")}
    assert trunk == {k[len("image_feature_extractor."):] for k in via_jax if not k.endswith("num_batches_tracked")}
    # the projections keep their values
    assert all(torch.equal(v, proj[k]) for k, v in ext.proj_layers.state_dict().items())
    del sd["layer1.0.conv1.weight"]
    with pytest.raises(KeyError, match=r"layer1\.0\.conv1\.weight"):
        load_resnet_state_dict(ext, sd)


def test_pretrained_weights_path_reaches_the_extractor(tmp_path):
    sd = _torchvision_sd(seed=3)
    path = str(tmp_path / "resnet18.pth")
    torch.save(sd, path)
    exp = Experiment(tiny_cfg(tmp_path / "exp", [FE + "pretrained=true", FE + f"weights_path={path}"]), device="cpu")
    net = exp.init_state().model.image_feature_extractor.net
    assert torch.equal(net.layer1[0].conv1.weight, sd["layer1.0.conv1.weight"])
    assert torch.equal(net.bn1.running_var, sd["bn1.running_var"])
