"""The port's UNet family against the JAX package on the CPU: UNetModel3D in
1 and 2 dims, class-conditional, with `cond_features`, without
`conv_resample`, in bfloat16; SuperResModel, EncoderUNetModel with its three
pools, AttentionPool2d, ResBlockGigaGAN (plain and down), QKVLocalAttention
and AsymmetricUNetModel (JAX `tests/test_unet_variants.py`'s cases, held to
JAX's numbers, not shapes only). Each JAX model gets seeded random variables
(tests/torch_jax_params.py) that go to the port through
`weights.state_dict_from_jax`; the same numpy inputs go to both.

Tolerance: float32 on both sides, different summation orders through a few
layers: 1e-4 absolute and relative on O(1) outputs. bfloat16: 0.05 absolute
on O(1) outputs (a bfloat16 ulp is 2^-8 of the value, and roundings of
convolution sums in another order add up over ~10 layers).
"""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holo_diffusion_tpu.models import unet3d as junet
from holo_diffusion_tpu.models import unet_gigagan as jgiga
from holo_diffusion_tpu.models import unet_variants as jvar
from holo_diffusion_torch.models import unet_gigagan as giga
from holo_diffusion_torch.models import unet_variants as var
from holo_diffusion_torch.models.unet3d import UNetModel3D
from holo_diffusion_torch.weights import init_weights, state_dict_from_jax
from torch_jax_params import random_variables

TOL = dict(atol=1e-4, rtol=1e-4)
UNET_2D = dict(in_channels=3, model_channels=32, out_channels=3, num_res_blocks=1, channel_mult=(1, 2),
               attention_resolutions=(2,), dims=2)
UNET_3D = dict(in_channels=8, model_channels=32, out_channels=4, num_res_blocks=1, channel_mult=(1, 2),
               attention_resolutions=(2,), num_heads=2)
ENCODER = dict(in_channels=3, model_channels=32, out_channels=10, num_res_blocks=1, channel_mult=(1, 2),
               attention_resolutions=(2,), dims=2)


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _first(x):
    return np.moveaxis(x, -1, 1).copy()


def _case(name):
    """(JAX module, JAX call args, JAX call kwargs, port module, port call
    args, port call kwargs, kind of `state_dict_from_jax`, channels-first
    output) for a case; the port's tensors are the same numpy arrays."""
    rs = np.random.RandomState(CASES.index(name))
    t2 = np.array([3, 500])
    if name == "unet_2d":
        x = _rand(rs, 2, 16, 16, 3)
        return junet.UNetModel3D(use_remat=False, **UNET_2D), (x, t2), {}, UNetModel3D(**UNET_2D), (x, t2), {}, "unet"
    if name == "unet_1d":
        kw = dict(UNET_2D, in_channels=4, out_channels=4, attention_resolutions=(), dims=1)
        x = _rand(rs, 2, 32, 4)
        return junet.UNetModel3D(use_remat=False, **kw), (x, t2), {}, UNetModel3D(**kw), (x, t2), {}, "unet"
    if name == "unet_class_conditional":
        kw = dict(UNET_2D, channel_mult=(1,), attention_resolutions=(), num_classes=5)
        x, y = _rand(rs, 2, 8, 8, 3), np.array([0, 3])
        return (junet.UNetModel3D(use_remat=False, **kw), (x, t2), {"y": y}, UNetModel3D(**kw), (x, t2), {"y": y},
                "unet")
    if name == "unet_cond_features":
        x, c = _rand(rs, 1, 8, 8, 8, 4), _rand(rs, 1, 8, 8, 8, 4)
        t1 = np.array([42])
        return (junet.UNetModel3D(use_remat=False, **UNET_3D), (x, t1), {"cond_features": c},
                UNetModel3D(**UNET_3D), (x, t1), {"cond_features": c}, "unet")
    if name == "unet_no_conv_resample":
        kw = dict(UNET_3D, in_channels=4, conv_resample=False)
        x, t1 = _rand(rs, 1, 8, 8, 8, 4), np.array([7])
        return junet.UNetModel3D(use_remat=False, **kw), (x, t1), {}, UNetModel3D(**kw), (x, t1), {}, "unet"
    if name == "super_res":
        kw = dict(UNET_2D, in_channels=6, attention_resolutions=())
        x, low, t1 = _rand(rs, 1, 16, 16, 3), _rand(rs, 1, 8, 8, 3), np.array([9])
        return (jvar.SuperResModel(unet=junet.UNetModel3D(use_remat=False, **kw)), (x, t1, low), {},
                var.SuperResModel(**kw), (x, t1, low), {}, "unet")
    if name.startswith("encoder_"):
        pool = name[len("encoder_"):]
        x = _rand(rs, 2, 16, 16, 3)
        return (jvar.EncoderUNetModel(pool=pool, **ENCODER), (x, t2), {},
                var.EncoderUNetModel(image_size=16, pool=pool, **ENCODER), (x, t2), {}, "unet")
    if name == "attention_pool":
        x = _rand(rs, 3, 4, 4, 32)
        return (jvar.AttentionPool2d(embed_dim=32, num_heads=2, output_dim=7), (x,), {},
                var.AttentionPool2d(4, 32, 2, 7), (_first(x),), {}, "attention_pool")
    if name in ("resblock_gigagan", "resblock_gigagan_down"):
        down = name.endswith("down")
        cout = 32 if down else 64
        x = _rand(rs, 1, 8, 8, 32)
        return (jgiga.ResBlockGigaGAN(out_channels=cout, dims=2, down=down), (x,), {},
                giga.ResBlockGigaGAN(32, cout, down=down), (_first(x),), {}, "res_block")
    if name == "local_attention":
        x = _rand(rs, 2, 8, 8, 32)
        return (jgiga.QKVLocalAttention(num_heads=2, window=4), (x,), {},
                giga.QKVLocalAttention(32, num_heads=2, window=4), (_first(x),), {}, "attention")
    if name == "asymmetric_unet":
        kw = dict(in_channels=3, model_channels=32, out_channels=3, num_res_blocks=1, channel_mult=(1, 2),
                  attention_resolutions=(2,))
        x = _rand(rs, 1, 16, 16, 3)
        return jgiga.AsymmetricUNetModel(**kw), (x,), {}, giga.AsymmetricUNetModel(**kw), (x,), {}, "unet"
    raise KeyError(name)


CASES = ["unet_2d", "unet_1d", "unet_class_conditional", "unet_cond_features", "unet_no_conv_resample",
         "super_res", "encoder_adaptive", "encoder_attention", "encoder_spatial", "attention_pool",
         "resblock_gigagan", "resblock_gigagan_down", "local_attention", "asymmetric_unet"]


def _jax_and_port(name):
    jm, jargs, jkw, tm, targs, tkw, kind = _case(name)
    jargs = [jnp.asarray(a) for a in jargs]
    jkw = {k: jnp.asarray(v) for k, v in jkw.items()}
    flat, variables = random_variables(jm, *jargs, **jkw)
    y_j = np.asarray(jax.jit(lambda v, *a: jm.apply(v, *a, **jkw))(variables, *jargs))
    tm.load_state_dict(state_dict_from_jax(flat["params"], kind=kind), strict=True)
    tm.eval()
    with torch.no_grad():
        y_t = tm(*(torch.from_numpy(np.asarray(a)) for a in targs),
                 **{k: torch.from_numpy(v) for k, v in tkw.items()}).numpy()
    if kind in ("res_block", "attention"):  # blocks run channels-first
        y_t = np.moveaxis(y_t, 1, -1)
    return y_j, y_t, tm


@pytest.mark.parametrize("name", CASES)
def test_matches_jax(name):
    y_j, y_t, tm = _jax_and_port(name)
    assert y_t.shape == y_j.shape and np.isfinite(y_t).all()
    np.testing.assert_allclose(y_t, y_j, **TOL)
    if name == "unet_class_conditional":  # the label moves the output
        x = torch.zeros(2, 8, 8, 3)
        t = torch.zeros(2, dtype=torch.long)
        with torch.no_grad():
            assert (tm(x, t, y=torch.tensor([0, 0])) - tm(x, t, y=torch.tensor([3, 3]))).abs().max() > 0


def test_local_attention_is_the_identity_at_init():
    """Its projection starts at zero, in the module and through init_weights
    (JAX: `kernel_init=_zeros`)."""
    x = torch.randn(2, 32, 8, 8, generator=torch.Generator().manual_seed(0))
    m = giga.QKVLocalAttention(32, num_heads=2, window=4)
    for module in (m, init_weights(m, seed=3)):
        with torch.no_grad():
            assert torch.equal(module(x), x)


def test_bfloat16_unet_matches_jax_and_runs_its_convolutions_in_bfloat16(monkeypatch):
    """dtype bfloat16: every convolution and linear layer computes in
    bfloat16, every GroupNorm in float32, as JAX's `dtype` and its float32
    GroupNorm32; the output agrees with JAX's bfloat16 UNet within 0.05."""
    kw = dict(UNET_2D, dtype="bfloat16")
    rs = np.random.RandomState(5)
    x, t = _rand(rs, 2, 16, 16, 3), np.array([3, 500])
    jm = junet.UNetModel3D(use_remat=False, **dict(kw, dtype=jnp.bfloat16))
    flat, variables = random_variables(jm, jnp.asarray(x), jnp.asarray(t))
    y_j = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x), jnp.asarray(t)).astype(jnp.float32))
    tm = UNetModel3D(**kw)
    tm.load_state_dict(state_dict_from_jax(flat["params"], kind="unet"), strict=True)
    seen = {}

    def hook(mod, inputs, output):
        seen.setdefault(type(mod).__name__, set()).add((inputs[0].dtype, output.dtype))

    for mod in tm.modules():
        if isinstance(mod, (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.Linear)):
            mod.register_forward_hook(hook)
    group_norm = torch.nn.functional.group_norm

    def spy(x, *args, **kwargs):
        out = group_norm(x, *args, **kwargs)
        seen.setdefault("group_norm", set()).add((x.dtype, out.dtype))
        return out

    monkeypatch.setattr(torch.nn.functional, "group_norm", spy)
    with torch.no_grad():
        y_t = tm(torch.from_numpy(x), torch.from_numpy(t)).float().numpy()
    # autocast casts a layer's float32 input inside the call
    assert {o for k in ("Conv2d", "Conv1d", "Linear") for _, o in seen[k]} == {torch.bfloat16}
    # GroupNorm32 normalises in float32 and casts back
    assert seen["group_norm"] == {(torch.float32, torch.float32)}
    np.testing.assert_allclose(y_t, y_j, atol=0.05, rtol=0)


@pytest.mark.parametrize("simple_init,zero_last_conv", [(False, False), (True, True)])
def test_init_zeroes_what_jax_zeroes(simple_init, zero_last_conv):
    """`simple_init=False` zeroes the ResBlocks' out convs and the attention
    projections, `zero_last_conv` the last conv: the port's init_weights
    leaves exactly the parameters at zero that JAX's init does (the biases
    and these), and draws the other kernels within xavier's bound."""
    kw = dict(UNET_2D, in_channels=4, out_channels=4, dims=1, simple_init=simple_init,
              zero_last_conv=zero_last_conv)
    jm = junet.UNetModel3D(use_remat=False, **kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 4)), jnp.zeros((1,), jnp.int32))
    from flax.traverse_util import flatten_dict
    sd_j = state_dict_from_jax({k: np.asarray(v) for k, v in flatten_dict(params["params"], sep="/").items()},
                               kind="unet")
    tm = init_weights(UNetModel3D(**kw), seed=0)
    sd_t = tm.state_dict()
    assert sd_t.keys() == sd_j.keys()
    zeros_j = {k for k, v in sd_j.items() if not v.any()}
    zeros_t = {k for k, v in sd_t.items() if not v.any()}
    assert zeros_t == zeros_j
    named = {k for k in zeros_t if not k.endswith(".bias")}
    if simple_init:
        assert named == {"out.2.weight"}
    else:
        assert "input_blocks.1.0.out_layers.3.weight" in named and "middle_block.1.proj_out.weight" in named
        assert "out.2.weight" not in named
    for k, v in sd_t.items():
        if v.ndim >= 2 and k not in zeros_t:
            receptive = int(np.prod(v.shape[2:]))
            bound = (6.0 / ((v.shape[0] + v.shape[1]) * receptive)) ** 0.5
            assert v.abs().max() <= bound and sd_j[k].abs().max() <= bound + 1e-6, k


def test_remat_leaves_the_gradients_unchanged():
    """`use_remat` recomputes the ResBlocks and attention blocks in the
    backward (torch.utils.checkpoint): the same loss and gradients as
    without it, to float32 rounding (1e-6 relative)."""
    kw = dict(UNET_3D, dropout=0.0)
    gen = torch.Generator().manual_seed(0)
    x, c = torch.randn(1, 8, 8, 8, 4, generator=gen), torch.randn(1, 8, 8, 8, 4, generator=gen)
    t = torch.tensor([11])
    grads = []
    for remat in (False, True):
        m = init_weights(UNetModel3D(use_remat=remat, **kw), seed=1).train()
        loss = (m(x, t, cond_features=c) ** 2).mean()
        loss.backward()
        grads.append((loss.detach(), {k: p.grad for k, p in m.named_parameters()}))
    (l0, g0), (l1, g1) = grads
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-9, msg=k)


def test_hydrant_unet_keeps_its_parameter_names_and_shapes():
    """The hydrant net_3d's state_dict is exactly what `state_dict_from_jax`
    makes of JAX's hydrant UNet (names and shapes, from `jax.eval_shape`)."""
    from flax.traverse_util import flatten_dict

    kw = dict(in_channels=64, out_channels=64)
    jm = junet.UNetModel3D(use_remat=False, **kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 64)),
                            jnp.zeros((1,), jnp.int32))
    flat = {k: np.zeros(v.shape, np.float32) for k, v in flatten_dict(shapes["params"], sep="/").items()}
    sd_j = state_dict_from_jax(flat, kind="unet")
    sd_t = UNetModel3D(**kw).state_dict()
    assert {k: tuple(v.shape) for k, v in sd_t.items()} == {k: tuple(v.shape) for k, v in sd_j.items()}
    assert sum(v.numel() for v in sd_t.values()) == sum(v.size for v in flat.values())
