"""Packed transfer of the port (data/packing.py, `make_train_step(packer=)`,
`packed_transfer` in the loop) on the CPU, against the JAX package's
`BatchPacker` (tests/test_packing.py names the behaviours): every leaf
round-trips bitwise (the buffers differ: the port aligns each leaf to 16
bytes), the spec is taken lazily and guards structure and shapes, a packed
step and a packed run are bitwise the unpacked ones, and a packer under a
mesh raises."""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_compact import TINY  # noqa: E402
from torch_tiny_config import tiny_cfg  # noqa: E402

from holo_diffusion_torch.data.compact import SourceCompactor  # noqa: E402
from holo_diffusion_torch.data.frame_data import FrameData  # noqa: E402
from holo_diffusion_torch.data.packing import ALIGN, BatchPacker, packed_transfer  # noqa: E402
from holo_diffusion_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from holo_diffusion_torch.experiment import Experiment  # noqa: E402
from holo_diffusion_torch.geometry.cameras import PerspectiveCameras  # noqa: E402
from holo_diffusion_torch.models.holo_model import HoloDiffusionModel  # noqa: E402
from holo_diffusion_torch.parallel.train_step import TrainState, make_train_step  # noqa: E402
from holo_diffusion_torch.train.optimizer import make_optimizer  # noqa: E402
from holo_diffusion_torch.weights import init_weights  # noqa: E402
from holo_diffusion_tpu.data.packing import BatchPacker as JBatchPacker  # noqa: E402


def _odd_batch(seed=0):
    """uint8 leaves of odd byte counts ahead of float32, float16, bool and
    int64 leaves: no leaf after the first starts aligned unless padded."""
    rs = np.random.RandomState(seed)
    cam = PerspectiveCameras(*(torch.from_numpy(rs.randn(*s).astype(np.float32))
                               for s in ((3, 3, 3), (3, 3), (3, 2), (3, 2))))
    return FrameData(
        cam,
        image_rgb=torch.from_numpy(rs.randint(0, 256, (3, 5, 7, 3), dtype=np.uint8)),
        fg_probability=torch.from_numpy(rs.rand(3, 5, 7, 1).astype(np.float16)),
        mask_crop=torch.from_numpy(rs.rand(3, 5, 7, 1) > 0.5),
        depth_map=torch.from_numpy(rs.rand(3, 5, 7, 1).astype(np.float32)),
        sequence_id=torch.from_numpy(rs.randint(-2 ** 40, 2 ** 40, (3,), dtype=np.int64)),
        src_image_rgb=torch.from_numpy(rs.randint(0, 256, (1, 3, 5, 3), dtype=np.uint8)),
        src_fg_probability=torch.from_numpy(rs.rand(1, 3, 5, 1).astype(np.float32)),
    )


def _leaves(b):
    return [getattr(b.camera, k) for k in ("R", "T", "focal_length", "principal_point")] + [
        getattr(b, k) for k in ("image_rgb", "fg_probability", "mask_crop", "depth_map", "sequence_id",
                                "src_image_rgb", "src_fg_probability", "src_mask_crop")]


def _assert_bitwise(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))


def test_round_trip_is_bitwise_with_aligned_views():
    batch = _odd_batch()
    # float32 specials survive as bits
    batch.depth_map.view(-1)[:3] = torch.tensor([float("nan"), float("-inf"), -0.0])
    packer = BatchPacker()
    buf = packer.pack(batch)
    assert buf.dtype == torch.uint8 and buf.ndim == 1 and buf.numel() == packer.nbytes
    out = packer.unpack(buf)
    _assert_bitwise(out, batch)
    assert out.mask_crop.dtype == torch.bool
    for leaf in _leaves(out):
        if leaf is not None:  # views into the buffer, each 16-byte aligned
            assert leaf.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
            assert (leaf.storage_offset() * leaf.element_size()) % ALIGN == 0
    # bools are stored as their 0/1 bytes
    lo = packer._bounds[[i for i, n in enumerate(packer.structure) if n == "mask_crop"][0]][0]
    assert set(buf[lo:lo + batch.mask_crop.numel()].tolist()) <= {0, 1}


def test_leaves_match_jax_packer():
    """JAX's packer round-trips the same leaves to the same bits (its
    buffer packs them back to back, so only the leaves compare)."""
    batch = _odd_batch(1)
    batch.sequence_id = batch.sequence_id.to(torch.int32)  # JAX runs without 64-bit types here
    names = ["R", "T", "focal_length", "principal_point", "image_rgb", "fg_probability", "mask_crop",
             "depth_map", "sequence_id", "src_image_rgb", "src_fg_probability"]
    tree = {n: x.numpy() for n, x in zip(names, [x for x in _leaves(batch) if x is not None])}
    jp = JBatchPacker()
    jout = jp.unpack(jp.pack(tree))
    tp = BatchPacker()
    tout = tp.unpack(tp.pack(batch))
    for n, x in zip(names, [x for x in _leaves(tout) if x is not None]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(jout[n]), err_msg=n)
    assert tp.nbytes >= jp.nbytes


def test_lazy_spec_and_guards():
    batch = _odd_batch()
    with pytest.raises(ValueError, match="before any pack"):
        BatchPacker().unpack(torch.zeros(8, dtype=torch.uint8))
    eager = BatchPacker(batch)
    assert eager.structure is not None
    lazy = BatchPacker()
    lazy.pack(batch)
    assert lazy.structure == eager.structure and lazy.nbytes == eager.nbytes
    no_src = FrameData(batch.camera, image_rgb=batch.image_rgb)
    with pytest.raises(ValueError, match="structure"):
        lazy.pack(no_src)
    wider = _odd_batch()
    wider.image_rgb = torch.zeros((3, 5, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="leaf changed"):
        lazy.pack(wider)
    retyped = _odd_batch()
    retyped.depth_map = retyped.depth_map.double()
    with pytest.raises(ValueError, match="leaf changed"):
        lazy.pack(retyped)
    # a step-stacked batch is one more structure like any other
    stacked = FrameData.stack_steps([batch, batch])
    sp = BatchPacker()
    _assert_bitwise(sp.unpack(sp.pack(stacked)), stacked)


def test_packed_transfer_is_one_buffer():
    batch = _odd_batch()
    packer = BatchPacker()
    buf = packed_transfer(packer, "cpu")(batch)
    assert isinstance(buf, torch.Tensor) and buf.device.type == "cpu" and buf.dtype == torch.uint8
    _assert_bitwise(packer.unpack(buf), batch)


@pytest.mark.parametrize("compact", [False, True])
def test_packed_step_is_bitwise_the_unpacked_step(compact):
    scene = make_synthetic_scene(n_views=6, image_size=24, device="cpu")
    results = []
    for packed in (False, True):
        model = init_weights(HoloDiffusionModel(**TINY), seed=4)
        batch = SourceCompactor.from_model(model)(scene) if compact else scene
        opt = make_optimizer(model.named_parameters(), lr=1e-3)
        packer = BatchPacker() if packed else None
        step = make_train_step(model, opt, packer=packer)
        state, metrics = step(TrainState.create(model, opt), packer.pack(batch) if packed else batch,
                              torch.Generator().manual_seed(10))
        results.append((model.state_dict(), metrics))
    (sd0, m0), (sd1, m1) = results
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)


def test_packer_under_a_mesh_raises():
    model = HoloDiffusionModel(**TINY)
    opt = make_optimizer(model.named_parameters(), lr=1e-3)
    with pytest.raises(ValueError, match="single-device"):
        make_train_step(model, opt, mesh=object(), packer=BatchPacker())


@pytest.mark.parametrize("extra", [[], ["steps_per_dispatch=2", "compact_sources=true"]])
def test_packed_experiment_is_bitwise_the_unpacked_one(tmp_path, extra):
    runs = []
    for packed in (False, True):
        cfg = tiny_cfg(tmp_path / f"exp{int(packed)}", [*extra, f"packed_transfer={str(packed).lower()}"])
        runs.append(Experiment(cfg, device="cpu").run(max_epochs=1))
    (s0, st0), (s1, st1) = runs
    assert s0.step == s1.step == 2
    sd0, sd1 = s0.model.state_dict(), s1.model.state_dict()
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    assert [e["train"]["objective"] for e in st0.history] == [e["train"]["objective"] for e in st1.history]


def test_packed_transfer_is_ignored_with_whole_dataset_batch(tmp_path, caplog):
    exp = Experiment(tiny_cfg(tmp_path / "exp", ["packed_transfer=true",
                                                 "training_loop_ImplicitronTrainingLoop_args.whole_dataset_batch=true"]),
                     device="cpu")
    with caplog.at_level("WARNING"):
        assert exp._make_packer() is None
    assert "packed_transfer ignored" in caplog.text
    state, _ = exp.run(max_epochs=1)
    assert state.step == 2
