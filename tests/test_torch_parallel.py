"""Data-parallel training of the port on the CPU (parallel/launch.py,
mesh.py, collectives.py, train_step.py with a mesh, data/source.py's
`device_batched_loader`, the loop and the sample CLI on 2 ranks), against
the JAX package and single-process runs.

One spawn of 2 gloo ranks serves the whole module (tests/
torch_parallel_worker.py; torchrun's variables set, so the ranks join
through `initialize_distributed`), with a timeout, so a hung collective
fails the test and not the run. The checks:

  * each rank's loader batches bitwise JAX's `device_batched_loader` slice
    for its device index (disjoint, aligned);
  * `replicate` gives every rank rank 0's state;
  * one data-parallel step (loss-aware sampler, EMA; rank 0 takes the
    bootstrap pass, rank 1 does not): the parameters equal one Adam step on
    the mean of the ranks' single-process gradients (relative 1e-6), and
    the ranks' states are bitwise equal; the metrics are the ranks' mean;
    the sampler state is bitwise JAX's `loss_aware_update` on the gathered
    pairs;
  * `steps_per_call` 2 on the mesh equals 2 calls, bitwise;
  * a 2-rank `Experiment.run` of 1 epoch, resumed through the train CLI,
    bitwise a straight 2-epoch run; only rank 0 writes; its checkpoint
    loads in one process;
  * `generate_samples_main` on 2 ranks writes each sample once;
  * `initialize_distributed` is a no-op without torchrun's variables and
    raises on an unreachable store.
"""
import torch_threads  # noqa: F401  (one PyTorch thread a test process)
import datetime
import os
import socket
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(__file__))

import torch_parallel_worker as W  # noqa: E402

from holo_diffusion_torch.parallel import launch  # noqa: E402
from holo_diffusion_torch.utils.checkpoint_utils import load_experiment  # noqa: E402
from holo_diffusion_tpu.data.frame_data import FrameData as JFrameData  # noqa: E402
from holo_diffusion_tpu.data.source import SceneDataset as JSceneDataset  # noqa: E402
from holo_diffusion_tpu.data.source import device_batched_loader as j_device_batched_loader  # noqa: E402
from holo_diffusion_tpu.geometry.cameras import PerspectiveCameras as JCameras  # noqa: E402
from holo_diffusion_tpu.models import diffusion as jgd  # noqa: E402

SPAWN_TIMEOUT_S = 240
REL_TOL = 1e-6


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("ranks"))
    ctx = mp.start_processes(W.run_rank, args=(_free_port(), work), nprocs=W.WORLD, join=False,
                             start_method="spawn")
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=SPAWN_TIMEOUT_S)
    while not ctx.join(timeout=5):
        if datetime.datetime.now() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the 2 ranks did not finish within {SPAWN_TIMEOUT_S} s")
    return work, [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False) for r in range(W.WORLD)]


def test_ranks_joined_through_the_launch(ranks):
    _, out = ranks
    assert [o["rank"] for o in out] == [0, 1] and [o["is_main"] for o in out] == [True, False]


def test_device_batched_loader_is_jax_slice_for_each_rank(ranks):
    _, out = ranks
    scenes = []
    for i in range(3):
        a = W.loader_scene_arrays(i)
        scenes.append(JFrameData(camera=JCameras(*(a[k] for k in ("R", "T", "focal_length", "principal_point"))),
                                 image_rgb=a["image_rgb"], fg_probability=a["fg_probability"],
                                 sequence_id=a["sequence_id"]))
    glob = list(j_device_batched_loader(JSceneDataset(scenes), W.B_LOADER, W.N_BATCHES, W.LOADER_SEED, W.WORLD))
    per_process = [list(j_device_batched_loader(JSceneDataset(scenes), W.B_LOADER, W.N_BATCHES, W.LOADER_SEED,
                                                W.WORLD, process_index=r, process_count=W.WORLD))
                   for r in range(W.WORLD)]
    jkeys = {"R": lambda b: b.camera.R, "T": lambda b: b.camera.T, "focal_length": lambda b: b.camera.focal_length,
             "principal_point": lambda b: b.camera.principal_point, "image_rgb": lambda b: b.image_rgb,
             "fg_probability": lambda b: b.fg_probability, "sequence_id": lambda b: b.sequence_id}
    for r in range(W.WORLD):
        assert len(out[r]["loader"]) == W.N_BATCHES
        for b, got in enumerate(out[r]["loader"]):
            assert set(got) == set(jkeys)
            for k, get in jkeys.items():
                np.testing.assert_array_equal(got[k], np.asarray(get(glob[b]))[r], err_msg=f"rank {r} batch {b} {k}")
                np.testing.assert_array_equal(got[k], np.asarray(get(per_process[r][b]))[0])
    # the ranks draw their own batches (disjoint streams)
    assert any(not np.array_equal(out[0]["loader"][b]["image_rgb"], out[1]["loader"][b]["image_rgb"])
               for b in range(W.N_BATCHES))


def test_replicate_gives_every_rank_rank0s_state(ranks):
    _, out = ranks
    assert out[0]["replicated"] == out[1]["replicated"]
    assert out[0]["replicated"][-1] == 0


def test_data_parallel_step_is_the_mean_gradient_step(ranks):
    _, out = ranks
    want = out[0]["mean_grad_params"]
    for r in range(W.WORLD):
        bad = []
        for n, p in out[r]["dp_params"].items():
            scale = float(want[n].abs().max())
            err = float((p - want[n]).abs().max())
            if err > REL_TOL * max(scale, 1e-30):
                bad.append(f"rank {r} {n}: {err:.3e} of {scale:.3e}")
        assert not bad, "\n".join(bad)
    # the ranks ran different graphs (the bootstrap pass on rank 0 only),
    # and their gradients differ
    g0, g1 = out[0]["single_grads"]
    assert any(not torch.equal(g0[n], g1[n]) for n in g0)
    # the replicated state stays bitwise equal across ranks
    assert all(torch.equal(a, b) for a, b in zip(out[0]["dp_state"], out[1]["dp_state"]))


def test_metrics_are_the_ranks_mean(ranks):
    _, out = ranks
    singles = out[0]["single_metrics"]
    for r in range(W.WORLD):
        for k, v in out[r]["dp_metrics"].items():
            want = (singles[0][k] + singles[1][k]) / 2
            assert abs(v - want) <= REL_TOL * max(abs(want), 1e-30), (r, k, v, want)


def test_sampler_state_is_jax_update_on_the_gathered_pairs(ranks):
    _, out = ranks
    singles = out[0]["single_metrics"]
    ts = np.concatenate([W.rank_draws(r)["timesteps"] for r in range(W.WORLD)])
    losses = np.repeat(np.array([singles[r]["objective"] for r in range(W.WORLD)], np.float32), 2)
    mask = np.array([True, W.rank_draws(0)["take_boot"], True, W.rank_draws(1)["take_boot"]])
    hist = W.warm_history()
    state0 = jgd.LossSecondMomentState(loss_history=jnp.asarray(hist), loss_counts=jnp.full((W.T,), W.H, jnp.int32))
    # each rank credits its own objective, as its metrics held it before the average
    assert all(abs(float(out[0]["dp_sampler"][0][int(t)][-1]) - loss) < 1e-6 for t, loss in zip(ts[:1], losses[:1]))
    want = jgd.loss_aware_update(state0, jnp.asarray(ts), jnp.asarray(losses), mask=jnp.asarray(mask))
    for r in range(W.WORLD):
        got_hist, got_counts = out[r]["dp_sampler"]
        credited = np.nonzero((got_hist.numpy() != hist).any(1))[0].tolist()
        assert credited == sorted({400, 90, 700})  # rank 1's bootstrap timestep is not credited
        np.testing.assert_array_equal(got_hist.numpy(), np.asarray(want.loss_history))
        np.testing.assert_array_equal(got_counts.numpy(), np.asarray(want.loss_counts))


def test_two_steps_per_call_on_the_mesh_equal_two_calls(ranks):
    _, out = ranks
    assert out[0]["k2_equals_2_calls"] and out[1]["k2_equals_2_calls"]


def test_two_rank_loop_resumes_writes_once_and_loads_in_one_process(ranks):
    work, out = ranks
    # tiny: 2 batches an epoch, split over 2 ranks -> 1 step an epoch
    assert [o["epoch0_step"] for o in out] == [1, 1] and [o["resumed_step"] for o in out] == [2, 2]
    for r in range(W.WORLD):
        for n, p in out[r]["resumed"].items():
            assert torch.equal(p, out[0]["straight"][n]), (r, n)
    assert out[0]["writes"]["save_checkpoint"] == 4 and out[0]["writes"]["dump_expconfig"] == 3
    assert out[1]["writes"] == {}
    assert [e["epoch"] for e in out[0]["resumed_history"]] == [0, 1]
    exp, state = load_experiment(os.path.join(work, "exp"), device="cpu")
    for n, p in state.model.named_parameters():
        assert torch.equal(p, out[0]["resumed"][n]), n


def test_samples_are_written_once_across_ranks(ranks):
    work, out = ranks
    assert out[0]["samples"] == ["sample_00000", "sample_00002"] and out[1]["samples"] == ["sample_00001"]
    assert sorted(os.listdir(os.path.join(work, "samples"))) == ["sample_00000", "sample_00001", "sample_00002"]


def test_initialize_distributed_is_a_noop_without_torchrun(monkeypatch):
    for k in launch.ENV_VARS:
        monkeypatch.delenv(k, raising=False)
    assert launch.initialize_distributed("cpu") is False and not launch.is_initialized()
    assert (launch.rank(), launch.world_size(), launch.is_main_process()) == (0, 1, True)
    launch.barrier()  # nothing to wait for
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="incomplete launch environment"):
        launch.initialize_distributed("cpu")


def test_initialize_distributed_raises_on_an_unreachable_store(monkeypatch):
    """No rank 0 listens at the address: joining raises (JAX warns and goes
    on single-process; the port does not)."""
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    with pytest.raises(RuntimeError):
        launch.initialize_distributed("cpu", timeout=datetime.timedelta(seconds=2))
    assert not launch.is_initialized()
