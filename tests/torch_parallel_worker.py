"""The rank side of tests/test_torch_parallel.py: one process of a 2-rank
gloo group on the CPU, started by `torch.multiprocessing` (spawn) with
torchrun's variables set, so `parallel/launch.py:initialize_distributed`
joins the group as under torchrun. No JAX here: each rank saves what it saw
into `out_dir/rank<r>.pt`, and the test holds that against the JAX
package and against single-process runs."""
import copy
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))

from torch_tiny_config import TINY_OVERRIDES, tiny_cfg  # noqa: E402
from torch_toy_model import TOY  # noqa: E402

WORLD = 2
T, H = 1000, 10
B_LOADER, N_BATCHES, LOADER_SEED = 4, 3, 5
LR = 1e-3


def loader_scene_arrays(i):
    """Scene i of the loader check: 5 + i frames of numpy data, shared by
    the port's and JAX's datasets."""
    rs = np.random.RandomState(100 + i)
    n = 5 + i
    return dict(image_rgb=rs.randint(0, 256, (n, 6, 6, 3), dtype=np.uint8),
                fg_probability=rs.rand(n, 6, 6, 1).astype(np.float32),
                sequence_id=np.full((n,), i, np.int32),
                R=rs.randn(n, 3, 3).astype(np.float32), T=rs.randn(n, 3).astype(np.float32),
                focal_length=rs.rand(n, 2).astype(np.float32), principal_point=rs.rand(n, 2).astype(np.float32))


def warm_history():
    rs = np.random.RandomState(21)
    return (rs.rand(T, H) * np.linspace(0.2, 2.0, T)[:, None]).astype(np.float32)


def rank_draws(r, k=0):
    """Rank r's draws for step k of the toy model: rank 0 takes the
    bootstrap pass and rank 1 does not, so the ranks run different graphs."""
    rs = np.random.RandomState(1000 + 10 * r + k)
    return {"timesteps": np.array([[400, 90], [700, 5]][r]) + k, "take_boot": r == 0,
            "noise": rs.randn(1, 8, 8, 8, 8), "noise2": rs.randn(1, 8, 8, 8, 8), "ray_pixel_u": rs.rand(2, 64)}


def rank_batch(r):
    from holo_diffusion_torch.data.synthetic import make_synthetic_scene

    return make_synthetic_scene(n_views=5, image_size=16, seed=r, device="cpu")


def toy_state(loss_aware=True):
    from holo_diffusion_torch.models import diffusion as gd
    from holo_diffusion_torch.models.holo_model import HoloDiffusionModel
    from holo_diffusion_torch.parallel.train_step import TrainState
    from holo_diffusion_torch.train.optimizer import make_optimizer
    from holo_diffusion_torch.weights import init_weights

    model = init_weights(HoloDiffusionModel(**TOY), seed=3)
    opt = make_optimizer(model.named_parameters(), lr=LR)
    sampler = gd.LossSecondMomentState(torch.from_numpy(warm_history()), torch.full((T,), H, dtype=torch.int64))
    return TrainState.create(model, opt, sampler_state=sampler if loss_aware else None, ema=True)


def _numpy_batch(b):
    import dataclasses

    out = {k: getattr(b.camera, k).numpy() for k in ("R", "T", "focal_length", "principal_point")}
    out.update({f.name: getattr(b, f.name).numpy() for f in dataclasses.fields(b)[1:]
                if getattr(b, f.name) is not None})
    return out


def _state_tensors(state):
    from holo_diffusion_torch.parallel.mesh import _state_tensors as tensors

    return [t.detach().clone() for t in tensors(state)]


def _counting(module, names, counts):
    """Replace module.<name> by a wrapper that counts its calls."""
    for name in names:
        fn = getattr(module, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **kw)

        setattr(module, name, wrapped)


def run_rank(rank, port, work_dir):
    torch.set_num_threads(2)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    import holo_diffusion_torch.experiment as texp
    from holo_diffusion_torch import cli
    from holo_diffusion_torch.data.frame_data import FrameData
    from holo_diffusion_torch.data.source import SceneDataset, device_batched_loader
    from holo_diffusion_torch.geometry.cameras import PerspectiveCameras
    from holo_diffusion_torch.parallel import launch
    from holo_diffusion_torch.parallel.mesh import make_mesh, replicate
    from holo_diffusion_torch.parallel.train_step import make_train_step

    assert launch.initialize_distributed("cpu") and launch.world_size() == WORLD and launch.rank() == rank
    mesh = make_mesh("cpu")
    out = {"rank": rank, "is_main": launch.is_main_process()}

    # ---- device_batched_loader: this rank's slice
    scenes = []
    for i in range(3):
        a = loader_scene_arrays(i)
        scenes.append(FrameData(PerspectiveCameras(*(torch.from_numpy(a[k]) for k in
                                                     ("R", "T", "focal_length", "principal_point"))),
                                image_rgb=torch.from_numpy(a["image_rgb"]),
                                fg_probability=torch.from_numpy(a["fg_probability"]),
                                sequence_id=torch.from_numpy(a["sequence_id"])))
    out["loader"] = [_numpy_batch(b) for b in device_batched_loader(
        SceneDataset(scenes), B_LOADER, N_BATCHES, LOADER_SEED, WORLD, process_index=rank, process_count=WORLD)]

    # ---- replicate: a rank whose weights differ gets rank 0's
    state = toy_state()
    if rank == 1:
        with torch.no_grad():
            next(state.model.parameters()).add_(1.0)
        state.step = 7
    replicate(state, mesh)
    out["replicated"] = [t.sum().item() for t in _state_tensors(state)[:3]] + [state.step]

    # ---- one data-parallel step (loss-aware sampler, EMA) on each rank's batch
    state = toy_state()
    step = make_train_step(state.model, state.optimizer, schedule_sampler="loss-second-moment", ema_rate=0.9,
                           mesh=mesh)
    state, metrics = step(state, rank_batch(rank), rank_draws(rank))
    out["dp_params"] = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    out["dp_metrics"] = {k: float(v) for k, v in metrics.items()}
    out["dp_sampler"] = (state.sampler_state.loss_history.clone(), state.sampler_state.loss_counts.clone())
    out["dp_state"] = _state_tensors(state)

    # ---- the single-process pieces of that step, on rank 0: each rank's
    # gradient and metrics through the plain step with the update held back
    if rank == 0:
        singles = []
        for r in range(WORLD):
            s = toy_state()
            s.optimizer.optimizer.step = lambda *a, **k: None
            plain = make_train_step(s.model, s.optimizer, schedule_sampler="loss-second-moment", ema_rate=0.0)
            _, m = plain(s, rank_batch(r), rank_draws(r))
            singles.append(({n: p.grad.clone() for n, p in s.model.named_parameters()},
                            {k: float(v) for k, v in m.items()}))
        out["single_grads"] = [g for g, _ in singles]
        out["single_metrics"] = [m for _, m in singles]
        # one Adam step of a fresh state on the mean of the two gradients
        ref = toy_state()
        for n, p in ref.model.named_parameters():
            p.grad = (singles[0][0][n] + singles[1][0][n]) / WORLD
        ref.optimizer.step()
        out["mean_grad_params"] = {n: p.detach().clone() for n, p in ref.model.named_parameters()}

    # ---- K = 2 steps in one call on the mesh against 2 calls
    batches = [rank_batch(rank), rank_batch(rank)[torch.arange(4, -1, -1)]]
    draws = [rank_draws(rank, 0), rank_draws(rank, 1)]
    finals = []
    for k in (2, 1):
        state = toy_state()
        step = make_train_step(state.model, state.optimizer, schedule_sampler="loss-second-moment", ema_rate=0.9,
                               steps_per_call=k, mesh=mesh)
        if k == 2:
            state, m = step(state, FrameData.stack_steps(batches), draws)
        else:
            for b, d in zip(batches, draws):
                state, m = step(state, b, d)
        finals.append(_state_tensors(state))
    out["k2_equals_2_calls"] = all(torch.equal(a, b) for a, b in zip(*finals))

    # ---- the loop: 1 epoch, a resume through the train CLI, a straight run
    counts = {}
    _counting(texp, ("save_checkpoint", "dump_expconfig", "plot_stats_pdf", "write_dashboard_html"), counts)
    exp_dir = os.path.join(work_dir, "exp")
    loop_args = ["disable_validation=false", "training_loop_ImplicitronTrainingLoop_args.visualize_interval=0"]
    s1, _ = texp.Experiment(tiny_cfg(exp_dir, loop_args), device="cpu").run(max_epochs=1)
    out["epoch0_step"] = s1.step
    s2, stats2 = cli.train_main(["--config-name", "synthetic_debug.yaml", "--device", "cpu", "--max-epochs", "2",
                                 f"exp_dir={exp_dir}", *TINY_OVERRIDES, *loop_args])
    out["resumed_step"] = s2.step
    out["resumed"] = {n: p.detach().clone() for n, p in s2.model.named_parameters()}
    out["resumed_history"] = stats2.history
    s3, _ = texp.Experiment(tiny_cfg(os.path.join(work_dir, "straight"), loop_args), device="cpu").run(max_epochs=2)
    out["straight"] = {n: p.detach().clone() for n, p in s3.model.named_parameters()}
    out["writes"] = counts

    # ---- sampling: each rank its share
    samples = cli.generate_samples_main([f"exp_dir={exp_dir}", "num_samples=3", "n_flyaround_poses=1",
                                         "render_size=[8,8]", "max_iter=2", "device=cpu",
                                         f"output_directory={os.path.join(work_dir, 'samples')}"])
    out["samples"] = sorted(samples)

    launch.barrier()
    torch.save(out, os.path.join(work_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
