"""The rank side of tests/test_torch_spatial.py and
tests/test_torch_render_sharded.py: one process of a gloo group on the CPU,
started by `torch.multiprocessing` (spawn) with torchrun's variables set, so
`parallel/launch.py:initialize_distributed` joins the group as under
torchrun. No JAX here: the parent writes the models' weights and inputs into
`work/inputs.pt`, each rank runs the sharded UNets, one sharded `p_sample`
step, the sharded sampling loop and the ray-sharded render, and saves what
it computed into `work/rank<r>.pt`."""
import os

import torch


def run_rank(rank, world, port, work):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from holo_diffusion_torch.models import diffusion as gd
    from holo_diffusion_torch.models.holo_model import HoloDiffusionModel
    from holo_diffusion_torch.models.unet3d import UNetModel3D
    from holo_diffusion_torch.parallel import spatial
    from holo_diffusion_torch.parallel.launch import initialize_distributed
    from holo_diffusion_torch.parallel.mesh import make_mesh
    from holo_diffusion_torch.render_eval import render_image_sharded

    initialize_distributed("cpu")
    mesh = make_mesh("cpu")
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    out = {"rank": rank, "world": world}
    for name in ("jax_test", "hydrant_levels"):
        spec = inputs[name]
        unet = UNetModel3D(**spec["kwargs"]).eval()
        unet.load_state_dict(spec["sd"], strict=True)
        spatial.reset_counts()
        out[name] = spatial.make_sharded_denoiser(unet, mesh)(spec["x"], spec["t"])
        out[name + "_counts"] = dict(spatial.COUNTS)
        sharding = spatial.spatial_sharding(mesh)
        # the slab form the sampling loop runs underneath
        slab = spatial._slab_denoiser(unet, mesh)(sharding.shard(spec["x"]), spec["t"])
        out[name + "_slab"] = slab

    spec = inputs["p_sample"]
    model = HoloDiffusionModel(**spec["kwargs"]).eval()
    model.net_3d.load_state_dict(spec["sd"], strict=True)
    net = spatial.make_sharded_denoiser(model, mesh)
    out["p_sample"] = gd.p_sample(model.schedule, net, spec["x"], spec["t"], noise=spec["noise"])["sample"]
    out["loop"] = spatial.sample_random_voxel_features_sharded(
        model, torch.Generator().manual_seed(spec["loop_seed"]), mesh)

    spec = inputs["render"]
    model = HoloDiffusionModel(**spec["kwargs"]).eval()
    model.load_state_dict(spec["sd"], strict=True)
    out["render"] = render_image_sharded(model, spec["camera"], spec["grid"], mesh)

    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
