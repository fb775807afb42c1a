"""PyTorch/CUDA port of HoloDiffusion for one NVIDIA H100.

Mirrors the module paths and public names of `holo_diffusion_tpu` (the JAX
reference, which this package never imports). Public layouts match the
reference: voxel grids are (D, H, W, C), UNet inputs (B, D, H, W, C), rays
(B, N, P, .). Entry points run on CUDA unless the caller passes
`device="cpu"`; see `device.resolve_device`.

Slice 1 covers serving: DDPM/DDIM sampling of a voxel grid and the fly-around
render, whose implicit function is one hand-written CUDA kernel
(`csrc/fused_decode.cu`). Slice 2 covers one training step
(`parallel/train_step.py`): view pooling, the bootstrapped denoise, the
training render and loss, backward through the decode's backward kernel
(`csrc/fused_decode_bwd.cu`), and the optimizer step. Later slices add the
unfused implicit function (`csrc/kron_sample.cu`, `csrc/fused_render.cu`)
and the training loop (`experiment.py`: synthetic data, stats, checkpoints
with resume, `utils/checkpoint_utils.py:load_experiment`, `cli.train_main`).
"""

__version__ = "0.1.0"
