"""The tiny synthetic experiment of tests/test_experiment.py
(`_tiny_synthetic_cfg`: 2 scenes of 4 views at 16 px, batches of 3, resol
4, C 32, one UNet level, 8 diffusion steps) as dotted overrides on the
port's synthetic_debug.yaml. No JAX here, so the card tests can use it;
tests/test_torch_experiment.py holds it equal to the JAX test's config."""
from holo_diffusion_torch.config import load_config

_SYN = "data_source_ImplicitronDataSource_args.dataset_map_provider_SyntheticDataProvider_args."
_DL = "data_source_ImplicitronDataSource_args.data_loader_map_provider_SequenceDataLoaderMapProvider_args."
MODEL = "model_factory_ImplicitronModelFactory_args.model_HoloDiffusionModel_args."
LOOP = "training_loop_ImplicitronTrainingLoop_args."

TINY_OVERRIDES = [
    _SYN + "n_scenes=2",
    _SYN + "image_size=16",
    _SYN + "n_views_per_scene=4",
    _DL + "batch_size=3",
    _DL + "dataset_length_train=6",
    _DL + "dataset_length_val=3",
    MODEL + "resol=4",
    MODEL + "feature_size=32",
    MODEL + "render_image_width=16",
    MODEL + "render_image_height=16",
    MODEL + "n_train_target_views=1",
    MODEL + "raysampler_AdaptiveRaySampler_args.n_pts_per_ray_training=8",
    MODEL + "raysampler_AdaptiveRaySampler_args.n_rays_per_image_sampled_from_mask=16",
    MODEL + "raysampler_AdaptiveRaySampler_args.n_pts_per_ray_evaluation=8",
    MODEL + "renderer_HoloMultiPassEmissionAbsorptionRenderer_args.n_pts_per_ray_fine_training=4",
    MODEL + "renderer_HoloMultiPassEmissionAbsorptionRenderer_args.n_pts_per_ray_fine_evaluation=4",
    MODEL + "net_3d_SimpleUnet3D_args.channel_mult=[1]",
    MODEL + "net_3d_SimpleUnet3D_args.attention_resolutions=[]",
    MODEL + "diffusion_args.num_steps=8",
    MODEL + "diffusion_args.beta_start_unscaled=8.0e-7",
    MODEL + "diffusion_args.beta_end_unscaled=1.6e-4",
    MODEL + "image_feature_extractor_ResNetFeatureExtractor_args.stages=[1]",
    MODEL + "image_feature_extractor_ResNetFeatureExtractor_args.proj_dim=4",
]


def tiny_cfg(exp_dir, extra=()):
    """The tiny config with its experiment in `exp_dir`, plus `extra`
    overrides."""
    return load_config("synthetic_debug.yaml", [f"exp_dir={exp_dir}", *TINY_OVERRIDES, *extra])
