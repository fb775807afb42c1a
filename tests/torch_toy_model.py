"""The golden toy model of the port's training tests, importable without
JAX (the card tests use it too)."""

# the toy model of tests/test_holo_forward_parity.py::_model in the port's terms
TOY = dict(
    resol=8, volume_extent=3.0, feature_size=8, num_passes=2,
    net_3d_args=dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=(2,),
                     num_heads=2, use_scale_shift_norm=True, homogeneous_resample=True),
    enable_bootstrap=True, bootstrap_prob=0.5, render_image_height=16, render_image_width=16,
    n_train_target_views=2, n_pts_per_ray_training=8, n_pts_per_ray_evaluation=8, n_rays_per_image=64,
    n_pts_per_ray_fine_training=4, n_pts_per_ray_fine_evaluation=4,
    stratified_point_sampling_training=False, density_noise_std_train=0.0, scene_extent=1.5,
    image_feature_extractor_args=dict(name_arch="resnet18", stages=(1,), proj_dim=4, image_rescale=0.5,
                                      first_max_pool=True, l2_norm=True, add_masks=True, add_images=True,
                                      normalize_image=True),
    view_pooler_args=dict(aggregator_class_type="MLPMeanFeatureAggregator",
                          aggregator_args=dict(n_hidden=16, dim_out=12, n_layers=1, n_harmonic_functions_ray=3)),
    render_mlp_args=dict(dir_emb_dims=4, dnet_num_layers=4, dnet_hidden_dim=16, dnet_input_skips=(2,),
                         rnet_num_layers=1, rnet_hidden_dim=16),
)
