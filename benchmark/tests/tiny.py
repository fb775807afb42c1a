"""A tiny copy of the benchmark for CPU tests: the same cells, mixes,
limits and metric readers, with configurations cut to narrow widths, few
frames, rays and points, so one run takes seconds on the CPU."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from benchmark.harness.manifest import ROOT
from benchmark.reference import DEFAULT_NET_3D, net3d_plugin

BENCH = ROOT / "benchmark"


def tiny_program_config(cfg: dict, n_targets: int) -> dict:
    cfg = copy.deepcopy(cfg)
    m = cfg["model_factory_ImplicitronModelFactory_args"]["model_HoloDiffusionModel_args"]
    m.update(resol=8, feature_size=32, render_image_width=16, render_image_height=16, chunk_size_grid=320,
             n_train_target_views=n_targets)
    net_3d = m.get("net_3d_class_type", DEFAULT_NET_3D)
    m[f"net_3d_{net_3d}_args"] = net3d_plugin("reference", net_3d).tiny(m[f"net_3d_{net_3d}_args"])
    m["raysampler_AdaptiveRaySampler_args"].update(n_pts_per_ray_training=8, n_pts_per_ray_evaluation=8,
                                                   n_rays_per_image_sampled_from_mask=32)
    m["renderer_HoloMultiPassEmissionAbsorptionRenderer_args"].update(n_pts_per_ray_fine_training=8,
                                                                      n_pts_per_ray_fine_evaluation=8)
    m["image_feature_extractor_ResNetFeatureExtractor_args"].update(proj_dim=4, image_rescale=0.5)
    agg = m["view_pooler_args"]["feature_aggregator_class_type"]
    if agg == "MLPMeanFeatureAggregator":
        m["view_pooler_args"]["feature_aggregator_MLPMeanFeatureAggregator_args"].update(n_hidden=16, dim_out=16)
    m["implicit_function_HoloVoxelGridImplicitFunction_args"]["render_mlp_args"].update(dnet_hidden_dim=32)
    d = cfg["data_source_ImplicitronDataSource_args"]
    d["data_loader_map_provider_SequenceDataLoaderMapProvider_args"]["batch_size"] = 5
    d["dataset_map_provider_JsonIndexDatasetMapProviderV2_args"]["dataset_JsonIndexDataset_args"].update(
        image_height=32, image_width=32)
    return cfg


TINY_MIXES = {
    "train": {"pool_batches": 3},
    "frames": {"poses": 4, "check_frames": 2},
    "sample": {"start_steps": 2, "check_steps": 3, "trace_units": 4},
}


def make_tiny_root(tmp: Path) -> Path:
    """A checkout-like root under `tmp` with BENCHMARK.json and a tiny
    benchmark/ (configs, mixes, limits, metrics)."""
    root = Path(tmp)
    bench = root / "benchmark"
    for sub in ("limits", "metrics"):
        shutil.copytree(BENCH / sub, bench / sub)
    (bench / "configs").mkdir(parents=True)
    (bench / "mixes").mkdir()
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for c in manifest["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        conf["program_config"] = tiny_program_config(conf["program_config"], 2 if c["name"] == "hydrant" else 3)
        conf["data"] = {"frames": 5, "image_size": 32}
        (root / c["file"]).write_text(json.dumps(conf))
    for path in (BENCH / "mixes").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(TINY_MIXES.get(path.stem, {}))
        (bench / "mixes" / path.name).write_text(json.dumps(mix))
    return root
