"""Experiment re-hydration from a trained exp_dir (port of
holo_diffusion_tpu/utils/checkpoint_utils.py; reference
utils/checkpoint_utils.py:23-76): the stored `expconfig.yaml` with
overrides, the Experiment it builds, and its last checkpoint.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

from ..config import apply_dotted_overrides, load_config
from ..device import DeviceLike, resolve_device
from ..experiment import Experiment
from ..parallel.train_step import TrainState
from ..train.checkpoint import restore_checkpoint


def load_experiment(
    exp_dir: str,
    overrides: Optional[List[str]] = None,
    render_size: Optional[Tuple[int, int]] = None,
    use_ema: bool = False,
    device: DeviceLike = None,
) -> Tuple[Experiment, TrainState]:
    """(experiment, restored TrainState) on `device` (CUDA unless "cpu");
    raises FileNotFoundError when `exp_dir` holds no checkpoint.
    `render_size` (height, width) replaces the config's render size.
    `use_ema` copies the EMA of the parameters (trained with ema_rate > 0)
    into the model, so sampling and evaluation go through the averaged
    weights; it raises when the run kept no EMA."""
    device = resolve_device(device)
    cfg = load_config(os.path.join(exp_dir, "expconfig.yaml"))
    cfg["exp_dir"] = exp_dir
    if overrides:
        apply_dotted_overrides(cfg, overrides)
    if render_size is not None:
        m = cfg.setdefault("model_factory_ImplicitronModelFactory_args", {}).setdefault(
            "model_HoloDiffusionModel_args", {})
        m["render_image_height"], m["render_image_width"] = (int(v) for v in render_size)
    exp = Experiment(cfg, device=device)
    restored, _ = restore_checkpoint(exp_dir, exp.init_state())
    if restored is None:
        raise FileNotFoundError(f"no checkpoint found in {exp_dir}")
    if use_ema:
        if restored.ema is None:
            raise ValueError(f"use_ema requested but {exp_dir} was trained without EMA "
                             "(set ema_rate > 0 in the training config)")
        restored.swap_in_ema()
    return exp, restored
