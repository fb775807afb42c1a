"""Turn a reference HoloDiffusion `.pth` checkpoint into a checkpoint of the
port (counterpart of scripts/import_reference_checkpoint.py), so
`generate_samples_main exp_dir=...`, `visualize_reconstruction_main` and
resumed training run on reference-trained weights:

    python -m holo_diffusion_torch.import_reference_checkpoint \\
        --pth model_epoch_00000350.pth --config-name hydrant.yaml \\
        --exp-dir ./experiments/imported_hydrant [--epoch 350] [--device cpu] [key=value ...]

(installed as `holo-torch-import-reference-checkpoint`). The file holds
`{"model": state_dict, ...}` (Implicitron's `safe_save_model`) or a bare
state_dict, read with `torch.load(..., weights_only=True)`. Its keys go
through `weights.state_dict_from_reference` and must match the model the
config builds, else KeyError naming every missing and unexpected key. The
checkpoint of epoch `--epoch` and `expconfig.yaml` are written into
`--exp-dir`, which `utils/checkpoint_utils.py:load_experiment` then serves.
The model is built on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch

from .config import dump_expconfig, load_config
from .device import DeviceLike
from .experiment import Experiment
from .train.checkpoint import CHECKPOINT_FILE, checkpoint_dir, save_checkpoint
from .weights import load_strict, state_dict_from_reference


def import_reference_checkpoint(pth: str, exp_dir: str, config_name: str = "hydrant.yaml",
                                overrides: Optional[List[str]] = None, config_dir: Optional[str] = None,
                                epoch: int = 0, device: DeviceLike = None) -> str:
    """Write the port's checkpoint of the reference weights in `pth` into
    `exp_dir` as epoch `epoch`; returns its directory."""
    cfg = load_config(config_name, overrides, config_dir)
    cfg["exp_dir"] = exp_dir
    exp = Experiment(cfg, device=device)
    state = exp.init_state()
    blob = torch.load(pth, map_location="cpu", weights_only=True)
    sd = blob["model"] if isinstance(blob, dict) and isinstance(blob.get("model"), dict) else blob
    load_strict(state.model, state_dict_from_reference(sd), what=f"{pth} (through state_dict_from_reference)")
    dump_expconfig(cfg, exp_dir)
    save_checkpoint(exp_dir, epoch, state, purge=0)
    out = checkpoint_dir(exp_dir, epoch)
    # save_checkpoint logs an IO error and goes on; here it is the result
    if not os.path.isfile(os.path.join(out, CHECKPOINT_FILE)):
        raise OSError(f"no checkpoint was written into {out}")
    return out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pth", required=True, help="the reference checkpoint")
    ap.add_argument("--config-name", default="hydrant.yaml")
    ap.add_argument("--config-dir", default=None)
    ap.add_argument("--exp-dir", required=True)
    ap.add_argument("--epoch", type=int, default=0)
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("overrides", nargs="*", help="dotted key=value config overrides")
    args = ap.parse_args(argv)
    out = import_reference_checkpoint(args.pth, args.exp_dir, args.config_name, args.overrides,
                                      args.config_dir, args.epoch, args.device)
    print(f"imported {args.pth} -> {out}")


if __name__ == "__main__":
    main()
