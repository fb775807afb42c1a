"""The plain reference of the benchmark: HoloDiffusion's training step,
chunked render and DDPM step, written out in float32 PyTorch.

It is a frozen copy of the plain paths the release configurations take
(ResNet34 extractor, the MLPMean and AngleWeighted aggregators, ray
sampling, a trilinear decode written out in full, the emission-absorption
raymarcher, the DDPM step and Adam), and of the voxel-grid denoiser the
configuration's `net_3d_class_type` names: `net3d_<class_type>.py` here
(`net3d_SimpleUnet3D.py`, the 3D UNet), found by `net3d_plugin`. It imports
nothing of the program under test and reads its sizes from the
configuration dict the benchmark holds. Precision is float32 with TF32 off,
unless a caller asks for the control's lower precision
(`precision(tf32=True)`).
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Optional

# the directory that holds reference/ and counts/; tests point it elsewhere
BENCH_DIR = Path(__file__).resolve().parent.parent
# the program's translator's net_3d_class_type when a configuration names none
DEFAULT_NET_3D = "SimpleUnet3D"


def net3d_plugin(part: str, class_type: str, bench_dir: Optional[Path] = None) -> ModuleType:
    """The denoiser's plug-in `<bench_dir>/<part>/net3d_<class_type>.py`,
    loaded by path: `part` "reference" defines `check(args)`,
    `build(feature_size, args)` and `tiny(args)`; "counts" defines
    `forward(spec, batch=1)`. A class type with no file is refused."""
    path = Path(bench_dir or BENCH_DIR) / part / f"net3d_{class_type}.py"
    if not path.is_file():
        raise NotImplementedError(f"no {part} plug-in for net_3d_class_type={class_type!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(f"benchmark_{part}_net3d_{class_type}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
