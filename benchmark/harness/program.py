"""What the benchmark takes from the program (`holo_diffusion_torch`): the
model built from the configuration dict, with the benchmark's weights. The
program is imported here, inside functions, and nowhere in the reference."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..reference.model import Model
from ..reference.spec import Spec
from .weights import make_state_dict, shapes_of


@dataclasses.dataclass
class Context:
    """One run's inputs: the configuration file (`cfg`, the program's
    configuration dict, beside the benchmark's own keys), the traffic
    mix, the cell's limits, the seed and the device."""

    config: Dict
    mix: Dict
    limits: Dict
    seed: int
    device: torch.device
    # keyword arguments of the program's model beyond the configuration's
    # (calibration's second witnesses, e.g. fuse_decode="off"); none in a run
    program_args: Dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.cfg = self.config["program_config"]
        self.spec = Spec.from_config(self.cfg)
        with torch.device("meta"):
            self.shapes = shapes_of(Model(self.spec))

    def weights(self) -> Dict[str, torch.Tensor]:
        return make_state_dict(self.shapes, self.seed, self.device)

    def reference(self) -> Model:
        """The reference model on the device with this run's weights."""
        with torch.device(self.device):
            ref = Model(self.spec)
        ref.load_state_dict(self.weights())
        return ref


def program_model(ctx: Context, sd: Dict[str, torch.Tensor]):
    """The program's model for the configuration, built on the device,
    loaded strictly with `sd`; float32 with TF32 off, as the
    configuration states."""
    from holo_diffusion_torch.config import model_args_from_config
    from holo_diffusion_torch.device import set_full_precision
    from holo_diffusion_torch.models.holo_model import HoloDiffusionModel

    set_full_precision()
    with torch.device(ctx.device):
        model = HoloDiffusionModel(**{**model_args_from_config(ctx.cfg), **ctx.program_args})
    model.load_state_dict(sd, strict=True)
    return model


def free_cuda() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
