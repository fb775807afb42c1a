from .config import (
    apply_dotted_overrides,
    audit_unconsumed_keys,
    data_source_args_from_config,
    dump_expconfig,
    extractor_weights_path,
    load_config,
    model_args_from_config,
    optimizer_args_from_config,
    training_loop_args_from_config,
)

__all__ = [
    "apply_dotted_overrides",
    "audit_unconsumed_keys",
    "data_source_args_from_config",
    "dump_expconfig",
    "extractor_weights_path",
    "load_config",
    "model_args_from_config",
    "optimizer_args_from_config",
    "training_loop_args_from_config",
]
