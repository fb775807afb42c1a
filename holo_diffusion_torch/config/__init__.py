from .config import apply_dotted_overrides, load_config, model_args_from_config

__all__ = ["apply_dotted_overrides", "load_config", "model_args_from_config"]
