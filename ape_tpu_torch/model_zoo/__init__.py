from .model_zoo import MODELS, build_criterion, build_model, get, get_config, get_config_file

__all__ = ["MODELS", "build_criterion", "build_model", "get", "get_config", "get_config_file"]
