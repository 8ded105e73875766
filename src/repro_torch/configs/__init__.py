from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCHS, get_config, list_archs

__all__ = ["ModelConfig", "ARCHS", "get_config", "list_archs"]
