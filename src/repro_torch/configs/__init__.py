from repro_torch.configs.base import ModelConfig, get_config, list_configs, register

__all__ = ["ModelConfig", "get_config", "list_configs", "register"]
