"""Published model configurations (the ported part of the zoo)."""

from repro_torch.configs.registry import get_config, list_archs

__all__ = ["get_config", "list_archs"]
