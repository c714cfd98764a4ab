"""Published model configurations of the whole zoo."""

from repro_torch.configs.registry import get_config, list_archs

__all__ = ["get_config", "list_archs"]
