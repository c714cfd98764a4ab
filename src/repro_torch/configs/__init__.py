"""Published model configurations of the whole zoo."""

from repro_torch.configs.registry import applicable_shapes, get_config, get_shape, input_specs, list_archs, list_shapes

__all__ = ["get_config", "list_archs", "get_shape", "list_shapes", "input_specs", "applicable_shapes"]
