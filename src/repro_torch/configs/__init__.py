from .base import SHAPES, ModelConfig, ShapeSpec, get_config, list_archs, shape_for

__all__ = ["SHAPES", "ModelConfig", "ShapeSpec", "get_config", "list_archs", "shape_for"]
