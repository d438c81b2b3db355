"""Utilities: configs, image IO, lane swizzle (twin: ``unity_raytracer_tpu/utils``)."""

from unity_raytracer_tpu_torch.utils.config import DiffConfig, RenderConfig

__all__ = ["RenderConfig", "DiffConfig"]
