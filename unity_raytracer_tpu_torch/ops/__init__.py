"""Compute ops: BVH host side and the renderer (twin: ``unity_raytracer_tpu/ops``)."""
