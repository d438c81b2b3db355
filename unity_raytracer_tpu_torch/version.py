"""The port's version (twin: ``unity_raytracer_tpu/version.py``)."""

__version__ = "0.1.0"
