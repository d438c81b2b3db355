"""Hand-written Hopper kernels, their wrappers and plain versions, and the
host packers that lay out their inputs (twin: ``unity_raytracer_tpu/ops/pallas``)."""
