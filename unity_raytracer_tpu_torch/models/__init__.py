"""Scene models: containers, camera, presets (twin: ``unity_raytracer_tpu/models``)."""
