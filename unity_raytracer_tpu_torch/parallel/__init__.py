"""Multi-device parallelism on ``torch.distributed``: meshes, collectives, sharded renderers (twin: ``unity_raytracer_tpu/parallel``)."""
