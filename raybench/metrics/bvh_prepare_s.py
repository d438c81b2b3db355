"""Seconds of the host BVH prepare (``ops/bvh.prepare_bvh``) in set-up, on
a host clock between two device synchronisations. Nothing to read where
the configuration builds no BVH."""


def read(ctx):
    return ctx["spans"].get("bvh_prepare_s")
