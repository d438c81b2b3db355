"""Count the FP32 operations of one frame of a configuration on the port's
counting instance, to freeze as the configuration's
``yardstick.frame_fp32_ops`` (run once, on the card):

    python3 -m raybench.tools.count_ops mesh100k

The frame is the configuration's own camera (not an orbit camera), traced
through the fused segment kernel's counting instance with the port's
``utils/profiling.capture_segments`` and ``segment_work`` (its tests
times ``OPS_PER_TEST``). The orbit's end cameras are counted too, to show
how far the yardstick is from the frames the window renders. Prints one
JSON line.
"""

from __future__ import annotations

import json
import sys


def main(name: str) -> dict:
    from raybench import run, scene as scn, traffic as trf
    from raybench.drivers.frames import _port_scene
    from unity_raytracer_tpu_torch.models.camera import Camera
    from unity_raytracer_tpu_torch.ops import bvh as bvhmod
    from unity_raytracer_tpu_torch.ops.kernels import mega
    from unity_raytracer_tpu_torch.ops.render import (
        _segment_kw, render_frame, resolve_mode)
    from unity_raytracer_tpu_torch.utils.config import RenderConfig
    from unity_raytracer_tpu_torch.utils.profiling import (
        capture_segments, nvidia_smi, segment_work)

    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    entry = [c for c in bench["configs"] if c["name"] == name][0]
    conf = run.load_json(run.ROOT / entry["file"])
    traffic = run.load_json(run.HERE / "traffic" / "orbit.json")
    dep = scn.build(conf)
    scene = _port_scene(dep, "cuda")
    rc = dict(conf["render"], background=tuple(conf["render"]["background"]))
    cfg = resolve_mode(scene, RenderConfig(**rc))
    bvh = bvhmod.prepare_bvh(scene, cfg, "cuda")
    route = mega.segment_route(bvh, cfg.tri_isect, cfg.bvh_arity != 0)
    aux = mega.build_aux(scene, cfg.background)
    base = scn.camera(conf)
    orbit = trf.orbit_cameras(traffic, conf, base)
    out = {}
    for label, p in (("preset", base), ("orbit_first", orbit[0]),
                     ("orbit_last", orbit[-1])):
        cam = Camera.make(position=p["position"], forward=p["forward"],
                          up=p["up"], dist=p["dist"], half_h=p["half_h"],
                          half_v=p["half_v"], width=conf["width"],
                          height=conf["height"], device="cuda")
        segs = capture_segments(lambda: render_frame(scene, cam, cfg,
                                                     bvh=bvh))
        _, ops = segment_work(bvh, aux, _segment_kw(scene, cfg), segs, 52,
                              route)
        out[label] = ops
    out["device"] = nvidia_smi("name,power.limit")
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1])))
