"""The plain reference against the port on the CPU, at a tiny size; the
benchmark's scenes against the port's presets; the bfloat16 control
failing the check."""

import numpy as np
import pytest
import torch

from raybench import reference, scene as scn

from conftest import FITS, tiny_spec

CELL_OF = {"mesh100k": "mesh100k.frame", "cornell_box": "cornell_box.tree"}


@pytest.mark.parametrize("name", ["mesh100k", "cornell_box"])
def test_scene_and_camera_are_the_presets(name):
    from unity_raytracer_tpu_torch.models.presets import get_preset
    from unity_raytracer_tpu_torch.utils.config import RenderConfig
    from raybench import run
    from raybench.drivers.frames import _port_scene
    spec = run.cell_spec(CELL_OF[name])
    conf = spec["config"]
    ref_scene, ref_cam, ref_cfg = get_preset(name, device="cpu")
    ours = _port_scene(scn.build(conf), "cpu")
    for part in ("spheres", "triangles", "meshes", "lights"):
        a, b = getattr(ours, part), getattr(ref_scene, part)
        for f in a.__dataclass_fields__:
            x, y = getattr(a, f), getattr(b, f)
            if hasattr(x, "__dataclass_fields__"):
                for g in x.__dataclass_fields__:
                    assert torch.equal(getattr(x, g), getattr(y, g)), (part, f, g)
            else:
                assert torch.equal(x, y), (part, f)
    cam = scn.camera(conf)
    from unity_raytracer_tpu_torch.models.camera import Camera
    ours_cam = Camera.make(position=cam["position"], forward=cam["forward"],
                           up=cam["up"], dist=cam["dist"],
                           half_h=cam["half_h"], half_v=cam["half_v"],
                           width=conf["width"], height=conf["height"],
                           device="cpu")
    for f in ("position", "forward", "right", "up", "dist", "half_h",
              "half_v"):
        assert torch.equal(getattr(ours_cam, f), getattr(ref_cam, f)), f
    rc = dict(conf["render"], background=tuple(conf["render"]["background"]))
    assert RenderConfig(**rc) == ref_cfg.with_(kernel="mega")


def _driver(name, w=48, h=32):
    import importlib
    spec = tiny_spec(name, w, h)
    mod = importlib.import_module(
        f"raybench.drivers.{spec['traffic']['driver']}")
    d = mod.Driver(spec["config"], spec["traffic"], spec["cell"], "cpu")
    d.setup()
    return d


def _within(d, values):
    return all(v <= float(d.cell["check"]["limits"][k])
               for k, v in values.items())


def test_reference_matches_the_port(cell_name):
    d = _driver(cell_name)
    d.start(5)
    win = d.window(5, 0.3)
    s = d.samples(5, win)
    assert s and all(len(x["idx"]) > 0 for x in s)
    values, failed = d.check(s)
    assert failed == 0 and _within(d, values), values


@pytest.mark.parametrize("name", FITS)
def test_fit_reference_follows_the_port(name):
    """The composed fit's first steps, the port's against the plain
    reference's (its own target and Adam) from the same seeded start."""
    d = _driver(name, 40, 24)
    d.start(8)
    win = d.window(8, 0.1)
    values, failed = d.check(d.samples(8, win))
    assert failed == 0, values
    assert values["loss_gap"] < 1e-3 and values["grad_gap"] < 1e-2, values


@pytest.mark.parametrize("name", FITS)
def test_fit_control_and_half_batch_fail(name):
    d = _driver(name, 40, 24)
    for seed in (1, 2, 3):
        d.start(seed)
        s = d.samples(seed, d.window(seed, 0.1))
        for kw in ({"control": True}, {"fault": "half"}):
            values, failed = d.check(s, **kw)
            assert failed > 0, (kw, values)


def test_every_pixel_of_a_frame_matches(cell_name):
    d = _driver(cell_name, 40, 24)
    img = d._frame(d.cams[1]).numpy().reshape(-1, 3)
    idx = np.arange(40 * 24)
    ref = reference.Reference(d.arrays, d.config["render"]["max_bounces"],
                              "cpu")
    want = d._render_ref(ref, d.cam_params[1], idx, torch.float32)
    diff = np.abs(want - img).max(axis=-1)
    # rounding, amplified along a few chaotic paths of the dielectric tree
    # (grazing refractions, phong-300 highlights) on the fused route
    assert np.quantile(diff, 0.99) < 2e-4
    tol = float(d.cell["check"]["pixel_tol"])
    assert 100 * (diff > tol).mean() <= float(d.cell["check"]["limits"]["pixels_off_pct"])


def test_control_fails_the_check(cell_name):
    """The reference in bfloat16, put in the program's place, reads above
    the cell's limit on three seeds."""
    d = _driver(cell_name)
    for seed in (1, 2, 3):
        win = d.window(seed, 0.2)
        values, failed = d.check(d.samples(seed, win), control=True)
        assert failed > 0 and not _within(d, values), values
