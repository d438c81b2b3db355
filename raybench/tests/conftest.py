"""Shared helpers of the benchmark's CPU tests: the repository root on the
path, and cells cut to a size the CPU runs in seconds."""

import copy
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ("mesh100k.frame", "cornell_box.tree")
FITS = ("mesh100k.fit_replay", "mesh100k.fit_composed")


def tiny_spec(name: str, width: int = 48, height: int = 32) -> dict:
    """The cell ``name`` with its images at ``width`` x ``height``, its
    icospheres subdivided at most twice, small BVH leaves, 4 orbit
    cameras and at most 512 checked pixels a frame (frame cells)."""
    from raybench import run
    spec = copy.deepcopy(run.cell_spec(name))
    conf = spec["config"]
    conf["width"], conf["height"] = width, height
    for m in conf["scene"].get("meshes", []):
        ico = m["icosphere"]
        ico["subdivisions"] = min(ico["subdivisions"] - 3, 2)
    if "bvh_leaf" in conf["render"]:
        conf["render"]["bvh_leaf"] = 14
    if "cameras" in spec["traffic"]:
        spec["traffic"]["cameras"] = 4
    if spec["cell"]["check"].get("pixels"):
        spec["cell"]["check"]["pixels"] = 512
    return spec


@pytest.fixture(params=CELLS)
def cell_name(request):
    return request.param
