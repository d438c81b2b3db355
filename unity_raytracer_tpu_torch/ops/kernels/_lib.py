"""Build and load the port's native libraries from the sources in the checkout.

No JAX twin: the JAX package loads the tracked ``native/libbvh.so`` (built
with ``-march=native``) and rebuilds it in place when it is missing
(``unity_raytracer_tpu/ops/bvh.py:54-90``). The port never loads or
rewrites that file. At first use it compiles, into ``build/torch_kernels/``
(listed in ``.gitignore``):

* ``libbvh-<key>.so`` from ``native/bvh_builder.cc`` with
  ``g++ -O3 -fPIC -shared -std=c++17`` — plus ``-mfma`` on x86-64, so that
  the SAH cost sums contract to FMAs exactly as in the tracked library and
  the port builds the same trees as the JAX package (no ``-march=native``:
  the library must load on any host of its architecture);
* ``libmega_wide4-<key>.so``, ``libmega_wide8-<key>.so`` and
  ``libmega_binary-<key>.so`` from ``csrc/mega_segment.cu`` (the fused
  segment kernel; ``-DURT_MEGA_GROUP`` picks each library's instances:
  the BVH4 rows, the BVH8 rows, or the binary nodes and the meshless
  fork), ``libtraverse-<key>.so`` from ``csrc/traverse.cu`` (the BVH
  walks) and ``libnearest_tri-<key>.so`` from ``csrc/nearest_tri.cu``
  (the brute-force nearest triangle), ``libprobes-<key>.so`` from
  ``csrc/probes.cu`` (the dispatch-cost and FP32-rate probes of
  ``utils/probes.py``) and ``librefit-<key>.so`` from ``csrc/refit.cu``
  (the Baldwin–Weber records of ``ops/bvh.refit``), each with ``nvcc -gencode
  arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false -shared
  -Xcompiler -fPIC`` (plain C entry points, bound with ctypes). The two
  walk sources share ``csrc/bvh_walk.cuh``.
  ``-fmad=false`` keeps every multiply and add separately rounded, as the
  plain PyTorch versions round them: with contraction on, grazing hits on
  the mirror sphere moved by up to 1e-2 on the 0-255 scale (7 of 65,536
  lanes of a mesh10k frame, just over the 0.01% the smoke run allows);
  with it off the kernel matched the plain version exactly on every lane
  checked (PERF.md).

``<key>`` hashes the source, the shared headers and the command line,
so an edited source builds anew and concurrent builders never share a half-written file. A
failed build or load raises; nothing falls back. ``build_all`` builds
every library at once, one compiler process per library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import shutil
import subprocess
import threading
import time

REPO = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO / "build" / "torch_kernels"
BVH_SRC = REPO / "native" / "bvh_builder.cc"
CSRC = REPO / "unity_raytracer_tpu_torch" / "csrc"
MEGA_SRC = CSRC / "mega_segment.cu"
# the fused kernel's libraries: -DURT_MEGA_GROUP of each
MEGA_GROUPS = {"wide4": 4, "wide8": 8, "binary": 0}
TRAVERSE_SRC = CSRC / "traverse.cu"
NEAREST_TRI_SRC = CSRC / "nearest_tri.cu"
PROBES_SRC = CSRC / "probes.cu"
REFIT_SRC = CSRC / "refit.cu"

_libs: dict = {}  # the loaded library handles
_locks = {name: threading.Lock()
          for name in ("bvh", "traverse", "nearest_tri", "probes", "refit",
                       *(f"mega_{g}" for g in MEGA_GROUPS))}


def _build(name: str, src: pathlib.Path, cmd_for) -> ctypes.CDLL:
    """Compile ``src`` with ``cmd_for(out_path)`` unless a library with the
    same key exists, then load it. The handle's ``build`` attribute records
    the path, the compile seconds (0.0 when an earlier build was reused)
    and the compiler's output."""
    key_cmd = cmd_for(pathlib.Path("OUT"))
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src.read_bytes() + headers
                         + "\0".join(key_cmd).encode())
    out = BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd_for(tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {out.name} failed ({' '.join(cmd_for(tmp))}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        seconds, log = time.perf_counter() - t0, proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(out))
    lib.build = {"path": str(out), "seconds": seconds, "log": log}
    return lib


def _which(tool: str, *fallbacks: str) -> str:
    path = shutil.which(tool)
    for f in fallbacks:
        if path is None and os.path.exists(f):
            path = f
    if path is None:
        raise RuntimeError(f"{tool} not found on PATH")
    return path


def bvh_lib() -> ctypes.CDLL:
    """The SAH BVH builder (``urt_build_bvh_ex``)."""
    with _locks["bvh"]:
        if "bvh" not in _libs:
            cxx = _which("g++")
            arch = ["-mfma"] if platform.machine() in ("x86_64", "AMD64") \
                else []
            lib = _build("bvh", BVH_SRC, lambda out: [
                cxx, "-O3", "-fPIC", "-shared", "-std=c++17", *arch,
                "-o", str(out), str(BVH_SRC)])
            p = ctypes.c_void_p
            i = ctypes.c_int
            lib.urt_build_bvh_ex.restype = i
            lib.urt_build_bvh_ex.argtypes = [p, i, i, i, i, p, p, p, p, p, p]
            _libs["bvh"] = lib
        return _libs["bvh"]


def nvcc_cmd(src: pathlib.Path, out: pathlib.Path, *defines: str) -> list:
    """The command that builds a CUDA source's library (``defines``:
    extra ``-D`` flags)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = _which("nvcc", os.path.join(cuda_home, "bin", "nvcc"))
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", *(f"-D{x}" for x in defines), "-o", str(out),
            str(src)]


def mega_lib(group: str) -> ctypes.CDLL:
    """The fused segment kernel's library of one layout group (a key of
    ``MEGA_GROUPS``): ``urt_mega_segment``, every mode of its instances."""
    name = f"mega_{group}"
    with _locks[name]:
        if name not in _libs:
            flag = f"URT_MEGA_GROUP={MEGA_GROUPS[group]}"
            lib = _build(name, MEGA_SRC,
                         lambda out: nvcc_cmd(MEGA_SRC, out, flag))
            p = ctypes.c_void_p
            i = ctypes.c_int
            f = ctypes.c_float
            lib.urt_mega_segment.restype = i
            lib.urt_mega_segment.argtypes = [
                p, p, p, p, i, i,          # o d thr tmax n depth
                p, i, i,                   # table layout mt
                p, p, i, i,                # leaf leafbox leaf_rows bw_rows
                p, i,                      # leafmeta meta_w
                p, i, i, i, i, i, f,       # aux L S T M max_bounces cull
                p, p, p, p, p,             # delta o2 d2 thr2 tmax2
                p, i,                      # overflow mode
                p, p, p, p, p,             # records: t n matid occbits st
                p, p, p, p,                # refract child: o d w tmax
                p, p]                      # counts stream
            _libs[name] = lib
        return _libs[name]


def traverse_lib() -> ctypes.CDLL:
    """The BVH walks (``urt_traverse``: mk3, mk4, wide 4/8; nearest and
    any-hit)."""
    with _locks["traverse"]:
        if "traverse" not in _libs:
            lib = _build("traverse", TRAVERSE_SRC,
                         lambda out: nvcc_cmd(TRAVERSE_SRC, out))
            p = ctypes.c_void_p
            i = ctypes.c_int
            lib.urt_traverse.restype = i
            lib.urt_traverse.argtypes = [
                p, p, p, i,                # o d tmax n
                i, i, p, p, p, i,          # layout any_hit table tris
                                           # leafbox rows
                p, p, p, p, p,             # t slot leaf overflow counts
                p, p, p]                   # seen_rows seen_slots stream
            _libs["traverse"] = lib
        return _libs["traverse"]


def nearest_tri_lib() -> ctypes.CDLL:
    """The brute-force nearest triangle (``urt_nearest_tri``)."""
    with _locks["nearest_tri"]:
        if "nearest_tri" not in _libs:
            lib = _build("nearest_tri", NEAREST_TRI_SRC,
                         lambda out: nvcc_cmd(NEAREST_TRI_SRC, out))
            p = ctypes.c_void_p
            i = ctypes.c_int
            lib.urt_nearest_tri.restype = i
            lib.urt_nearest_tri.argtypes = [
                p, p, p, p, i, i,          # o d tris valid n n_tris
                p, p, p, p, p, p]          # scratch keys t index
                                           # survivors stream
            _libs["nearest_tri"] = lib
        return _libs["nearest_tri"]


def probes_lib() -> ctypes.CDLL:
    """The dispatch-cost and FP32-rate probes (``urt_dead_tables``,
    ``urt_dead_nob``, ``urt_dead_persistent``, ``urt_fma_chain``)."""
    with _locks["probes"]:
        if "probes" not in _libs:
            lib = _build("probes", PROBES_SRC,
                         lambda out: nvcc_cmd(PROBES_SRC, out))
            p = ctypes.c_void_p
            i = ctypes.c_int
            ll = ctypes.c_longlong
            for fn, args in (
                    ("urt_dead_tables", [p, p, p, p, ll, i, p]),
                    ("urt_dead_nob", [p, p, ll, i, p]),
                    ("urt_dead_persistent", [p, p, p, p, ll, i, i, p]),
                    ("urt_fma_chain", [p, p, ll, p])):
                getattr(lib, fn).restype = i
                getattr(lib, fn).argtypes = args
            _libs["probes"] = lib
        return _libs["probes"]


def refit_lib() -> ctypes.CDLL:
    """The refit's Baldwin–Weber records (``urt_bw_records``)."""
    with _locks["refit"]:
        if "refit" not in _libs:
            lib = _build("refit", REFIT_SRC,
                         lambda out: nvcc_cmd(REFIT_SRC, out))
            p = ctypes.c_void_p
            i = ctypes.c_int
            lib.urt_bw_records.restype = i
            lib.urt_bw_records.argtypes = [p, i, i, i, p, p]
            _libs["refit"] = lib
        return _libs["refit"]


def build_all() -> dict:
    """Build (or load) every library at once, one compiler process per
    library started together; returns {name: handle}. Raises the first
    failure after all have finished."""
    from concurrent.futures import ThreadPoolExecutor
    fns = {"bvh": bvh_lib, "traverse": traverse_lib,
           "nearest_tri": nearest_tri_lib, "probes": probes_lib,
           "refit": refit_lib,
           **{f"mega_{g}": (lambda g=g: mega_lib(g)) for g in MEGA_GROUPS}}
    with ThreadPoolExecutor(len(fns)) as ex:
        futs = {name: ex.submit(fn) for name, fn in fns.items()}
    return {name: f.result() for name, f in futs.items()}
