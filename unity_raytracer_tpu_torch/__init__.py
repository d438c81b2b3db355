"""unity_raytracer_tpu_torch — the PyTorch + CUDA port of ``unity_raytracer_tpu``.

The JAX package beside this one is the reference; this package mirrors its
module names, and each module's docstring names its JAX twin by file. The
port imports ``torch`` and numpy only — never ``jax`` and never the JAX
package.

Slices ported so far: the mirror bounce chain on its two routes — the
fused segment kernel (``ops/render.py`` → ``ops/kernels/mega.py`` →
``csrc/mega_segment.cu``) and the composed differentiable path
(``ops/intersect.py``, ``ops/shade.py``, ``ops/render.py`` around the
BVH walks of ``csrc/traverse.cu`` and the brute-force nearest triangle of
``csrc/nearest_tri.cu``) — with the host BVH build and packers, the scene
containers, presets, camera and image assembly around them; training by
record-replay (``ops/replay.py``) and on the composed path; the fitting
loop (``fit.py``). What is left raises ``NotImplementedError`` naming the
ROADMAP item that ports it. Entry points run on the CUDA card unless the
caller asks for the CPU.

    python -m unity_raytracer_tpu_torch render --preset mesh100k --out f.png
    python -m unity_raytracer_tpu_torch fit --preset mesh100k --replay
    python -m unity_raytracer_tpu_torch fit            # composed, three_spheres
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
