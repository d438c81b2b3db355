"""ptxas' registers, stack frame and spill stores per kernel entry of a CUDA source.

    python -m unity_raytracer_tpu_torch.ops.kernels.ptxas [SOURCE.cu ...]

Compiles each source (by default ``csrc/mega_segment.cu``) with the command
the port builds the fused segment kernel with (``_lib.nvcc_cmd``: sm_90a,
``-O3 -fmad=false -Xptxas -v``) into ``build/ptxas/`` and prints one line
per kernel entry. To hold the kernel against an earlier revision built the
same way, write that revision's source to a file first (``git show
REV:unity_raytracer_tpu_torch/csrc/mega_segment.cu > build/old.cu``) and
pass both. Needs ``nvcc``. No JAX twin.
"""

from __future__ import annotations

import pathlib
import re
import subprocess
import sys

from unity_raytracer_tpu_torch.ops.kernels import _lib


def entries(log: str) -> dict:
    """{mangled entry name: {registers, stack, spill}} from ``ptxas -v``
    output: the stack and spill of the ``Function properties`` block of
    the entry, the registers of its ``Used`` line."""
    out, entry, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([\w$]+)'", line)
        if m:
            entry = props = m.group(1)
            out.setdefault(entry, {})
            continue
        m = re.search(r"Function properties for ([\w$]+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and props in out:
            out[props].update(stack=int(m.group(1)), spill=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry in out:
            out[entry]["registers"] = int(m.group(1))
    return out


def main(argv=None) -> int:
    srcs = [pathlib.Path(s) for s in (sys.argv[1:] if argv is None
                                      else argv)] or [_lib.MEGA_SRC]
    work = _lib.BUILD_DIR.parent / "ptxas"
    work.mkdir(parents=True, exist_ok=True)
    for k, src in enumerate(srcs):
        cmd = _lib.nvcc_cmd(src, work / f"lib{k}.so")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            print(f"{src}: build failed ({' '.join(cmd)}):\n{proc.stdout}"
                  f"{proc.stderr}", file=sys.stderr)
            return 1
        print(f"{src}: {' '.join(cmd[1:-3])}")
        for name, v in sorted(entries(proc.stdout + proc.stderr).items()):
            print(f"  {name}: {v.get('registers')} registers, "
                  f"{v.get('stack')} bytes stack, {v.get('spill')} bytes "
                  f"spill")
    return 0


if __name__ == "__main__":
    sys.exit(main())
