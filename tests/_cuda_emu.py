"""A kernel source of the port compiled for the CPU (tests/cuda_emu/):
its launch and its dynamic shared memory rewritten for the stand-in
runtime, g++ into a shared library, loaded with ctypes. Each block runs
after the other, its threads as fibers of one host thread."""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
LAUNCH = re.compile(r"(\S+)<<<(.+?),\s*(\S+),\s*(\S+),\s*(\S+)>>>\((.*?)\);")
DYN_SMEM = re.compile(r"extern __shared__ (\w+) (\w+)\[\];")


def build(src: Path, out_dir: Path) -> ctypes.CDLL:
    """`src` (csrc/*.cu) for the CPU, compiled into `out_dir`."""
    if shutil.which("g++") is None:
        raise RuntimeError("g++ is needed to run a kernel source on the CPU")
    text = LAUNCH.sub(r"emu_launch<\3>(\1, \2, \4, \6);", src.read_text())
    text = DYN_SMEM.sub(r"\1* \2 = emu_dyn_smem<\1>();", text)
    if "<<<" in text:
        raise RuntimeError(f"a launch of {src.name} was not rewritten")
    cpp, lib = out_dir / f"{src.stem}_emu.cpp", out_dir / f"lib{src.stem}_emu.so"
    cpp.write_text(text)
    cmd = ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
           "-I", str(HERE / "cuda_emu"), "-o", str(lib), str(cpp)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"g++ failed on {src.name}:\n{done.stderr[-4000:]}")
    return ctypes.CDLL(str(lib))
