"""Build a pose-table kernel's CUDA source for the CPU tests: g++ under
tests/cuda_host_emu.h (the CUDA keywords as C++, a launch that runs each
block's threads in turn in two passes split at the one __syncthreads), with
csrc/ on the include path for the shared headers."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "dmsa_lidar_slam_tpu_torch" / "csrc"


def build_host(source: str, entry: str, argtypes, out_dir: Path):
    """csrc/<source> as a host library; `entry` gets ctypes `argtypes` and
    an int result.  Skips without g++."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    src = (CSRC / source).read_text().replace("#include <cuda_runtime.h>", '#include "cuda_host_emu.h"')
    src, n = re.subn(r"(\w+)<<<(\w+), (\w+), 0, stream>>>\((\w+)\)", r"emu_launch(\1, \2, \3, \4)", src)
    assert n == 1, f"the launch of {entry}"
    stem = Path(source).stem
    cpp, so = out_dir / f"{stem}_host.cpp", out_dir / f"lib{stem}_host.so"
    cpp.write_text(src)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(HERE), "-I", str(CSRC), "-o", str(so),
                    str(cpp)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib
