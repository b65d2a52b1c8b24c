"""Build a kernel's CUDA source for the CPU tests: g++ under an emulation
header, with csrc/ on the include path for the shared headers.

  - tests/cuda_host_emu.h (the default): the CUDA keywords as C++, a launch
    that runs each block's threads in turn in two passes split at the one
    __syncthreads (the pose-table kernels K6, K7);
  - tests/cuda_warp_emu.h: each thread of a block a fiber on one OS
    thread, barriers for __syncthreads and the warp intrinsics (K1)."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "dmsa_lidar_slam_tpu_torch" / "csrc"


def build_host(source: str, entry: str, argtypes, out_dir: Path, header: str = "cuda_host_emu.h", launches: int = 1):
    """csrc/<source> as a host library under `header` (its `launches` kernel
    launches turned into emu_launch calls); `entry` gets ctypes `argtypes`
    and an int result.  Skips without g++."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    src = (CSRC / source).read_text().replace("#include <cuda_runtime.h>", f'#include "{header}"')
    src, n = re.subn(r"(\w+(?:<\w+>)?)<<<([^<>;]+?), ([^<>;]+?), 0, stream>>>\(", r"emu_launch(\1, \2, \3, ", src)
    assert n == launches, f"the launches of {entry}: {n}"
    stem = Path(source).stem
    cpp, so = out_dir / f"{stem}_host.cpp", out_dir / f"lib{stem}_host.so"
    cpp.write_text(src)
    # the shared headers' own #include <cuda_runtime.h>
    (out_dir / "cuda_runtime.h").write_text(f'#pragma once\n#include "{header}"\n')
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(out_dir), "-I", str(HERE),
                    "-I", str(CSRC), "-o", str(so), str(cpp)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib
