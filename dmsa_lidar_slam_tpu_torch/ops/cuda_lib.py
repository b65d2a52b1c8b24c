"""Build, load and count the hand-written CUDA kernels of csrc/.

The sources are compiled at first use with nvcc for sm_90a, one nvcc
process per source, all started together, then linked into one shared
library with a plain C interface under build/kernels/ (named by a hash of
the sources and flags, so a change rebuilds and an unchanged tree reuses
the library), and loaded with ctypes.  Every C entry point returns
cudaGetLastError(); `check` raises if it is not 0.

Nothing here runs at import time: importing the package needs neither
nvcc nor a card.  Each kernel wrapper adds one to LAUNCHES[name] where it
launches its kernel, and nowhere else; BRANCHES counts the launches of a
wrapper that took one of its kernel's paths (K2's dense-J path for
P + 1 > 128; K1's 12-row layout).
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

LAUNCHES = {
    "build_packed": 0, "gn_system": 0, "cand_errors": 0, "min_sq_dist": 0, "radius_neighbor_moments": 0,
    "window_tables": 0, "keyframe_tables": 0,
}
BRANCHES = {"gn_system_dense_j": 0, "build_rows12": 0}
BUILD_SECONDS = None  # wall time of the last nvcc build (None: none ran)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # pts, mask, split, n, g_host, grid, key, stream
    "k1_voxel_keys": [_P, _P, _P, _I, _F, _P, _P, _P],
    # tab, xs, tidx, rings, mask, key_s, order, n, min_points, floor, packed, scratch, nvalid,
    # num_raw, long_out, long_acc, stream
    "k1_build": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P, _P, _P, _P, _P, _P, _P],
    # pts, obs, then k1_build's arguments after tab
    "k1_build_rows12": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P, _P, _P, _P, _P, _P, _P],
    # n, the scratch array's bytes (out)
    "k1_scratch_bytes": [_I, _P],
    "dmsa_chunk_positions": [],
    # m, P (K2) or K (K3), the scratch arrays' bytes (out)
    "k2_scratch_bytes": [_I, _I, _P],
    "k3_scratch_bytes": [_I, _I, _P],
    # n, the scratch array's bytes (out)
    "k5_scratch_bytes": [_I, _P],
    # tab, jt, P, packed, m, stage_u, stage_s, has_start, block_cnt, partial, hext, stream
    "k2_gn_small": [_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P],
    # tab, jt, P, packed, m, stage_u, stage_s, has_start, block_cnt, jrows, rmax, nrows, splits,
    # partial, hext, stream
    "k2_gn_large": [_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P],
    # tabs, K, dtab, packed, m, stage, has_start, span_end, partial, out, stream
    "k3_cand_errors": [_P, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P],
    # ref, rvalid, n, q, qvalid, nq, out, stream
    "k4_min_sq_dist": [_P, _P, _I, _P, _P, _I, _P, _P],
    # pts, valid, n, rho_host, rho, part, cnt, mean, cov, stream
    "k5_radius_moments": [_P, _P, _I, _F, _P, _P, _P, _P, _P, _P],
    # params, n_sets, P, C, D, use_imu, anchor_o, anchor_t, A, left, right, u, dt, stamps, gravity,
    # prot, pvel, ppos, cov, bal, tab, extra, dtab, jextra, stream
    "k6_window_tables": [_P, _I, _I, _I, _I, _I, *[_P] * 14, _P, _P, _P, _P, _P],
    # params, n_sets, P, S, use_grav, use_odom, anchor_o, anchor_t, kf_mask, plausible, grav_meas, gravity,
    # cov_grav, bal_grav, odom_t, odom_o, cov_ot, cov_oo, bal_odom, tab, extra, dtab, jextra, stream
    "k7_keyframe_tables": [_P, _I, _I, _I, _I, _I, *[_P] * 13, _P, _P, _P, _P, _P],
}

_lib = None


def reset_launches():
    for counts in (LAUNCHES, BRANCHES):
        for k in counts:
            counts[k] = 0


def launch_counts() -> dict:
    """The kernel launch counters, with K1's 12-row launches as
    "build_rows12" (BRANCHES)."""
    return dict(LAUNCHES, build_rows12=BRANCHES["build_rows12"])


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libdmsa_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the hashed library if it is not there yet:
    one nvcc per source, all running at once, then one link."""
    global BUILD_SECONDS
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, f.stem + ".o") for f in cu]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-c", "-o", o, str(f)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for f, o in zip(cu, objs)
        ]
        errors = []
        for f, p in zip(cu, procs):
            _, err = p.communicate()
            if p.returncode != 0:
                errors.append(f"{f.name} ({p.returncode}):\n{err}")
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        tmp = os.path.join(tmpdir, so.name)
        res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)
    BUILD_SECONDS = time.perf_counter() - t0
    return so


def library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=256)
def scratch_bytes(name, count, *dims):
    """The bytes of each of the `count` scratch arrays of a kernel call, as
    the library's own `name` entry point lays them out for the call's sizes
    `dims`: k1_scratch_bytes (n positions), k2_scratch_bytes (m positions,
    P), k3_scratch_bytes (m, K), k5_scratch_bytes (n points, on the current
    device)."""
    out = (ctypes.c_longlong * count)()
    check(getattr(library(), name)(*dims, out), name)
    return tuple(out)


def stream_ptr(device):
    """The raw handle of `device`'s current CUDA stream (an int, as ctypes
    takes a pointer; ~4 us cheaper than a torch.cuda.Stream object)."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def ptr(t):
    return t.data_ptr()


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def require(t, name, dtype, shape=None, device=None):
    """Check a kernel operand: CUDA, dtype, contiguity, optional shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
