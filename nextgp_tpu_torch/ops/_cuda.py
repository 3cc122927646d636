"""Build and load the port's CUDA kernels (nvcc + ctypes).

The sources in `nextgp_tpu_torch/csrc/` are compiled at first use into one
shared library with a plain C interface for `sm_90a` (Hopper), cached in
`nextgp_tpu_torch/_build/<hash of sources and flags>/`. Each C entry point
launches on the stream it is given and returns `cudaGetLastError()`;
`check` raises on anything but 0. There is no fallback: a missing `nvcc`,
a failed build or a failed launch raises.

`LAUNCHES` counts kernel launches per kernel; each wrapper adds one where
it launches, so a run can show which kernels its path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {"pack2_matvec": 0, "pack2_rank_update": 0, "r_block_scan_v": 0}

_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (looked in CUDA_HOME, PATH, /usr/local/cuda/bin)")


def build() -> Path:
    """Compile csrc/*.cu into the cached shared library; return its path.
    ptxas's register and shared-memory report is kept beside it."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    so = out_dir / "libnextgp_torch_kernels.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".build-{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    (out_dir / "ptxas.log").write_text(res.stdout + res.stderr)
    os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA kernels need a CUDA device")
        cap = torch.cuda.get_device_capability()
        if cap != (9, 0):
            raise RuntimeError(f"the kernels are built for sm_90a (Hopper); device has sm_{cap[0]}{cap[1]}")
        L = ctypes.CDLL(str(build()))
        P, I, S = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p
        L.ngt_error_string.argtypes = [ctypes.c_int]
        L.ngt_error_string.restype = ctypes.c_char_p
        L.ngt_pack2_matvec.argtypes = [P, P, P, I, I, S]
        L.ngt_pack2_rank_update.argtypes = [P, P, P, P, I, I, I, S]
        L.ngt_r_block_scan_v.argtypes = [P, P, P, P, P, I, I, I, S]
        for fn in (L.ngt_pack2_matvec, L.ngt_pack2_rank_update, L.ngt_r_block_scan_v):
            fn.restype = ctypes.c_int
        _lib = L
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = lib().ngt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_of(t) -> int:
    """Handle of the current CUDA stream on t's device, as an int."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
