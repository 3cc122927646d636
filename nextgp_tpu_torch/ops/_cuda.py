"""Build and load the port's CUDA kernels (nvcc + ctypes).

The sources in `nextgp_tpu_torch/csrc/` are compiled at first use (one
`nvcc` per source, all started together, then one link) into one shared
library with a plain C interface for `sm_90a` (Hopper), cached in
`nextgp_tpu_torch/_build/<hash of sources and flags>/`. Each C entry point
launches on the stream it is given and returns `cudaGetLastError()`;
`check` raises on anything but 0. There is no fallback: a missing `nvcc`,
a failed build or a failed launch raises.

`LAUNCHES` counts kernel launches per kernel; each wrapper adds one where
it launches, so a run can show which kernels its path went through. A
kernel's float64 instance has a counter of its own (`<name>_f64`). A
launch captured in a CUDA graph counts once, at capture: the graph's
replays run on the card without the wrappers.
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {"pack2_matvec": 0, "pack2_rank_update": 0, "r_block_scan_v": 0,
            "pack2_matvec_f64": 0, "pack2_rank_update_f64": 0, "r_block_scan_v_f64": 0,
            "gauss_block_scan_v": 0, "bc_block_scan_v": 0, "bc_block_scan_wv": 0,
            "gauss_block_scan_v_f64": 0, "bc_block_scan_v_f64": 0, "bc_block_scan_wv_f64": 0,
            "rcpi_block_scan_v": 0, "rcplus_block_scan_v": 0,
            "rcpi_block_scan_v_f64": 0, "rcplus_block_scan_v_f64": 0,
            "gather_width1": 0, "gather_width4": 0, "read_step": 0, "dense_gather": 0,
            "dense_scatter": 0, "fused_step": 0, "keyed_rng": 0, "level_scan": 0,
            "corr_level_scan": 0, "level_scan_f64": 0, "corr_level_scan_f64": 0,
            "corr_block_scan_v": 0, "corr_rule": 0, "corr_block_scan_v_f64": 0, "corr_rule_f64": 0,
            "cg_solve": 0, "grn_scan": 0}

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
    nvcc, tag = _nvcc(), f".build-{os.getpid()}"
    objs = [out_dir / f"{src.stem}{tag}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [(src.name, p.returncode, log) for src, p, log in zip(sources, procs, logs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(f"{n} ({rc}):\n{log}" for n, rc, log in failed))
    tmp = out_dir / f"{tag}.so"
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    (out_dir / "ptxas.log").write_text("".join(logs))
    for obj in objs:
        obj.unlink()
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
        L.ngt_pack2_matvec.argtypes = [P, P, P, I, I, I, S]
        L.ngt_pack2_rank_update.argtypes = [P, P, P, P, P, I, I, I, S]
        L.ngt_r_block_scan_v.argtypes = [P, P, P, P, P, I, I, I, S]
        L.ngt_pack2_matvec_f64.argtypes = L.ngt_pack2_matvec.argtypes
        L.ngt_pack2_rank_update_f64.argtypes = L.ngt_pack2_rank_update.argtypes
        L.ngt_r_block_scan_v_f64.argtypes = L.ngt_r_block_scan_v.argtypes
        L.ngt_gauss_block_scan_v.argtypes = [P, P, P, P, I, I, S]
        L.ngt_bc_block_scan_v.argtypes = [P, P, P, P, P, I, I, S]
        L.ngt_bc_block_scan_wv.argtypes = [P, P, P, P, P, P, I, I, S]
        L.ngt_gauss_block_scan_v_f64.argtypes = L.ngt_gauss_block_scan_v.argtypes
        L.ngt_bc_block_scan_v_f64.argtypes = L.ngt_bc_block_scan_v.argtypes
        L.ngt_bc_block_scan_wv_f64.argtypes = L.ngt_bc_block_scan_wv.argtypes
        L.ngt_rcpi_block_scan_v.argtypes = [P] * 7 + [I] * 4 + [S]
        L.ngt_rcplus_block_scan_v.argtypes = [P] * 8 + [I] * 4 + [S]
        L.ngt_rcpi_block_scan_v_f64.argtypes = L.ngt_rcpi_block_scan_v.argtypes
        L.ngt_rcplus_block_scan_v_f64.argtypes = L.ngt_rcplus_block_scan_v.argtypes
        L.ngt_gather_width.argtypes = [P, P, P, I, I, I, I, S]
        L.ngt_read_step.argtypes = [P, P, I, I, I, S]
        L.ngt_dense_gather.argtypes = [P, P, P, I, I, I, S]
        L.ngt_dense_scatter.argtypes = [P, P, P, P, I, I, I, S]
        L.ngt_fused_step.argtypes = [P] * 8 + [I] * 4 + [S]
        L.ngt_keyed_rng.argtypes = [P, ctypes.c_ulonglong, ctypes.POINTER(ctypes.c_ulonglong), I, I,
                                    P, P, P, I, S]
        L.ngt_keyed_rng_rows.argtypes = [P, ctypes.c_ulonglong, ctypes.POINTER(ctypes.c_ulonglong),
                                         I, I, I, I, P, P, P, I, S]
        L.ngt_level_scan.argtypes = [P, I, P, P, P, P, P, P, P, S]
        L.ngt_level_scan_f64.argtypes = L.ngt_level_scan.argtypes
        L.ngt_level_scan_scratch_words.argtypes = [I]
        L.ngt_level_scan_scratch_words.restype = ctypes.c_longlong
        L.ngt_level_scan_smem_bytes.argtypes = [I, I]
        L.ngt_level_scan_smem_bytes.restype = ctypes.c_longlong
        L.ngt_smem_optin_bytes.argtypes = []
        L.ngt_smem_optin_bytes.restype = ctypes.c_longlong
        bind_re2(L)
        bind_cm1(L)
        L.ngt_keyed_rng_f64.argtypes = L.ngt_keyed_rng.argtypes
        L.ngt_keyed_rng_rows_f64.argtypes = L.ngt_keyed_rng_rows.argtypes
        bind_cg(L)
        bind_grn(L)
        for fn in (L.ngt_pack2_matvec, L.ngt_pack2_rank_update, L.ngt_r_block_scan_v,
                   L.ngt_pack2_matvec_f64, L.ngt_pack2_rank_update_f64, L.ngt_r_block_scan_v_f64,
                   L.ngt_gauss_block_scan_v, L.ngt_bc_block_scan_v, L.ngt_bc_block_scan_wv,
                   L.ngt_gauss_block_scan_v_f64, L.ngt_bc_block_scan_v_f64,
                   L.ngt_bc_block_scan_wv_f64,
                   L.ngt_rcpi_block_scan_v, L.ngt_rcplus_block_scan_v, L.ngt_rcpi_block_scan_v_f64,
                   L.ngt_rcplus_block_scan_v_f64, L.ngt_gather_width,
                   L.ngt_read_step, L.ngt_dense_gather, L.ngt_dense_scatter, L.ngt_fused_step,
                   L.ngt_keyed_rng, L.ngt_keyed_rng_rows, L.ngt_keyed_rng_f64,
                   L.ngt_keyed_rng_rows_f64, L.ngt_level_scan, L.ngt_level_scan_f64):
            fn.restype = ctypes.c_int
        _lib = L
    return _lib


def bind_re2(L: ctypes.CDLL) -> None:
    """Bind RE2's C interface (csrc/level_scan.cu) in a loaded library: the
    port's, or another build of that source (whose float64 entry, where it
    has one, is bound too)."""
    I = ctypes.c_longlong
    L.ngt_corr_level_scan.argtypes = [ctypes.c_void_p, I, I] + [ctypes.c_void_p] * 10
    L.ngt_corr_level_scan.restype = ctypes.c_int
    if hasattr(L, "ngt_corr_level_scan_f64"):
        L.ngt_corr_level_scan_f64.argtypes = L.ngt_corr_level_scan.argtypes
        L.ngt_corr_level_scan_f64.restype = ctypes.c_int
    L.ngt_corr_level_scan_takes_rule.argtypes = [I]
    L.ngt_corr_level_scan_takes_rule.restype = I
    L.ngt_corr_level_scan_scratch_words.argtypes = [I, I]
    L.ngt_corr_level_scan_scratch_words.restype = I


def bind_cm1(L: ctypes.CDLL) -> None:
    """Bind CM1's C interface (csrc/corr_scan.cu: the block-step and the
    rule launch) in a loaded library: the port's, or another build of that
    source (whose float64 entries and shared-memory export, where it has
    them, are bound too)."""
    I, P = ctypes.c_longlong, ctypes.c_void_p
    L.ngt_corr_block_step.argtypes = [P, P, I, P, P, P, P, I, P, P, I, I, I, P]
    L.ngt_corr_rule.argtypes = [P] * 8 + [I] * 3 + [P]
    L.ngt_corr_block_step.restype = L.ngt_corr_rule.restype = ctypes.c_int
    if hasattr(L, "ngt_corr_block_step_f64"):
        L.ngt_corr_block_step_f64.argtypes = L.ngt_corr_block_step.argtypes
        L.ngt_corr_rule_f64.argtypes = L.ngt_corr_rule.argtypes
        L.ngt_corr_block_step_f64.restype = L.ngt_corr_rule_f64.restype = ctypes.c_int
        L.ngt_corr_block_step_smem_bytes.argtypes = [I] * 3
        L.ngt_corr_block_step_smem_bytes.restype = I


def bind_cg(L: ctypes.CDLL) -> None:
    """Bind CG1's C interface (csrc/cg_solve.cu) in a loaded library: the
    port's, or another build of that source."""
    I = ctypes.c_longlong
    for fn, args in ((L.ngt_cg_solve_grid, [I]), (L.ngt_cg_solve_scratch_bytes, [I] * 4)):
        fn.argtypes, fn.restype = args, ctypes.c_longlong
    L.ngt_cg_solve.argtypes = ([I] * 3 + [ctypes.c_void_p] * 13 + [ctypes.c_double] + [I] * 4
                               + [ctypes.c_void_p])
    L.ngt_cg_solve.restype = ctypes.c_int


def bind_grn(L: ctypes.CDLL) -> None:
    """Bind GRN1's C interface (csrc/grn_scan.cu) in a loaded library: the
    port's, or another build of that source."""
    I, P = ctypes.c_longlong, ctypes.c_void_p
    L.ngt_grn_scan.argtypes = [P] * 8 + [I] * 3 + [P]
    L.ngt_grn_scan.restype = ctypes.c_int
    L.ngt_grn_scan_smem_snps.argtypes, L.ngt_grn_scan_smem_snps.restype = [I], I


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
