"""Small shared utilities: frozen-dataclass replace, rounding, and the
device/dtype policy of the port.

Policy: the device is explicit and decides the path. On CUDA the engine
works in float32 (the kernels' type); on the CPU it works in float64, the
type in which the port is held to the JAX reference (nextgp_tpu).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch


def replace(obj, **kwargs):
    """dataclasses.replace for the frozen state dataclasses."""
    return dataclasses.replace(obj, **kwargs)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def default_device() -> torch.device:
    """The card. There is no silent CPU path: without a CUDA device this
    raises, and the CPU is used only where the caller passes device="cpu"."""
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the port runs on the card by default; '
                           'pass device="cpu" to run the plain versions on the CPU')
    return torch.device("cuda")


def default_dtype(device) -> torch.dtype:
    """float32 on CUDA, float64 on the CPU."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


@contextlib.contextmanager
def full_f32():
    """Matrix products in full float32 inside the block: TF32 would put
    ~1e-3 relative error into each product (PyTorch's default is off; this
    holds it off whatever the caller set)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
