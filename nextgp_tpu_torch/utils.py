"""Small shared utilities: frozen-dataclass replace, rounding, and the
device/dtype policy of the port.

Policy: the device is explicit and decides the path. On CUDA the engine
works in float32 (the kernels' type); on the CPU it works in float64, the
type in which the port is held to the JAX reference (nextgp_tpu).
"""
from __future__ import annotations

import dataclasses

import torch


def replace(obj, **kwargs):
    """dataclasses.replace for the frozen state dataclasses."""
    return dataclasses.replace(obj, **kwargs)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def default_dtype(device) -> torch.dtype:
    """float32 on CUDA, float64 on the CPU."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64
