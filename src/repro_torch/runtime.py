"""Device selection and the numerics every entry point pins.

The reference trains in full float32 and its cycle is bitwise
deterministic. On the card that takes: TF32 off for matmuls and cuDNN
convolutions (cuDNN defaults to TF32), deterministic algorithms on, and
cuBLAS given a fixed workspace, which must be set before cuBLAS starts.
"""

from __future__ import annotations

import os

import torch


def configure(device: str = "cuda") -> torch.device:
    """Pin float32 and deterministic kernels, and return the device. A
    CUDA device without a card raises: nothing drops to the CPU unless
    the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    return dev
