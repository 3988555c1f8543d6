"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``. The first call builds every source that is not built yet,
one ``nvcc`` process per source, all started together. Libraries go to
``build/repro_torch_kernels/`` at the root of the checkout, named by a
hash of their source so that an edited kernel is rebuilt. A missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("segment_tree", "categorical_projection", "rmsnorm",
           "flash_attention", "decode_attention", "ssm_scan", "slstm_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (searched PATH and /usr/local/cuda/bin): the "
            "port's CUDA kernels are built from source at first use")
    return path


def _target(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, in parallel.
    Returns the compiler's report (``-Xptxas -v``) per source built."""
    todo = [n for n in SOURCES if not _target(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for name in todo:
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, _target(name))
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            build_all()
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]


# the element types the attention and norm kernels take, by their C code
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# shared memory one block may use on sm_90 (227 KB)
MAX_SMEM_BYTES = 232448


def dtype_code(op: str, *tensors: torch.Tensor) -> int:
    """The C dtype code of ``tensors``, which must share one of
    ``DTYPE_CODES``' types; raises naming the op otherwise."""
    dt = tensors[0].dtype
    if dt not in DTYPE_CODES or any(t.dtype != dt for t in tensors):
        raise TypeError(f"{op}: the kernel takes float32 or bfloat16 inputs "
                        f"of one type, got {[t.dtype for t in tensors]}")
    return DTYPE_CODES[dt]


def vector_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` laid out for 16-byte vector loads along its last axis: that
    axis contiguous, the base and every other stride a multiple of 16
    bytes. A tensor that is not is copied into a new contiguous one; if
    its last axis is not a multiple of 16 bytes that is no help, and the
    call raises."""
    def ok(x):
        es = x.element_size()
        return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
                and all(x.stride(i) * es % 16 == 0 or x.shape[i] == 1
                        for i in range(x.dim() - 1)))
    if not ok(t):
        t = t.clone(memory_format=torch.contiguous_format)
        if not ok(t):
            raise ValueError(f"a {tuple(t.shape)} {t.dtype} tensor cannot "
                             "be read in 16-byte vectors (last axis not a "
                             "multiple of 16 bytes, or a misaligned base)")
    return t


def output(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """A buffer that a kernel writes in full: ``torch.empty`` without the
    NaN fill that deterministic mode
    (``torch.utils.deterministic.fill_uninitialized_memory``, on while
    ``torch.use_deterministic_algorithms(True)``) gives every allocation,
    which would cost one more write pass over the buffer per call."""
    flags = torch.utils.deterministic
    fill = flags.fill_uninitialized_memory
    flags.fill_uninitialized_memory = False
    try:
        return torch.empty(shape, dtype=dtype, device=device)
    finally:
        flags.fill_uninitialized_memory = fill


def stream_of(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
