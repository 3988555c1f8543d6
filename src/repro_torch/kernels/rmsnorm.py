"""The RMSNorm op: rows of x scaled by rsqrt(mean(x^2) + eps) and a gain.

On a CUDA tensor ``rmsnorm`` launches the kernel of ``csrc/rmsnorm.cu``,
which reads each row once into registers, with the thread layout
``rmsnorm_plan`` picks for the shape; on a CPU tensor it runs the plain
version of ``kernels/ref.py``. The two agree to float rounding: the
kernel sums the squares in another order. A call that must record a
gradient goes through ``recompute.PlainRecompute``: the kernel forward,
the plain version's autograd backward (the reference's ``custom_vjp``
rule). Fake tensors take a shape-only branch (``route``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, route
from repro_torch.kernels.ref import rmsnorm as rmsnorm_plain

__all__ = ["rmsnorm", "rmsnorm_plain", "rmsnorm_plan", "RmsnormPlan",
           "rmsnorm_work"]

# the units per thread the kernel is compiled for (csrc/rmsnorm.cu,
# launch): 16-byte vectors, and single values for a D that is no
# multiple of the vector
VEC_VPTS = (1, 2, 3, 4, 8)
SCALAR_VPTS = (1, 2, 4, 8, 16)
# from this many rows on, a row gets fewer threads with more units each
# and a block holds several rows (prefill); below it each row is spread
# over more threads, so that all of its loads are in flight at once
# (decode)
MANY_ROWS = 1024
VPT_FEW_ROWS, VPT_MANY_ROWS = 2, 3
MIN_WARPS_PER_BLOCK = 4


def max_threads(vec: bool, vpt: int) -> int:
    """Threads per block the kernel's instance takes (csrc/rmsnorm.cu,
    max_threads): its units' registers, 4 a vector and 1 a value, bound
    how many threads the register file holds."""
    regs = (4 if vec else 1) * vpt
    return 1024 if regs <= 16 else 512 if regs <= 40 else 256


class RmsnormPlan(NamedTuple):
    vec: bool            # 16-byte units, else single values
    units: int           # units per row
    vpt: int             # units per thread
    warps_per_row: int
    rows_per_block: int


def rmsnorm_plan(rows: int, D: int, itemsize: int,
                 aligned: bool = True) -> RmsnormPlan:
    """The kernel's layout for ``rows`` rows of width D of ``itemsize``
    bytes: units of 16 bytes when D is a multiple of the vector and the
    tensors are ``aligned``, else single values; per row ``warps_per_row``
    warps holding ``vpt`` units per thread. Layouts whose threads cover
    the row exactly come first, then the one whose ``vpt`` is nearest the
    target for this many rows (on a tie, more threads for few rows and
    fewer for many). Raises for a row longer than one block holds in
    registers (32768 bf16 or 16384 float32 values; 16384 when D is no
    multiple of the vector)."""
    n = 16 // itemsize
    vec = aligned and D % n == 0
    units = D // n if vec else D
    vpts = VEC_VPTS if vec else SCALAR_VPTS
    many = rows >= MANY_ROWS
    target = VPT_MANY_ROWS if many else VPT_FEW_ROWS
    best = None
    for wpr in range(1, 33):
        fits = [v for v in vpts if 32 * wpr * v >= units
                and 32 * wpr <= max_threads(vec, v)]
        if not fits:
            continue
        vpt = fits[0]
        key = (32 * wpr * vpt != units, abs(vpt - target),
               -vpt if many else vpt)
        if best is None or key < best[0]:
            best = (key, vpt, wpr)
    if best is None:
        longest = max(max_threads(vec, v) * v for v in vpts)
        raise ValueError(f"rmsnorm: a row of {D} values is longer than the "
                         f"kernel holds in registers "
                         f"({longest * (n if vec else 1)} values)")
    _, vpt, wpr = best
    rpb = max(1, -(-MIN_WARPS_PER_BLOCK // wpr)) if many else 1
    rpb = min(rpb, max_threads(vec, vpt) // (32 * wpr))
    return RmsnormPlan(vec, units, vpt, wpr, rpb)


def _lib() -> ctypes.CDLL:
    lib = build.library("rmsnorm")
    fn = lib.rmsnorm
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D) float32 or bfloat16; gamma: (D,) float32. Returns x's
    shape and type. CUDA tensors go through the kernel (its launches are
    counted in ``rmsnorm.launches``); CPU tensors through the plain
    version; fake tensors through the shape-only branch (``route``). On
    the card a call that needs a gradient gets it from the plain version
    (``recompute``)."""
    return route.call("rmsnorm", lambda: rmsnorm_work(x, gamma), _launch,
                      rmsnorm_plain, _shape_only, {"eps": eps}, x, gamma)


def rmsnorm_work(x: torch.Tensor, gamma: torch.Tensor):
    """(flops, bytes) of one call: x read and written once, gamma read;
    4 float32 operations per element (square-add, two products, the
    cast)."""
    n = x.numel()
    return 4 * n, 2 * n * x.element_size() + gamma.numel() * 4


def _shape_only(x: torch.Tensor, gamma: torch.Tensor,
                eps: float) -> torch.Tensor:
    return torch.empty_like(x)


def _launch(x: torch.Tensor, gamma: torch.Tensor,
            eps: float) -> torch.Tensor:
    """The kernel's launch, counted in ``rmsnorm.launches``."""
    D = x.shape[-1]
    code = build.dtype_code("rmsnorm", x)
    if gamma.shape != (D,) or gamma.dtype != torch.float32:
        raise ValueError(f"rmsnorm: gamma must be ({D},) float32, got "
                         f"{tuple(gamma.shape)} {gamma.dtype}")
    if gamma.device != x.device:
        raise ValueError("rmsnorm: gamma must be on x's device")
    x2 = x.reshape(-1, D).contiguous()
    gamma = gamma.contiguous()
    out = build.output(x2.shape, x2.dtype, x2.device)
    rows = x2.shape[0]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2, out, gamma))
    plan = rmsnorm_plan(rows, D, x2.element_size(), aligned)
    err = _lib().rmsnorm(x2.data_ptr(), gamma.data_ptr(), out.data_ptr(), rows,
                         D, float(eps), code, int(plan.vec), plan.vpt,
                         plan.warps_per_row, plan.rows_per_block,
                         build.stream_of(x))
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed at ({rows}, {D}) "
                           f"{x.dtype}: CUDA error {err}")
    rmsnorm.launches += 1
    return out.reshape(x.shape)


rmsnorm.launches = 0
