"""Observation preprocessing: the port of ``repro.envs.preprocess``.

Games render (S, S, C) float grids; ``to_frame84`` blends the channels
to a grayscale intensity and nearest-neighbour-upscales it onto the
84x84 uint8 canvas the Nature CNN consumes, ``to_frame10`` keeps the
native size. Frames stack along a trailing axis, newest last. Every
function here is batched over a leading stream axis. An
:class:`ObsPipeline` names what one observation is: ``pixels`` (rendered
uint8 frames, the paper's pipeline) or ``vector`` (the env's float32
``observe`` state vector); the stack and step helpers work on either.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.envs.games import EnvSpec
from repro_torch.kernels.categorical_projection import linspace


@dataclasses.dataclass(frozen=True)
class ObsPipeline:
    """What one observation frame is: its mode, per-frame shape (without
    the batch and stack axes) and dtype."""
    mode: str
    shape: Tuple[int, ...]
    dtype: Any


def pixel_obs(frame_size: int) -> ObsPipeline:
    return ObsPipeline("pixels", (frame_size, frame_size), torch.uint8)


def vector_obs(spec: EnvSpec) -> ObsPipeline:
    if spec.observe is None:
        raise ValueError(f"env {spec.name!r} has no observe(); "
                         "vector observations unavailable")
    return ObsPipeline("vector", (spec.obs_dim,), torch.float32)


def as_obs(obs: Union[int, ObsPipeline]) -> ObsPipeline:
    """A bare int is the pixel frame size; an ObsPipeline passes."""
    return obs if isinstance(obs, ObsPipeline) else pixel_obs(int(obs))


def grid_to_gray(grid: torch.Tensor) -> torch.Tensor:
    """(..., S, S, C) float -> (..., S, S) float in [0, 1]: the channels
    blended by weights from 1.0 down to 0.4."""
    C = grid.shape[-1]
    w = linspace(1.0, 0.4, C, grid.device)
    return torch.clamp((grid * w).sum(dim=-1), 0.0, 1.0)


def to_frame84(grid: torch.Tensor) -> torch.Tensor:
    """(..., 10, 10, C) -> (..., 84, 84) uint8: 8x nearest upscale and a
    2-pixel border."""
    gray = grid_to_gray(grid)
    *lead, h, w = gray.shape
    up = gray[..., :, None, :, None].expand(*lead, h, 8, w, 8)
    up = F.pad(up.reshape(*lead, 8 * h, 8 * w), (2, 2, 2, 2))
    return (up * 255.0).to(torch.uint8)


def to_frame10(grid: torch.Tensor) -> torch.Tensor:
    """(..., S, S, C) -> (..., S, S) uint8 at the native size."""
    return (grid_to_gray(grid) * 255.0).to(torch.uint8)


def init_obs_stack(batch, pipe: ObsPipeline, stack: int,
                   device=None) -> torch.Tensor:
    """Zero observation stack: (B,) + pipe.shape + (K,) in pipe.dtype
    (uint8 frames or float32 state vectors); ``batch`` may be a tuple of
    stream axes, (R, W) for a population."""
    lead = tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)
    return torch.zeros(lead + pipe.shape + (stack,), dtype=pipe.dtype,
                       device=device)


def push_frame(stack: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
    """stack (B, *obs, K), frame (B, *obs): drop the oldest, append."""
    return torch.cat([stack[..., 1:], frame[..., None]], dim=-1)


def reset_stack_where(stack: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
    """Zero the history of streams whose episode just ended (done has
    the stack's stream axes)."""
    d = done.reshape(done.shape + (1,) * (stack.dim() - done.dim()))
    return torch.where(d, torch.zeros_like(stack), stack)


def render_batch(spec: EnvSpec, states, size: int = 84) -> torch.Tensor:
    """Render W env states -> (W, size, size) uint8."""
    conv = to_frame84 if size == 84 else to_frame10
    return conv(spec.render(states))


def obs_batch(pipe: ObsPipeline, spec: EnvSpec, states) -> torch.Tensor:
    """One observation per env state: (W,) + pipe.shape in pipe.dtype."""
    if pipe.mode == "vector":
        return spec.observe(states)
    if pipe.shape[0] == 84 and spec.size != 10:
        raise ValueError(
            f"84x84 frames assume a 10x10 grid (8x upscale + border); env "
            f"{spec.name!r} has size={spec.size} — use frame_size="
            f"{spec.size} (native) instead")
    return render_batch(spec, states, pipe.shape[0])
