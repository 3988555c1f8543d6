"""Batched grid games in PyTorch: the port of ``repro.envs.games``.

A game is a set of functions closed over a frozen :class:`EnvParams`,
batched over a leading stream axis W:

    spec = make_env("pong")
    state = spec.reset(keys)                  # keys (W, 2) -> dict of (W,)
    state, reward, done = spec.step(state, actions, keys)
    grid = spec.render(state)                 # (W, size, size, C) float32

State tensors are int32, rewards float32 and dones bool, as in the
reference; every draw goes through :mod:`repro_torch.rng`, so the same
keys give the reference's states bit for bit. This slice ports pong;
the other five games of the reference are later work (ROADMAP.md,
queue 1 item 2) and ``make_env`` names them in its error.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar, Dict, Optional, Tuple

import torch

from repro_torch import rng

SIZE = 10
State = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Static per-game knobs. ``max_steps = 0`` derives the episode cap
    from ``size``. ``RANGES`` is the validation table and the text of the
    error messages."""

    size: int = SIZE
    max_steps: int = 0

    RANGES: ClassVar[Dict[str, Tuple[float, float]]] = {
        "size": (4, 64),
        "max_steps": (0, 100_000),
    }

    @classmethod
    def describe(cls) -> str:
        parts = []
        for f in dataclasses.fields(cls):
            lo, hi = cls.RANGES[f.name]
            note = " (0=auto)" if f.name == "max_steps" else ""
            parts.append(f"{f.name}∈[{lo}, {hi}] default={f.default}{note}")
        return ", ".join(parts)

    def validate(self, game: str) -> None:
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            lo, hi = self.RANGES[f.name]
            if not (lo <= v <= hi):
                raise ValueError(
                    f"env {game!r}: param {f.name}={v!r} outside valid "
                    f"range [{lo}, {hi}]; valid params: {self.describe()}")


@dataclasses.dataclass(frozen=True)
class PongParams(EnvParams):
    paddle_width: int = 3

    RANGES: ClassVar[Dict[str, Tuple[float, float]]] = {
        **EnvParams.RANGES, "paddle_width": (1, 63)}


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    name: str
    n_actions: int
    channels: int
    max_steps: int
    reset: Callable[[torch.Tensor], State]
    step: Callable[[State, torch.Tensor, torch.Tensor],
                   Tuple[State, torch.Tensor, torch.Tensor]]
    render: Callable[[State], torch.Tensor]
    size: int = SIZE
    obs_dim: int = 0         # width of the state vector (vector obs, unported)
    params: Optional[EnvParams] = None


def _full(like: torch.Tensor, value: int) -> torch.Tensor:
    return torch.full(like.shape[:-1], value, dtype=torch.int32,
                      device=like.device)


# ---------------------------------------------------------------------------
# Pong (squash): the ball bounces off three walls; the paddle guards the
# bottom row.
# ---------------------------------------------------------------------------

def _make_pong(p: PongParams) -> EnvSpec:
    n, hw = p.size, p.paddle_width // 2
    max_steps = p.max_steps or 50 * n

    def reset(keys: torch.Tensor) -> State:
        k = rng.split(keys)
        dirs = torch.arange(-1, 2, 2, dtype=torch.int32, device=keys.device)
        return {
            "ball_x": rng.randint(k[..., 0, :], (), 1, n - 1),
            "ball_y": _full(keys, 1),
            "dx": rng.choice(k[..., 1, :], dirs),
            "dy": _full(keys, 1),
            "paddle_x": _full(keys, n // 2),
            "t": _full(keys, 0),
        }

    def step(s: State, a: torch.Tensor, keys: torch.Tensor):
        moves = torch.arange(-1, 2, dtype=torch.int32, device=a.device)
        paddle = torch.clamp(s["paddle_x"] + moves[a.long()], 0, n - 1)
        nx = s["ball_x"] + s["dx"]
        dx = torch.where((nx < 0) | (nx >= n), -s["dx"], s["dx"])
        nx = torch.clamp(nx, 0, n - 1)
        ny = s["ball_y"] + s["dy"]
        dy = torch.where(ny < 0, -s["dy"], s["dy"])
        ny = torch.clamp(ny, 0, n - 1)
        at_bottom = ny >= n - 1
        on_paddle = torch.abs(nx - paddle) <= hw
        bounce = at_bottom & on_paddle
        dy = torch.where(bounce, -torch.abs(dy), dy)
        reward = bounce.to(torch.float32)
        done = (at_bottom & ~on_paddle) | (s["t"] >= max_steps)
        ns = {"ball_x": nx, "ball_y": ny, "dx": dx, "dy": dy,
              "paddle_x": paddle, "t": s["t"] + 1}
        return ns, reward, done

    def render(s: State) -> torch.Tensor:
        W = s["ball_x"].shape[0]
        dev = s["ball_x"].device
        g = torch.zeros((W, n, n, 2), dtype=torch.float32, device=dev)
        g[torch.arange(W, device=dev), s["ball_y"].long(),
          s["ball_x"].long(), 0] = 1.0
        cols = torch.arange(n, device=dev)
        pad = torch.abs(cols[None, :] - s["paddle_x"][:, None]) <= hw
        g[:, n - 1, :, 1] = pad.to(torch.float32)
        return g

    return EnvSpec("pong", 3, 2, max_steps, reset, step, render, size=n,
                   obs_dim=5, params=p)


# The reference's registry; only pong is ported in this slice.
GAMES: Dict[str, Tuple[type, Callable[[EnvParams], EnvSpec]]] = {
    "pong": (PongParams, _make_pong),
}
NOT_PORTED = ("catch", "breakout", "seeker", "freeway", "dodge")


def _coerce(field: dataclasses.Field, value: Any, game: str) -> Any:
    ok_int = isinstance(value, int) and not isinstance(value, bool)
    if field.type in ("int", int):
        if not ok_int:
            raise ValueError(
                f"env {game!r}: param {field.name} expects an int, got "
                f"{value!r}")
        return value
    if not (ok_int or isinstance(value, float)):
        raise ValueError(
            f"env {game!r}: param {field.name} expects a number, got "
            f"{value!r}")
    return float(value)


def _require(cond: bool, game: str, msg: str, cls: type) -> None:
    if not cond:
        raise ValueError(
            f"env {game!r}: {msg}; valid params: {cls.describe()}")


def make_env(name: str, params: Optional[EnvParams] = None,
             **overrides: Any) -> EnvSpec:
    """Build an :class:`EnvSpec` for ``name`` with validated parameters,
    from a full ``params`` dataclass or keyword overrides of the game's
    defaults. Unknown games, unknown parameter names and out-of-range
    values raise ``ValueError`` listing what is valid."""
    if name in NOT_PORTED:
        raise ValueError(
            f"env {name!r} is not ported to repro_torch yet (ROADMAP.md, "
            f"queue 1 item 2); ported: {sorted(GAMES)}")
    if name not in GAMES:
        raise ValueError(
            f"unknown env {name!r}; available: {sorted(GAMES)}")
    cls, build = GAMES[name]
    if params is None:
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for k in overrides:
            if k not in fields:
                raise ValueError(
                    f"env {name!r} has no param {k!r}; valid params: "
                    f"{cls.describe()}")
        params = cls(**{k: _coerce(fields[k], v, name)
                        for k, v in overrides.items()})
    elif overrides:
        raise ValueError("pass either params or keyword overrides, not both")
    elif not isinstance(params, cls):
        raise ValueError(
            f"env {name!r} expects {cls.__name__}, got "
            f"{type(params).__name__}")
    params.validate(name)
    n = params.size
    _require(params.paddle_width % 2 == 1, name,
             f"paddle_width={params.paddle_width} must be odd", cls)
    _require(params.paddle_width <= n, name,
             f"paddle_width={params.paddle_width} must fit the grid "
             f"(size={n})", cls)
    return build(params)


def step_autoreset(spec: EnvSpec, state: State, action: torch.Tensor,
                   keys: torch.Tensor):
    """Step; where an episode ends, the next state is a fresh reset (the
    returned reward and done describe the finished episode). Each key
    splits once into (step, reset) halves."""
    k = rng.split(keys)
    ns, reward, done = spec.step(state, action, k[..., 0, :])
    fresh = spec.reset(k[..., 1, :])
    ns = {f: torch.where(done, fresh[f], ns[f]) for f in ns}
    return ns, reward, done
