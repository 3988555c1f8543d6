"""Batched grid games in PyTorch: the port of ``repro.envs.games``.

A game is a set of functions closed over a frozen :class:`EnvParams`,
batched over a leading stream axis W:

    spec = make_env("catch", size=16)
    state = spec.reset(keys)                  # keys (W, 2) -> dict of (W, ...)
    state, reward, done = spec.step(state, actions, keys)
    grid = spec.render(state)                 # (W, size, size, C) float32
    vec = spec.observe(state)                 # (W, obs_dim) float32 in [0, 1]

State tensors are int32 (bool for brick and obstacle grids), rewards
float32 and dones bool, as in the reference. The reference's games are
per env under ``vmap``; here each per-env draw is one call of
:mod:`repro_torch.rng` on the (W, 2) keys, which gives every env the
draw its own key gives in the reference, so the same keys give the
reference's states bit for bit. Each ``.at[].set`` of a render is one
indexed write over the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar, Dict, Optional, Tuple

import numpy as np
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
class CatchParams(EnvParams):
    paddle_width: int = 3        # odd; catch rule is |ball-paddle| <= w//2
    ball_speed: int = 1          # rows fallen per step

    RANGES: ClassVar[Dict[str, Tuple[float, float]]] = {
        **EnvParams.RANGES, "paddle_width": (1, 63), "ball_speed": (1, 3)}


@dataclasses.dataclass(frozen=True)
class BreakoutParams(EnvParams):
    brick_rows: int = 3
    paddle_width: int = 3

    RANGES: ClassVar[Dict[str, Tuple[float, float]]] = {
        **EnvParams.RANGES, "brick_rows": (1, 61), "paddle_width": (1, 63)}


@dataclasses.dataclass(frozen=True)
class PongParams(EnvParams):
    paddle_width: int = 3

    RANGES: ClassVar[Dict[str, Tuple[float, float]]] = {
        **EnvParams.RANGES, "paddle_width": (1, 63)}


@dataclasses.dataclass(frozen=True)
class SeekerParams(EnvParams):
    n_hazards: int = 1

    RANGES: ClassVar[Dict[str, Tuple[float, float]]] = {
        **EnvParams.RANGES, "n_hazards": (1, 16)}


@dataclasses.dataclass(frozen=True)
class FreewayParams(EnvParams):
    car_speed: int = 1

    RANGES: ClassVar[Dict[str, Tuple[float, float]]] = {
        **EnvParams.RANGES, "car_speed": (1, 3)}


@dataclasses.dataclass(frozen=True)
class DodgeParams(EnvParams):
    spawn_prob: float = 0.25     # per-column obstacle spawn probability

    RANGES: ClassVar[Dict[str, Tuple[float, float]]] = {
        **EnvParams.RANGES, "spawn_prob": (0.0, 0.9)}


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
    # vector observations: observe(state) -> (W, obs_dim) float32 in [0, 1]
    observe: Optional[Callable[[State], torch.Tensor]] = None
    obs_dim: int = 0
    params: Optional[EnvParams] = None
    reward_range: Tuple[float, float] = (-1.0, 1.0)


def _full(like: torch.Tensor, value: int) -> torch.Tensor:
    """An int32 (W,) tensor of ``value``, one per key of ``like`` (W, 2)."""
    return torch.full(like.shape[:-1], value, dtype=torch.int32,
                      device=like.device)


def _dx(a: torch.Tensor) -> torch.Tensor:
    """The reference's ``[-1, 0, 1][a]``: left, stay, right."""
    return a.to(torch.int32) - 1


def _signed(a: torch.Tensor, minus: int, plus: int) -> torch.Tensor:
    """-1 where ``a == minus``, +1 where ``a == plus``, else 0 (int32):
    a lookup table's column without building the table on the device."""
    return (a == plus).to(torch.int32) - (a == minus).to(torch.int32)


def _dirs(device) -> torch.Tensor:
    """The reference's ``jnp.array([-1, 1])``."""
    return torch.arange(-1, 2, 2, dtype=torch.int32, device=device)


def _f32(*parts: torch.Tensor) -> torch.Tensor:
    """Concatenate (W,) or (W, ...) parts into one (W, D) float32 vector
    per env, each part flattened in row-major order."""
    W = parts[0].shape[0]
    return torch.cat([p.to(torch.float32).reshape(W, -1) for p in parts],
                     dim=1)


def _div(x: torch.Tensor, d: int) -> torch.Tensor:
    """float32 ``x / d`` as the reference's compiled program computes it:
    XLA turns a division by a constant into a product with its float32
    reciprocal, which rounds differently from a true division."""
    recip = float(np.float32(1) / np.float32(d))
    return x.to(torch.float32) * recip


def _draw_paddle(g: torch.Tensor, paddle_x: torch.Tensor, hw: int) -> None:
    """Channel 1 of the bottom row of (W, n, n, C) grids: the cells within
    ``hw`` of each env's paddle."""
    n = g.shape[1]
    cols = torch.arange(n, device=g.device)
    pad = torch.abs(cols[None, :] - paddle_x[:, None]) <= hw
    g[:, n - 1, :, 1] = pad.to(torch.float32)


def _rows(s: State) -> torch.Tensor:
    """The batch index (W,) for an indexed write over the batch."""
    t = s["t"]
    return torch.arange(t.shape[0], device=t.device)


# ---------------------------------------------------------------------------
# Catch: the ball falls from the top; a 3-action paddle on the bottom row.
# ---------------------------------------------------------------------------

def _make_catch(p: CatchParams) -> EnvSpec:
    n, hw = p.size, p.paddle_width // 2
    max_steps = p.max_steps or 2 * n

    def reset(keys: torch.Tensor) -> State:
        k = rng.split(keys)
        return {
            "ball_x": rng.randint(k[..., 0, :], (), 0, n),
            "ball_y": _full(keys, 0),
            "paddle_x": rng.randint(k[..., 1, :], (), 0, n),
            "t": _full(keys, 0),
        }

    def step(s: State, a: torch.Tensor, keys: torch.Tensor):
        dx = _dx(a)
        paddle = torch.clamp(s["paddle_x"] + dx, 0, n - 1)
        ball_y = s["ball_y"] + p.ball_speed
        done = ball_y >= n - 1
        caught = torch.abs(s["ball_x"] - paddle) <= hw
        reward = torch.where(done, torch.where(caught, 1.0, -1.0), 0.0)
        ns = {"ball_x": s["ball_x"], "ball_y": torch.clamp(ball_y, max=n - 1),
              "paddle_x": paddle, "t": s["t"] + 1}
        return ns, reward.to(torch.float32), done

    def render(s: State) -> torch.Tensor:
        W, dev = s["t"].shape[0], s["t"].device
        g = torch.zeros((W, n, n, 2), dtype=torch.float32, device=dev)
        g[_rows(s), s["ball_y"].long(), s["ball_x"].long(), 0] = 1.0
        _draw_paddle(g, s["paddle_x"], hw)
        return g

    def observe(s: State) -> torch.Tensor:
        return _div(_f32(s["ball_x"], s["ball_y"], s["paddle_x"]), n - 1)

    return EnvSpec("catch", 3, 2, max_steps, reset, step, render, size=n,
                   observe=observe, obs_dim=3, params=p)


# ---------------------------------------------------------------------------
# Breakout: a bouncing ball, a paddle, rows of bricks.
# ---------------------------------------------------------------------------

def _make_breakout(p: BreakoutParams) -> EnvSpec:
    n, rows, hw = p.size, p.brick_rows, p.paddle_width // 2
    max_steps = p.max_steps or 50 * n

    def reset(keys: torch.Tensor) -> State:
        k = rng.split(keys)
        W = keys.shape[0]
        return {
            "ball_x": rng.randint(k[..., 0, :], (), 0, n),
            "ball_y": _full(keys, rows),
            "dx": rng.choice(k[..., 1, :], _dirs(keys.device)),
            "dy": _full(keys, 1),
            "paddle_x": _full(keys, n // 2),
            "bricks": torch.ones((W, rows, n), dtype=torch.bool,
                                 device=keys.device),
            "t": _full(keys, 0),
        }

    def step(s: State, a: torch.Tensor, keys: torch.Tensor):
        dxa = _dx(a)
        paddle = torch.clamp(s["paddle_x"] + dxa, 0, n - 1)
        # move the ball; bounce off the side walls
        nx = s["ball_x"] + s["dx"]
        dx = torch.where((nx < 0) | (nx >= n), -s["dx"], s["dx"])
        nx = torch.clamp(nx, 0, n - 1)
        ny = s["ball_y"] + s["dy"]
        dy = torch.where(ny < 0, -s["dy"], s["dy"])
        ny_c = torch.clamp(ny, 0, n - 1)
        # brick hit (rows 1..rows)
        row = ny_c - 1
        in_bricks = (row >= 0) & (row < rows)
        rc = torch.clamp(row, 0, rows - 1)
        b = _rows(s)
        at = s["bricks"][b, rc.long(), nx.long()]
        hit = in_bricks & at
        bricks = s["bricks"].clone()
        bricks[b, rc.long(), nx.long()] = torch.where(hit, False, at)
        dy = torch.where(hit, -dy, dy)
        reward = torch.where(hit, 1.0, 0.0)
        # paddle bounce on the bottom row
        at_bottom = ny_c >= n - 1
        on_paddle = torch.abs(nx - paddle) <= hw
        dy = torch.where(at_bottom & on_paddle, -torch.abs(dy), dy)
        done = ((at_bottom & ~on_paddle) | ~bricks.flatten(1).any(dim=1)
                | (s["t"] >= max_steps))
        ns = {"ball_x": nx, "ball_y": ny_c, "dx": dx, "dy": dy,
              "paddle_x": paddle, "bricks": bricks, "t": s["t"] + 1}
        return ns, reward.to(torch.float32), done

    def render(s: State) -> torch.Tensor:
        W, dev = s["t"].shape[0], s["t"].device
        g = torch.zeros((W, n, n, 3), dtype=torch.float32, device=dev)
        g[_rows(s), s["ball_y"].long(), s["ball_x"].long(), 0] = 1.0
        _draw_paddle(g, s["paddle_x"], hw)
        g[:, 1:rows + 1, :, 2] = s["bricks"].to(torch.float32)
        return g

    def observe(s: State) -> torch.Tensor:
        return _f32(
            _div(s["ball_x"], n - 1), _div(s["ball_y"], n - 1),
            _div(s["dx"] + 1, 2), _div(s["dy"] + 1, 2),
            _div(s["paddle_x"], n - 1), s["bricks"])

    return EnvSpec("breakout", 3, 3, max_steps, reset, step, render, size=n,
                   observe=observe, obs_dim=5 + rows * n, params=p)


# ---------------------------------------------------------------------------
# Pong (squash): the ball bounces off three walls; the paddle guards the
# bottom row.
# ---------------------------------------------------------------------------

def _make_pong(p: PongParams) -> EnvSpec:
    n, hw = p.size, p.paddle_width // 2
    max_steps = p.max_steps or 50 * n

    def reset(keys: torch.Tensor) -> State:
        k = rng.split(keys)
        return {
            "ball_x": rng.randint(k[..., 0, :], (), 1, n - 1),
            "ball_y": _full(keys, 1),
            "dx": rng.choice(k[..., 1, :], _dirs(keys.device)),
            "dy": _full(keys, 1),
            "paddle_x": _full(keys, n // 2),
            "t": _full(keys, 0),
        }

    def step(s: State, a: torch.Tensor, keys: torch.Tensor):
        dxa = _dx(a)
        paddle = torch.clamp(s["paddle_x"] + dxa, 0, n - 1)
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
        W, dev = s["t"].shape[0], s["t"].device
        g = torch.zeros((W, n, n, 2), dtype=torch.float32, device=dev)
        g[_rows(s), s["ball_y"].long(), s["ball_x"].long(), 0] = 1.0
        _draw_paddle(g, s["paddle_x"], hw)
        return g

    def observe(s: State) -> torch.Tensor:
        return _f32(
            _div(s["ball_x"], n - 1), _div(s["ball_y"], n - 1),
            _div(s["dx"] + 1, 2), _div(s["dy"] + 1, 2),
            _div(s["paddle_x"], n - 1))

    return EnvSpec("pong", 3, 2, max_steps, reset, step, render, size=n,
                   observe=observe, obs_dim=5, params=p)


# ---------------------------------------------------------------------------
# Seeker: reach the goal, avoid the random-walking hazards.
# ---------------------------------------------------------------------------

def _moves(a: torch.Tensor) -> torch.Tensor:
    """The reference's ``_MOVES[a]`` for ``_MOVES`` = [[0, 0], [-1, 0],
    [1, 0], [0, -1], [0, 1]]: (..., 2) int32 steps."""
    return torch.stack([_signed(a, 1, 2), _signed(a, 3, 4)], dim=-1)


def _make_seeker(p: SeekerParams) -> EnvSpec:
    n, nh = p.size, p.n_hazards
    max_steps = p.max_steps or 20 * n

    def reset(keys: torch.Tensor) -> State:
        k = rng.split(keys, 3)
        return {
            "agent": rng.randint(k[..., 0, :], (2,), 0, n),
            "goal": rng.randint(k[..., 1, :], (2,), 0, n),
            "hazard": rng.randint(k[..., 2, :], (nh, 2), 0, n),
            "t": _full(keys, 0),
        }

    def step(s: State, a: torch.Tensor, keys: torch.Tensor):
        k = rng.split(keys)
        agent = torch.clamp(s["agent"] + _moves(a), 0, n - 1)
        hz_mv = _moves(rng.randint(k[..., 0, :], (nh,), 0, 5))
        hazard = torch.clamp(s["hazard"] + hz_mv, 0, n - 1)
        reached = (agent == s["goal"]).all(dim=-1)
        hit = (agent[:, None, :] == hazard).all(dim=-1).any(dim=-1)
        reward = (torch.where(reached, 1.0, 0.0)
                  - torch.where(hit, 1.0, 0.0))
        goal = torch.where(reached[:, None],
                           rng.randint(k[..., 1, :], (2,), 0, n), s["goal"])
        done = hit | (s["t"] >= max_steps)
        ns = {"agent": agent, "goal": goal, "hazard": hazard,
              "t": s["t"] + 1}
        return ns, reward.to(torch.float32), done

    def render(s: State) -> torch.Tensor:
        W, dev = s["t"].shape[0], s["t"].device
        g = torch.zeros((W, n, n, 3), dtype=torch.float32, device=dev)
        b = _rows(s)
        ag, go, hz = (s[f].long() for f in ("agent", "goal", "hazard"))
        g[b, ag[:, 0], ag[:, 1], 0] = 1.0
        g[b, go[:, 0], go[:, 1], 1] = 1.0
        g[b[:, None], hz[..., 0], hz[..., 1], 2] = 1.0
        return g

    def observe(s: State) -> torch.Tensor:
        return _div(_f32(s["agent"], s["goal"], s["hazard"]), n - 1)

    return EnvSpec("seeker", 5, 3, max_steps, reset, step, render, size=n,
                   observe=observe, obs_dim=4 + 2 * nh, params=p)


# ---------------------------------------------------------------------------
# Freeway: cross the lanes of moving cars; +1 per crossing, -1 per hit.
# ---------------------------------------------------------------------------

def _make_freeway(p: FreewayParams) -> EnvSpec:
    n, speed = p.size, p.car_speed
    lanes = n - 2                        # rows 1..n-2 carry one car each
    center = n // 2                      # the agent climbs a fixed column
    max_steps = p.max_steps or 25 * n

    def reset(keys: torch.Tensor) -> State:
        return {
            "row": _full(keys, n - 1),
            "cars": rng.randint(keys, (lanes,), 0, n),
            "t": _full(keys, 0),
        }

    def step(s: State, a: torch.Tensor, keys: torch.Tensor):
        dev = a.device
        lane_ix = torch.arange(lanes, dtype=torch.int32, device=dev)
        dirs = torch.where(lane_ix % 2 == 0, 1, -1).to(torch.int32)
        move = _signed(a, 1, 2)                        # stay / up / down
        row = torch.clamp(s["row"] + move, 0, n - 1)
        cars = (s["cars"] + dirs * speed) % n
        in_lane = (row >= 1) & (row <= n - 2)
        lane = torch.clamp(row - 1, 0, lanes - 1)
        hit = in_lane & (cars[_rows(s), lane.long()] == center)
        reached = row == 0
        reward = torch.where(reached, 1.0, torch.where(hit, -1.0, 0.0))
        row = torch.where(reached | hit, n - 1, row)    # teleport home
        done = s["t"] >= max_steps
        ns = {"row": row, "cars": cars, "t": s["t"] + 1}
        return ns, reward.to(torch.float32), done

    def render(s: State) -> torch.Tensor:
        W, dev = s["t"].shape[0], s["t"].device
        g = torch.zeros((W, n, n, 2), dtype=torch.float32, device=dev)
        b = _rows(s)
        g[b, s["row"].long(), center, 0] = 1.0
        lane_rows = 1 + torch.arange(lanes, device=dev)
        g[b[:, None], lane_rows[None, :], s["cars"].long(), 1] = 1.0
        return g

    def observe(s: State) -> torch.Tensor:
        return _div(_f32(s["row"], s["cars"]), n - 1)

    return EnvSpec("freeway", 3, 2, max_steps, reset, step, render, size=n,
                   observe=observe, obs_dim=1 + lanes, params=p)


# ---------------------------------------------------------------------------
# Dodge: obstacles rain down; survive (+0.1 a step) or collide (-1, done).
# ---------------------------------------------------------------------------

def _make_dodge(p: DodgeParams) -> EnvSpec:
    n, prob = p.size, p.spawn_prob
    max_steps = p.max_steps or 20 * n

    def reset(keys: torch.Tensor) -> State:
        return {
            "paddle_x": rng.randint(keys, (), 0, n),
            "grid": torch.zeros((keys.shape[0], n, n), dtype=torch.bool,
                                device=keys.device),
            "t": _full(keys, 0),
        }

    def step(s: State, a: torch.Tensor, keys: torch.Tensor):
        dx = _dx(a)
        paddle = torch.clamp(s["paddle_x"] + dx, 0, n - 1)
        new_row = rng.uniform(keys, (n,)) < prob
        grid = torch.cat([new_row[:, None, :], s["grid"][:, :-1]], dim=1)
        hit = grid[_rows(s), n - 1, paddle.long()]
        reward = torch.where(hit, -1.0, 0.1)
        done = hit | (s["t"] >= max_steps)
        ns = {"paddle_x": paddle, "grid": grid, "t": s["t"] + 1}
        return ns, reward.to(torch.float32), done

    def render(s: State) -> torch.Tensor:
        W, dev = s["t"].shape[0], s["t"].device
        g = torch.zeros((W, n, n, 2), dtype=torch.float32, device=dev)
        g[_rows(s), n - 1, s["paddle_x"].long(), 0] = 1.0
        g[..., 1] = s["grid"].to(torch.float32)
        return g

    def observe(s: State) -> torch.Tensor:
        return _f32(_div(s["paddle_x"], n - 1), s["grid"])

    return EnvSpec("dodge", 3, 2, max_steps, reset, step, render, size=n,
                   observe=observe, obs_dim=1 + n * n, params=p)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

GAMES: Dict[str, Tuple[type, Callable[[EnvParams], EnvSpec]]] = {
    "catch": (CatchParams, _make_catch),
    "breakout": (BreakoutParams, _make_breakout),
    "pong": (PongParams, _make_pong),
    "seeker": (SeekerParams, _make_seeker),
    "freeway": (FreewayParams, _make_freeway),
    "dodge": (DodgeParams, _make_dodge),
}


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
    if isinstance(params, (CatchParams, BreakoutParams, PongParams)):
        _require(params.paddle_width % 2 == 1, name,
                 f"paddle_width={params.paddle_width} must be odd", cls)
        _require(params.paddle_width <= n, name,
                 f"paddle_width={params.paddle_width} must fit the grid "
                 f"(size={n})", cls)
    if isinstance(params, CatchParams):
        _require(params.ball_speed <= n - 1, name,
                 f"ball_speed={params.ball_speed} must be < size", cls)
    if isinstance(params, BreakoutParams):
        _require(params.brick_rows <= n - 3, name,
                 f"brick_rows={params.brick_rows} must leave room for the "
                 f"ball and paddle (<= size-3 = {n - 3})", cls)
    if isinstance(params, SeekerParams):
        _require(params.n_hazards <= n * n // 4, name,
                 f"n_hazards={params.n_hazards} must be <= size*size/4", cls)
    return build(params)


ENVS: Dict[str, EnvSpec] = {name: make_env(name) for name in GAMES}


def get_env(name: str, **overrides: Any) -> EnvSpec:
    """The default-parameter spec from the registry; overrides build a
    fresh one."""
    if overrides:
        return make_env(name, **overrides)
    if name not in ENVS:
        raise ValueError(
            f"unknown env {name!r}; available: {sorted(ENVS)}")
    return ENVS[name]


def step_autoreset(spec: EnvSpec, state: State, action: torch.Tensor,
                   keys: torch.Tensor):
    """Step; where an episode ends, the next state is a fresh reset (the
    returned reward and done describe the finished episode). Each key
    splits once into (step, reset) halves."""
    k = rng.split(keys)
    ns, reward, done = spec.step(state, action, k[..., 0, :])
    fresh = spec.reset(k[..., 1, :])

    def pick(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
        d = done.reshape(done.shape + (1,) * (old.dim() - 1))
        return torch.where(d, new, old)

    ns = {f: pick(ns[f], fresh[f]) for f in ns}
    return ns, reward, done
