"""`ExperimentSpec`, one declarative run description: the port of
``repro.api.spec`` (parsing, validation, config derivation and run-spec
storage; sweeps stay with ROADMAP.md queue 1 item 9). The JSON
schema is the reference's, so every committed spec file parses
unchanged. The run spec is stored beside a run's checkpoints
(``save_run_spec``, canonical JSON byte for byte as the reference writes
it), and ``--resume`` is refused with a field-level diff when the
requested spec no longer describes the stored run
(``check_resume_compat``)."""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Optional

from repro_torch.config import DQNConfig, ExecConfig, VariantConfig

__all__ = ["MODES", "ScheduleSpec", "AlgoSpec", "CheckpointSpec",
           "MetricsSpec", "ExperimentSpec", "SpecCompatError",
           "spec_compat_diff", "check_resume_compat", "save_run_spec",
           "load_run_spec", "RUN_SPEC_FILENAME"]

MODES = ("baseline", "synchronized", "concurrent", "population")

# written beside the checkpoints, so --resume can check that the
# requested spec still describes the run that produced the carry
RUN_SPEC_FILENAME = "spec.json"


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    cycles: int = 60
    cycle_steps: int = 256
    prepopulate: int = 2048
    eval_every: int = 20
    eval_episodes: int = 64


@dataclasses.dataclass(frozen=True)
class AlgoSpec:
    minibatch_size: int = 32
    replay_capacity: int = 16384
    train_period: int = 2
    discount: float = 0.9
    optimizer: str = "adamw"
    learning_rate: float = 0.0       # 0.0 = the optimizer's default
    eps_anneal_steps: int = 0        # 0 = cycles * cycle_steps // 2


@dataclasses.dataclass(frozen=True)
class CheckpointSpec:
    dir: Optional[str] = None
    every: int = 20


@dataclasses.dataclass(frozen=True)
class MetricsSpec:
    jsonl: Optional[str] = None


def _default_exec() -> ExecConfig:
    return ExecConfig(compute_dtype="float32", kernel_backend="auto")


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    env: str = "catch"
    env_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    mode: str = "population"
    variant: VariantConfig = VariantConfig()
    envs: int = 8
    obs_mode: str = "pixels"
    frame_size: int = 10
    net: str = "auto"
    seed: int = 0
    seeds: int = 1
    schedule: ScheduleSpec = ScheduleSpec()
    algo: AlgoSpec = AlgoSpec()
    checkpoint: CheckpointSpec = CheckpointSpec()
    metrics: MetricsSpec = MetricsSpec()
    exec: ExecConfig = dataclasses.field(default_factory=_default_exec)

    def validate(self) -> None:
        from repro_torch.configs.dqn_nature import NET_PRESETS
        from repro_torch.envs.games import make_env
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; one of {MODES}")
        env = make_env(self.env, **self.env_params)
        if self.obs_mode not in ("pixels", "vector"):
            raise ValueError(
                f"unknown obs_mode {self.obs_mode!r}; one of "
                "('pixels', 'vector')")
        if self.net not in NET_PRESETS:
            raise ValueError(
                f"unknown net {self.net!r}; one of {NET_PRESETS}")
        mlp_net = self.net in ("mlp", "mlp_tiny")
        if self.obs_mode == "vector" and not (mlp_net or self.net == "auto"):
            raise ValueError(
                f"obs_mode='vector' feeds flat state vectors; net "
                f"{self.net!r} is a conv preset — use net='auto', 'mlp' "
                "or 'mlp_tiny'")
        if self.obs_mode == "pixels" and mlp_net:
            raise ValueError(
                f"net {self.net!r} consumes vector observations; set "
                "obs_mode='vector' (or pick a conv preset)")
        if self.obs_mode == "pixels":
            if self.net == "auto" and self.frame_size not in (10, 84):
                raise ValueError(
                    f"net='auto' resolves on frame_size 10 or 84, got "
                    f"{self.frame_size}; pick an explicit net preset")
            if self.frame_size == 84 and env.size != 10:
                raise ValueError(
                    f"frame_size=84 assumes a 10x10 grid (8x upscale); "
                    f"env {self.env!r} with size={env.size} renders "
                    f"natively — set frame_size={env.size}")
            if self.frame_size not in (84, env.size):
                raise ValueError(
                    f"frame_size={self.frame_size} matches neither the "
                    f"env grid (size={env.size}) nor the 84x84 Nature "
                    "geometry")
        if self.algo.optimizer not in ("adamw", "rmsprop"):
            raise ValueError(
                f"unknown optimizer {self.algo.optimizer!r}; "
                "one of ('adamw', 'rmsprop')")
        for name, v in (("envs", self.envs), ("seeds", self.seeds),
                        ("cycles", self.schedule.cycles),
                        ("cycle_steps", self.schedule.cycle_steps),
                        ("minibatch_size", self.algo.minibatch_size),
                        ("replay_capacity", self.algo.replay_capacity),
                        ("train_period", self.algo.train_period),
                        ("schedule.eval_every", self.schedule.eval_every),
                        ("schedule.eval_episodes",
                         self.schedule.eval_episodes),
                        ("checkpoint.every", self.checkpoint.every)):
            if v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
        self.variant.validate()

    def obs_dim(self) -> int:
        """The env's state-vector width under obs_mode='vector', else 0."""
        if self.obs_mode != "vector":
            return 0
        from repro_torch.envs.games import make_env
        return make_env(self.env, **self.env_params).obs_dim

    def cnn_config(self, n_actions: int):
        """The NatureCNNConfig this spec implies (geometry preset plus the
        variant's head selection)."""
        from repro_torch.configs.dqn_nature import cnn_config_for, cnn_geometry
        base = cnn_geometry(self.net, self.frame_size, n_actions,
                            obs_dim=self.obs_dim())
        return cnn_config_for(self.variant, base)

    def dqn_config(self) -> DQNConfig:
        """The DQNConfig this spec implies: C is the cycle length and the
        ε anneal horizon defaults to half the run."""
        sched, algo = self.schedule, self.algo
        eps_anneal = algo.eps_anneal_steps or max(
            sched.cycles * sched.cycle_steps // 2, 1)
        from repro_torch.configs.dqn_nature import cnn_geometry
        frame_stack = cnn_geometry(self.net, self.frame_size, 1,
                                   obs_dim=self.obs_dim()).frame_stack
        return DQNConfig(
            minibatch_size=algo.minibatch_size,
            replay_capacity=algo.replay_capacity,
            target_update_period=sched.cycle_steps,
            train_period=algo.train_period,
            prepopulate=sched.prepopulate,
            n_envs=self.envs,
            frame_stack=frame_stack,
            eps_anneal_steps=eps_anneal,
            discount=algo.discount,
            concurrent=self.mode in ("concurrent", "population"),
            synchronized=self.mode != "baseline",
            variant=self.variant)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        """Canonical JSON: sorted keys, 2-space indent, trailing newline."""
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ExperimentSpec":
        return _build_dataclass(cls, data, path="")

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        data = json.loads(text)
        if not isinstance(data, dict):
            raise ValueError(
                f"spec JSON must be an object, got {type(data).__name__}")
        return cls.from_dict(data)


_NESTED = {
    "variant": VariantConfig,
    "schedule": ScheduleSpec,
    "algo": AlgoSpec,
    "checkpoint": CheckpointSpec,
    "metrics": MetricsSpec,
    "exec": ExecConfig,
}


def _build_dataclass(dc_type, data: Dict[str, Any], path: str):
    """A (possibly nested) frozen dataclass from a JSON dict. Unknown keys
    are an error, missing keys take the defaults, and ints given for
    float fields are coerced."""
    if not isinstance(data, dict):
        raise ValueError(f"spec field {path or '<root>'}: expected an "
                         f"object, got {type(data).__name__}")
    fields = {f.name: f for f in dataclasses.fields(dc_type)}
    unknown = sorted(set(data) - set(fields))
    if unknown:
        raise ValueError(
            f"unknown spec field(s) {', '.join(path + k for k in unknown)} "
            f"for {dc_type.__name__}; known: {sorted(fields)}")
    kwargs: Dict[str, Any] = {}
    for name, val in data.items():
        sub = _NESTED.get(name) if dc_type is ExperimentSpec else None
        if sub is not None:
            kwargs[name] = _build_dataclass(sub, val, f"{path}{name}.")
            continue
        default = fields[name].default
        if isinstance(default, bool):
            if not isinstance(val, bool):
                raise ValueError(f"spec field {path}{name}: expected a "
                                 f"bool, got {val!r}")
        elif isinstance(default, float) and isinstance(val, int) \
                and not isinstance(val, bool):
            val = float(val)
        kwargs[name] = val
    try:
        return dc_type(**kwargs)
    except TypeError as e:
        raise ValueError(f"invalid spec at {path or '<root>'}: {e}") from None


# ---------------------------------------------------------------------------
# Resume compatibility: the spec is stored beside the checkpoints, and a
# mismatched --resume fails with a field-level diff instead of a shape
# error deep inside the checkpoint restore.
# ---------------------------------------------------------------------------

class SpecCompatError(ValueError):
    """A resume request's spec does not describe the run that produced
    the stored checkpoints."""


# Fields that may differ between the stored and the requested spec
# without invalidating the carry: output paths, and schedule knobs that
# only extend or re-time the run.
_COMPAT_EXEMPT = {
    "checkpoint": None,                     # whole section
    "metrics": None,                        # whole section
    "schedule": {"cycles", "eval_every", "eval_episodes"},
}


def _compat_view(spec: ExperimentSpec) -> Dict[str, Any]:
    d = spec.to_dict()
    # materialise derived fields BEFORE dropping the exempt schedule
    # knobs: eps_anneal_steps=0 derives from cycles, so extending such a
    # run would change its ε schedule; the materialised value shows up
    # as an algo.eps_anneal_steps diff (pin it to make a run extendable)
    if d["algo"]["eps_anneal_steps"] == 0:
        d["algo"]["eps_anneal_steps"] = max(
            d["schedule"]["cycles"] * d["schedule"]["cycle_steps"] // 2, 1)
    for key, sub in _COMPAT_EXEMPT.items():
        if sub is None:
            d.pop(key, None)
        else:
            d[key] = {k: v for k, v in d[key].items() if k not in sub}
    return d


def spec_compat_diff(stored: ExperimentSpec,
                     requested: ExperimentSpec) -> List[str]:
    """Field-level differences that make ``requested`` incompatible with
    the run ``stored`` describes; empty when compatible."""
    diffs: List[str] = []

    def walk(a: Any, b: Any, path: str):
        if isinstance(a, dict) and isinstance(b, dict):
            for k in sorted(set(a) | set(b)):
                walk(a.get(k), b.get(k), f"{path}.{k}" if path else k)
            return
        if a != b:
            diffs.append(f"{path}: checkpoint={a!r}, requested={b!r}")

    walk(_compat_view(stored), _compat_view(requested), "")
    return diffs


def check_resume_compat(stored: ExperimentSpec,
                        requested: ExperimentSpec) -> None:
    """Raise :class:`SpecCompatError`, with the field-level diff, when
    ``requested`` cannot resume ``stored``'s carry."""
    diffs = spec_compat_diff(stored, requested)
    if diffs:
        raise SpecCompatError(
            "resume spec does not match the checkpointed run "
            f"({len(diffs)} field(s) differ):\n  " + "\n  ".join(diffs)
            + "\n(the stored spec lives in the checkpoint dir as "
            f"{RUN_SPEC_FILENAME}; pass a matching --spec/flags, or "
            "point --ckpt-dir at a fresh directory)")


def save_run_spec(ckpt_dir: str, spec: ExperimentSpec) -> str:
    """Write the resolved spec beside the checkpoints (canonical JSON).
    A stored compatible spec is left untouched, so a resumed run keeps
    the original file. A stored *incompatible* spec with checkpoints
    beside it is never overwritten: a later --resume would restore the
    old run's carry under the new run's description."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, RUN_SPEC_FILENAME)
    if os.path.exists(path):
        stored = load_run_spec(ckpt_dir)
        if stored is not None and not spec_compat_diff(stored, spec):
            return path
        has_ckpts = any(f.startswith("step_") and f.endswith(".npz")
                        for f in os.listdir(ckpt_dir))
        if stored is not None and has_ckpts:
            raise SpecCompatError(
                f"{ckpt_dir} already holds checkpoints from a run with a "
                "different spec:\n  "
                + "\n  ".join(spec_compat_diff(stored, spec))
                + "\npoint --ckpt-dir at a fresh directory (or delete the "
                "old run's step_*.npz + spec.json to reuse this one)")
    # atomic (tmp + rename), like the checkpoints: a run killed mid-write
    # must not leave a truncated spec.json
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        f.write(spec.to_json())
    os.replace(tmp, path)
    return path


def load_run_spec(ckpt_dir: str) -> Optional[ExperimentSpec]:
    """The spec stored beside the checkpoints, or None when there is
    none. An unreadable or corrupt file raises :class:`SpecCompatError`
    naming the path."""
    path = os.path.join(ckpt_dir, RUN_SPEC_FILENAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        text = f.read()
    try:
        return ExperimentSpec.from_json(text)
    except ValueError as e:
        raise SpecCompatError(
            f"stored run spec {path} is unreadable ({e}); delete it (and "
            "the step_*.npz checkpoints, if the run is dead) or restore "
            "it from the original --print-spec output") from None
