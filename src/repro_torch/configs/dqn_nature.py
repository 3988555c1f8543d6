"""The Nature-DQN network geometry (Mnih et al. 2015) and the off-policy
variant presets: the port's copy of ``repro.configs.dqn_nature``."""

import dataclasses
from typing import Tuple

from repro_torch.config import VariantConfig


@dataclasses.dataclass(frozen=True)
class NatureCNNConfig:
    frame_size: int = 84
    frame_stack: int = 4
    # >0: the per-frame observation is a flat state vector (fc-only trunk)
    vector_dim: int = 0
    # (out_channels, kernel, stride) per conv layer
    convs: Tuple[Tuple[int, int, int], ...] = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
    hidden: int = 512
    n_actions: int = 18
    dueling: bool = False
    num_atoms: int = 1
    v_min: float = -10.0
    v_max: float = 10.0
    noisy: bool = False
    noisy_sigma0: float = 0.5


CONFIG = NatureCNNConfig()

NET_PRESETS = ("auto", "nature", "small", "tiny", "mlp", "mlp_tiny")


def cnn_geometry(net: str, frame_size: int, n_actions: int,
                 obs_dim: int = 0) -> NatureCNNConfig:
    """The variant-free network geometry a preset names. ``auto`` picks
    ``small`` for 10x10 frames, the exact Nature stack for 84x84 and
    ``mlp`` for vector observations."""
    if net == "auto":
        if obs_dim > 0:
            net = "mlp"
        else:
            net = "small" if frame_size == 10 else "nature"
    if net in ("mlp", "mlp_tiny"):
        if obs_dim <= 0:
            raise ValueError(
                f"net preset {net!r} consumes vector observations; it "
                "needs the env's obs_dim (obs_mode='vector' in the "
                "ExperimentSpec)")
        hidden = 128 if net == "mlp" else 32
        return NatureCNNConfig(
            frame_size=frame_size, frame_stack=2, convs=(),
            hidden=hidden, n_actions=n_actions, vector_dim=obs_dim)
    if net == "nature":
        return NatureCNNConfig(
            frame_size=frame_size, frame_stack=4,
            convs=((32, 8, 4), (64, 4, 2), (64, 3, 1)), hidden=512,
            n_actions=n_actions)
    if net == "small":
        return NatureCNNConfig(
            frame_size=frame_size, frame_stack=2,
            convs=((16, 3, 1), (16, 3, 1)), hidden=64, n_actions=n_actions)
    if net == "tiny":
        return NatureCNNConfig(
            frame_size=frame_size, frame_stack=2, convs=((8, 3, 1),),
            hidden=16, n_actions=n_actions)
    raise KeyError(f"unknown net preset {net!r}; available: {NET_PRESETS}")


def cnn_config_for(variant: VariantConfig, base: NatureCNNConfig = CONFIG,
                   **overrides) -> NatureCNNConfig:
    """The head selection a variant implies: dueling, noisy, and the C51
    atom grid."""
    return dataclasses.replace(
        base, dueling=variant.dueling, noisy=variant.noisy,
        noisy_sigma0=variant.noisy_sigma0,
        num_atoms=variant.num_atoms if variant.distributional else 1,
        v_min=variant.v_min, v_max=variant.v_max, **overrides)


VARIANTS = {
    "dqn": VariantConfig(name="dqn"),
    "double": VariantConfig(name="double", double=True),
    "dueling": VariantConfig(name="dueling", dueling=True),
    "per": VariantConfig(name="per", prioritized=True),
    "c51": VariantConfig(name="c51", distributional=True),
    "noisy": VariantConfig(name="noisy", noisy=True),
    "rainbow_lite": VariantConfig(name="rainbow_lite", double=True,
                                  dueling=True, prioritized=True, n_step=3),
    "rainbow": VariantConfig(name="rainbow", double=True, dueling=True,
                             prioritized=True, n_step=3, distributional=True,
                             noisy=True),
}


def get_variant(name: str) -> VariantConfig:
    try:
        return VARIANTS[name]
    except KeyError:
        raise KeyError(
            f"unknown variant {name!r}; available: {sorted(VARIANTS)}") from None
