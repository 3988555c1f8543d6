"""What a trace's header records of the framework and the card, beside
:func:`~repro_torch.telemetry.provenance.provenance` (which gathers no
framework field, as the reference's does not)."""

from __future__ import annotations

import subprocess
from typing import Any, Dict, Optional

import torch

__all__ = ["device_meta", "gpu_name_and_power_limit"]


def gpu_name_and_power_limit(index: int = 0) -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    for card ``index`` (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"), or None
    where nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def device_meta(device) -> Dict[str, Any]:
    """The torch and CUDA versions and the device a run uses; on a card
    also its name and power limit as nvidia-smi gives them (``gpu``),
    since a card below its 700 W maximum runs slower under load."""
    dev = torch.device(device)
    meta: Dict[str, Any] = {"torch": torch.__version__,
                            "cuda": torch.version.cuda, "device": str(dev)}
    if dev.type == "cuda":
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        meta["gpu"] = gpu_name_and_power_limit(index)
    return meta
