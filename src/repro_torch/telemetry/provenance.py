"""Run provenance: enough metadata to interpret a recorded number later
(a copy of ``repro.telemetry.provenance``).

A committed ``BENCH_<n>.json`` or a trace file is only evidence if it
says *what produced it*: which commit (and whether the tree was dirty),
on what machine, under which interpreter. :func:`provenance` gathers
that once, best-effort — every field degrades to ``None`` rather than
raising, because recording a benchmark must never fail on a machine
without git or /proc.
"""

from __future__ import annotations

import os
import platform
import subprocess
import sys
from typing import Dict, Optional

__all__ = ["provenance", "git_sha", "git_dirty", "cpu_model"]


def _git(args, cwd: Optional[str] = None) -> Optional[str]:
    try:
        out = subprocess.run(["git"] + args, cwd=cwd, timeout=10,
                             capture_output=True, text=True)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return out.stdout.strip()


def git_sha(cwd: Optional[str] = None) -> Optional[str]:
    """The current commit SHA, or None outside a git checkout."""
    return _git(["rev-parse", "HEAD"], cwd=cwd)


def git_dirty(cwd: Optional[str] = None) -> Optional[bool]:
    """True when tracked files differ from HEAD (the recorded number
    may not be reproducible from the SHA alone); None without git."""
    out = _git(["status", "--porcelain", "--untracked-files=no"], cwd=cwd)
    return None if out is None else bool(out)


def cpu_model(cpuinfo: str = "/proc/cpuinfo") -> Optional[str]:
    """The CPU model string (Linux /proc/cpuinfo), falling back to
    ``platform.processor()``; None when neither says anything."""
    try:
        with open(cpuinfo) as f:
            for line in f:
                # "model name" on x86, "Hardware" on ARM SoCs; never the
                # bare "processor"/"model" lines (those are indices)
                if line.lower().startswith(("model name", "hardware")):
                    _, _, value = line.partition(":")
                    if value.strip():
                        return value.strip()
    except OSError:
        pass
    return platform.processor() or None


def provenance(cwd: Optional[str] = None) -> Dict[str, object]:
    """One JSON-able dict identifying this run's code + machine.

    Keys: ``git_sha``, ``git_dirty``, ``platform``, ``cpu_model``,
    ``python_version``, ``hostname``. Framework fields (the torch and
    CUDA versions, the card) are *not* gathered here, so importing
    telemetry starts no CUDA context; the launchers add them beside
    this dict (``repro_torch.telemetry.device_meta``).
    """
    cwd = cwd or os.getcwd()
    return {
        "git_sha": git_sha(cwd),
        "git_dirty": git_dirty(cwd),
        "platform": platform.platform(),
        "cpu_model": cpu_model(),
        "python_version": sys.version.split()[0],
        "hostname": platform.node() or None,
    }
