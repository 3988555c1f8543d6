""".npz checkpointing of tensor trees: the port of
``repro.checkpoint.ckpt``, in the same file layout.

A tree (nested dicts, tuples and NamedTuples of tensors) is flattened to
path-keyed arrays, and restored into the structure of a template, with
its tensors placed on a chosen ``device``, or, as the reference places
them on shardings, each spread over the template's DTensor mesh by the
``placements`` given (``distribute_tensor``), so a checkpoint written on
one mesh restores onto another. A DTensor leaf is saved whole: every
rank gathers it and rank 0 writes. Steps are kept under
``<dir>/step_<n>.npz``.

The layout is the JAX package's, byte for byte in names, shapes and
dtypes, so a checkpoint written by either package restores in the other:

* paths come from :func:`_flatten`: dict keys sorted, ``__<i>`` for each
  tuple or NamedTuple position, ``/`` between levels;
* the port holds PRNG keys as ``(..., 2)`` int64 tensors of uint32 words
  (``rng.py``); JAX, without 64-bit mode, holds no 64-bit array at all,
  and its keys are uint32. So an int64 leaf is written as uint32 (its
  values must fit) and read back widened to the template's int64. Every
  other dtype is written as it is held;
* a population carry (``core.population``) is the concurrent carry with
  a leading replica axis on every leaf, in both packages, so it needs
  nothing more: its template (``PopulationTrainer.init_template``)
  gives the paths and the (P, ...) shapes.

Durability contract (checkpoints are what a policy server boots from,
not only a resume convenience):

* writes are atomic AND durable: tmp file, ``fsync`` before the rename,
  ``os.replace``, then an fsync of the directory so the rename itself
  survives a power cut;
* a failed write never leaks its tmp file into the checkpoint dir;
* :func:`restore_latest` walks down from the newest step past any
  checkpoint that cannot be restored (truncated, corrupt, partial), so
  one torn file never blocks ``--resume`` or a policy server boot;
  callers get the skipped paths back to warn about.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import zipfile
import zlib
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

SEP = "/"

# What a truncated or corrupt .npz surfaces as: zipfile errors on a torn
# archive, zlib, value and EOF errors on a torn member, OSError on
# unreadable files; ValueError also covers template mismatches
# (restore_latest reports every skipped path, so callers can tell a torn
# file from a structural error).
RESTORE_ERRORS = (OSError, ValueError, EOFError, KeyError,
                  zipfile.BadZipFile, zlib.error)

_WORD = 0xFFFFFFFF


def _flatten(tree: Any, prefix: str = "",
             leaf=lambda node: False) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict) and not leaf(tree):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}{SEP}", leaf)
    elif isinstance(tree, (tuple, list)) and not leaf(tree):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}__{i}{SEP}", leaf)
    else:
        yield prefix.rstrip(SEP), tree


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def _disk_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a tensor of ``dtype`` is written as: uint32 for
    the int64 key words, the tensor's own dtype otherwise."""
    if dtype == torch.int64:
        return np.dtype(np.uint32)
    return _np_dtype(dtype)


def _to_host(leaves: List[torch.Tensor]) -> List[np.ndarray]:
    """Every leaf as a numpy array, through ONE device-to-host copy: the
    leaves' bytes are laid end to end (each from an 8-byte boundary) in
    one uint8 buffer on their device, copied once, and split on the
    host."""
    if not leaves:
        return []
    devices = {str(t.device) for t in leaves}
    if len(devices) > 1:
        raise ValueError(f"checkpoint leaves span devices {sorted(devices)}")
    parts, spans, off = [], [], 0
    for t in leaves:
        raw = t.detach().reshape(-1).view(torch.uint8)
        pad = -off % 8
        if pad:
            parts.append(torch.zeros(pad, dtype=torch.uint8, device=t.device))
            off += pad
        parts.append(raw)
        spans.append((off, raw.numel()))
        off += raw.numel()
    flat = torch.cat(parts).cpu().numpy()
    return [flat[o:o + n].view(_np_dtype(t.dtype)).reshape(tuple(t.shape))
            for t, (o, n) in zip(leaves, spans)]


def _narrow(path: str, a: np.ndarray) -> np.ndarray:
    if a.dtype != np.int64:
        return a
    if a.size and (a.min() < 0 or a.max() > _WORD):
        raise ValueError(
            f"checkpoint leaf {path!r} is int64 with values outside uint32: "
            "the port holds only PRNG key words as int64")
    return a.astype(np.uint32)


def _whole(leaf):
    """A DTensor leaf gathered whole (a collective: every rank calls it)."""
    from repro_torch.kernels.route import is_sharded
    return leaf.full_tensor() if is_sharded(leaf) else leaf


def _writer() -> bool:
    """Whether this process writes: rank 0 of a process group, or the
    only process."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    flat = [(p, _whole(leaf)) for p, leaf in _flatten(tree)]
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    if not _writer():
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    host = _to_host([leaf for _, leaf in flat])
    arrays = {p: _narrow(p, a) for (p, _), a in zip(flat, host)}
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            # flush to stable storage BEFORE the rename: os.replace is
            # atomic in the namespace but says nothing about the data;
            # without this a crash can leave a fully named step_*.npz
            # holding truncated bytes, which latest_step() then selects
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # never leak the tmp file into the checkpoint dir
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(ckpt_dir)
    return path


def _fsync_dir(path: str) -> None:
    """Make a completed rename durable (best effort where a directory
    cannot be opened or fsynced)."""
    try:
        dfd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


def _unflatten_into(template: Any, arrays, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], arrays, f"{prefix}{k}{SEP}")
                for k in template}
    if isinstance(template, (tuple, list)):
        vals = [_unflatten_into(v, arrays, f"{prefix}__{i}{SEP}")
                for i, v in enumerate(template)]
        if hasattr(template, "_fields"):
            # NamedTuples (TrainerCarry, SamplerState, ...) take their
            # fields positionally, not as one iterable
            return type(template)(*vals)
        return type(template)(vals)
    return arrays[prefix.rstrip(SEP)]


def restore_checkpoint(ckpt_dir: str, step: int, template: Any,
                       device=None, placements: Optional[Any] = None) -> Any:
    """The checkpoint at ``step`` in the structure of ``template`` (whose
    leaves give each tensor's shape and dtype; meta tensors will do), on
    ``device`` (the CPU when None). With ``placements`` (a tree like the
    template's of DTensor placements, one per mesh dim) each leaf is
    spread over its template leaf's mesh (the template's leaves are
    DTensors then), on the mesh's device."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    want = dict(_flatten(template))
    if set(want) != set(arrays):
        # name the paths rather than fail with a KeyError deep inside
        # _unflatten_into (launchers also guard with the stored spec,
        # check_resume_compat, which gives a field-level diff first)
        missing = sorted(set(want) - set(arrays))
        extra = sorted(set(arrays) - set(want))
        detail = []
        if missing:
            detail.append(f"missing from checkpoint: {missing[:8]}")
        if extra:
            detail.append(f"not in template: {extra[:8]}")
        raise ValueError(
            f"checkpoint {path} does not match the restore template "
            f"({'; '.join(detail)}) — was it written by a run with a "
            "different spec?")
    wrong = [f"{p}: {arrays[p].dtype}{list(arrays[p].shape)}, template "
             f"{_disk_dtype(t.dtype)}{list(t.shape)}"
             for p, t in sorted(want.items())
             if arrays[p].dtype != _disk_dtype(t.dtype)
             or arrays[p].shape != tuple(t.shape)]
    if wrong:
        raise ValueError(
            f"checkpoint {path} does not match the restore template "
            f"(dtype or shape: {wrong[:8]}) — was it written by a run with "
            "a different spec?")
    dev = torch.device("cpu") if device is None else torch.device(device)
    placed = {} if placements is None else dict(_flatten(placements,
                                                          leaf=_is_placed))
    held = {}
    for p, t in want.items():
        a = torch.from_numpy(arrays[p].astype(np.int64)
                             if t.dtype == torch.int64 else arrays[p])
        if p in placed:
            from torch.distributed.tensor import distribute_tensor
            mesh = t.device_mesh
            held[p] = distribute_tensor(a.to(mesh.device_type), mesh,
                                        list(placed[p]))
        else:
            held[p] = a.to(dev)
    return _unflatten_into(template, held)


def _is_placed(node) -> bool:
    """A placements leaf: a list or tuple of DTensor placements."""
    from torch.distributed.tensor import Placement
    return (isinstance(node, (list, tuple)) and len(node) > 0
            and all(isinstance(x, Placement) for x in node))


def list_steps(ckpt_dir: str) -> List[int]:
    """All checkpointed step numbers in ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                  if (m := re.match(r"step_(\d+)\.npz$", f)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def prune_steps(ckpt_dir: str, keep_last: int = 1) -> List[str]:
    """Delete all but the newest ``keep_last`` checkpoints and return the
    removed paths. Never removes the newest file, so a concurrent
    ``restore_latest`` always has its first candidate intact."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    removed: List[str] = []
    for step in list_steps(ckpt_dir)[:-keep_last]:
        path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
        try:
            os.unlink(path)
        except OSError:
            continue
        removed.append(path)
    return removed


def trim_metrics_jsonl(path: str, start_cycle: int) -> None:
    """Drop metrics rows with cycle > start_cycle (and any torn trailing
    line an interrupted run left), so a resumed loop never writes two
    rows per (cycle, replica). The trimmed copy is written to a tmp file
    in the same directory, fsynced and renamed over the original: an
    interrupt mid-trim leaves the full history intact."""
    kept = []
    with open(path) as f:
        for ln in f:
            try:
                row = json.loads(ln)
            except ValueError:
                continue
            if row.get("cycle", 0) <= start_cycle:
                kept.append(ln)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".metrics-", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.writelines(kept)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def restore_latest(ckpt_dir: str, template: Any, device=None,
                   placements: Optional[Any] = None
                   ) -> Tuple[Optional[int], Any, List[str]]:
    """Restore the newest *restorable* checkpoint.

    Walks down from the latest step; a checkpoint that fails to restore
    (a torn write, a truncated copy, a structural mismatch) is skipped
    and the walk goes on to the previous step. Returns ``(step, tree,
    skipped)``, where ``skipped`` lists ``"<path>: <error>"`` for every
    file passed over; callers MUST surface these. ``(None, None,
    skipped)`` when nothing restores."""
    skipped: List[str] = []
    for step in reversed(list_steps(ckpt_dir)):
        path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
        try:
            return step, restore_checkpoint(ckpt_dir, step, template,
                                            device, placements), skipped
        except RESTORE_ERRORS as e:
            skipped.append(f"{path}: {type(e).__name__}: {e}")
    return None, None, skipped
