"""The mesh context: the purpose of the reference's ``compat.set_mesh``
and ``get_abstract_mesh`` (its other shims cover JAX versions and have
no counterpart here).

``use_mesh(mesh)`` installs a ``DeviceMesh`` as the ambient mesh for the
code it wraps; ``current_mesh()`` returns it, or None outside any
``use_mesh``. The expert-parallel MoE reads it, as the reference's reads
the abstract mesh. The mesh is the process's, not the thread's: the
autograd engine runs a backward (and a checkpointed block's recomputed
forward) on threads of its own, which must see the mesh the forward saw.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List, Optional

_lock = threading.Lock()
_meshes: List[object] = []


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[None]:
    """Make ``mesh`` the ambient mesh inside the ``with`` block."""
    with _lock:
        _meshes.append(mesh)
    try:
        yield
    finally:
        with _lock:
            _meshes.pop()


def current_mesh() -> Optional[object]:
    """The innermost ``use_mesh``'s mesh, None outside any."""
    with _lock:
        return _meshes[-1] if _meshes else None
