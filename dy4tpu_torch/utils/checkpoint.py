"""Checkpoint / resume of the streaming receiver: the counterpart of
``dy4tpu/utils/checkpoint.py``, in the same file format.

A checkpoint is one compressed npz: every array leaf of the state as
``leaf_<i>``, in NamedTuple depth-first field order with None subtrees
skipped (the order of ``jax.tree.flatten``), the pickled host-side
decoder state as ``host`` and a pickled ``meta`` dict.  dy4tpu also
stores its pickled JAX treedef (``treedef``), which cannot be unpickled
without JAX; the port writes the leaves' field paths (``paths``, a plain
string array) instead, and ``load`` fills a template state of the port's
own types, so it reads files of both packages.  Host state pickled by
dy4tpu names ``dy4tpu.rds.*`` classes; they are read as their copies in
``dy4tpu_torch.rds``, so the port never imports ``dy4tpu``.

.. warning::
   Checkpoints are **trusted input only**.  The host-decoder and meta
   payloads are pickled (host state holds live decoder objects), so
   ``load()`` on a file from an untrusted source is arbitrary code
   execution: the same trust model as a pickle or torch checkpoint.
   Never pass user-supplied files to ``--resume``.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Optional

import numpy as np
import torch


def _leaves(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(field path, leaf) of every non-None leaf, depth first."""
    out = []
    for name, v in zip(tree._fields, tree):
        if v is None:
            continue
        if hasattr(v, "_fields"):
            out += _leaves(v, prefix + name + ".")
        else:
            out.append((prefix + name, v))
    return out


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _fill(tree, it):
    """``tree`` with its non-None leaves replaced from ``it`` in order."""
    vals = []
    for v in tree:
        if v is None:
            vals.append(None)
        elif hasattr(v, "_fields"):
            vals.append(_fill(v, it))
        else:
            vals.append(next(it))
    return type(tree)(*vals)


class _PortUnpickler(pickle.Unpickler):
    """Reads host state pickled by either package: ``dy4tpu.*`` classes
    resolve to their copies under ``dy4tpu_torch``."""

    def find_class(self, module: str, name: str):
        if module == "dy4tpu" or module.startswith("dy4tpu."):
            module = "dy4tpu_torch" + module[len("dy4tpu"):]
        return super().find_class(module, name)


def _unpickle(a: np.ndarray):
    return _PortUnpickler(io.BytesIO(a.tobytes())).load()


def save(path: str, state: Any, *, host_state: Optional[dict] = None,
         meta: Optional[dict] = None) -> None:
    """Write ``state`` (a NamedTuple tree of tensors or arrays) and
    optional host-side objects to ``path`` (.npz)."""
    leaves = _leaves(state)
    payload = {f"leaf_{i}": _numpy(v) for i, (_, v) in enumerate(leaves)}
    payload["paths"] = np.array([k for k, _ in leaves], dtype=np.str_)
    payload["host"] = np.frombuffer(pickle.dumps(host_state or {}),
                                    np.uint8)
    payload["meta"] = np.frombuffer(pickle.dumps(meta or {}), np.uint8)
    buf = io.BytesIO()
    np.savez_compressed(buf, **payload)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def holds(path: str, field: str, template: Any) -> bool:
    """Whether the file at ``path`` holds the subtree ``field`` of
    ``template`` (a state that has it, e.g. ``iqcorr``): by the leaves'
    field paths in a port file, by their count in a dy4tpu file, which
    has none."""
    with np.load(path, allow_pickle=False) as z:
        if "paths" in z.files:
            return any(str(p).startswith(field + ".") for p in z["paths"])
        n = sum(1 for k in z.files if k.startswith("leaf_"))
    return n == len(_leaves(template))


def load(path: str, template: Any) -> tuple[Any, dict, dict]:
    """Returns ``(state, host_state, meta)``: ``template`` (a state of the
    port's types, e.g. ``receiver.init_state(...)``) with its leaves
    filled from the file, each on its template leaf's device.  Raises
    ``ValueError`` when the file's leaves do not match the template's in
    count, field path (port files), shape or dtype.  A ``treedef`` entry
    (dy4tpu's files) is ignored.

    Unpickles the host/meta payloads: only load files this process (or a
    trusted peer) wrote; see the module warning.
    """
    want = _leaves(template)
    with np.load(path, allow_pickle=False) as z:
        host = _unpickle(z["host"])
        meta = _unpickle(z["meta"])
        n = sum(1 for k in z.files if k.startswith("leaf_"))
        got = [z[f"leaf_{i}"] for i in range(n)]
        paths = list(z["paths"]) if "paths" in z.files else None
    if n != len(want):
        raise ValueError(f"{path}: {n} state leaves, the template has "
                         f"{len(want)} ({[k for k, _ in want]})")
    if paths is not None and paths != [k for k, _ in want]:
        raise ValueError(f"{path}: leaves {paths}, the template has "
                         f"{[k for k, _ in want]}")
    leaves = []
    for (key, t), a in zip(want, got):
        leaf = torch.from_numpy(a.copy())
        t = torch.as_tensor(t)
        if leaf.shape != t.shape or leaf.dtype != t.dtype:
            raise ValueError(f"{path}: leaf {key} is {leaf.dtype}"
                             f"{list(leaf.shape)}, the template's "
                             f"{t.dtype}{list(t.shape)}")
        leaves.append(leaf.to(t.device))
    return _fill(template, iter(leaves)), host, meta
