"""Checkpointing: atomic, resumable, in the reference's layout (the
reference's `training/checkpoint.py`).

Layout: <dir>/step_<n>/
    manifest.json   — step, leaf count, tree description, shapes, dtypes
    arrays.npz      — the leaves as `leaf_<i>`

The leaves are the reference's, in its order (`optimizer.tree_groups`: dict
keys sorted, a `QState`'s fields in turn, each per-layer tensor stacked on
a leading 'layers' axis), so either package restores the other's
checkpoint.  bfloat16 is not npz-serializable: it is stored as float32
(exactly) with the logical dtype in the manifest.

  * **atomic**: written to `tmp_step_<n>` then `os.replace`d — a crashed
    writer never corrupts the latest checkpoint.
  * **async**: `save(..., blocking=False)` hands the writing to a thread.
    The host copy is complete before `save` returns: the train step
    updates the parameters and moments in place, so a copy still in
    flight would take a later step's values.
  * `restore` writes the checkpoint into the tensors of `like` in place
    (the parameters are the model's own) and returns `like`.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.training.optimizer import tree_fill, tree_groups

__all__ = ["save", "restore", "latest_step", "wait_pending"]

_pending: list[threading.Thread] = []
_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
          torch.float64: "float64", torch.int8: "int8", torch.int32: "int32",
          torch.int64: "int64", torch.bool: "bool"}


def _to_numpy(tensors, stacked: bool):
    """One leaf on the host (the layers' tensors stacked; bfloat16 upcast
    losslessly to float32) and its logical dtype's name."""
    dt = tensors[0].dtype
    host = [t.detach().to("cpu", torch.float32 if dt == torch.bfloat16
                          else dt, copy=True).numpy() for t in tensors]
    return (np.stack(host) if stacked else host[0]), _NAMES[dt]


def _describe(state) -> str:
    """The tree's structure, for the manifest (restore checks the count)."""
    if torch.is_tensor(state):
        return "*"
    if isinstance(state, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(state[k])}"
                               for k in sorted(state)) + "}"
    if isinstance(state, tuple):
        return "(" + ", ".join(_describe(v) for v in state) + ")"
    return f"layers[{len(state)}]{_describe(state[0])}"


def save(ckpt_dir: str, step: int, state: Any, blocking: bool = True) -> str:
    pairs = [_to_numpy(ts, stacked) for ts, stacked in tree_groups(state)]
    host = [p[0] for p in pairs]
    logical_dtypes = [p[1] for p in pairs]
    treedef_str = _describe(state)

    def write():
        tmp = os.path.join(ckpt_dir, f"tmp_step_{step}")
        final = os.path.join(ckpt_dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": a for i, a in enumerate(host)})
        manifest = {
            "step": step,
            "num_leaves": len(host),
            "treedef": treedef_str,
            "shapes": [list(a.shape) for a in host],
            "dtypes": logical_dtypes,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)

    if blocking:
        write()
    else:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        _pending.append(t)
    return os.path.join(ckpt_dir, f"step_{step}")


def wait_pending():
    while _pending:
        _pending.pop().join()


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    """Write checkpoint `step` into the tensors of `like` (each keeps its
    device and dtype) and return `like`."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    groups = tree_groups(like)
    if manifest["num_leaves"] != len(groups):
        raise ValueError(f"{path} holds {manifest['num_leaves']} leaves, the "
                         f"state {len(groups)}: the tree structure changed")
    mine = [_NAMES[ts[0].dtype] for ts, _ in groups]
    if manifest["dtypes"] != mine:
        raise ValueError(f"{path} holds dtypes {manifest['dtypes']}, the "
                         f"state {mine}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        tree_fill(like, [torch.from_numpy(data[f"leaf_{i}"])
                         for i in range(len(groups))])
    return like
