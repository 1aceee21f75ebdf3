"""Checkpointing: a tree of tensors <-> ``.npz`` with a structure manifest.

Counterpart of ``repro.checkpoint.store``.  A checkpoint is the whole train
state: the parameters, the optimizer state, the step and every entry of
the consensus state (``x_tilde``, ``m_agg``, the push-sum ``ps_w`` and
``ps_nbr``, the async in-flight ``fly_self`` / ``fly_up`` / ``fly_dn``).
ADC-DGD is stateful across iterations, so a run resumed from it replays
the uninterrupted one bit for bit: the same noise ``(seed, step, node)``,
loss masks, stride and membership epoch, all keyed by the step.

Layout: ``<dir>/step_<k>.npz`` with keys ``leaf_<i>`` (leaves in JAX's
flattening order, ``core.tree``) and ``manifest``, a JSON object of
``step``, ``n_leaves``, ``treedef``, ``shapes`` and ``dtypes``, written to
a temporary file and then renamed.  ``treedef`` is the port's own tree
description (the reference's is a JAX treedef string), so parity with a
reference checkpoint is by leaf order, shape and dtype.  A Python ``int``
or ``float`` leaf (the step) is stored as a 32-bit scalar, the type the
reference's state holds it in.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch

from repro_torch.core import tree as T

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, bool):
        return np.asarray(leaf)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float32)
    return np.asarray(leaf)


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.npz")


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Write ``tree`` as ``<directory>/step_<step>.npz``; returns the
    path."""
    os.makedirs(directory, exist_ok=True)
    leaves, treedef = T.tree_flatten(tree)
    arrays = {f"leaf_{i}": _to_numpy(l) for i, l in enumerate(leaves)}
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "treedef": repr(treedef),
        "shapes": [list(a.shape) for a in arrays.values()],
        "dtypes": [str(a.dtype) for a in arrays.values()],
    }
    path = _path(directory, step)
    tmp = path + ".tmp.npz"
    np.savez(tmp, manifest=json.dumps(manifest), **arrays)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> int | None:
    """The highest step saved in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"step_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def load_checkpoint(directory: str, template: Any, step: int | None = None,
                    device=None) -> tuple[Any, int]:
    """Load step ``step`` (default the latest) into the structure of
    ``template``, whose leaves' shapes and dtypes it must match.  Tensors
    go to ``device``, else to the device of their template leaf; scalar
    leaves come back as the template's Python type.  Returns (tree,
    step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    leaves, treedef = T.tree_flatten(template)
    with np.load(_path(directory, step), allow_pickle=False) as z:
        manifest = json.loads(str(z["manifest"]))
        if manifest["n_leaves"] != len(leaves):
            raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                             f"template has {len(leaves)}")
        if manifest["treedef"] != repr(treedef):
            raise ValueError("checkpoint treedef does not match template")
        out = []
        for i, ref in enumerate(leaves):
            arr = z[f"leaf_{i}"]
            want = _to_numpy(ref) if not torch.is_tensor(ref) else None
            shape = tuple(ref.shape) if want is None else want.shape
            dtype = (str(ref.dtype).removeprefix("torch.") if want is None
                     else str(want.dtype))
            if tuple(arr.shape) != shape or str(arr.dtype) != dtype:
                raise ValueError(f"leaf {i}: {arr.dtype}{list(arr.shape)} != "
                                 f"template {dtype}{list(shape)}")
            if want is not None:
                out.append(type(ref)(arr.item()))
            else:
                # np.load reads an npz member into a fresh, writable array
                out.append(torch.from_numpy(arr).to(
                    ref.device if device is None else device))
    return T.tree_unflatten(treedef, out), step
