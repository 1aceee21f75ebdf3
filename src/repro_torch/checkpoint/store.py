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
reference checkpoint is by leaf order, shape and dtype: the port loads a
reference checkpoint (its treedef a ``PyTreeDef(...)`` string) by those,
since both packages flatten a tree in the same order.  The reference's
loader compares treedef strings, so it refuses the port's files.  A Python ``int``
or ``float`` leaf (the step) is stored as a 32-bit scalar, the type the
reference's state holds it in.  A bfloat16 leaf is stored as the
reference stores one (numpy has no bfloat16; the reference's arrays are
``ml_dtypes.bfloat16``): an ``.npy`` member of descr ``'<V2'``, raw
2-byte words, with ``"bfloat16"`` in the manifest's ``dtypes``.  The
port writes and reads such members without ``ml_dtypes``, so either
package loads the other's bfloat16 checkpoints bit for bit.
"""
from __future__ import annotations

import json
import os
import re
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.core import tree as T

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]


#: the ``.npy`` descr and manifest name of a bfloat16 leaf (the
#: reference's, through ``ml_dtypes``)
BF16_DESCR, BF16_NAME = "<V2", "bfloat16"
#: how the reference's treedef strings start
JAX_TREEDEF = "PyTreeDef("


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as numpy; a bfloat16 tensor as its raw 2-byte words
    (``int16``)."""
    if torch.is_tensor(leaf):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy()
        return leaf.numpy()
    if isinstance(leaf, bool):
        return np.asarray(leaf)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float32)
    return np.asarray(leaf)


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.npz")


def _is_bf16(leaf) -> bool:
    return torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16


def _write_npz(path: str, members: dict, bf16: set) -> None:
    """``np.savez``'s layout (uncompressed zip of ``<key>.npy`` members),
    with the members named in ``bf16`` written under the descr
    BF16_DESCR."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, a in members.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if key not in bf16:
                    np.lib.format.write_array(f, np.asanyarray(a),
                                              allow_pickle=False)
                    continue
                a = np.ascontiguousarray(a)
                np.lib.format.write_array_header_1_0(f, {
                    "descr": BF16_DESCR, "fortran_order": False,
                    "shape": a.shape})
                f.write(a.tobytes())


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Write ``tree`` as ``<directory>/step_<step>.npz``; returns the
    path."""
    os.makedirs(directory, exist_ok=True)
    leaves, treedef = T.tree_flatten(tree)
    arrays = {f"leaf_{i}": _to_numpy(l) for i, l in enumerate(leaves)}
    bf16 = {f"leaf_{i}" for i, l in enumerate(leaves) if _is_bf16(l)}
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "treedef": repr(treedef),
        "shapes": [list(a.shape) for a in arrays.values()],
        "dtypes": [BF16_NAME if k in bf16 else str(a.dtype)
                   for k, a in arrays.items()],
    }
    path = _path(directory, step)
    tmp = path + ".tmp.npz"
    _write_npz(tmp, {"manifest": np.asarray(json.dumps(manifest)),
                     **arrays}, bf16)
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
        if manifest["treedef"] != repr(treedef) and not \
                manifest["treedef"].startswith(JAX_TREEDEF):
            raise ValueError("checkpoint treedef does not match template")
        out = []
        for i, ref in enumerate(leaves):
            arr = z[f"leaf_{i}"]
            have = str(arr.dtype)
            if manifest["dtypes"][i] == BF16_NAME and arr.dtype.itemsize == 2:
                # raw 2-byte words (numpy reads the '<V2' descr as 'V2')
                have, arr = BF16_NAME, arr.view(np.int16)
            want = _to_numpy(ref) if not torch.is_tensor(ref) else None
            shape = tuple(ref.shape) if want is None else want.shape
            dtype = (str(ref.dtype).removeprefix("torch.") if want is None
                     else str(want.dtype))
            if tuple(arr.shape) != shape or have != dtype:
                raise ValueError(f"leaf {i}: {have}{list(arr.shape)} != "
                                 f"template {dtype}{list(shape)}")
            if want is not None:
                out.append(type(ref)(arr.item()))
            else:
                # np.load reads an npz member into a fresh, writable array
                t = torch.from_numpy(arr)
                if have == BF16_NAME:
                    t = t.view(torch.bfloat16)
                out.append(t.to(ref.device if device is None else device))
    return T.tree_unflatten(treedef, out), step
