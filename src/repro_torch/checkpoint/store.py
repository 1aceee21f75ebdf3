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

Over ranks (``ctx``, a process context of ``models.sharding``: one
consensus node per rank, every tensor leaf holding the rank's row) the
checkpoint is still the global state, as the reference saves
``jax.device_get(state)``: rank 0 gathers every rank's row over the group
one leaf at a time and writes the one file, byte for byte the stacked
run's for the same run (every member is dated the zip format's first day,
so a file is a function of the state alone).  Rank 0 holds one leaf of
every node at a time, where the stacked save holds the whole state.  A
load with ``ctx`` reads each rank's own row of every leaf straight from
the file's bytes, so a ring run starts from a stacked checkpoint and the
other way round.  Python scalar leaves (the step) are the same on every
rank and stored once.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import struct
import zipfile
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

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


def _write_npz(path: str, members) -> None:
    """``np.savez``'s layout (uncompressed zip of ``<key>.npy`` members)
    from ``(key, array, bf16)`` triples, each taken from ``members`` only
    when it is written; a ``bf16`` member is written under the descr
    BF16_DESCR."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, a, is_bf16 in members:
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if not is_bf16:
                    np.lib.format.write_array(f, np.asanyarray(a),
                                              allow_pickle=False)
                    continue
                a = np.ascontiguousarray(a)
                np.lib.format.write_array_header_1_0(f, {
                    "descr": BF16_DESCR, "fortran_order": False,
                    "shape": a.shape})
                f.write(a.tobytes())


def _ring(ctx) -> bool:
    if ctx is not None and ctx.tp > 1:
        raise NotImplementedError(
            f"tp={ctx.tp}: checkpoints of a tensor-parallel grid are not yet "
            "ported (ROADMAP Queue 1 item 5d)")
    return ctx is not None and ctx.process_ring


def save_checkpoint(directory: str, step: int, tree: Any,
                    ctx=None) -> str:
    """Write ``tree`` as ``<directory>/step_<step>.npz``; returns the
    path.  With a process context ``ctx`` every rank calls it with its
    rows, and rank 0 writes the global state (:func:`_gathered`)."""
    leaves, treedef = T.tree_flatten(tree)
    if _ring(ctx):
        n = ctx.total_consensus_nodes
        # shapes and dtypes from each leaf's empty slice: nothing gathered
        heads = [_to_numpy(l[:0]) if torch.is_tensor(l) else _to_numpy(l)
                 for l in leaves]
        shapes = [[n, *a.shape[1:]] if torch.is_tensor(l) else list(a.shape)
                  for a, l in zip(heads, leaves)]
        arrays = _gathered(leaves, ctx)
    else:
        heads = [_to_numpy(l) for l in leaves]
        shapes = [list(a.shape) for a in heads]
        arrays = iter(heads)
    bf16 = [_is_bf16(l) for l in leaves]
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "treedef": repr(treedef),
        "shapes": shapes,
        "dtypes": [BF16_NAME if b else str(a.dtype)
                   for a, b in zip(heads, bf16)],
    }
    path = _path(directory, step)
    if _ring(ctx) and ctx.rank != 0:
        for _ in arrays:                # the gathers rank 0 takes part in
            pass
    else:
        del heads
        os.makedirs(directory, exist_ok=True)
        tmp = path + ".tmp.npz"
        _write_npz(tmp, itertools.chain(
            [("manifest", np.asarray(json.dumps(manifest)), False)],
            ((f"leaf_{i}", a, b) for i, (a, b) in
             enumerate(zip(arrays, bf16)))))
        os.replace(tmp, path)
    if _ring(ctx):                      # the file is there for every rank
        dist.barrier(group=ctx.group)
    return path


def _gathered(leaves: list, ctx):
    """Yield every leaf of the global state in order, one at a time: a
    tensor leaf's rows gathered from every rank to rank 0 as raw bytes
    over the group (``dist.gather``, so every dtype crosses bit for bit),
    a scalar leaf as this rank holds it.  Every rank must take every
    item; only rank 0's items hold the gathered rows (the others yield
    None for a tensor leaf)."""
    n, root = ctx.total_consensus_nodes, ctx.rank == 0
    for leaf in leaves:
        if not torch.is_tensor(leaf):
            yield _to_numpy(leaf)
            continue
        row = leaf.detach().to("cpu").contiguous().reshape(-1)
        row = row.view(torch.uint8)
        rows = torch.empty((n, row.numel()), dtype=torch.uint8) if root \
            else None
        dist.gather(row, list(rows) if root else None, dst=0,
                    group=ctx.group)
        del row
        yield (_to_numpy(rows.view(leaf.dtype).reshape(
            (n, *leaf.shape[1:]))) if root else None)
        del rows


def latest_step(directory: str) -> int | None:
    """The highest step saved in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"step_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def _member_row(path: str, key: str, row: int) -> np.ndarray:
    """Row ``row`` of the leading axis of the npz member ``key`` (stored,
    uncompressed), read from its bytes alone: the member's local header
    gives where its ``.npy`` starts, the ``.npy`` header its shape and
    dtype.  Returns ``(1, *shape[1:])`` (a bfloat16 member as its raw
    2-byte words, dtype ``V2``)."""
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo(key + ".npy")
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{path}: member {key} is compressed")
    with open(path, "rb") as f:
        # the 30-byte local file header ends with the name's and the
        # extra field's lengths; the member's bytes follow both
        f.seek(info.header_offset)
        name_len, extra_len = struct.unpack("<HH", f.read(30)[26:])
        f.seek(name_len + extra_len, os.SEEK_CUR)
        version = np.lib.format.read_magic(f)
        shape, fortran, dtype = (np.lib.format.read_array_header_1_0(f)
                                 if version == (1, 0) else
                                 np.lib.format.read_array_header_2_0(f))
        if fortran or not shape or not 0 <= row < shape[0]:
            raise ValueError(f"{path}: member {key} of shape {shape} has "
                             f"no row {row}")
        n = int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize
        f.seek(row * n, os.SEEK_CUR)
        data = f.read(n)
    return np.frombuffer(bytearray(data), dtype=dtype).reshape(
        (1, *shape[1:]))


def load_checkpoint(directory: str, template: Any, step: int | None = None,
                    device=None, ctx=None) -> tuple[Any, int]:
    """Load step ``step`` (default the latest) into the structure of
    ``template``, whose leaves' shapes and dtypes it must match.  Tensors
    go to ``device``, else to the device of their template leaf; scalar
    leaves come back as the template's Python type.  With a process
    context ``ctx`` the template holds this rank's rows and every tensor
    leaf comes back as the rank's row of the file's (each read alone).
    Returns (tree, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    leaves, treedef = T.tree_flatten(template)
    path = _path(directory, step)
    ring = _ring(ctx)
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["manifest"]))
        if manifest["n_leaves"] != len(leaves):
            raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                             f"template has {len(leaves)}")
        if manifest["treedef"] != repr(treedef) and not \
                manifest["treedef"].startswith(JAX_TREEDEF):
            raise ValueError("checkpoint treedef does not match template")
        out = []
        for i, ref in enumerate(leaves):
            if ring and torch.is_tensor(ref):
                if manifest["shapes"][i][:1] != [ctx.total_consensus_nodes]:
                    raise ValueError(
                        f"leaf {i}: {manifest['shapes'][i]} holds no row "
                        f"per node of {ctx.total_consensus_nodes}")
                arr = _member_row(path, f"leaf_{i}", ctx.rank)
            else:
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
