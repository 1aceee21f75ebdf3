"""Dequant-combine: the receive side of the ADC-DGD exchange.

Port of ``repro.kernels.dequant_combine``.  One call decodes the self /
left / right int8 operands and applies the shadow update and the ring
combine::

    x_tilde' = x_tilde + deamp * dec(self)
    m_agg'   = m_agg + (w_side * deamp) * (dec(left) + dec(right))
    combined = w_self * x_tilde' + m_agg'

``dequant_combine_payload`` (``dequant_combine_payload_pallas``) decodes
three wire payloads; ``dequant_combine`` (``dequant_combine_pallas``) three
pairs of codes and scales, as the per-leaf reference transport ships them.

Both dispatch on the device of their operands: CPU tensors take the plain
PyTorch version, CUDA tensors launch the hand-written kernel
(``csrc/dequant_combine_payload.cu``, ``csrc/dequant_combine_blocks.cu``)
or raise, ``meta`` tensors (a dry run) get empty outputs; every call
reports its bytes to an active ``launch.op_cost`` counter.
``dequant_combine_payload.launches`` and ``dequant_combine.launches``
count kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.launch.op_cost import kernel_call

from . import _build, ref
from .quantize import (BLOCK, SCALE_BYTES, _check_rows, _into, _out_rows,
                       chunk_rows, chunk_view, combine_bytes, on_meta,
                       unpack_payload)

__all__ = ["dequant_combine_payload_plain", "dequant_combine_payload",
           "dequant_combine_plain", "dequant_combine"]


def dequant_combine_payload_plain(payload_self, payload_left, payload_right,
                                  x_tilde, m_agg, w_self: float,
                                  w_side: float, deamp: float,
                                  row_offset: int = 0,
                                  n_rows: int | None = None):
    """Plain PyTorch version on the chunk's rows: unpack the three payloads
    and run ``dequant_combine_ref``.  Runs on any device."""
    n = chunk_view(x_tilde.shape[0], n_rows, row_offset)
    dec = [unpack_payload(chunk_rows(p, row_offset, n), x_tilde.shape[1])
           for p in (payload_self, payload_left, payload_right)]
    return ref.dequant_combine_ref(
        *dec[0], *dec[1], *dec[2], chunk_rows(x_tilde, row_offset, n),
        chunk_rows(m_agg, row_offset, n), w_self, w_side, deamp)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/dequant_combine_payload.cu (built at
    first use)."""
    fn = _build.load("dequant_combine_payload").dequant_combine_payload_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dequant_combine_payload(payload_self, payload_left, payload_right,
                            x_tilde, m_agg, w_self: float, w_side: float,
                            deamp: float, row_offset: int = 0,
                            n_rows: int | None = None, out=None):
    """Fused decode + shadow update + ring combine.

    Payloads are ``(n or n_full, BLOCK + 4)`` uint8, shadows ``(n or
    n_full, BLOCK)`` float32, where ``n_full = x_tilde.shape[0]`` and the
    static ``row_offset``/``n_rows`` chunk view picks ``n`` rows: operands
    of chunk height are read from row 0, full-height ones at
    ``row_offset``.  Returns (x_tilde', m_agg', combined), each
    ``(n, BLOCK)`` float32: fresh tensors, or the three of ``out`` (e.g.
    row slices of full-height buffers) written in place."""
    n_full = x_tilde.shape[0]
    n = chunk_view(n_full, n_rows, row_offset)
    pays = (payload_self, payload_left, payload_right)
    for name, p in zip(("payload_self", "payload_left", "payload_right"),
                       pays):
        _check_rows(name, p, BLOCK + SCALE_BYTES, n, n_full, (torch.uint8,))
    for name, a in (("x_tilde", x_tilde), ("m_agg", m_agg)):
        _check_rows(name, a, BLOCK, n, n_full, (torch.float32,))
    operands = (*pays, x_tilde, m_agg)
    with kernel_call("dequant_combine_payload",
                     combine_bytes(n, BLOCK + SCALE_BYTES)):
        if all(a.device.type == "cpu" for a in operands):
            return _into(out, dequant_combine_payload_plain(
                *pays, x_tilde, m_agg, w_self, w_side, deamp, row_offset,
                n_rows))
        if on_meta(*operands):
            return _out_rows("dequant_combine_payload", out or (None,) * 3,
                             (n, BLOCK), torch.float32, x_tilde.device)
        return _payload_launch(operands, w_self, w_side, deamp, row_offset,
                               n, out)


def _payload_launch(operands, w_self, w_side, deamp, row_offset, n, out):
    x_tilde = operands[3]
    dev = x_tilde.device
    if dev.type != "cuda" or any(a.device != dev for a in operands):
        raise ValueError("dequant_combine_payload: operands on "
                         f"{sorted({str(a.device) for a in operands})}; all "
                         "must be on one CUDA device (or all on the CPU)")
    if not all(a.is_contiguous() for a in operands):
        raise ValueError("dequant_combine_payload: CUDA operands must be "
                         "contiguous")

    def at(a):
        r0 = 0 if a.shape[0] == n else row_offset
        return a.data_ptr() + r0 * a.stride(0) * a.element_size()

    outs = _out_rows("dequant_combine_payload", out or (None,) * 3,
                     (n, BLOCK), torch.float32, dev, align=16)
    err = _kernel()(
        *(at(a) for a in operands), *(o.data_ptr() for o in outs), n,
        float(np.float32(w_self)),
        float(np.float32(w_side) * np.float32(deamp)),
        float(np.float32(deamp)),
        torch.cuda.current_stream(dev).cuda_stream)
    dequant_combine_payload.launches += 1
    if err != 0:
        raise RuntimeError(f"dequant_combine_payload kernel launch failed: "
                           f"CUDA error {err}")
    return outs


dequant_combine_payload.launches = 0


#: plain PyTorch version of ``dequant_combine``: runs on any device
dequant_combine_plain = ref.dequant_combine_ref


@functools.lru_cache(maxsize=None)
def _blocks_kernel():
    """The C entry point of csrc/dequant_combine_blocks.cu (built at first
    use)."""
    fn = _build.load("dequant_combine_blocks").dequant_combine_blocks_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [
        ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dequant_combine(codes_self, scale_self, codes_left, scale_left,
                    codes_right, scale_right, x_tilde, m_agg, w_self: float,
                    w_side: float, deamp: float):
    """Fused decode of three (codes ``(n, BLOCK)`` int8, scales ``(n, 1)``
    f32) pairs + shadow update + ring combine on ``(n, BLOCK)`` f32
    shadows.  Returns (x_tilde', m_agg', combined), each ``(n, BLOCK)``
    float32."""
    n = x_tilde.shape[0]
    codes = (codes_self, codes_left, codes_right)
    scales = (scale_self, scale_left, scale_right)
    for side, c, s in zip(("self", "left", "right"), codes, scales):
        _check_rows(f"codes_{side}", c, BLOCK, n, n, (torch.int8,))
        _check_rows(f"scale_{side}", s, 1, n, n, (torch.float32,))
    for name, a in (("x_tilde", x_tilde), ("m_agg", m_agg)):
        _check_rows(name, a, BLOCK, n, n, (torch.float32,))
    operands = (codes_self, scale_self, codes_left, scale_left, codes_right,
                scale_right, x_tilde, m_agg)
    with kernel_call("dequant_combine",
                     combine_bytes(n, BLOCK + SCALE_BYTES)):
        if all(a.device.type == "cpu" for a in operands):
            return dequant_combine_plain(*operands, w_self, w_side, deamp)
        if on_meta(*operands):
            return tuple(torch.empty((n, BLOCK), dtype=torch.float32,
                                     device=x_tilde.device)
                         for _ in range(3))
        return _blocks_launch(operands, w_self, w_side, deamp, n)


def _blocks_launch(operands, w_self, w_side, deamp, n):
    dev = operands[6].device
    if dev.type != "cuda" or any(a.device != dev for a in operands):
        raise ValueError("dequant_combine: operands on "
                         f"{sorted({str(a.device) for a in operands})}; all "
                         "must be on one CUDA device (or all on the CPU)")
    if not all(a.is_contiguous() for a in operands):
        raise ValueError("dequant_combine: CUDA operands must be contiguous")
    outs = tuple(torch.empty((n, BLOCK), dtype=torch.float32, device=dev)
                 for _ in range(3))
    err = _blocks_kernel()(
        *(a.data_ptr() for a in operands), *(o.data_ptr() for o in outs), n,
        float(np.float32(w_self)),
        float(np.float32(w_side) * np.float32(deamp)),
        float(np.float32(deamp)),
        torch.cuda.current_stream(dev).cuda_stream)
    dequant_combine.launches += 1
    if err != 0:
        raise RuntimeError(f"dequant_combine kernel launch failed: CUDA "
                           f"error {err}")
    return outs


dequant_combine.launches = 0
