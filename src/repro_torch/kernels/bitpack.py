"""Sub-byte bit-packed and top-k sparse wire codecs.

Port of ``repro.kernels.bitpack`` (``subbyte_encode_pallas``,
``subbyte_combine_pallas``, ``topk_encode_pallas``, ``topk_combine_pallas``).
Per ``BLOCK``-wide row of the packed differential:

* **sub-byte dense** (``int4`` / ``int2``): stochastic rounding onto a
  ``+-(2^(b-1) - 1)`` grid, codes biased to unsigned b-bit fields and packed
  ``8 // b`` per byte (low code first), then the 2 bytes of the bf16 scale:
  ``BLOCK // (8 // b) + 2`` bytes (258 for int4, 130 for int2);
* **top-k sparse** (``topk``): the row splits into ``k`` strata of ``g =
  BLOCK // k`` elements, each sends one element picked with probability
  proportional to ``|y|`` (an exponential race on noise columns ``[0,
  BLOCK)``) and scaled by the inverse of that probability, then rounded to
  int8 on noise columns ``[BLOCK, BLOCK + k)``: a ``BLOCK``-bit bitmap, ``k``
  int8 values and the 2 bf16 scale bytes, ``BLOCK // 8 + k + 2`` bytes.

Scales are rounded to bf16 before the rounding, so the receiver's grid is
bit for bit the sender's.  Adaptive scales round up one bf16 ulp where the
nearest bf16 fell below ``absmax / code_max`` (no row clips its maximum);
fixed grids use the bf16-rounded step.  Scale bytes are the bf16 image,
least significant byte first.

Each entry point dispatches on the device of its operands: CPU tensors take
the plain PyTorch version (``*_plain``), CUDA tensors launch the
hand-written kernel in ``csrc/`` or raise, and ``meta`` tensors (a dry
run) get empty outputs; every call reports its bytes to an active
``launch.op_cost`` counter.  ``<entry>.launches`` counts kernel launches.
Every transformation is row-local, so the static ``row_offset``/``n_rows``
chunk view of the int8 kernels carries over.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.launch.op_cost import kernel_call

from . import _build
from .quantize import (BLOCK, _check_noise, _check_rows, _into,
                       _noise_rows_ok, _out_rows, chunk_rows, chunk_view,
                       combine_bytes, encode_bytes, on_meta)
from .ref import combine_core

__all__ = [
    "SUB_SCALE_BYTES", "subbyte_code_max", "subbyte_pack",
    "subbyte_payload_width", "topk_payload_width", "combine_core",
    "subbyte_encode_plain", "subbyte_decode_plain", "subbyte_combine_plain",
    "topk_encode_plain", "topk_decode_plain", "topk_combine_plain",
    "subbyte_encode_payload", "subbyte_decode_combine",
    "topk_encode_payload", "topk_decode_combine",
]

SUB_SCALE_BYTES = 2      # bf16 scale image appended to each payload row

#: float32 constants of the reference, bit for bit
EPS = float(np.float32(1e-30))         # absmax floor; top-k weight |y| + eps
EPS_NOISE = float(np.float32(1e-37))   # floor of the race's uniform
#: XLA's CPU compiler splits a reduction over more than 32 elements into
#: runs of 32 (a reduce-window), each added left to right, and then adds
#: the runs' sums left to right; the top-k stratum sum follows that order
SUM_RUN = 32
BF16_BUMP = 1.0 + 2.0 ** -7            # moves any bf16 to the next one up


# ---------------------------------------------------------------------------
# static payload geometry
# ---------------------------------------------------------------------------

def subbyte_code_max(code_bits: int) -> int:
    """Symmetric code range of a b-bit field: +-(2^(b-1) - 1)."""
    return (1 << (code_bits - 1)) - 1


def subbyte_pack(code_bits: int) -> int:
    """Codes per payload byte."""
    if code_bits not in (2, 4):
        raise ValueError(f"code_bits must be 2 or 4, got {code_bits}")
    return 8 // code_bits


def subbyte_payload_width(block: int, code_bits: int) -> int:
    """Bytes per payload row: packed codes + bf16 scale."""
    return block // subbyte_pack(code_bits) + SUB_SCALE_BYTES


def topk_payload_width(block: int, k: int) -> int:
    """Bytes per payload row: selection bitmap + k int8 values + bf16
    scale."""
    return block // 8 + k + SUB_SCALE_BYTES


def _check_k(k: int, block: int = BLOCK) -> None:
    if k < 1 or block % k:
        raise ValueError(f"k must divide BLOCK={block}, got {k}")


# ---------------------------------------------------------------------------
# shared math of the plain versions (the reference's, op for op)
# ---------------------------------------------------------------------------

def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest, ties to even) and back to float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _sr_clip(s, noise, code_max: int):
    """Stochastic round + clip to the symmetric code range."""
    lo = torch.floor(s)
    frac = s - lo
    q = lo + (noise < frac).to(torch.float32)
    return torch.clamp(q, -float(code_max), float(code_max))


def _row_scale(y, step, code_max: int):
    """Per-row grid step, bf16-rounded: adaptive ``max(absmax, 1e-30) *
    f32(1/code_max)`` bumped one bf16 ulp up where the nearest bf16 fell
    below it, or the fixed ``step``."""
    if step is None:
        absmax = y.abs().amax(dim=-1, keepdim=True)
        scale = (torch.clamp_min(absmax, EPS)
                 * float(np.float32(1.0 / code_max)))
        s_near = _bf16_round(scale)
        s_up = _bf16_round(s_near * BF16_BUMP)
        return torch.where(s_near < scale, s_up, s_near)
    return _bf16_round(torch.full((y.shape[0], 1), float(np.float32(step)),
                                  dtype=torch.float32, device=y.device))


def _pack_fields(q, code_max: int, pack: int):
    """(R, B) float codes in [-code_max, code_max] -> (R, B // pack) uint8:
    each code biased to the field ``code + code_max + 1``, ``pack``
    consecutive fields shifted into one byte, low code first."""
    r, b = q.shape
    bits = 8 // pack
    field = (q + float(code_max + 1)).to(torch.int32).reshape(
        r, b // pack, pack)
    out = field[..., 0]
    for j in range(1, pack):
        out = out | (field[..., j] << (j * bits))
    return out.to(torch.uint8)


def _unpack_fields(code_bytes, code_max: int, pack: int):
    """(R, B // pack) uint8 -> (R, B) float32 codes (inverse of
    ``_pack_fields``)."""
    r, w = code_bytes.shape
    bits = 8 // pack
    shifts = torch.arange(pack, dtype=torch.int32,
                          device=code_bytes.device) * bits
    fields = (code_bytes.to(torch.int32).unsqueeze(-1) >> shifts) \
        & ((1 << bits) - 1)
    return fields.reshape(r, w * pack).to(torch.float32) - float(code_max + 1)


def _scale_to_bf16_bytes(scale_col):
    """(R, 1) float32 (bf16-exact) -> (R, 2) uint8, least significant byte
    first (the byte order of a little-endian bf16 image)."""
    return scale_col.to(torch.bfloat16).contiguous().view(torch.uint8)


def _bf16_bytes_to_scale(scale_bytes):
    """(R, 2) uint8 -> (R, 1) float32 (inverse of ``_scale_to_bf16_bytes``)."""
    return scale_bytes.contiguous().view(torch.bfloat16).to(torch.float32)


def _pack_bits(bits):
    """(R, B) {0, 1} -> (R, B // 8) uint8, bit j of byte i = element 8i+j."""
    r, b = bits.shape
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)
    b3 = bits.to(torch.int32).reshape(r, b // 8, 8)
    return (b3 << shifts).sum(dim=-1).to(torch.uint8)


def _unpack_bits(bitmap_bytes):
    """(R, B // 8) uint8 -> (R, B) float32 {0, 1}."""
    r, w = bitmap_bytes.shape
    shifts = torch.arange(8, dtype=torch.int32, device=bitmap_bytes.device)
    bits = (bitmap_bytes.to(torch.int32).unsqueeze(-1) >> shifts) & 1
    return bits.reshape(r, w * 8).to(torch.float32)


def _topk_select(y, u_sel, k: int):
    """One magnitude-proportional pick per stratum of ``g = B // k``.

    The exponential race ``argmin_i -log(max(u_i, 1e-37)) / w_i`` with
    weights ``w_i = |y_i| + 1e-30`` picks i with probability ``w_i /
    sum(w)``; ties go to the lowest index.  The pick is sent as ``y_i *
    (sum(w) / w_i)``.  ``sum(w)`` is added in the order of the reference's
    compiled CPU reduction: left to right over each run of 32 elements,
    then the runs' partial sums left to right (one run for g <= 32).

    Returns (onehot3 (R, k, g) bool, v (R, k) float32)."""
    r, b = y.shape
    g = b // k
    y3 = y.reshape(r, k, g)
    w = y3.abs() + EPS
    u3 = torch.clamp_min(u_sel.reshape(r, k, g), EPS_NOISE)
    keys = -torch.log(u3) / w
    kmin = keys.amin(dim=-1, keepdim=True)
    idx = torch.arange(g, device=y.device).expand(r, k, g)
    sel = torch.where(keys <= kmin, idx, g).amin(dim=-1, keepdim=True)
    wsum = None
    for c in range(0, g, SUM_RUN):
        part = w[..., c:c + 1]
        for j in range(c + 1, min(c + SUM_RUN, g)):
            part = part + w[..., j:j + 1]
        wsum = part if wsum is None else wsum + part
    v = torch.gather(y3, -1, sel) * (wsum / torch.gather(w, -1, sel))
    return idx == sel, v.squeeze(-1)


def _subbyte_encode_core(y, noise, step, code_bits: int):
    """(R, B) f32/bf16 + (R, B) uniform noise -> (R, B // pack + 2) uint8."""
    cm = subbyte_code_max(code_bits)
    y = y.to(torch.float32)
    scale = _row_scale(y, step, cm)
    q = _sr_clip(y / scale, noise, cm)
    return torch.cat([_pack_fields(q, cm, subbyte_pack(code_bits)),
                      _scale_to_bf16_bytes(scale)], dim=1)


def _subbyte_decode_core(payload, block: int, code_bits: int):
    """(R, B // pack + 2) uint8 -> (R, B) float32 decoded values."""
    pack = subbyte_pack(code_bits)
    w = block // pack
    codes = _unpack_fields(payload[:, :w], subbyte_code_max(code_bits), pack)
    return codes * _bf16_bytes_to_scale(payload[:, w:])


def _topk_encode_core(y, noise, step, k: int):
    """(R, B) f32/bf16 + (R, >= B + k) noise -> (R, B // 8 + k + 2) uint8:
    bitmap || int8 values || bf16 scale."""
    r, b = y.shape
    y = y.to(torch.float32)
    onehot3, v = _topk_select(y, noise[:, :b], k)
    scale = _row_scale(v, step, 127)
    q = _sr_clip(v / scale, noise[:, b:b + k], 127)
    return torch.cat([_pack_bits(onehot3.reshape(r, b)),
                      q.to(torch.int8).view(torch.uint8),
                      _scale_to_bf16_bytes(scale)], dim=1)


def _topk_decode_core(payload, block: int, k: int):
    """(R, B // 8 + k + 2) uint8 -> (R, B) float32, zeros where nothing was
    picked (``bit * value``, as the reference multiplies)."""
    wb = block // 8
    r = payload.shape[0]
    bits = _unpack_bits(payload[:, :wb])
    codes = payload[:, wb:wb + k].view(torch.int8).to(torch.float32)
    vals = codes * _bf16_bytes_to_scale(payload[:, wb + k:])
    return (bits.reshape(r, k, block // k)
            * vals.reshape(r, k, 1)).reshape(r, block)


# ---------------------------------------------------------------------------
# plain PyTorch versions (any device): the parity oracles of the kernels
# ---------------------------------------------------------------------------

def subbyte_encode_plain(y, noise, code_bits: int, fixed_step=None,
                         row_offset: int = 0, n_rows: int | None = None):
    """Sub-byte encode of the chunk's rows; reads the leading ``BLOCK``
    columns of ``noise``."""
    n = chunk_view(y.shape[0], n_rows, row_offset)
    return _subbyte_encode_core(
        chunk_rows(y, row_offset, n),
        chunk_rows(noise, row_offset, n)[:, :y.shape[1]], fixed_step,
        code_bits)


def subbyte_decode_plain(payload, code_bits: int, block: int = BLOCK):
    """Payload rows -> decoded ``(rows, block)`` float32."""
    return _subbyte_decode_core(payload, block, code_bits)


def topk_encode_plain(y, noise, k: int, fixed_step=None, row_offset: int = 0,
                      n_rows: int | None = None):
    """Top-k encode of the chunk's rows; reads noise columns ``[0, BLOCK +
    k)``."""
    n = chunk_view(y.shape[0], n_rows, row_offset)
    return _topk_encode_core(chunk_rows(y, row_offset, n),
                             chunk_rows(noise, row_offset, n), fixed_step, k)


def topk_decode_plain(payload, k: int, block: int = BLOCK):
    """Sparse payload rows -> dense decoded ``(rows, block)`` float32."""
    return _topk_decode_core(payload, block, k)


def _combine_plain(decode, payloads, x_tilde, m_agg, w_self, w_side, deamp,
                   row_offset, n_rows):
    n = chunk_view(x_tilde.shape[0], n_rows, row_offset)
    d = [decode(chunk_rows(p, row_offset, n)) for p in payloads]
    return combine_core(*d, chunk_rows(x_tilde, row_offset, n),
                        chunk_rows(m_agg, row_offset, n), w_self, w_side,
                        deamp)


def subbyte_combine_plain(payload_self, payload_left, payload_right, x_tilde,
                          m_agg, w_self: float, w_side: float, deamp: float,
                          code_bits: int, row_offset: int = 0,
                          n_rows: int | None = None):
    """Decode the three sub-byte payloads, then ``combine_core``."""
    return _combine_plain(
        lambda p: _subbyte_decode_core(p, x_tilde.shape[1], code_bits),
        (payload_self, payload_left, payload_right), x_tilde, m_agg, w_self,
        w_side, deamp, row_offset, n_rows)


def topk_combine_plain(payload_self, payload_left, payload_right, x_tilde,
                       m_agg, w_self: float, w_side: float, deamp: float,
                       k: int, row_offset: int = 0,
                       n_rows: int | None = None):
    """Scatter the three top-k payloads, then ``combine_core``."""
    return _combine_plain(
        lambda p: _topk_decode_core(p, x_tilde.shape[1], k),
        (payload_self, payload_left, payload_right), x_tilde, m_agg, w_self,
        w_side, deamp, row_offset, n_rows)


# ---------------------------------------------------------------------------
# device-dispatching entry points
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernel(source: str):
    """The C entry point ``<source>_launch`` of ``csrc/<source>.cu`` (built
    at first use).  Encoders take (y, y_is_bf16, noise, noise_stride, out,
    n_rows, param, fixed, step, stream); combines take (3 payloads, 2
    shadows, 3 outputs, n_rows, param, w_self, w_side * deamp, deamp,
    stream), where ``param`` is the code width or k."""
    fn = getattr(_build.load(source), f"{source}_launch")
    if source.endswith("encode"):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launched(entry, err: int) -> None:
    entry.launches += 1
    if err != 0:
        raise RuntimeError(f"{entry.__name__} kernel launch failed: CUDA "
                           f"error {err}")


def _encode(entry, source, plain, param, width, noise_cols, y, noise,
            fixed_step, row_offset, n_rows, out, align):
    """Shared checks and launch of the two encoders; ``out`` as in
    ``quantize_payload`` (``align``: the kernel's widest payload store)."""
    n_full = y.shape[0]
    n = chunk_view(n_full, n_rows, row_offset)
    _check_rows("y", y, BLOCK, n, n_full, (torch.float32, torch.bfloat16))
    _check_noise(entry.__name__, noise, noise_cols, n, n_full)
    # the kernels read BLOCK noise columns, top-k BLOCK + k of its 2 BLOCK
    read = BLOCK + param if source == "topk_encode" else BLOCK
    with kernel_call(entry.__name__, encode_bytes(y, n, read, width)):
        if y.device.type == "cpu" and noise.device.type == "cpu":
            return _into(out, plain(y, noise, param, fixed_step, row_offset,
                                    n_rows))
        if on_meta(y, noise):
            return _out_rows(entry.__name__, out, (n, width), torch.uint8,
                             y.device)
        return _encode_launch(entry, source, param, width, y, noise,
                              fixed_step, row_offset, n, out, align)


def _encode_launch(entry, source, param, width, y, noise, fixed_step,
                   row_offset, n, out, align):
    name = entry.__name__
    if y.device.type != "cuda" or noise.device != y.device:
        raise ValueError(f"{name}: y on {y.device}, noise on {noise.device}; "
                         "both must be on one CUDA device (or both on the "
                         "CPU)")
    if not y.is_contiguous() or not _noise_rows_ok(noise):
        raise ValueError(f"{name}: y must be contiguous and noise rows "
                         "unit-stride and 16-byte aligned")
    u0 = 0 if noise.shape[0] == n else row_offset
    out = _out_rows(name, out, (n, width), torch.uint8, y.device, align)
    err = _kernel(source)(
        y.data_ptr() + row_offset * y.stride(0) * y.element_size(),
        int(y.dtype == torch.bfloat16),
        noise.data_ptr() + u0 * noise.stride(0) * noise.element_size(),
        noise.stride(0), out.data_ptr(), n, param,
        int(fixed_step is not None),
        0.0 if fixed_step is None else float(np.float32(fixed_step)),
        torch.cuda.current_stream(y.device).cuda_stream)
    _launched(entry, err)
    return out


def _combine(entry, source, plain, param, width, payloads, x_tilde, m_agg,
             w_self, w_side, deamp, row_offset, n_rows, out):
    """Shared checks and launch of the two combines (the chunk-view and
    ``out`` contract of ``dequant_combine_payload``)."""
    n_full = x_tilde.shape[0]
    n = chunk_view(n_full, n_rows, row_offset)
    for nm, p in zip(("payload_self", "payload_left", "payload_right"),
                     payloads):
        _check_rows(nm, p, width, n, n_full, (torch.uint8,))
    for nm, a in (("x_tilde", x_tilde), ("m_agg", m_agg)):
        _check_rows(nm, a, BLOCK, n, n_full, (torch.float32,))
    operands = (*payloads, x_tilde, m_agg)
    with kernel_call(entry.__name__, combine_bytes(n, width)):
        if all(a.device.type == "cpu" for a in operands):
            return _into(out, plain(*payloads, x_tilde, m_agg, w_self,
                                    w_side, deamp, param, row_offset,
                                    n_rows))
        if on_meta(*operands):
            return _out_rows(entry.__name__, out or (None,) * 3,
                             (n, BLOCK), torch.float32, x_tilde.device)
        return _combine_launch(entry, source, param, operands, w_self,
                               w_side, deamp, row_offset, n, out)


def _combine_launch(entry, source, param, operands, w_self, w_side, deamp,
                    row_offset, n, out):
    name = entry.__name__
    x_tilde = operands[3]
    dev = x_tilde.device
    if dev.type != "cuda" or any(a.device != dev for a in operands):
        raise ValueError(f"{name}: operands on "
                         f"{sorted({str(a.device) for a in operands})}; all "
                         "must be on one CUDA device (or all on the CPU)")
    if not all(a.is_contiguous() for a in operands):
        raise ValueError(f"{name}: CUDA operands must be contiguous")

    def at(a):
        r0 = 0 if a.shape[0] == n else row_offset
        return a.data_ptr() + r0 * a.stride(0) * a.element_size()

    outs = _out_rows(name, out or (None,) * 3, (n, BLOCK), torch.float32,
                     dev, align=16)
    err = _kernel(source)(
        *(at(a) for a in operands), *(o.data_ptr() for o in outs), n, param,
        float(np.float32(w_self)),
        float(np.float32(w_side) * np.float32(deamp)),
        float(np.float32(deamp)),
        torch.cuda.current_stream(dev).cuda_stream)
    _launched(entry, err)
    return outs


def subbyte_encode_payload(y, noise, code_bits: int, fixed_step=None,
                           row_offset: int = 0, n_rows: int | None = None,
                           out=None):
    """Bit-packed sub-byte quantize-to-wire: ``(n_full, BLOCK)`` f32/bf16 +
    ``(n_full or n, >= BLOCK)`` f32 noise -> ``(n, BLOCK // (8 //
    code_bits) + 2)`` uint8.  Same chunk view as ``quantize_payload``;
    ``fixed_step`` is rounded to bf16 before use."""
    return _encode(subbyte_encode_payload, "subbyte_encode",
                   subbyte_encode_plain, code_bits,
                   subbyte_payload_width(BLOCK, code_bits), BLOCK, y, noise,
                   fixed_step, row_offset, n_rows, out, align=2)


def subbyte_decode_combine(payload_self, payload_left, payload_right,
                           x_tilde, m_agg, w_self: float, w_side: float,
                           deamp: float, code_bits: int, row_offset: int = 0,
                           n_rows: int | None = None, out=None):
    """Sub-byte receive side: unpack the three payloads, shadow update and
    ring combine.  Returns (x_tilde', m_agg', combined), each ``(n,
    BLOCK)`` float32."""
    return _combine(subbyte_decode_combine, "subbyte_combine",
                    subbyte_combine_plain, code_bits,
                    subbyte_payload_width(BLOCK, code_bits),
                    (payload_self, payload_left, payload_right), x_tilde,
                    m_agg, w_self, w_side, deamp, row_offset, n_rows, out)


def topk_encode_payload(y, noise, k: int, fixed_step=None,
                        row_offset: int = 0, n_rows: int | None = None,
                        out=None):
    """Top-k sparse quantize-to-wire: ``(n_full, BLOCK)`` f32/bf16 +
    ``(n_full or n, >= 2 * BLOCK)`` f32 noise -> ``(n, BLOCK // 8 + k +
    2)`` uint8 (bitmap || int8 values || bf16 scale)."""
    _check_k(k)
    return _encode(topk_encode_payload, "topk_encode", topk_encode_plain, k,
                   topk_payload_width(BLOCK, k), 2 * BLOCK, y, noise,
                   fixed_step, row_offset, n_rows, out, align=1)


def topk_decode_combine(payload_self, payload_left, payload_right, x_tilde,
                        m_agg, w_self: float, w_side: float, deamp: float,
                        k: int, row_offset: int = 0,
                        n_rows: int | None = None, out=None):
    """Top-k receive side: scatter the three payloads through their
    bitmaps, shadow update and ring combine."""
    _check_k(k)
    return _combine(topk_decode_combine, "topk_combine", topk_combine_plain,
                    k, topk_payload_width(BLOCK, k),
                    (payload_self, payload_left, payload_right), x_tilde,
                    m_agg, w_self, w_side, deamp, row_offset, n_rows, out)


for _entry in (subbyte_encode_payload, subbyte_decode_combine,
               topk_encode_payload, topk_decode_combine):
    _entry.launches = 0
del _entry
