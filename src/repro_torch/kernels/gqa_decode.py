"""Flash-decode: one query token's GQA attention over a KV cache.

Port of ``repro.kernels.gqa_decode`` (``gqa_decode_pallas``).  One call
returns the partials ``(m, l, acc)`` of every query of every KV head over
the cache positions marked valid; ``models.layers.combine_decode_partials``
turns them into the attention output ``acc / l``.

``gqa_decode`` dispatches on the device of its operands: CPU tensors take
the plain PyTorch version (``ref.gqa_decode_ref``), CUDA tensors launch the
hand-written kernel ``csrc/gqa_decode.cu`` or raise.  Unlike the TPU
kernel it reads K and V in the cache's ``(b, S, kvh, hd)`` layout without a
transposed copy and takes any S.  ``gqa_decode.launches`` counts calls that
launched the kernel (each is one split pass and one small merge pass).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, ref

__all__ = ["gqa_decode_plain", "gqa_decode", "decode_splits", "HEAD_DIMS",
           "MAX_GROUP"]

#: head dims and queries per KV head the CUDA kernel is compiled for
HEAD_DIMS = (64, 128)
MAX_GROUP = 8
#: the fewest cache positions one CTA takes, and CTAs wanted per SM
MIN_SPLIT, CTAS_PER_SM = 256, 8

#: plain PyTorch version: runs on any device
gqa_decode_plain = ref.gqa_decode_ref


def decode_splits(rows: int, seq: int, n_sms: int) -> tuple[int, int]:
    """(positions per range, ranges): the cache of each of ``rows`` (b x
    kvh) rows is cut into ranges of whole 128-position multiples, enough
    for about ``CTAS_PER_SM`` CTAs per SM but none shorter than
    ``MIN_SPLIT`` (or the whole cache)."""
    want = max(1, -(-CTAS_PER_SM * n_sms // max(rows, 1)))
    want = min(want, max(1, -(-seq // MIN_SPLIT)))
    per = -(-seq // want)
    split_len = max(128, -(-per // 128) * 128)
    return split_len, max(1, -(-seq // split_len))


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/gqa_decode.cu (built at first use)."""
    fn = _build.load("gqa_decode").gqa_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + \
        [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, valid):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (b, kvh, g, hd) and k/v (b, S, kvh, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, kvh, g, hd = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, kvh, hd):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if valid.shape != (k.shape[1],) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be ({k.shape[1]},) bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} dtype {a.dtype} is not float32/bf16")
    if k.dtype != v.dtype:
        raise TypeError(f"k is {k.dtype}, v is {v.dtype}")


def gqa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               valid: torch.Tensor, softcap: float | None = None):
    """Flash-decode partials ``(m (b,kvh,g), l (b,kvh,g), acc
    (b,kvh,g,hd))``, float32, of ``q`` (b, kvh, g, hd) over the cache
    ``k``/``v`` (b, S, kvh, hd) at the positions where ``valid`` (S,) is
    True, with an optional tanh ``softcap`` of the scores."""
    _check(q, k, v, valid)
    operands = (q, k, v, valid)
    if all(a.device.type == "cpu" for a in operands):
        return gqa_decode_plain(q, k, v, valid, softcap=softcap)
    dev = k.device
    if dev.type != "cuda" or any(a.device != dev for a in operands):
        raise ValueError("gqa_decode: operands on "
                         f"{sorted({str(a.device) for a in operands})}; all "
                         "must be on one CUDA device (or all on the CPU)")
    b, kvh, g, hd = q.shape
    seq = k.shape[1]
    if hd not in HEAD_DIMS or g > MAX_GROUP:
        raise ValueError(f"gqa_decode: the CUDA kernel takes hd in "
                         f"{HEAD_DIMS} and g <= {MAX_GROUP}, got hd={hd}, "
                         f"g={g}")
    if not (k.is_contiguous() and v.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("gqa_decode: k, v and valid must be contiguous")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    q32 = q.to(torch.float32).contiguous()          # exact for bf16
    split_len, n_splits = decode_splits(
        b * kvh, seq, torch.cuda.get_device_properties(dev)
        .multi_processor_count)
    f32 = dict(dtype=torch.float32, device=dev)
    m_part = torch.empty((b * kvh, n_splits, g), **f32)
    l_part = torch.empty((b * kvh, n_splits, g), **f32)
    acc_part = torch.empty((b * kvh, n_splits, g, hd), **f32)
    m = torch.empty((b, kvh, g), **f32)
    l = torch.empty((b, kvh, g), **f32)
    acc = torch.empty((b, kvh, g, hd), **f32)
    err = _kernel()(
        q32.data_ptr(), k.data_ptr(), v.data_ptr(),
        int(k.dtype == torch.bfloat16), valid.data_ptr(), m_part.data_ptr(),
        l_part.data_ptr(), acc_part.data_ptr(), m.data_ptr(), l.data_ptr(),
        acc.data_ptr(), b, seq, kvh, g, hd, split_len, n_splits,
        1.0 / math.sqrt(hd), 0.0 if softcap is None else float(softcap),
        torch.cuda.current_stream(dev).cuda_stream)
    gqa_decode.launches += 1
    if err != 0:
        raise RuntimeError(f"gqa_decode kernel launch failed: CUDA error "
                           f"{err}")
    return m, l, acc


gqa_decode.launches = 0
