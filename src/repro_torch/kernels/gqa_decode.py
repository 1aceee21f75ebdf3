"""Flash-decode: one query token's GQA attention over a KV cache.

Port of ``repro.kernels.gqa_decode`` (``gqa_decode_pallas``).  One call
returns the partials ``(m, l, acc)`` of every query of every KV head over
the cache positions marked valid; ``models.layers.combine_decode_partials``
turns them into the attention output ``acc / l``.

``gqa_decode`` dispatches on the device of its operands: CPU tensors take
the plain PyTorch version (``ref.gqa_decode_ref``), CUDA tensors launch the
hand-written kernel ``csrc/gqa_decode.cu`` or raise, and ``meta`` tensors
(a dry run) get empty partials; every call reports its bytes and FLOPs to
an active ``launch.op_cost`` counter (:func:`decode_cost`).  Unlike the TPU
kernel it reads K and V in the cache's ``(b, S, kvh, hd)`` layout without a
transposed copy and takes any S and any mask.  A float32 cache goes
through the float32 kernel (q cast to float32); a bfloat16 cache through
the bfloat16 kernel, which reads q as it is, bfloat16 or float32, and runs
its products on tensor cores over exact bfloat16 slices.
``decode_splits`` cuts each (b, kv head) row's positions into the ranges
the kernel's CTAs take; the ranges of a row merge inside the one launch,
over a thread block cluster of up to 16 CTAs (so up to 16 x 32,768 =
524,288 positions).  ``gqa_decode.launches`` counts calls that launched a
kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.launch.op_cost import kernel_call

from . import _build, ref

__all__ = ["gqa_decode_plain", "gqa_decode", "decode_splits", "decode_tile",
           "decode_grid", "decode_cost", "HEAD_DIMS", "MAX_GROUP"]

#: head dims and queries per KV head the CUDA kernel is compiled for
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8
#: bytes of one K (or V) tile the float32 kernel stages in shared memory;
#: the bfloat16 kernel stages chunks of MMA_CHUNK positions (one tensor-core
#: tile)
TILE_BYTES, MMA_CHUNK = 8192, 16
#: CTAs the float32 kernel keeps resident on one SM where the card is not
#: asked (4 stages of 16 KB and ~6.5 KB of mask bits each; the launch asks
#: the card: ``ctas_per_sm``), the most ranges of one row the split picks
#: by itself (a portable thread block cluster, merged over distributed
#: shared memory), the most ranges of one row at all (a non-portable
#: cluster of 16, for caches longer than 8 ranges), the most positions of
#: one range (its mask bits live in shared memory), and the fewest tiles a
#: float32 range is cut down to (shorter ranges spend more on their start
#: and merge than they gain in balance: ``chip_smoke.py``'s range sweep)
CTAS_PER_SM, PORTABLE_RANGES, MAX_RANGES = 3, 8, 16
MAX_RANGE, MIN_RANGE_TILES = 32768, 20
#: the bfloat16 kernel's grid: rows x ranges near FILL of the SMs, one CTA
#: each (``chip_smoke.py``'s bfloat16 range sweeps: more CTAs, and the
#: clusters that merge them, cost more than they add), and no range below
#: MIN_RANGE_BYTES of K and V
FILL, MIN_RANGE_BYTES = 0.75, 65536

#: plain PyTorch version: runs on any device
gqa_decode_plain = ref.gqa_decode_ref


def decode_tile(hd: int, dtype: torch.dtype) -> int:
    """Cache positions in one tile of the kernel for a cache of ``dtype``:
    TILE_BYTES of K in float32, MMA_CHUNK positions in bfloat16."""
    return MMA_CHUNK if dtype == torch.bfloat16 else TILE_BYTES // (hd * 4)


def decode_splits(rows: int, seq: int, n_sms: int, tile: int,
                  ranges: int | None = None,
                  ctas_per_sm: int = CTAS_PER_SM,
                  kv_bytes: int | None = None,
                  clusters=None) -> tuple[int, int]:
    """(positions per range, ranges per row): each of ``rows`` (b x kvh)
    rows' ``seq`` positions is cut into ranges of whole tiles.  For the
    float32 kernel, as many as make about two waves of the card's
    ``ctas_per_sm`` x ``n_sms`` resident CTAs, but none shorter than
    MIN_RANGE_TILES tiles (or the whole cache) and at most PORTABLE_RANGES.
    For the bfloat16 kernel (``kv_bytes``, the bytes of K and V of one
    position of a row, given), sized by bytes: as many as put rows x ranges
    near FILL x ``n_sms``, one CTA per SM, but none below MIN_RANGE_BYTES,
    at most PORTABLE_RANGES, and no more than let every row's cluster be
    resident at once (``clusters(n)``: how many clusters of n CTAs the card
    holds, where given).  ``ranges`` asks for that many instead.  No range
    exceeds MAX_RANGE positions, so a longer cache takes more ranges, up to
    MAX_RANGES."""
    if ranges is None and kv_bytes:
        ranges = min(int(FILL * n_sms) // max(rows, 1), PORTABLE_RANGES,
                     seq * kv_bytes // MIN_RANGE_BYTES)
        while clusters is not None and ranges > 1 and clusters(ranges) < rows:
            ranges -= 1
    elif ranges is None:
        ranges = min(2 * ctas_per_sm * n_sms // max(rows, 1),
                     PORTABLE_RANGES, seq // (MIN_RANGE_TILES * tile))
    want = max(1, ranges, -(-seq // MAX_RANGE))
    if want > MAX_RANGES:
        raise ValueError(f"gqa_decode: {want} ranges of a {seq}-position "
                         f"cache exceed the kernel's {MAX_RANGES} x "
                         f"{MAX_RANGE}")
    per = -(-max(seq, 1) // want)
    range_len = -(-per // tile) * tile
    return range_len, max(1, -(-seq // range_len))


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/gqa_decode.cu (built at first use)."""
    fn = _build.load("gqa_decode").gqa_decode_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2 \
        + [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
        [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def occupancy(index: int, bf16: bool, hd: int, g: int,
              n_ranges: int = 1, q_bf16: bool = False) -> tuple[int, int]:
    """(CTAs of the kernel one SM of CUDA device ``index`` holds, clusters
    of ``n_ranges`` CTAs the card holds at once), as the CUDA occupancy
    calculator gives them for the kernel that takes that cache type
    (``bf16``), q type (``q_bf16``: bfloat16 q over a bfloat16 cache),
    head dim and group."""
    fn = _build.load("gqa_decode").gqa_decode_occupancy
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    ctas, clusters = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        err = fn(int(bf16), int(bf16 and q_bf16), hd, g, n_ranges,
                 ctypes.addressof(ctas), ctypes.addressof(clusters))
    if err != 0:
        raise RuntimeError(f"gqa_decode occupancy query failed: CUDA error "
                           f"{err}")
    return ctas.value, clusters.value


def decode_grid(q: torch.Tensor, k: torch.Tensor,
                ranges: int | None = None) -> tuple[int, int, int, int]:
    """(positions per range, ranges per row, CTAs per SM, clusters of a
    row's ranges resident at once) of the kernel a call on these CUDA
    operands launches: a float32 cache takes the float32 kernel, a
    bfloat16 one the bfloat16 kernel for q's type."""
    b, kvh, g, hd = q.shape
    index = k.device.index
    bf16 = k.dtype == torch.bfloat16
    q_bf16 = bf16 and q.dtype == torch.bfloat16

    def clusters(n):
        return occupancy(index, bf16, hd, g, n, q_bf16)[1]

    ctas = occupancy(index, bf16, hd, g, q_bf16=q_bf16)[0]
    range_len, n_ranges = decode_splits(
        b * kvh, k.shape[1], _sm_count(index), decode_tile(hd, k.dtype),
        ranges, ctas, kv_bytes=4 * hd if bf16 else None, clusters=clusters)
    return range_len, n_ranges, ctas, clusters(n_ranges)


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


def decode_cost(q: torch.Tensor, k: torch.Tensor) -> tuple[int, int]:
    """(bytes, matrix-product FLOPs) of one call over the whole cache, a
    static count that does not read the mask: q as the kernel reads it
    (float32 over a float32 cache, in its own type over a bfloat16 one),
    every position's K and V row and mask byte read once, ``m``, ``l`` and
    ``acc`` written once; ``q . k`` and ``p v`` are ``2 hd`` FLOPs each per
    query and position."""
    b, kvh, g, hd = q.shape
    seq = k.shape[1]
    q_bytes = q.element_size() if k.dtype == torch.bfloat16 else 4
    n_bytes = (b * kvh * g * hd * q_bytes
               + 2 * b * seq * kvh * hd * k.element_size()
               + seq + b * kvh * g * (2 + hd) * 4)
    return n_bytes, 4 * b * kvh * g * seq * hd


def gqa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               valid: torch.Tensor, softcap: float | None = None,
               ranges: int | None = None):
    """Flash-decode partials ``(m (b,kvh,g), l (b,kvh,g), acc
    (b,kvh,g,hd))``, float32, of ``q`` (b, kvh, g, hd) over the cache
    ``k``/``v`` (b, S, kvh, hd) at the positions where ``valid`` (S,) is
    True, with an optional tanh ``softcap`` of the scores.  ``ranges``
    overrides how many ranges the kernel cuts each row into
    (``decode_splits``); the CPU path ignores it."""
    _check(q, k, v, valid)
    operands = (q, k, v, valid)
    with kernel_call("gqa_decode", *decode_cost(q, k)):
        if all(a.device.type == "cpu" for a in operands):
            return gqa_decode_plain(q, k, v, valid, softcap=softcap)
        if all(a.device.type == "meta" for a in operands):
            return (torch.empty(q.shape[:3], dtype=torch.float32,
                                device=q.device),
                    torch.empty(q.shape[:3], dtype=torch.float32,
                                device=q.device),
                    torch.empty(q.shape, dtype=torch.float32,
                                device=q.device))
        return _launch(q, k, v, valid, softcap, ranges)


def _launch(q, k, v, valid, softcap, ranges):
    operands = (q, k, v, valid)
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
    bf16 = k.dtype == torch.bfloat16
    # the bfloat16 kernel reads q in its own type; the float32 kernel
    # takes a float32 q (exact from bfloat16)
    qk = q.contiguous() if bf16 else q.to(torch.float32).contiguous()
    if qk.data_ptr() % 16:
        qk = qk.clone()
    if valid.data_ptr() % 16:
        valid = valid.clone()
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("gqa_decode: k and v must start 16-byte aligned")
    q_bf16 = qk.dtype == torch.bfloat16
    range_len, n_ranges = decode_grid(qk, k, ranges)[:2]
    n = b * kvh * g
    out = torch.empty(n * (hd + 2), dtype=torch.float32, device=dev)
    acc = out[:n * hd].view(b, kvh, g, hd)
    m = out[n * hd:n * (hd + 1)].view(b, kvh, g)
    l = out[n * (hd + 1):].view(b, kvh, g)
    err = _kernel()(
        qk.data_ptr(), int(q_bf16), k.data_ptr(), v.data_ptr(),
        int(bf16), valid.data_ptr(), m.data_ptr(),
        l.data_ptr(), acc.data_ptr(), b, seq, kvh, g, hd, range_len,
        n_ranges, 1.0 / math.sqrt(hd),
        0.0 if softcap is None else float(softcap),
        torch.cuda.current_stream(dev).cuda_stream)
    gqa_decode.launches += 1
    if err != 0:
        raise RuntimeError(f"gqa_decode kernel launch failed: CUDA error "
                           f"{err}")
    return m, l, acc


gqa_decode.launches = 0
