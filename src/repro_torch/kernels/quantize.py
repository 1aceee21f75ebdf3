"""Quantize-to-wire: the int8 encoders of the ADC-DGD exchange.

Port of ``repro.kernels.quantize``.  ``quantize_payload``
(``quantize_payload_pallas``) turns ``(n, BLOCK)`` float32/bf16 rows into
the ``(n, BLOCK + 4)`` uint8 wire payload: 512 int8 codes followed by the
row's fp32 scale, least significant byte first.  ``quantize_blocks``
(``quantize_blocks_pallas``) computes the same codes and scales as two
tensors, ``(n, BLOCK)`` int8 and ``(n, 1)`` float32: the per-leaf reference
transport and ``compressed_dgd`` ship them that way.

Both dispatch on the device of their input: a CPU tensor takes the plain
PyTorch version, a CUDA tensor launches the hand-written kernel
(``csrc/quantize_payload.cu``, ``csrc/quantize_blocks.cu``) or raises, and
a ``meta`` tensor (asked for by a dry run, never a fallback) gets empty
outputs of the kernel's shapes and dtypes.  Every call reports its bytes
to an active ``launch.op_cost`` counter (:func:`encode_bytes`).
``quantize_payload.launches`` and ``quantize_blocks.launches`` count kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.launch.op_cost import kernel_call

from . import _build, ref

__all__ = ["BLOCK", "TILE_N", "SCALE_BYTES", "pack_payload",
           "unpack_payload", "chunk_view", "chunk_rows",
           "quantize_payload_plain", "quantize_payload",
           "quantize_blocks_plain", "quantize_blocks", "encode_bytes",
           "combine_bytes", "on_meta"]

TILE_N = 32      # row multiple of every packed buffer's height
BLOCK = 512      # quantization block = payload row width in codes
SCALE_BYTES = 4  # one fp32 scale per row, appended to the wire payload


def pack_payload(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(rows, B) int8 codes + (rows, 1) f32 scales -> (rows, B+4) uint8.

    The scale bytes are the fp32 image least-significant byte first (the
    reference's XLA bitcast order, pinned by ``test_payload_byte_order``)."""
    rows = codes.shape[0]
    su = scales.to(torch.float32).contiguous().view(torch.uint8)
    return torch.cat([codes.view(torch.uint8),
                      su.reshape(rows, SCALE_BYTES)], dim=1)


def unpack_payload(payload: torch.Tensor, block: int = BLOCK):
    """(rows, B+4) uint8 -> (codes int8 (rows, B), scales f32 (rows, 1))."""
    if payload.shape[-1] != block + SCALE_BYTES:
        raise ValueError(f"payload width {payload.shape[-1]} != "
                         f"{block + SCALE_BYTES}")
    codes = payload[:, :block].contiguous().view(torch.int8)
    scales = payload[:, block:].contiguous().view(torch.float32)
    return codes, scales


def chunk_view(n_full: int, n_rows: int | None, row_offset: int) -> int:
    """Height of the static chunk view ``[row_offset, row_offset + n)`` of
    full-height ``(n_full, ...)`` operands.  Any row range is allowed: the
    CUDA kernels have no tile grid to align to."""
    n = n_full if n_rows is None else int(n_rows)
    if n < 0 or row_offset < 0 or row_offset + n > n_full:
        raise ValueError(f"chunk [{row_offset}, {row_offset + n}) outside "
                         f"{n_full} rows")
    return n


def chunk_rows(a: torch.Tensor, row_offset: int, n: int) -> torch.Tensor:
    """The chunk's rows of an operand: chunk-height operands pass through,
    full-height ones are viewed at ``row_offset`` (a view, never a copy)."""
    if a.shape[0] == n:
        return a
    return a[row_offset:row_offset + n]


def encode_bytes(y: torch.Tensor, n: int, noise_cols: int,
                 width: int) -> int:
    """Least bytes of one encoder call on ``n`` rows: the rows of ``y``
    and the ``noise_cols`` float32 noise columns it reads, and the ``(n,
    width)`` payload it writes, each once."""
    return n * (BLOCK * y.element_size() + noise_cols * 4 + width)


def combine_bytes(n: int, width: int) -> int:
    """Least bytes of one combine call on ``n`` rows: three payloads of
    ``width`` bytes a row and two float32 shadows read, three float32
    outputs written."""
    return n * (3 * width + 5 * BLOCK * 4)


def on_meta(*operands) -> bool:
    """Whether every operand lies on the ``meta`` device: a dry run."""
    return all(a.device.type == "meta" for a in operands)


def _check_rows(name: str, a: torch.Tensor, width: int, n: int,
                n_full: int, dtypes) -> None:
    if a.dim() != 2 or a.shape[1] != width:
        raise ValueError(f"{name} must be (rows, {width}), got "
                         f"{tuple(a.shape)}")
    if a.shape[0] not in (n, n_full):
        raise ValueError(f"{name} has {a.shape[0]} rows; the chunk view "
                         f"needs {n} or {n_full}")
    if a.dtype not in dtypes:
        raise TypeError(f"{name} dtype {a.dtype} not in {dtypes}")


def _into(out, got):
    """``got`` returned as it is, or copied into the caller's ``out``
    (a tensor or a tuple of them) and ``out`` returned: the plain
    versions' side of the wrappers' ``out=``."""
    if out is None:
        return got
    many = not isinstance(out, torch.Tensor)
    for o, g in zip(out, got) if many else ((out, got),):
        if o.shape != g.shape or o.dtype != g.dtype:
            raise ValueError(f"out must be {tuple(g.shape)} {g.dtype}, got "
                             f"{tuple(o.shape)} {o.dtype}")
        o.copy_(g)
    return tuple(out) if many else out


def _out_rows(name: str, out, shape: tuple, dtype, device, align: int = 1):
    """The caller's ``out`` tensor(s), checked for what a kernel writes
    (``shape``, ``dtype``, contiguous on ``device``, ``align``-byte
    aligned), fresh ones where it is None: one tensor, or a tuple for a
    kernel with several outputs (a None entry is made fresh)."""
    many = isinstance(out, (tuple, list))
    outs = tuple(out) if many else (out,)
    made = []
    for o in outs:
        if o is None:
            o = torch.empty(shape, dtype=dtype, device=device)
        elif (tuple(o.shape) != tuple(shape) or o.dtype != dtype
              or o.device != device or not o.is_contiguous()
              or o.data_ptr() % align):
            raise ValueError(f"{name}: out must be a contiguous {shape} "
                             f"{dtype} tensor on {device}, {align}-byte "
                             f"aligned; got {tuple(o.shape)} {o.dtype} on "
                             f"{o.device}")
        made.append(o)
    return tuple(made) if many else made[0]


def quantize_payload_plain(y: torch.Tensor, noise: torch.Tensor,
                           fixed_step: float | None = None,
                           row_offset: int = 0,
                           n_rows: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: ``pack_payload(quantize_blocks_ref(...))`` on
    the chunk's rows and the leading ``BLOCK`` columns of ``noise``.  Runs
    on any device."""
    n = chunk_view(y.shape[0], n_rows, row_offset)
    codes, scales = ref.quantize_blocks_ref(
        chunk_rows(y, row_offset, n),
        chunk_rows(noise, row_offset, n)[:, :BLOCK], fixed_step=fixed_step)
    return pack_payload(codes, scales)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/quantize_payload.cu (built at first
    use)."""
    fn = _build.load("quantize_payload").quantize_payload_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_noise(name: str, noise: torch.Tensor, cols: int, n: int,
                 n_full: int) -> None:
    """Noise of ``n`` or ``n_full`` rows and at least ``cols`` float32
    columns, of which the encoder reads the leading ones in place."""
    if noise.dim() != 2 or noise.shape[1] < cols \
            or noise.shape[0] not in (n, n_full):
        raise ValueError(f"{name}: noise must be ({n} or {n_full}, >= "
                         f"{cols}), got {tuple(noise.shape)}")
    if noise.dtype != torch.float32:
        raise TypeError(f"noise dtype {noise.dtype} is not float32")


def _noise_rows_ok(noise: torch.Tensor) -> bool:
    """What the CUDA encoders need of a noise buffer: unit column stride
    and every row 16-byte aligned."""
    return (noise.stride(1) == 1 and noise.stride(0) % 4 == 0
            and noise.data_ptr() % 16 == 0)


def quantize_payload(y: torch.Tensor, noise: torch.Tensor,
                     fixed_step: float | None = None, row_offset: int = 0,
                     n_rows: int | None = None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Fused quantize-to-wire: ``(n_full, BLOCK)`` f32/bf16 differential +
    ``(n_full or n, >= BLOCK)`` f32 uniform noise -> ``(n, BLOCK + 4)``
    uint8.  The leading ``BLOCK`` columns of each noise row are read, so a
    wider buffer shared with the top-k encoder serves as it is.

    Static ``row_offset``/``n_rows`` select a chunk of full-height
    operands, read in place.  ``fixed_step`` (a float) is every row's
    scale; ``None`` picks the adaptive per-row scale.  ``out``: an
    ``(n, BLOCK + 4)`` uint8 tensor to write the payload into (contiguous,
    4-byte aligned on the card)."""
    n_full = y.shape[0]
    n = chunk_view(n_full, n_rows, row_offset)
    _check_rows("y", y, BLOCK, n, n_full, (torch.float32, torch.bfloat16))
    _check_noise("quantize_payload", noise, BLOCK, n, n_full)
    with kernel_call("quantize_payload", encode_bytes(
            y, n, BLOCK, BLOCK + SCALE_BYTES)):
        if y.device.type == "cpu" and noise.device.type == "cpu":
            return _into(out, quantize_payload_plain(y, noise, fixed_step,
                                                     row_offset, n_rows))
        if on_meta(y, noise):
            return _out_rows("quantize_payload", out,
                             (n, BLOCK + SCALE_BYTES), torch.uint8,
                             y.device)
        return _quantize_payload_launch(y, noise, fixed_step, row_offset, n,
                                        out)


def _quantize_payload_launch(y, noise, fixed_step, row_offset, n, out):
    if y.device.type != "cuda" or noise.device != y.device:
        raise ValueError(f"quantize_payload: y on {y.device}, noise on "
                         f"{noise.device}; both must be on one CUDA device "
                         "(or both on the CPU)")
    if not y.is_contiguous() or not _noise_rows_ok(noise):
        raise ValueError("quantize_payload: y must be contiguous and noise "
                         "rows unit-stride and 16-byte aligned")
    u0 = 0 if noise.shape[0] == n else row_offset
    out = _out_rows("quantize_payload", out, (n, BLOCK + SCALE_BYTES),
                    torch.uint8, y.device, align=4)
    step = 0.0 if fixed_step is None else float(np.float32(fixed_step))
    err = _kernel()(
        y.data_ptr() + row_offset * y.stride(0) * y.element_size(),
        int(y.dtype == torch.bfloat16),
        noise.data_ptr() + u0 * noise.stride(0) * noise.element_size(),
        noise.stride(0), out.data_ptr(), n, int(fixed_step is not None),
        step,
        torch.cuda.current_stream(y.device).cuda_stream)
    quantize_payload.launches += 1
    if err != 0:
        raise RuntimeError(f"quantize_payload kernel launch failed: CUDA "
                           f"error {err}")
    return out


quantize_payload.launches = 0


#: plain PyTorch version of ``quantize_blocks``: runs on any device
quantize_blocks_plain = ref.quantize_blocks_ref


@functools.lru_cache(maxsize=None)
def _blocks_kernel():
    """The C entry point of csrc/quantize_blocks.cu (built at first use)."""
    fn = _build.load("quantize_blocks").quantize_blocks_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quantize_blocks(y: torch.Tensor, noise: torch.Tensor,
                    fixed_step: float | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stochastic int8 quantization of ``(n, BLOCK)`` f32/bf16 rows with
    ``(n, BLOCK)`` f32 uniform noise -> (codes int8 ``(n, BLOCK)``, scales
    f32 ``(n, 1)``).  ``fixed_step`` (a float) is every row's scale;
    ``None`` picks the adaptive per-row scale."""
    n = y.shape[0]
    _check_rows("y", y, BLOCK, n, n, (torch.float32, torch.bfloat16))
    _check_rows("noise", noise, BLOCK, n, n, (torch.float32,))
    with kernel_call("quantize_blocks", encode_bytes(
            y, n, BLOCK, BLOCK + SCALE_BYTES)):
        if y.device.type == "cpu" and noise.device.type == "cpu":
            return quantize_blocks_plain(y, noise, fixed_step=fixed_step)
        if on_meta(y, noise):
            return (torch.empty((n, BLOCK), dtype=torch.int8,
                                device=y.device),
                    torch.empty((n, 1), dtype=torch.float32,
                                device=y.device))
        return _quantize_blocks_launch(y, noise, fixed_step, n)


def _quantize_blocks_launch(y, noise, fixed_step, n):
    if y.device.type != "cuda" or noise.device != y.device:
        raise ValueError(f"quantize_blocks: y on {y.device}, noise on "
                         f"{noise.device}; both must be on one CUDA device "
                         "(or both on the CPU)")
    if not (y.is_contiguous() and noise.is_contiguous()):
        raise ValueError("quantize_blocks: CUDA operands must be contiguous")
    codes = torch.empty((n, BLOCK), dtype=torch.int8, device=y.device)
    scales = torch.empty((n, 1), dtype=torch.float32, device=y.device)
    step = 0.0 if fixed_step is None else float(np.float32(fixed_step))
    err = _blocks_kernel()(
        y.data_ptr(), int(y.dtype == torch.bfloat16), noise.data_ptr(),
        codes.data_ptr(), scales.data_ptr(), n, int(fixed_step is not None),
        step, torch.cuda.current_stream(y.device).cuda_stream)
    quantize_blocks.launches += 1
    if err != 0:
        raise RuntimeError(f"quantize_blocks kernel launch failed: CUDA "
                           f"error {err}")
    return codes, scales


quantize_blocks.launches = 0
