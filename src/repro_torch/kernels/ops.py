"""Layout helpers and device-dispatching entry points of the kernels.

Port of ``repro.kernels.ops``: the int8 payload and the sub-byte
(int4/int2) and top-k payloads of ``kernels.bitpack`` for the packed
exchange, the separate int8 codes and scales of the per-leaf reference
transport, and the flash-decode partials of serving.
Dispatch is by device, not by flag: a CPU tensor takes the plain PyTorch
version and a CUDA tensor launches the hand-written kernel (or raises).
Unlike the TPU grid, the CUDA kernels take any row range, so there is no
tile-alignment fallback.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .bitpack import (subbyte_decode_combine, subbyte_encode_payload,
                      topk_decode_combine, topk_encode_payload)
from .dequant_combine import dequant_combine, dequant_combine_payload
from .gqa_decode import gqa_decode
from .quantize import (BLOCK, SCALE_BYTES, TILE_N, pack_payload,
                       quantize_blocks, quantize_payload, unpack_payload)

__all__ = ["BLOCK", "TILE_N", "SCALE_BYTES", "padded_block_rows", "blockify",
           "unblockify", "payload_width", "pack_payload", "unpack_payload",
           "quantize_payload", "dequant_combine_payload",
           "subbyte_encode_payload", "subbyte_decode_combine",
           "topk_encode_payload", "topk_decode_combine", "quantize_blocks",
           "dequant_combine", "gqa_decode"]


def padded_block_rows(n_elements: int, block: int = BLOCK,
                      tile_n: int = TILE_N) -> int:
    """Rows of ``block`` elements holding ``n_elements``, padded to a
    ``tile_n`` multiple."""
    rows = math.ceil(max(n_elements, 1) / block)
    return int(math.ceil(rows / tile_n) * tile_n)


def blockify(flat: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """1-D -> (n_rows, block) zero-padded, rows padded to TILE_N."""
    n = flat.shape[0]
    rows = padded_block_rows(n, block)
    return F.pad(flat, (0, rows * block - n)).reshape(rows, block)


def unblockify(blocks: torch.Tensor, n: int) -> torch.Tensor:
    return blocks.reshape(-1)[:n]


def payload_width(block: int = BLOCK) -> int:
    """Bytes per payload row: ``block`` int8 codes + one fp32 scale."""
    return block + SCALE_BYTES
