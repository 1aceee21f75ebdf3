"""Wire codecs: how a packed block row becomes wire bytes and back.

Port of the ``WireCodec`` contract and the ``Int8Codec`` of
``repro.core.codec`` (the sub-byte and top-k codecs come with a later
slice).  A codec maps ``(n_rows, BLOCK)`` float32 rows to ``(n_rows,
payload_width)`` uint8 wire rows and back, fused with the consensus combine
on the receive side.  Every codec is row-local, so the static
``row_offset``/``n_rows`` chunk views of the kernels carry over.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops as kops

__all__ = ["WireCodec", "Int8Codec", "by_name"]


class WireCodec:
    """Payload format contract between the compressor and the transport."""

    name: str
    #: largest transmittable |code| (the clip boundary)
    code_max: int

    def payload_width(self, block: int = kops.BLOCK) -> int:
        """Wire bytes per block row."""
        raise NotImplementedError

    def payload_bytes(self, n_rows: int, block: int = kops.BLOCK) -> int:
        """Wire bytes of an ``n_rows``-row payload (one ring direction)."""
        return n_rows * self.payload_width(block)

    def codes_per_row(self, block: int = kops.BLOCK) -> int:
        """Transmitted codes per row (the clip-fraction denominator)."""
        return block

    def encode_payload(self, y, noise, fixed_step=None, row_offset: int = 0,
                       n_rows: int | None = None) -> torch.Tensor:
        """(rows, BLOCK) f32 differential -> (rows, payload_width) uint8."""
        raise NotImplementedError

    def decode_combine(self, payload_self, payload_left, payload_right,
                       x_tilde, m_agg, w_self, w_side, deamp,
                       row_offset: int = 0, n_rows: int | None = None):
        """Fused decode + shadow update + ring combine; returns
        (x_tilde', m_agg', combined), all chunk-height."""
        raise NotImplementedError

    def count_clipped(self, payload, block: int = kops.BLOCK):
        """Transmitted codes at the clip boundary (paper §IV-D overflow
        monitoring), as a float32 scalar tensor."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Int8Codec(WireCodec):
    """int8 codes + fp32 scale per row: the packed main-path wire."""

    name: str = "int8"
    code_max: int = 127

    def payload_width(self, block: int = kops.BLOCK) -> int:
        return kops.payload_width(block)

    def encode_payload(self, y, noise, fixed_step=None, row_offset=0,
                       n_rows=None):
        return kops.quantize_payload(y, noise, fixed_step=fixed_step,
                                     row_offset=row_offset, n_rows=n_rows)

    def decode_combine(self, payload_self, payload_left, payload_right,
                       x_tilde, m_agg, w_self, w_side, deamp,
                       row_offset=0, n_rows=None):
        return kops.dequant_combine_payload(
            payload_self, payload_left, payload_right, x_tilde, m_agg,
            w_self, w_side, deamp, row_offset=row_offset, n_rows=n_rows)

    def count_clipped(self, payload, block: int = kops.BLOCK):
        codes = payload[..., :block].view(torch.int8)
        return (codes.to(torch.int16).abs() >= self.code_max).sum(
            dtype=torch.float32)


_CODECS = {"int8": Int8Codec()}


def by_name(name: str) -> WireCodec:
    if name not in _CODECS:
        raise KeyError(f"unknown wire codec {name!r}; ported: "
                       f"{sorted(_CODECS)}")
    return _CODECS[name]
