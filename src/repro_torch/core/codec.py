"""Wire codecs: how a packed block row becomes wire bytes and back.

Port of ``repro.core.codec``.  A codec maps ``(n_rows, BLOCK)`` float32
rows to ``(n_rows, payload_width)`` uint8 wire rows and back, fused with
the consensus combine on the receive side.  Every codec is row-local, so
the static ``row_offset``/``n_rows`` chunk views of the kernels carry over.

  ``int8``          int8 codes + fp32 scale (``kernels/quantize.py``)
  ``int4``/``int2`` codes bit-packed 2/4 per byte + bf16 scale
  ``topk``          one magnitude-proportionally sampled element per
                    ``BLOCK // k`` stratum, inverse-probability scaled:
                    bitmap + k int8 values + bf16 scale
                    (``kernels/bitpack.py``)

:class:`AdaptiveBitController` re-selects the codec per epoch from the
residual RMS against the amplified grid ``Delta_0 / k^gamma``, the clip
fraction and a byte budget; over a mixed wire plan (``core.wireplan``) it
picks the tier of the plan's hot slots.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.kernels import bitpack
from repro_torch.kernels import ops as kops

__all__ = ["WireCodec", "Int8Codec", "SubByteCodec", "TopKCodec",
           "by_name", "CODEC_NAMES", "AdaptiveBitController"]


def _count(mask: torch.Tensor) -> torch.Tensor:
    """An integer count as a float32 scalar tensor (the reference's)."""
    return mask.sum(dtype=torch.float32)


class WireCodec:
    """Payload format contract between the compressor and the transport."""

    name: str
    #: largest transmittable |code| (the clip boundary)
    code_max: int

    # -- static geometry -------------------------------------------------
    def payload_width(self, block: int = kops.BLOCK) -> int:
        """Wire bytes per block row."""
        raise NotImplementedError

    def payload_bytes(self, n_rows: int, block: int = kops.BLOCK) -> int:
        """Wire bytes of an ``n_rows``-row payload (one ring direction)."""
        return n_rows * self.payload_width(block)

    def noise_cols(self, block: int = kops.BLOCK) -> int:
        """Uniform-noise columns consumed per block row."""
        return block

    def codes_per_row(self, block: int = kops.BLOCK) -> int:
        """Transmitted codes per row (the clip-fraction denominator)."""
        return block

    def coverage(self, block: int = kops.BLOCK) -> float:
        """Share of each row the codec transmits: 1.0 for dense codecs,
        ``k / block`` for top-k (the controller's capacity scale)."""
        del block
        return 1.0

    # -- wire transformation --------------------------------------------
    def encode_payload(self, y, noise, fixed_step=None, row_offset: int = 0,
                       n_rows: int | None = None, out=None) -> torch.Tensor:
        """(rows, BLOCK) f32 differential -> (rows, payload_width) uint8,
        written into ``out`` when it is given."""
        raise NotImplementedError

    def decode_payload(self, payload, block: int = kops.BLOCK):
        """Payload -> dense (rows, BLOCK) float32 (plain PyTorch: tests and
        metrics; the exchange decodes inside ``decode_combine``)."""
        raise NotImplementedError

    def decode_combine(self, payload_self, payload_left, payload_right,
                       x_tilde, m_agg, w_self, w_side, deamp,
                       row_offset: int = 0, n_rows: int | None = None,
                       out=None):
        """Fused decode + shadow update + ring combine; returns
        (x_tilde', m_agg', combined), all chunk-height, written into the
        three tensors of ``out`` when it is given."""
        raise NotImplementedError

    def count_clipped(self, payload, block: int = kops.BLOCK):
        """Transmitted codes at the clip boundary (paper §IV-D overflow
        monitoring), as a float32 scalar tensor."""
        raise NotImplementedError

    def count_saturated(self, y, fixed_step, payload,
                        block: int = kops.BLOCK):
        """Transmitted values that overflowed the fixed grid: the
        ``overflow_frac`` signal.  The boundary census (``count_clipped``)
        by default, honest for the 255-level grids of int8 and top-k."""
        del y, fixed_step
        return self.count_clipped(payload, block)


@dataclasses.dataclass(frozen=True)
class Int8Codec(WireCodec):
    """int8 codes + fp32 scale per row: the packed main-path wire."""

    name: str = "int8"
    code_max: int = 127

    def payload_width(self, block: int = kops.BLOCK) -> int:
        return kops.payload_width(block)

    def encode_payload(self, y, noise, fixed_step=None, row_offset=0,
                       n_rows=None, out=None):
        return kops.quantize_payload(y, noise, fixed_step=fixed_step,
                                     row_offset=row_offset, n_rows=n_rows,
                                     out=out)

    def decode_payload(self, payload, block: int = kops.BLOCK):
        if payload.shape[-1] != self.payload_width(block):
            raise ValueError(f"payload width {payload.shape[-1]} != "
                             f"{self.payload_width(block)}")
        # the codes read where they lie (no contiguous copy); int8 times
        # float32 widens them exactly, so each value is rounded once
        scales = payload[:, block:].contiguous().view(torch.float32)
        return payload[:, :block].view(torch.int8) * scales

    def decode_combine(self, payload_self, payload_left, payload_right,
                       x_tilde, m_agg, w_self, w_side, deamp,
                       row_offset=0, n_rows=None, out=None):
        return kops.dequant_combine_payload(
            payload_self, payload_left, payload_right, x_tilde, m_agg,
            w_self, w_side, deamp, row_offset=row_offset, n_rows=n_rows,
            out=out)

    def count_clipped(self, payload, block: int = kops.BLOCK):
        codes = payload[..., :block].view(torch.int8)
        return _count(codes.to(torch.int16).abs() >= self.code_max)


@dataclasses.dataclass(frozen=True)
class SubByteCodec(WireCodec):
    """Dense ``code_bits``-bit codes (4 -> int4, 2 -> int2), bit-packed
    ``8 // code_bits`` per byte, + 2 bf16 scale bytes per row."""

    code_bits: int = 4

    def __post_init__(self):
        if self.code_bits not in (2, 4):
            raise ValueError(f"code_bits must be 2 or 4, got {self.code_bits}")

    @property
    def name(self) -> str:  # type: ignore[override]
        return f"int{self.code_bits}"

    @property
    def code_max(self) -> int:  # type: ignore[override]
        return bitpack.subbyte_code_max(self.code_bits)

    def payload_width(self, block: int = kops.BLOCK) -> int:
        return bitpack.subbyte_payload_width(block, self.code_bits)

    def encode_payload(self, y, noise, fixed_step=None, row_offset=0,
                       n_rows=None, out=None):
        return kops.subbyte_encode_payload(
            y, noise, self.code_bits, fixed_step=fixed_step,
            row_offset=row_offset, n_rows=n_rows, out=out)

    def decode_payload(self, payload, block: int = kops.BLOCK):
        return bitpack.subbyte_decode_plain(payload, self.code_bits, block)

    def decode_combine(self, payload_self, payload_left, payload_right,
                       x_tilde, m_agg, w_self, w_side, deamp,
                       row_offset=0, n_rows=None, out=None):
        return kops.subbyte_decode_combine(
            payload_self, payload_left, payload_right, x_tilde, m_agg,
            w_self, w_side, deamp, self.code_bits, row_offset=row_offset,
            n_rows=n_rows, out=out)

    def count_clipped(self, payload, block: int = kops.BLOCK):
        pack = bitpack.subbyte_pack(self.code_bits)
        codes = bitpack._unpack_fields(payload[:, :block // pack],
                                       self.code_max, pack)
        return _count(codes.abs() >= self.code_max)

    def count_saturated(self, y, fixed_step, payload,
                        block: int = kops.BLOCK):
        """|y| beyond the fixed grid, ``|y| > code_max * bf16(step)``,
        counted from the differential: on a 3- or 15-level alphabet the
        boundary codes are mostly legitimate values, not clips."""
        if fixed_step is None:
            return self.count_clipped(payload, block)
        step = np.float32(bitpack._bf16_round(
            torch.tensor(float(np.float32(fixed_step)))).item())
        return _count(y.abs() > float(np.float32(self.code_max) * step))


@dataclasses.dataclass(frozen=True)
class TopKCodec(WireCodec):
    """Sparse one-per-stratum codec: k magnitude-proportionally sampled
    elements per row (unbiased by inverse-probability scaling), shipped as
    a BLOCK-bit bitmap + k int8 values + 2 bf16 scale bytes."""

    k: int = 64
    name: str = "topk"
    code_max: int = 127

    def __post_init__(self):
        if self.k < 1 or kops.BLOCK % self.k:
            raise ValueError(f"k must divide BLOCK={kops.BLOCK}, got {self.k}")

    def payload_width(self, block: int = kops.BLOCK) -> int:
        return bitpack.topk_payload_width(block, self.k)

    def noise_cols(self, block: int = kops.BLOCK) -> int:
        # [0, block): selection race; [block, block + k): value rounding
        return 2 * block

    def codes_per_row(self, block: int = kops.BLOCK) -> int:
        return self.k

    def coverage(self, block: int = kops.BLOCK) -> float:
        return self.k / block

    def encode_payload(self, y, noise, fixed_step=None, row_offset=0,
                       n_rows=None, out=None):
        return kops.topk_encode_payload(
            y, noise, self.k, fixed_step=fixed_step, row_offset=row_offset,
            n_rows=n_rows, out=out)

    def decode_payload(self, payload, block: int = kops.BLOCK):
        return bitpack.topk_decode_plain(payload, self.k, block)

    def decode_combine(self, payload_self, payload_left, payload_right,
                       x_tilde, m_agg, w_self, w_side, deamp,
                       row_offset=0, n_rows=None, out=None):
        return kops.topk_decode_combine(
            payload_self, payload_left, payload_right, x_tilde, m_agg,
            w_self, w_side, deamp, self.k, row_offset=row_offset,
            n_rows=n_rows, out=out)

    def count_clipped(self, payload, block: int = kops.BLOCK):
        wb = block // 8
        vals = payload[:, wb:wb + self.k].view(torch.int8)
        return _count(vals.to(torch.int16).abs() >= self.code_max)


#: every entry is a valid ``by_name`` spec; "topk:k=128" stands in for the
#: whole ``topk:k=<int>`` family (any k >= 1 dividing BLOCK)
CODEC_NAMES = ("int8", "int4", "int2", "topk", "topk:k=128")


def by_name(name: str) -> WireCodec:
    """Codec registry.  Besides the bare names, ``"topk:k=<int>"`` sets the
    sparse codec's samples per row; k = 64 keeps the bare name ``topk``."""
    reg = {
        "int8": Int8Codec,
        "int4": lambda: SubByteCodec(code_bits=4),
        "int2": lambda: SubByteCodec(code_bits=2),
        "topk": TopKCodec,
    }
    if name in reg:
        return reg[name]()
    if name.startswith("topk:k="):
        try:
            k = int(name[len("topk:k="):])
        except ValueError:
            raise KeyError(
                f"unknown wire codec {name!r}; the topk parameter grammar "
                "is 'topk:k=<int>'") from None
        return TopKCodec(k=k, name="topk" if k == 64 else name)
    raise KeyError(f"unknown wire codec {name!r}; have "
                   f"{sorted(reg) + ['topk:k=<int>']}")


# ---------------------------------------------------------------------------
# Adaptive bit-budget controller (host level, epoch granularity)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdaptiveBitController:
    """Per-epoch codec selector driven by runtime feedback (port of the
    reference's controller, decision for decision).

      fidelity need   n(k) = max(residual_rms, consensus_err) * headroom
                      / Delta_k,  Delta_k = fixed_step0 / k^gamma
      candidates      ladder entries whose 2 * n_rows * payload_width fits
                      ``byte_budget`` (all without a budget; the cheapest
                      when none fits), cheapest first
      target          cheapest candidate whose capacity, code_max times row
                      coverage, reaches n(k); else the highest capacity
      up-switches     immediate; also forced one rung up when
                      overflow_frac > overflow_hi
      down-switches   only after ``patience`` consecutive epochs agree

    ``residual_rms=None`` (no fixed grid) leaves only the budget filter.

    Plan mode: with a built mixed ``core.wireplan.WirePlan`` in ``plan``,
    each ladder entry names the tier of the plan's hot slots
    (``plan.retier_hot``), the other slots stay pinned, and ``wire_bytes``
    prices the whole heterogeneous payload.  ``initial`` and ``select``
    still return ladder names; the trainer maps them back to plan specs
    with ``PlanSpec.with_hot_tier``.
    """

    ladder: tuple[str, ...] = ("int2", "int4", "int8")
    byte_budget: float | None = None
    gamma: float = 1.0
    fixed_step0: float = 1e-3
    headroom: float = 4.0        # target code_max >= headroom * rms / Delta_k
    overflow_hi: float = 0.01    # clip fraction that forces a rung up
    patience: int = 2            # consecutive epochs before a down-switch
    #: optional WirePlan (duck-typed: retier_hot / payload_bytes)
    plan: Any = None
    current: str | None = None
    _pending: str | None = dataclasses.field(default=None, repr=False)
    _pending_count: int = dataclasses.field(default=0, repr=False)

    def __post_init__(self):
        if not self.ladder:
            raise ValueError("ladder must be non-empty")
        for name in self.ladder:
            by_name(name)  # validates

    # -- static helpers --------------------------------------------------
    def wire_bytes(self, name: str, n_rows: int,
                   block: int = kops.BLOCK) -> float:
        """Bytes per step a candidate puts on the ring (both directions):
        the codec's payload, or in plan mode the whole payload of the plan
        with its hot slots moved to ``name``."""
        if self.plan is not None:
            return 2.0 * float(self.plan.retier_hot(name).payload_bytes)
        return 2.0 * by_name(name).payload_bytes(n_rows, block)

    def candidates(self, n_rows: int, block: int = kops.BLOCK
                   ) -> tuple[str, ...]:
        """Budget-filtered ladder, cheapest first."""
        order = sorted(self.ladder,
                       key=lambda n: (by_name(n).payload_width(block),
                                      by_name(n).code_max))
        if self.byte_budget:
            fit = tuple(n for n in order
                        if self.wire_bytes(n, n_rows, block)
                        <= self.byte_budget)
            return fit if fit else (order[0],)
        return tuple(order)

    def candidate_table(self, n_rows: int, block: int = kops.BLOCK
                        ) -> list[dict]:
        """The priced ladder, one JSON-able row per rung."""
        cands = set(self.candidates(n_rows, block))
        return [{"name": name,
                 "wire_bytes": self.wire_bytes(name, n_rows, block),
                 "code_max": by_name(name).code_max,
                 "coverage": by_name(name).coverage(block),
                 "capacity": self._capacity(name, block),
                 "payload_width": by_name(name).payload_width(block),
                 "fits_budget": name in cands,
                 "current": name == self.current}
                for name in self.ladder]

    def _fidelity(self, name: str) -> int:
        return self.ladder.index(name)

    @staticmethod
    def _capacity(name: str, block: int = kops.BLOCK) -> float:
        """Fidelity ceiling of one rung: ``code_max`` times the share of
        the row shipped (``code_max`` itself for dense codecs)."""
        c = by_name(name)
        return float(c.code_max) * c.coverage(block)

    def target(self, next_step: int, residual_rms: float | None,
               overflow_frac: float, n_rows: int,
               block: int = kops.BLOCK,
               consensus_err: float | None = None) -> str:
        cands = self.candidates(n_rows, block)
        if residual_rms is None:          # adaptive grid: budget filter only
            pick = cands[0]
        else:
            if consensus_err is not None:
                residual_rms = max(float(residual_rms), float(consensus_err))
            delta_k = (self.fixed_step0
                       / max(1.0, float(next_step)) ** self.gamma)
            need = float(residual_rms) * self.headroom / delta_k
            pick = None
            for name in cands:
                if self._capacity(name, block) >= need:
                    pick = name
                    break
            if pick is None:
                pick = max(cands, key=lambda n: self._capacity(n, block))
        if (self.current is not None and overflow_frac > self.overflow_hi
                and self._fidelity(pick) <= self._fidelity(self.current)):
            # observed clipping overrides the prediction: force a rung up
            cur = self._fidelity(self.current)
            above = [n for n in cands if self._fidelity(n) > cur]
            if above:
                pick = min(above, key=self._fidelity)
        return pick

    def initial(self, n_rows: int, block: int = kops.BLOCK) -> str:
        """Conservative start: the highest-fidelity budget candidate."""
        self.current = max(self.candidates(n_rows, block),
                           key=self._fidelity)
        return self.current

    # -- the state machine ----------------------------------------------
    def select(self, next_step: int, residual_rms: float | None,
               overflow_frac: float, n_rows: int,
               block: int = kops.BLOCK,
               consensus_err: float | None = None) -> str:
        """Advance one epoch; returns the codec to use until the next
        call."""
        pick = self.target(next_step, residual_rms, overflow_frac, n_rows,
                           block, consensus_err=consensus_err)
        if self.current is None:
            self.current = pick
        elif self._fidelity(pick) > self._fidelity(self.current):
            self.current = pick           # up-switch: immediate
            self._pending, self._pending_count = None, 0
        elif pick != self.current:
            if pick == self._pending:
                self._pending_count += 1
            else:
                self._pending, self._pending_count = pick, 1
            if self._pending_count >= self.patience:
                self.current = pick       # down-switch: after patience
                self._pending, self._pending_count = None, 0
        else:
            self._pending, self._pending_count = None, 0
        return self.current
