"""Wire plans: one codec per leaf of the packed buffer, one flat payload.

Port of ``repro.core.wireplan``.  A :class:`WirePlan` binds a
:class:`~repro_torch.core.wire.WireLayout` to one wire codec per leaf slot
and owns the resulting heterogeneous payload geometry:

* adjacent same-codec slots merge into contiguous **codec runs**;
* per-run payload **byte offsets are a prefix sum** of ``n_rows *
  payload_width``, so the whole payload is one flat uint8 buffer;
* pipeline **chunk bounds snap to run edges** (no chunk straddles a codec
  change), so every chunk is a single-width payload and any chunking gives
  the packed exchange's bytes;
* ``payload_bytes`` / ``noise_cols`` / ``codes_total`` replace the
  uniform-codec accounting of ``ConsensusRuntime``.

Plan specs (:func:`parse_spec`) keep ``ConsensusConfig.wire_codec`` a
string: a bare codec name is a uniform plan, ``"mixed:norm=int2,embed=int4,
*=int8"`` a rule list matched against leaf paths, first match wins.
Patterns holding ``*``, ``?`` or ``[`` are fnmatch globs against the whole
path; any other pattern is a substring match.

The geometry (runs, fragments, transfer units, chunk bounds) is the
reference's, list for list.  Encoding differs: the reference cuts each run
into a ``TILE_N``-aligned interior and ragged edges, because only aligned
views launch as Pallas grids there.  The port's kernels take any row
range, so :meth:`WirePlan.encode_unit` issues **one launch per codec run**
over the run's rows inside the unit, merging the reference's ragged
fragments into their run: encodings are row-local, so the bytes are the
same.  On a CUDA tensor every row goes through its codec's kernel.
"""
from __future__ import annotations

import dataclasses
from fnmatch import fnmatchcase

import torch

from repro_torch.core import codec as wire_codec
from repro_torch.core import tree as T
from repro_torch.core import wire
from repro_torch.core.compression import Compressor
from repro_torch.kernels import ops as kops

__all__ = ["PlanSpec", "parse_spec", "grouped_placement", "CodecRun",
           "Fragment", "TransferUnit", "WirePlan", "WirePlanCompressor",
           "PUSH_SUM_TRAILER_BYTES"]

#: the push-sum transport appends the fp32 weight to the last transfer
#: unit's payload, as the reference's does (``WirePlan.wire_bytes(
#: push_sum=True)``; ``ConsensusRuntime`` writes and reads the trailer)
PUSH_SUM_TRAILER_BYTES = 4

_MIXED_PREFIX = "mixed:"

#: byte alignment each codec's kernels read and write its payload rows at
#: (32-bit code words for int8, 16-bit for the sub-byte codecs, bytes for
#: top-k): a fragment of a flat payload that starts elsewhere is encoded
#: aside and copied in, or copied out before its combine
_PAYLOAD_ALIGN = {"int8": 4, "int4": 2, "int2": 2}


# ---------------------------------------------------------------------------
# plan specs: the string grammar behind ConsensusConfig.wire_codec
# ---------------------------------------------------------------------------

def _check_codec_name(name: str) -> None:
    """Validate a codec name with the ValueError every plan entry point
    raises (``codec.by_name`` raises KeyError)."""
    try:
        wire_codec.by_name(name)
    except KeyError:
        raise ValueError(
            f"unknown wire codec {name!r} in plan; have "
            f"{wire_codec.CODEC_NAMES}") from None


def _rank(name: str, block: int = kops.BLOCK) -> tuple[int, int]:
    """Fidelity order of codecs: code ceiling, then bytes per row."""
    cd = wire_codec.by_name(name)
    return cd.code_max, cd.payload_width(block)


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """A layout-independent plan recipe: ordered (pattern, codec) rules;
    slots no rule matches take ``default``.  A spec whose rules all name
    the default's codec is uniform."""

    rules: tuple[tuple[str, str], ...] = ()
    default: str = "int8"

    def __post_init__(self):
        _check_codec_name(self.default)
        for pat, name in self.rules:
            if not pat:
                raise ValueError("empty pattern in wire plan rule")
            _check_codec_name(name)

    @property
    def is_uniform(self) -> bool:
        return all(name == self.default for _, name in self.rules)

    @property
    def uniform_codec(self) -> str | None:
        """The single codec of a uniform plan, else None."""
        return self.default if self.is_uniform else None

    def to_string(self) -> str:
        if self.is_uniform:
            return self.default
        body = ",".join(f"{p}={n}" for p, n in self.rules)
        return f"{_MIXED_PREFIX}{body},*={self.default}"

    def codec_for_path(self, path: str) -> str:
        for pat, name in self.rules:
            if _pattern_matches(pat, path):
                return name
        return self.default

    def build(self, layout: wire.WireLayout) -> "WirePlan":
        return WirePlan.from_slot_codecs(
            layout, tuple(self.codec_for_path(s.path) for s in layout.slots))

    @property
    def hot_codec(self) -> str:
        """The highest-fidelity codec the spec names (rules and default).
        A layout-independent upper bound: a rule may match no slot, so
        whatever drives a built plan passes ``WirePlan.hot_codec`` to
        :meth:`with_hot_tier` as ``hot``."""
        names = {name for _, name in self.rules} | {self.default}
        return max(names, key=_rank)

    def with_hot_tier(self, name: str, hot: str | None = None) -> "PlanSpec":
        """Every rule (and the default) assigning the hot codec now assigns
        ``name``; the other rules stay pinned.  ``hot`` overrides the
        spec-level proxy (pass the built plan's ``hot_codec``)."""
        _check_codec_name(name)
        hot = self.hot_codec if hot is None else hot
        rules = tuple((p, name if n == hot else n) for p, n in self.rules)
        default = name if self.default == hot else self.default
        return PlanSpec(rules=rules, default=default)


def grouped_placement(layout: wire.WireLayout,
                      slot_codecs) -> tuple[int, ...] | None:
    """Stable group-by-codec buffer placement for a mixed plan: leaves keep
    their relative order inside each codec group, groups are ordered by
    first occurrence in the current buffer order, so the plan has one run
    per codec.  ``None`` when the order is already codec-contiguous."""
    slot_codecs = tuple(slot_codecs)
    if len(slot_codecs) != len(layout.slots):
        raise ValueError(f"{len(slot_codecs)} slot codecs != "
                         f"{len(layout.slots)} layout slots")
    order = layout.buffer_order
    first_seen: list[str] = []
    for i in order:
        if slot_codecs[i] not in first_seen:
            first_seen.append(slot_codecs[i])
    placement = tuple(i for name in first_seen for i in order
                      if slot_codecs[i] == name)
    return None if placement == tuple(order) else placement


def _pattern_matches(pat: str, path: str) -> bool:
    if pat == "*":
        return True
    if any(c in pat for c in "*?["):
        return fnmatchcase(path, pat)
    return pat in path


def parse_spec(spec: str) -> PlanSpec:
    """Parse a ``wire_codec`` string: a bare codec name (a uniform plan) or
    ``mixed:pattern=codec,...`` (first match wins; ``*=codec`` or
    ``default=codec`` sets the fallback, else int8)."""
    if not isinstance(spec, str):
        raise ValueError(f"wire plan spec must be a string, got {spec!r}")
    if not spec.startswith(_MIXED_PREFIX):
        try:
            wire_codec.by_name(spec)
        except KeyError:
            raise ValueError(
                f"wire_codec must be a codec name "
                f"{wire_codec.CODEC_NAMES} or a 'mixed:<rules>' plan spec, "
                f"got {spec!r}") from None
        return PlanSpec(rules=(), default=spec)
    rules: list[tuple[str, str]] = []
    default = None
    for item in spec[len(_MIXED_PREFIX):].split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(
                f"wire_codec plan rule {item!r} is not 'pattern=codec' "
                f"(spec {spec!r})")
        pat, _, name = item.partition("=")
        pat, name = pat.strip(), name.strip()
        try:
            wire_codec.by_name(name)
        except KeyError:
            raise ValueError(
                f"wire_codec plan rule {item!r} names unknown codec "
                f"{name!r}; have {wire_codec.CODEC_NAMES}") from None
        if pat in ("*", "default"):
            if default is not None:
                raise ValueError(
                    f"wire_codec plan spec {spec!r} has two default rules")
            default = name
        else:
            rules.append((pat, name))
    if not rules and default is None:
        raise ValueError(f"wire_codec plan spec {spec!r} has no rules")
    return PlanSpec(rules=tuple(rules), default=default or "int8")


# ---------------------------------------------------------------------------
# heterogeneous payload geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CodecRun:
    """A maximal contiguous row range sharing one codec."""

    codec: str
    row_start: int
    n_rows: int
    byte_start: int              # prefix sum of the preceding runs' bytes

    @property
    def row_end(self) -> int:
        return self.row_start + self.n_rows


@dataclasses.dataclass(frozen=True)
class Fragment:
    """One contiguous single-codec row range of a transfer: a whole run or
    a piece of one."""

    codec: str
    row_start: int
    n_rows: int
    byte_start: int              # offset in the full flat payload

    @property
    def row_end(self) -> int:
        return self.row_start + self.n_rows


@dataclasses.dataclass(frozen=True)
class TransferUnit:
    """What one ring transfer carries: contiguous fragments whose payloads
    concatenate into one flat uint8 buffer.  The packed transport has one
    unit holding every run; the pipelined one a unit per chunk."""

    fragments: tuple[Fragment, ...]

    @property
    def row_start(self) -> int:
        return self.fragments[0].row_start

    @property
    def row_end(self) -> int:
        return self.fragments[-1].row_end

    @property
    def n_rows(self) -> int:
        return self.row_end - self.row_start

    @property
    def byte_start(self) -> int:
        return self.fragments[0].byte_start


@dataclasses.dataclass(frozen=True)
class WirePlan:
    """A WireLayout bound to one codec per leaf slot (static, hashable).

    Runs are contiguous, cover ``[0, layout.n_rows)`` and merge adjacent
    same-codec slots (the ``TILE_N`` tail extends the last run: zero rows
    encode to zero payload under every codec); ``run.byte_start`` is the
    prefix sum of the preceding runs' bytes."""

    layout: wire.WireLayout
    slot_codecs: tuple[str, ...]
    runs: tuple[CodecRun, ...]

    # -- construction ----------------------------------------------------
    @classmethod
    def from_slot_codecs(cls, layout: wire.WireLayout,
                         slot_codecs: tuple[str, ...]) -> "WirePlan":
        if len(slot_codecs) != len(layout.slots):
            raise ValueError(
                f"{len(slot_codecs)} slot codecs != {len(layout.slots)} "
                "layout slots")
        for name in slot_codecs:
            _check_codec_name(name)
        runs: list[CodecRun] = []
        byte = 0
        for i in layout.buffer_order:       # runs follow buffer order
            slot, name = layout.slots[i], slot_codecs[i]
            if runs and runs[-1].codec == name:
                prev = runs[-1]
                runs[-1] = dataclasses.replace(
                    prev, n_rows=prev.n_rows + slot.n_rows)
            else:
                runs.append(CodecRun(codec=name, row_start=slot.row_start,
                                     n_rows=slot.n_rows, byte_start=byte))
            byte = (runs[-1].byte_start + runs[-1].n_rows
                    * wire_codec.by_name(name).payload_width(layout.block))
        if not runs:                                # empty tree: one run
            runs.append(CodecRun(codec="int8", row_start=0, n_rows=0,
                                 byte_start=0))
        tail = layout.n_rows - runs[-1].row_end
        if tail:
            runs[-1] = dataclasses.replace(runs[-1],
                                           n_rows=runs[-1].n_rows + tail)
        return cls(layout=layout, slot_codecs=tuple(slot_codecs),
                   runs=tuple(runs))

    @classmethod
    def uniform(cls, layout: wire.WireLayout, name: str) -> "WirePlan":
        return cls.from_slot_codecs(layout, (name,) * len(layout.slots))

    @classmethod
    def from_rules(cls, layout: wire.WireLayout, rules,
                   default: str = "int8") -> "WirePlan":
        """Programmatic :func:`parse_spec`: ordered ``(pattern, codec)``
        pairs, first match wins."""
        return PlanSpec(rules=tuple((p, n) for p, n in rules),
                        default=default).build(layout)

    # -- static geometry and accounting ---------------------------------
    @property
    def n_runs(self) -> int:
        return len(self.runs)

    @property
    def is_uniform(self) -> bool:
        return len({r.codec for r in self.runs}) <= 1

    def run_width(self, run) -> int:
        return wire_codec.by_name(run.codec).payload_width(self.layout.block)

    @property
    def payload_bytes(self) -> int:
        """Flat wire bytes of one encoded buffer (one ring direction)."""
        last = self.runs[-1]
        return last.byte_start + last.n_rows * self.run_width(last)

    def wire_bytes(self, push_sum: bool = False) -> int:
        """One ring direction's bytes, with the reference's push-sum weight
        trailer when ``push_sum``."""
        return self.payload_bytes + (PUSH_SUM_TRAILER_BYTES if push_sum
                                     else 0)

    def describe(self) -> dict:
        """JSON-able run geometry and payload totals."""
        return {
            "runs": [{"codec": r.codec, "row_start": r.row_start,
                      "n_rows": r.n_rows, "byte_start": r.byte_start,
                      "payload_bytes": r.n_rows * self.run_width(r)}
                     for r in self.runs],
            "payload_bytes": self.payload_bytes,
            "is_uniform": self.is_uniform,
            "hot_codec": self.hot_codec,
        }

    def noise_cols(self, block: int | None = None) -> int:
        """Columns of the one noise buffer an encode consumes: the most any
        codec of the plan reads; each run reads its leading columns."""
        block = self.layout.block if block is None else block
        return max(wire_codec.by_name(n).noise_cols(block)
                   for n in {r.codec for r in self.runs})

    def codes_total(self, block: int | None = None) -> int:
        """Transmitted codes per encoded buffer (the overflow denominator)."""
        block = self.layout.block if block is None else block
        return sum(r.n_rows * wire_codec.by_name(r.codec).codes_per_row(block)
                   for r in self.runs)

    # -- the adaptive controller's tiers ----------------------------------
    @property
    def hot_codec(self) -> str:
        """The highest-fidelity codec that ships (the controller's tier)."""
        return max({r.codec for r in self.runs},
                   key=lambda n: _rank(n, self.layout.block))

    def retier_hot(self, name: str) -> "WirePlan":
        """The plan with its hot slots moved to ``name``, the rest
        pinned."""
        hot = self.hot_codec
        return WirePlan.from_slot_codecs(
            self.layout,
            tuple(name if c == hot else c for c in self.slot_codecs))

    # -- chunking: pipeline bounds never straddle a codec run --------------
    def _run_pieces(self, run: CodecRun, tile: int) -> list[tuple[int, int]]:
        """The run's indivisible (row_start, n_rows) pieces, cut at
        absolute ``tile`` boundaries."""
        if run.n_rows == 0:
            return []
        pts = [run.row_start]
        t = (run.row_start // tile + 1) * tile
        while t < run.row_end:
            pts.append(t)
            t += tile
        pts.append(run.row_end)
        return [(pts[i], pts[i + 1] - pts[i]) for i in range(len(pts) - 1)]

    def chunk_bounds(self, pipeline_chunks: int,
                     tile: int = kops.TILE_N) -> tuple[tuple[int, int], ...]:
        """Static (row_start, n_rows) pipeline chunk bounds: each chunk
        inside one run, run interiors cut on tile boundaries, the chunk
        budget spread over the runs by rows (every run gets one; the
        request clamps to the pieces there are).  A uniform plan gives
        ``ChunkedLayout.split``'s bounds."""
        if pipeline_chunks < 1:
            raise ValueError(f"pipeline_chunks must be >= 1, got "
                             f"{pipeline_chunks}")
        live = [r for r in self.runs if r.n_rows > 0]
        pieces = [self._run_pieces(r, tile) for r in live]
        counts = [1] * len(live)
        budget = pipeline_chunks - len(live)
        while budget > 0:
            # grow the run with the most rows per chunk that can still be
            # cut (ties to the earlier run)
            best = None
            for i, r in enumerate(live):
                if counts[i] >= len(pieces[i]):
                    continue
                key = r.n_rows / counts[i]
                if best is None or key > best[0]:
                    best = (key, i)
            if best is None:
                break
            counts[best[1]] += 1
            budget -= 1
        bounds: list[tuple[int, int]] = []
        for ps, c in zip(pieces, counts):
            base, rem = divmod(len(ps), c)
            i = 0
            for j in range(c):
                take = base + (1 if j < rem else 0)
                seg = ps[i:i + take]
                i += take
                bounds.append((seg[0][0], sum(n for _, n in seg)))
        return tuple(bounds)

    def _fragment(self, run: CodecRun, start: int, rows: int) -> Fragment:
        return Fragment(codec=run.codec, row_start=start, n_rows=rows,
                        byte_start=run.byte_start
                        + (start - run.row_start) * self.run_width(run))

    def transfer_units(self, pipeline_chunks: int | None = None,
                       tile: int = kops.TILE_N) -> tuple[TransferUnit, ...]:
        """The ring transfers of one exchange step: ``None`` (packed) gives
        one unit holding every run as the reference's fragments; an int
        gives one single-fragment unit per chunk."""
        if pipeline_chunks is None:
            frags = tuple(f for r in self.runs if r.n_rows > 0
                          for f in self._run_fragments(r, tile))
            return (TransferUnit(fragments=frags),)
        return tuple(
            TransferUnit(fragments=(self._fragment(self.run_at(s), s, n),))
            for s, n in self.chunk_bounds(pipeline_chunks, tile))

    def _run_fragments(self, run: CodecRun, tile: int) -> list[Fragment]:
        """A run as the reference's 1-3 fragments: ragged head up to the
        first tile boundary, the tile-aligned interior, ragged tail."""
        start, end = run.row_start, run.row_end
        head_end = min(-(-start // tile) * tile, end)
        mid_end = max((end // tile) * tile, head_end)
        return [self._fragment(run, a, b - a)
                for a, b in ((start, head_end), (head_end, mid_end),
                             (mid_end, end)) if b > a]

    def n_chunks(self, pipeline_chunks: int) -> int:
        """Effective pipelined chunk count (at least the run count, at most
        the tile pieces)."""
        return len(self.chunk_bounds(pipeline_chunks))

    def fallback_fragments(self, pipeline_chunks: int | None = None,
                           tile: int = kops.TILE_N) -> int:
        """Geometry only: how many of the reference's fragments are not
        ``tile``-aligned (on the TPU those take its jnp path).  The port
        launches every row's kernel whatever this says."""
        return sum(1 for unit in self.transfer_units(pipeline_chunks, tile)
                   for f in unit.fragments
                   if f.n_rows and (f.row_start % tile or f.n_rows % tile))

    def run_at(self, row: int) -> CodecRun:
        for r in self.runs:
            if r.row_start <= row < r.row_end or (r.n_rows == 0
                                                  and row == r.row_start):
                return r
        raise ValueError(f"row {row} outside plan rows "
                         f"[0, {self.layout.n_rows})")

    # -- encode and decode --------------------------------------------------
    def unit_runs(self, unit: TransferUnit) -> list[Fragment]:
        """The unit's rows as one fragment per codec run: what the port
        launches (the reference's ragged fragments merged into their
        run)."""
        out = []
        for r in self.runs:
            lo, hi = max(r.row_start, unit.row_start), min(r.row_end,
                                                           unit.row_end)
            if hi > lo:
                out.append(self._fragment(r, lo, hi - lo))
        return out

    def encode_fragment(self, frag: Fragment, y, noise, fixed_step=None,
                        out=None):
        """One launch over a fragment's rows of the full-height ``y`` and
        noise: ``(frag.n_rows, width)`` uint8, written into ``out`` when it
        is given."""
        return wire_codec.by_name(frag.codec).encode_payload(
            y, noise, fixed_step=fixed_step, row_offset=frag.row_start,
            n_rows=frag.n_rows, out=out)

    def unit_bytes(self, unit: TransferUnit) -> int:
        """Length of the unit's flat payload."""
        last = unit.fragments[-1]
        return (last.byte_start - unit.byte_start
                + last.n_rows * wire_codec.by_name(last.codec).payload_width(
                    self.layout.block))

    def encode_unit(self, unit: TransferUnit, y, noise, fixed_step=None,
                    out=None):
        """The unit's flat 1-D uint8 payload (into ``out`` when it is
        given): one launch per codec run, each writing its rows' bytes in
        place."""
        if out is None:
            out = torch.empty(self.unit_bytes(unit), dtype=torch.uint8,
                              device=y.device)
        for f in self.unit_runs(unit):
            seg = self._rows_view(out, f, unit.byte_start)
            if seg.data_ptr() % _PAYLOAD_ALIGN.get(f.codec, 1):
                seg.copy_(self.encode_fragment(f, y, noise, fixed_step))
            else:
                self.encode_fragment(f, y, noise, fixed_step, out=seg)
        return out

    def encode(self, y, noise, fixed_step=None):
        """The whole buffer as one flat payload (the packed wire image)."""
        return self.encode_unit(self.transfer_units(None)[0], y, noise,
                                fixed_step)

    def _rows_view(self, payload_1d, frag: Fragment, base_byte: int):
        width = wire_codec.by_name(frag.codec).payload_width(
            self.layout.block)
        start = frag.byte_start - base_byte
        return payload_1d[start:start + frag.n_rows * width].view(
            frag.n_rows, width)

    def fragment_payload(self, payload_1d, frag: Fragment,
                         base_byte: int = 0):
        """A fragment's ``(n_rows, width)`` uint8 view of a flat payload
        that starts at ``base_byte``; a copy where the view would start
        off the alignment its combine kernel reads at."""
        seg = self._rows_view(payload_1d, frag, base_byte)
        if seg.data_ptr() % _PAYLOAD_ALIGN.get(frag.codec, 1):
            seg = seg.clone()
        return seg

    def decode_dense(self, payload_1d):
        """Flat payload -> dense ``(n_rows, block)`` float32 (plain
        PyTorch: tests and the reference algorithms' wire)."""
        return torch.cat([
            wire_codec.by_name(f.codec).decode_payload(
                self.fragment_payload(payload_1d, f), self.layout.block)
            for f in self.unit_runs(self.transfer_units(None)[0])])

    def count_saturated(self, y, fixed_step, payload_1d, base_byte: int = 0,
                        unit: TransferUnit | None = None):
        """Grid-saturation census (the overflow numerator) of a unit (the
        whole buffer by default) with each run's codec semantics, summed:
        integer counts, so the sum is exact."""
        if unit is None:
            unit = self.transfer_units(None)[0]
        total = None
        for f in self.unit_runs(unit):
            c = wire_codec.by_name(f.codec).count_saturated(
                y[f.row_start:f.row_end], fixed_step,
                self.fragment_payload(payload_1d, f, base_byte),
                self.layout.block)
            total = c if total is None else total + c
        return total


# ---------------------------------------------------------------------------
# the reference algorithms' wire
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WirePlanCompressor(Compressor):
    """A :class:`WirePlan` as a :class:`Compressor` of the paper's
    reference algorithms (``consensus.on_wire_plan``).

    ``apply(z, u)`` takes the stacked ``(N, P)`` iterate and ``(N, n_rows,
    noise_cols)`` uniforms; per node it packs the row into the plan's
    layout, encodes the flat payload (one launch per codec run) on the
    adaptive per-row grid and decodes it back in plain PyTorch:
    ``decode(encode(z))`` is what a receiver reconstructs.  ``wire_bytes``
    is the plan's flat payload size, so two algorithms on one plan ship
    equal bytes by construction."""

    plan: WirePlan

    def uniform_shape(self, shape):
        lead = tuple(shape[:-1])
        return lead + (self.plan.layout.n_rows, self.plan.noise_cols())

    def apply(self, z, u):
        layout = self.plan.layout
        if z.shape[-1] != layout.n_elements:
            raise ValueError(f"iterate shape {tuple(z.shape)} does not end "
                             f"in {layout.n_elements} for this plan")
        zf = z.to(torch.float32)
        leaves, off = [], 0
        for slot in layout.slots:
            leaves.append(zf[..., off:off + slot.size].reshape(
                z.shape[:-1] + slot.shape))
            off += slot.size
        buf = layout.pack(T.tree_unflatten(layout.treedef, leaves))
        lead = buf.shape[:-2]
        buf = buf.reshape((-1,) + buf.shape[-2:])
        noise = u.reshape((-1,) + u.shape[-2:])
        dense = torch.stack([self.plan.decode_dense(
            self.plan.encode(buf[i], noise[i])) for i in range(buf.shape[0])])
        back = layout.unpack(dense.reshape(lead + dense.shape[-2:]),
                             cast=False)
        flat = torch.cat([a.reshape(lead + (-1,))
                          for a in T.tree_leaves(back)], dim=-1)
        return flat.to(z.dtype)

    def wire_bytes(self, n_elements: int) -> float:
        if n_elements != self.plan.layout.n_elements:
            raise ValueError(
                f"problem dim {n_elements} != plan elements "
                f"{self.plan.layout.n_elements}")
        return float(self.plan.payload_bytes)
