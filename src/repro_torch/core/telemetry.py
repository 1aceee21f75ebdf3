"""Structured telemetry for the consensus stack (schema ``telemetry/v1``).

Counterpart of ``repro.core.telemetry``, with the same names, records and
schema, so that one sink validates under both packages:

* **Typed per-step counters and gauges.**  ``ConsensusConfig(telemetry=
  True)`` adds the exchange's extra per-node metrics (bytes shipped,
  saturation census, resync outcomes, async retirements);
  :class:`Telemetry` is the registry and JSONL sink they stream into, one
  record per step.  With ``telemetry=False`` the exchange computes the same
  bits and launches the same kernels.
* **Host events.**  Controller decisions, plan re-tiers, membership epochs,
  resyncs and the shipped wire geometry are ``kind="event"`` records of
  the same sink.
* **Span recorder.**  :class:`SpanRecorder` renders each step as
  Chrome/Perfetto ``trace_event`` spans.

What differs from the reference, and why.  The reference's marks fire
once, while its step is traced, and its recorder spreads them evenly over
a guessed tail of the step ("schedule-derived").  The port runs eagerly:
:func:`trace_mark` fires on every step, and with a :class:`SpanRecorder`
installed each mark records a timing-enabled ``torch.cuda.Event`` on the
current stream (``time.perf_counter()`` on the CPU); nothing
synchronizes inside the exchange.  After the trainer's synchronize,
:meth:`SpanRecorder.record_step_window` reads the elapsed times and emits
each phase with its measured duration, from its mark to the next mark or
to :func:`trace_end`, which closes a phase where its work ends.  What the
exchange window (:func:`exchange_window`) holds beyond the marked phases
is the glue: pack, noise and the differential, the overflow census, the
resync rebuild of the async transport, the freeze, push-sum weights and
the unpack.  It renders as
the exchange's own span on the ``host`` track; no phase name is added.
With no recorder installed a mark does nothing: it creates no event,
launches nothing and does not synchronize.

``kernel_fallback`` stays in :data:`EVENT_KINDS` so that the schema is the
reference's, but the port never emits it: every fragment of a plan
launches its kernel (``core.wireplan``).  The ``wire_plan`` event still
carries the reference's ``fallback_fragments`` geometry count.

:class:`WireAccounting` is the one source of wire-byte arithmetic:
shipped == delivered + dropped by construction, on floats and tensors
alike.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
from typing import Any, Callable

import torch

__all__ = [
    "SCHEMA", "EVENT_KINDS", "SPAN_PHASES", "STEP_METRICS",
    "WireAccounting", "timing_gate", "validate_record", "Telemetry",
    "SpanRecorder", "trace_mark", "trace_observer", "set_trace_observer",
]

SCHEMA = "telemetry/v1"

#: host-event record names (``kind="event"``, field ``event``)
EVENT_KINDS = ("codec_decision", "plan_retier", "membership_epoch",
               "resync", "wire_plan", "kernel_fallback", "run_end")

#: exchange span taxonomy: the five phases of one transfer unit's life on
#: the wire
SPAN_PHASES = ("quantize", "launch", "in_flight", "retire",
               "dequant_combine")

#: the typed registry of known per-step metrics: "counter" values are
#: non-negative per-step totals (bytes, event counts), "gauge" values are
#: instantaneous levels (fractions, norms, rates).  record_step validates
#: against this; unknown keys must be registered first.
STEP_METRICS: dict[str, str] = {
    "loss": "gauge",
    "lr": "gauge",
    "aux": "gauge",
    "collectives_per_step": "counter",
    "wire_bytes_per_step": "counter",
    "overflow_frac": "gauge",
    "residual_norm": "gauge",
    "push_sum_weight": "gauge",
    "wire_bytes_delivered": "counter",
    "delivered_frac": "gauge",
    "deadline_miss_frac": "gauge",
    "active_nodes": "gauge",
    "consensus_err": "gauge",
    # -- ConsensusConfig(telemetry=True) extras --------------------------
    "wire_bytes_shipped": "counter",
    "wire_bytes_inner": "counter",
    "wire_bytes_outer": "counter",
    "saturated_count": "counter",
    "resync_fired": "counter",
    "resync_ok": "gauge",
    "staleness_retired": "counter",
    # -- host-side timing riders -----------------------------------------
    "step_s": "gauge",
    "consensus_exchange_s": "gauge",
    "consensus_overhead_frac": "gauge",
}


# ---------------------------------------------------------------------------
# Unified wire-byte accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WireAccounting:
    """The one source of wire-byte arithmetic for a configured exchange.

    ``payload_bytes`` is ONE ring direction's flat payload (codes and
    scales, without the push-sum trailer); a step ships ``directions`` of
    them.  ``resync_bytes_amortized`` is the epoch-boundary fp32 x_tilde
    exchange averaged over the schedule period (an upper bound under
    membership, whose resyncs stop once the mask has clamped).  The
    invariant every caller leans on::

        shipped_payload == delivered_bytes(d) + dropped_bytes(d)

    for any delivered direction count ``d`` in [0, directions], a float or
    a tensor.  Under hierarchy ``inner_bytes`` is the lossless intra-pod
    fp32 level (``HierarchySpec.inner_bytes_per_step``): the invariant is a
    statement about the outer payload, and ``shipped_per_step`` totals both
    levels.
    """

    payload_bytes: int                 # one direction, codes + scales
    trailer_bytes: int = 0             # push-sum fp32 weight trailer
    directions: int = 2                # ring directions per step
    resync_bytes_amortized: float = 0.0
    inner_bytes: float = 0.0           # intra-pod fp32 level (hierarchy)

    @property
    def bytes_per_direction(self) -> int:
        return self.payload_bytes + self.trailer_bytes

    @property
    def shipped_payload(self) -> float:
        """Payload bytes put on the wire per step (all directions, without
        the amortized resync): the delivered + dropped total."""
        return float(self.directions * self.bytes_per_direction)

    @property
    def shipped_per_step(self) -> float:
        """Static bytes per step with the amortized resync and the
        intra-pod level: what ``ConsensusRuntime.wire_bytes_per_step``
        reports."""
        return (self.shipped_payload + self.resync_bytes_amortized
                + self.inner_bytes)

    def delivered_bytes(self, delivered_directions):
        """Bytes that arrived, given how many directions survived (a host
        float or a tensor: the arithmetic is the same)."""
        return float(self.bytes_per_direction) * delivered_directions

    def dropped_bytes(self, delivered_directions):
        return float(self.bytes_per_direction) * (
            self.directions - delivered_directions)

    # -- constructors ----------------------------------------------------
    @classmethod
    def for_plan(cls, plan, push_sum: bool = False,
                 resync_bytes_amortized: float = 0.0) -> "WireAccounting":
        """Accounting of a packed / pipelined / async WirePlan wire."""
        from repro_torch.core import wireplan
        return cls(payload_bytes=int(plan.payload_bytes),
                   trailer_bytes=(wireplan.PUSH_SUM_TRAILER_BYTES
                                  if push_sum else 0),
                   resync_bytes_amortized=resync_bytes_amortized)

    @classmethod
    def for_per_leaf(cls, layout, push_sum: bool = False,
                     resync_bytes_amortized: float = 0.0
                     ) -> "WireAccounting":
        """Accounting of the per-leaf int8 wire: each leaf is padded to its
        TILE_N-aligned height, so it ships more rows than the packed
        payload of the same tree."""
        from repro_torch.core import wireplan
        from repro_torch.kernels import ops as kops
        rows = sum(kops.padded_block_rows(s.size) for s in layout.slots)
        return cls(payload_bytes=rows * kops.payload_width(),
                   trailer_bytes=(wireplan.PUSH_SUM_TRAILER_BYTES
                                  if push_sum else 0),
                   resync_bytes_amortized=resync_bytes_amortized)

    @classmethod
    def uncompressed(cls, n_params: int, itemsize: int) -> "WireAccounting":
        """The fp32/bf16 DGD baseline wire (no codec, no trailer)."""
        return cls(payload_bytes=n_params * itemsize)


def timing_gate(*timings: dict, noise_tol: float = 0.5) -> float:
    """Variance-aware speedup gate: the more run-to-run spread the timed
    paths showed, the looser the acceptable ratio.  ``timings`` are
    timing dicts carrying ``timing_spread`` (IQR/median over repeats).  At
    zero spread the gate is ``noise_tol``; spread s relaxes it by
    1/(1 + 3 s)."""
    spread = max((t.get("timing_spread", 0.0) or 0.0) for t in timings)
    return noise_tol / (1.0 + 3.0 * spread)


# ---------------------------------------------------------------------------
# telemetry/v1 records + validation
# ---------------------------------------------------------------------------

def validate_record(rec: Any) -> str | None:
    """Validate one telemetry/v1 record; None when valid, else a
    human-readable reason (the reference's reasons, word for word)."""
    if not isinstance(rec, dict):
        return "record is not an object"
    if rec.get("schema") != SCHEMA:
        return f"schema must be {SCHEMA!r}, got {rec.get('schema')!r}"
    kind = rec.get("kind")
    if kind == "meta":
        if not isinstance(rec.get("run_id"), str) or not rec["run_id"]:
            return "meta.run_id must be a non-empty string"
        if not isinstance(rec.get("config"), dict):
            return "meta.config must be an object"
        sha = rec.get("git_sha")
        if sha is not None and not isinstance(sha, str):
            return "meta.git_sha must be a string or null"
        return None
    if kind == "step":
        step = rec.get("step")
        if not isinstance(step, int) or step < 0:
            return "step.step must be a non-negative integer"
        metrics = rec.get("metrics")
        if not isinstance(metrics, dict) or not metrics:
            return "step.metrics must be a non-empty object"
        for k, v in metrics.items():
            ty = rec.get("types", {}).get(k) or STEP_METRICS.get(k)
            if ty is None:
                return (f"step.metrics[{k!r}] is not a registered counter "
                        "or gauge")
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                return f"step.metrics[{k!r}] must be a number"
            if not math.isfinite(v):
                return f"step.metrics[{k!r}] must be finite"
            if ty == "counter" and v < 0:
                return f"counter step.metrics[{k!r}] must be >= 0"
        return None
    if kind == "event":
        name = rec.get("event")
        if name not in EVENT_KINDS:
            return (f"event.event must be one of {EVENT_KINDS}, "
                    f"got {name!r}")
        step = rec.get("step")
        if step is not None and (not isinstance(step, int) or step < 0):
            return "event.step must be a non-negative integer or null"
        if not isinstance(rec.get("data"), dict):
            return "event.data must be an object"
        return None
    return f"unknown record kind {kind!r}"


def validate_file(path: str) -> list[str]:
    """Validate every JSONL record in ``path``; the list of ``"line N:
    reason"`` problems (empty when clean)."""
    problems = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                problems.append(f"line {i}: invalid JSON ({e})")
                continue
            why = validate_record(rec)
            if why is not None:
                problems.append(f"line {i}: {why}")
    return problems


# ---------------------------------------------------------------------------
# The host-side registry + sink
# ---------------------------------------------------------------------------

class Telemetry:
    """Typed counter/gauge registry + schema-versioned JSONL sink.

    Writes ``{out_dir}/telemetry-{run_id}.jsonl`` (one record per line,
    ``meta`` first) and, with ``spans=True``, a Chrome/Perfetto trace at
    ``{out_dir}/trace-{run_id}.json`` on :meth:`close`.  ``device`` is the
    run's device: the span recorder stamps CUDA events there, or the host
    clock on the CPU.
    """

    def __init__(self, run_id: str, out_dir: str = "obs",
                 config: dict | None = None, git_sha: str | None = None,
                 spans: bool = False, device=None):
        self.run_id = run_id
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"telemetry-{run_id}.jsonl")
        self.trace_path = os.path.join(out_dir, f"trace-{run_id}.json")
        self._types = dict(STEP_METRICS)
        self._extra_types: dict[str, str] = {}
        self._f = open(self.path, "w")
        self.spans = SpanRecorder(device).install() if spans else None
        self._write({"schema": SCHEMA, "kind": "meta", "run_id": run_id,
                     "git_sha": git_sha, "config": dict(config or {}),
                     "time_unix": time.time()})

    # -- registry --------------------------------------------------------
    def register(self, name: str, kind: str) -> None:
        """Declare a metric outside the built-in registry."""
        if kind not in ("counter", "gauge"):
            raise ValueError(f"kind must be 'counter' or 'gauge', "
                             f"got {kind!r}")
        self._types[name] = kind
        self._extra_types[name] = kind

    def _write(self, rec: dict) -> None:
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")

    # -- records ---------------------------------------------------------
    def record_step(self, step: int, metrics: dict) -> None:
        """Append one per-step record; values are coerced to float and
        validated against the registry (counters must be >= 0)."""
        clean = {}
        for k, v in metrics.items():
            ty = self._types.get(k)
            if ty is None:
                raise ValueError(
                    f"unregistered metric {k!r}; Telemetry.register it as "
                    "a counter or gauge first")
            v = float(v)
            if not math.isfinite(v):
                raise ValueError(f"metric {k!r} is not finite: {v}")
            if ty == "counter" and v < 0:
                raise ValueError(f"counter {k!r} must be >= 0, got {v}")
            clean[k] = v
        rec = {"schema": SCHEMA, "kind": "step", "step": int(step),
               "metrics": clean}
        if self._extra_types:
            rec["types"] = dict(self._extra_types)
        self._write(rec)

    def event(self, name: str, step: int | None = None, **data) -> None:
        """Append one host event record (``name`` in EVENT_KINDS)."""
        if name not in EVENT_KINDS:
            raise ValueError(f"unknown event {name!r}; expected one of "
                             f"{EVENT_KINDS}")
        self._write({"schema": SCHEMA, "kind": "event", "event": name,
                     "step": None if step is None else int(step),
                     "data": data})

    # -- lifecycle -------------------------------------------------------
    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if self._f.closed:
            return
        self._f.flush()
        self._f.close()
        if self.spans is not None:
            self.spans.uninstall()
            self.spans.save(self.trace_path)

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# The exchange's marks
# ---------------------------------------------------------------------------

_trace_observer: Callable | None = None


def trace_observer() -> Callable | None:
    """The installed observer of :func:`trace_mark` (None without one)."""
    return _trace_observer


def set_trace_observer(obs: Callable | None) -> None:
    """Install (or clear) the module-global observer that
    :func:`trace_mark` calls with ``(phase, unit, info)``."""
    global _trace_observer
    _trace_observer = obs


def trace_mark(phase: str, unit: int = 0, **info) -> None:
    """One exchange phase of transfer unit ``unit`` starts here (called by
    ``core.distributed`` on every step, in the reference's order and with
    its ``info``).  A no-op unless an observer is installed."""
    if _trace_observer is not None:
        _trace_observer(phase, unit, info)


def trace_end() -> None:
    """The phase the last :func:`trace_mark` opened ends here: what runs
    until the next mark is glue.  A no-op unless a :class:`SpanRecorder`
    is installed."""
    if isinstance(_trace_observer, SpanRecorder):
        _trace_observer.end()


@contextlib.contextmanager
def exchange_window():
    """Bracket one consensus exchange with two stamps of the installed
    :class:`SpanRecorder` (nothing without one)."""
    rec = _trace_observer if isinstance(_trace_observer,
                                        SpanRecorder) else None
    if rec is not None:
        rec.window_begin()
    yield
    if rec is not None:
        rec.window_end()


# ---------------------------------------------------------------------------
# Span recorder + Perfetto export
# ---------------------------------------------------------------------------

#: Perfetto track ids (tid): one per concern, so overlapping spans render
#: on parallel tracks instead of nesting
TRACKS = {"compute": 0, "codec": 1, "wire": 2, "inflight": 3, "host": 4}
_TRACK_NAMES = {0: "model compute (fwd/bwd)", 1: "codec (quantize/dequant)",
                2: "wire (launch/retire)", 3: "wire in-flight",
                4: "host"}
#: which track each exchange phase renders on
_PHASE_TRACK = {"quantize": "codec", "launch": "wire", "retire": "wire",
                "dequant_combine": "codec"}


class SpanRecorder:
    """Measured exchange spans and the step timeline.

    Installed (:meth:`install`), it is the observer of :func:`trace_mark`:
    every mark, every :func:`trace_end` and the exchange window's two
    edges record one stamp on ``device``'s current stream (a timing CUDA
    event; the host clock on the CPU).  Per step the trainer calls
    :meth:`step_begin` before its forward pass and, after synchronizing,
    :meth:`measure` or :meth:`record_step_window`.

    ``schedule`` is the reference's: the ``(phase, unit, info)`` order of
    the first step, deduplicated by ``(phase, unit)`` over the run.  A
    launch with no retire of its unit in the same window (the async
    transport) leaves its in-flight span open; the next window's first
    retire closes it, so the one-step-stale payload's flight covers the
    next step's compute.
    """

    def __init__(self, device=None):
        self.device = torch.device("cpu" if device is None else device)
        self._origin = time.perf_counter()
        self._events: list[dict] = []
        self._schedule: list[tuple[str, int, dict]] = []
        self._seen: set = set()
        self._pending: list[dict] = []   # open in-flight spans (async)
        self._clear()

    def _clear(self) -> None:
        self._step_stamp = None
        self._win: list = [None, None]
        #: (phase, unit, info, stamp) in order; phase None is a trace_end
        self._marks: list = []

    # -- observer --------------------------------------------------------
    def install(self) -> "SpanRecorder":
        set_trace_observer(self)
        return self

    def uninstall(self) -> None:
        if _trace_observer is self:
            set_trace_observer(None)

    def _stamp(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    @staticmethod
    def _elapsed(a, b) -> float:
        """Seconds from stamp ``a`` to stamp ``b`` (after a synchronize)."""
        if isinstance(a, float):
            return b - a
        return a.elapsed_time(b) / 1e3

    def __call__(self, phase: str, unit: int, info: dict) -> None:
        key = (phase, unit)
        if key not in self._seen:
            self._seen.add(key)
            self._schedule.append((phase, unit, dict(info)))
        self._marks.append((phase, unit, dict(info), self._stamp()))

    def end(self) -> None:
        self._marks.append((None, 0, {}, self._stamp()))

    def step_begin(self) -> None:
        """A new step starts: drop the last step's stamps, stamp this
        one's start."""
        self._clear()
        self._step_stamp = self._stamp()

    def window_begin(self) -> None:
        self._win[0] = self._stamp()

    def window_end(self) -> None:
        self._win[1] = self._stamp()

    @property
    def schedule(self) -> list:
        return list(self._schedule)

    # -- host spans ------------------------------------------------------
    def us(self, t_perf: float) -> float:
        return (t_perf - self._origin) * 1e6

    def _emit(self, name: str, ts_us: float, dur_us: float, track: str,
              args: dict | None = None, cat: str = "exchange") -> None:
        self._events.append({
            "name": name, "cat": cat, "ph": "X", "pid": 0,
            "tid": TRACKS[track], "ts": round(ts_us, 3),
            "dur": round(max(dur_us, 0.001), 3),
            **({"args": args} if args else {})})

    @contextlib.contextmanager
    def span(self, name: str, track: str = "host", args: dict | None = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self._emit(name, self.us(t0), (t1 - t0) * 1e6, track,
                       args, cat="host")

    # -- measured exchange spans -------------------------------------------
    def _base(self):
        """The step's first stamp: its start, else the window's, else the
        first mark's."""
        for st in (self._step_stamp, self._win[0],
                   self._marks[0][3] if self._marks else None):
            if st is not None:
                return st
        return None

    def _phase_bounds(self) -> list:
        """``(phase, unit, info, t0, t1)`` of this step's marks in seconds
        from its first stamp: each phase runs to the next mark or
        :func:`trace_end`, the last one to the window's end."""
        base = self._base()
        stops = [m[3] for m in self._marks[1:]] + [self._win[1]]
        return [(ph, u, info, self._elapsed(base, st),
                 self._elapsed(base, stop))
                for (ph, u, info, st), stop in zip(self._marks, stops)
                if ph is not None and stop is not None]

    def measure(self) -> dict:
        """This step's measured exchange split, after a synchronize:
        ``window_s`` (the exchange), ``phases`` (seconds per phase name,
        summed over units), ``glue_s`` (the window less its phases),
        ``glue_parts`` (the glue read from its own stamps: ``before`` the
        first mark, ``between`` a phase's end and the next mark, ``after``
        the last end) and ``compute_s`` (step start to the window)."""
        out = {"phases": {}}
        for ph, _, _, t0, t1 in self._phase_bounds():
            out["phases"][ph] = out["phases"].get(ph, 0.0) + (t1 - t0)
        w0, w1 = self._win
        if w0 is None or w1 is None:
            return out
        out["window_s"] = self._elapsed(w0, w1)
        out["glue_s"] = out["window_s"] - sum(out["phases"].values())
        stamps = [w0] + [m[3] for m in self._marks] + [w1]
        starts = [None] + [m[0] for m in self._marks] + ["end"]
        gaps = [self._elapsed(a, b) for a, b in zip(stamps, stamps[1:])]
        # a gap is glue where it does not follow a mark (the window's
        # start, or a trace_end)
        glue = [g for g, ph in zip(gaps, starts) if ph is None]
        tail = gaps[-1] if self._marks and self._marks[-1][0] is None \
            else 0.0
        out["glue_parts"] = {"before": gaps[0],
                             "between": sum(glue[1:]) - tail,
                             "after": tail}
        if self._step_stamp is not None:
            out["compute_s"] = self._elapsed(self._step_stamp, w0)
        return out

    def record_step_window(self, step: int, t_start: float,
                           dur_s: float) -> dict:
        """Render step ``step``'s timeline from its stamps (after the
        trainer's synchronize) and return :meth:`measure`'s split.

        ``t_start`` is the host ``time.perf_counter()`` at the step's
        start, ``dur_s`` its blocked duration; device times are placed
        from ``t_start`` by their measured offsets from the step's first
        stamp."""
        split = self.measure()
        t0 = self.us(t_start)
        base = self._base()

        def at(stamp) -> float:
            return t0 + self._elapsed(base, stamp) * 1e6

        w0, w1 = self._win
        compute_end = at(w0) if w0 is not None else t0 + dur_s * 1e6
        self._emit(f"fwd/bwd step {step}", t0, compute_end - t0,
                   "compute", cat="compute")
        if w0 is None or w1 is None:
            return split
        self._emit(f"exchange step {step}", at(w0), at(w1) - at(w0), "host",
                   {"step": step, "glue_us": split["glue_s"] * 1e6})
        bounds = [(ph, u, info, t0 + a * 1e6, t0 + b * 1e6)
                  for ph, u, info, a, b in self._phase_bounds()]
        # the first retire closes any in-flight span carried over from
        # the previous step (the async one-step-stale payload)
        retire_at = next((s0 for ph, _, _, s0, _ in bounds
                          if ph == "retire"), None)
        if retire_at is not None:
            for p in self._pending:
                self._emit(p["name"], p["ts"], retire_at - p["ts"],
                           "inflight", p.get("args"))
            self._pending = []
        open_launches: dict[int, tuple[float, dict]] = {}
        for phase, unit, info, s0, s1 in bounds:
            self._emit(f"{phase} u{unit}", s0, s1 - s0,
                       _PHASE_TRACK.get(phase, "host"),
                       {**info, "step": step} if info else {"step": step})
            if phase == "launch":
                open_launches[unit] = (s1, info)
            elif phase == "retire" and unit in open_launches:
                fly0, info0 = open_launches.pop(unit)
                self._emit(f"in_flight u{unit}", fly0, s0 - fly0,
                           "inflight", {**info0, "step": step})
        # launches never retired in this window stay in flight across the
        # step boundary: one span per async in-flight buffer
        for unit, (fly0, info) in open_launches.items():
            for b in info.get("buffers") or (f"u{unit}",):
                self._pending.append(
                    {"name": f"in_flight {b}", "ts": fly0,
                     "args": {"step": step, "unit": unit}})
        return split

    # -- export ----------------------------------------------------------
    def to_perfetto(self) -> dict:
        meta = [{"name": "process_name", "ph": "M", "pid": 0,
                 "args": {"name": "repro consensus"}}]
        meta += [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                  "args": {"name": label}}
                 for tid, label in sorted(_TRACK_NAMES.items())]
        events = list(self._events)
        for p in self._pending:      # close still-open flights at the end
            end = max((e["ts"] + e["dur"] for e in events), default=p["ts"])
            events.append({"name": p["name"], "cat": "exchange", "ph": "X",
                           "pid": 0, "tid": TRACKS["inflight"],
                           "ts": round(p["ts"], 3),
                           "dur": round(max(end - p["ts"], 0.001), 3),
                           "args": p.get("args") or {}})
        spans = "cuda-events" if self.device.type == "cuda" else "host-clock"
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"schema": SCHEMA, "spans": spans}}

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_perfetto(), f)


def trace_phase_coverage(trace: dict) -> dict[str, int]:
    """Span count per exchange phase in an exported Perfetto trace."""
    counts = {ph: 0 for ph in SPAN_PHASES}
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        name = ev.get("name", "")
        for ph in SPAN_PHASES:
            if name.startswith(ph):
                counts[ph] += 1
    return counts


def trace_has_overlap(trace: dict) -> bool:
    """Does any in-flight span overlap compute (model or codec) on the
    timeline?  True for pipelined (transfer vs quantize/dequant) and async
    (transfer vs the next step's fwd/bwd) exports."""
    compute_tids = {TRACKS["compute"], TRACKS["codec"]}
    fly, work = [], []
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        iv = (ev["ts"], ev["ts"] + ev["dur"])
        if ev.get("tid") == TRACKS["inflight"]:
            fly.append(iv)
        elif ev.get("tid") in compute_tids:
            work.append(iv)
    eps = 1e-6
    return any(f0 < w1 - eps and w0 < f1 - eps
               for f0, f1 in fly for w0, w1 in work)
