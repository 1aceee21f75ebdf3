"""Observability CLI: telemetry health reports + bench-series regression.

Counterpart of ``repro.launch.obs``, with the same two subcommands:

``python -m repro_torch.launch.obs report``
    Joins a telemetry JSONL sink (``--telemetry`` path, or the newest
    ``telemetry-*.jsonl`` under ``--obs-dir``) with the append-mode
    ``bench-series/v1`` file (default ``BENCH_consensus_step.json``, the
    reference's series: it holds no timings taken on a CUDA card) into (a)
    a per-run health report: wire-byte conservation, delivery, saturation
    and resync census, host-event digest; and (b) a cross-run regression
    table: for every (arch, transport) timing of the series, the steps/s
    ratio against the previous run with the SAME config hash, gated by the
    variance-aware :func:`repro_torch.core.telemetry.timing_gate` floor
    (``--noise-tol`` at zero spread, relaxed by run-to-run spread).
    ``--gate`` exits nonzero when the newest run regresses.

``python -m repro_torch.launch.obs validate``
    Schema-validates every record of a telemetry JSONL file and, with
    ``--trace``, checks the Perfetto export: valid JSON, >= 1 span per
    exchange phase and (``--require-overlap``) at least one in-flight span
    overlapping compute on the timeline.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from repro_torch.core import telemetry

__all__ = ["load_series", "series_rows", "regression_table",
           "health_report", "main"]

SERIES_SCHEMA = "bench-series/v1"

#: payload keys under ``archs[name]`` that are per-transport timing dicts
_TIMING_KEYS = ("steps_per_s", "seconds_per_step")


# ---------------------------------------------------------------------------
# Bench-series access
# ---------------------------------------------------------------------------

def load_series(path: str) -> list[dict]:
    """The run list of an append-mode bench series file."""
    with open(path) as f:
        payload = json.load(f)
    if payload.get("schema") != SERIES_SCHEMA:
        raise ValueError(f"{path}: schema must be {SERIES_SCHEMA!r}, "
                         f"got {payload.get('schema')!r}")
    runs = payload.get("runs")
    if not isinstance(runs, list) or not runs:
        raise ValueError(f"{path}: empty bench series")
    return runs


def _is_timing(d) -> bool:
    return isinstance(d, dict) and any(k in d for k in _TIMING_KEYS)


def series_rows(payload: dict) -> dict:
    """Flatten one bench payload into ``{(arch, mode): row}`` timing rows.

    A row carries ``steps_per_s`` / ``timing_spread`` / ``mb_per_step``
    (from the unified wire accounting's bytes/step) and, for the overlap
    section's transports, ``consensus_overhead_frac``.
    """
    rows = {}
    for arch, entry in (payload.get("archs") or {}).items():
        if not isinstance(entry, dict):
            continue
        for mode, t in entry.items():
            if not _is_timing(t):
                continue
            rows[(arch, mode)] = {
                "steps_per_s": t.get("steps_per_s"),
                "timing_spread": t.get("timing_spread", 0.0),
                "mb_per_step": (t["wire_bytes_per_step"] / 1e6
                                if t.get("wire_bytes_per_step") is not None
                                else None),
            }
    for mode, t in ((payload.get("overlap") or {}).get("modes") or {}).items():
        if _is_timing(t):
            rows[("overlap", mode)] = {
                "steps_per_s": t.get("steps_per_s"),
                "timing_spread": t.get("timing_spread", 0.0),
                "mb_per_step": None,
                "consensus_overhead_frac": t.get("consensus_overhead_frac"),
            }
    for mode, t in ((payload.get("hierarchy_sweep") or {})
                    .get("modes") or {}).items():
        if _is_timing(t):
            # hierarchy rows track INTER-POD bytes (the slow links the
            # two-level design exists to relieve); intra-pod fp32 traffic
            # is reported by the health section, not regression-gated
            rows[("hierarchy", mode)] = {
                "steps_per_s": t.get("steps_per_s"),
                "timing_spread": t.get("timing_spread", 0.0),
                "mb_per_step": (t["inter_pod_bytes_per_step"] / 1e6
                                if t.get("inter_pod_bytes_per_step")
                                is not None else None),
            }
    return rows


def regression_table(runs: list[dict], noise_tol: float = 0.9) -> dict:
    """Compare every series run against its predecessor of the SAME
    config hash, per (arch, mode) timing row.

    Returns ``{"comparisons": [...], "regressions": [...]}`` where each
    comparison carries the steps/s ratio, its variance-aware floor
    (:func:`telemetry.timing_gate` with ``noise_tol`` as the zero-spread
    floor), MB/step and overhead deltas.  A comparison regresses when
    the ratio undercuts the floor or MB/step grows at a fixed config
    hash (bytes are deterministic — any growth is a real change).
    """
    comparisons, regressions = [], []
    last_by_hash: dict = {}
    for i, run in enumerate(runs):
        rows = series_rows(run.get("payload") or {})
        chash = run.get("config_hash")
        prev = last_by_hash.get(chash)
        if prev is not None:
            pi, prows = prev
            for key in sorted(set(rows) & set(prows)):
                cur, old = rows[key], prows[key]
                if not cur.get("steps_per_s") or not old.get("steps_per_s"):
                    continue
                ratio = cur["steps_per_s"] / old["steps_per_s"]
                floor = telemetry.timing_gate(old, cur, noise_tol=noise_tol)
                comp = {"run": i, "vs_run": pi, "arch": key[0],
                        "mode": key[1], "git_sha": run.get("git_sha"),
                        "prev_sha": runs[pi].get("git_sha"),
                        "steps_per_s": cur["steps_per_s"],
                        "prev_steps_per_s": old["steps_per_s"],
                        "ratio": ratio, "floor": floor,
                        "speed_ok": ratio >= floor}
                if (cur.get("mb_per_step") is not None
                        and old.get("mb_per_step") is not None):
                    comp["mb_per_step"] = cur["mb_per_step"]
                    comp["d_mb"] = cur["mb_per_step"] - old["mb_per_step"]
                    comp["bytes_ok"] = comp["d_mb"] <= 1e-9
                if (cur.get("consensus_overhead_frac") is not None
                        and old.get("consensus_overhead_frac") is not None):
                    comp["d_overhead_frac"] = (
                        cur["consensus_overhead_frac"]
                        - old["consensus_overhead_frac"])
                comparisons.append(comp)
                if not (comp["speed_ok"] and comp.get("bytes_ok", True)):
                    regressions.append(comp)
        last_by_hash[chash] = (i, rows)
    return {"comparisons": comparisons, "regressions": regressions}


# ---------------------------------------------------------------------------
# Telemetry health
# ---------------------------------------------------------------------------

def _read_sink(path: str) -> tuple[dict | None, list[dict], list[dict]]:
    meta, steps, events = None, [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("kind") == "meta":
                meta = rec
            elif rec.get("kind") == "step":
                steps.append(rec)
            elif rec.get("kind") == "event":
                events.append(rec)
    return meta, steps, events


def health_report(path: str) -> dict:
    """Per-run health summary of one telemetry JSONL sink."""
    problems = telemetry.validate_file(path)
    meta, steps, events = _read_sink(path)
    rep: dict = {"path": path, "schema_problems": problems,
                 "run_id": meta.get("run_id") if meta else None,
                 "git_sha": meta.get("git_sha") if meta else None,
                 "n_steps": len(steps), "n_events": len(events)}
    if steps:
        series: dict[str, list[float]] = {}
        for rec in steps:
            for k, v in rec["metrics"].items():
                series.setdefault(k, []).append(v)
        totals, gauges = {}, {}
        for k, vs in series.items():
            if telemetry.STEP_METRICS.get(k) == "counter":
                totals[k] = sum(vs)
            else:
                gauges[k] = {"first": vs[0], "last": vs[-1],
                             "mean": sum(vs) / len(vs)}
        rep["counters_total"] = totals
        rep["gauges"] = gauges
        shipped = totals.get("wire_bytes_shipped")
        delivered = totals.get("wire_bytes_delivered")
        if shipped is not None and delivered is not None:
            rep["wire"] = {
                "shipped_mb": shipped / 1e6,
                "delivered_mb": delivered / 1e6,
                "dropped_mb": (shipped - delivered) / 1e6,
                "delivered_frac": delivered / shipped if shipped else 1.0,
            }
        inner = totals.get("wire_bytes_inner")
        outer = totals.get("wire_bytes_outer")
        if inner is not None and outer is not None:
            # two-level split: intra-pod fp32 psum traffic vs the
            # compressed inter-pod ring (core.hierarchy)
            rep["hierarchy_wire"] = {
                "intra_pod_mb": inner / 1e6,
                "inter_pod_mb": outer / 1e6,
                "inter_frac": (outer / (inner + outer)
                               if inner + outer else 1.0),
            }
    by_kind: dict[str, int] = {}
    for ev in events:
        by_kind[ev["event"]] = by_kind.get(ev["event"], 0) + 1
    rep["events"] = by_kind
    return rep


def _newest_sink(obs_dir: str) -> str | None:
    paths = glob.glob(os.path.join(obs_dir, "telemetry-*.jsonl"))
    return max(paths, key=os.path.getmtime) if paths else None


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def _sha8(sha) -> str:
    return (sha or "-")[:8]


def _print_health(rep: dict) -> None:
    print(f"== health: {rep['path']}")
    print(f"   run_id={rep['run_id']} git_sha={_sha8(rep['git_sha'])} "
          f"steps={rep['n_steps']} events={rep['n_events']}")
    if rep["schema_problems"]:
        print(f"   SCHEMA PROBLEMS ({len(rep['schema_problems'])}):")
        for p in rep["schema_problems"][:10]:
            print(f"     {p}")
    if "wire" in rep:
        w = rep["wire"]
        print(f"   wire: shipped={w['shipped_mb']:.3f}MB "
              f"delivered={w['delivered_mb']:.3f}MB "
              f"dropped={w['dropped_mb']:.3f}MB "
              f"(delivered_frac={w['delivered_frac']:.3f})")
    if "hierarchy_wire" in rep:
        h = rep["hierarchy_wire"]
        print(f"   hierarchy: intra-pod={h['intra_pod_mb']:.3f}MB "
              f"inter-pod={h['inter_pod_mb']:.3f}MB "
              f"(inter_frac={h['inter_frac']:.3f})")
    for k, v in sorted(rep.get("counters_total", {}).items()):
        if not k.startswith("wire_bytes"):
            print(f"   total {k}={v:g}")
    loss = rep.get("gauges", {}).get("loss")
    if loss:
        print(f"   loss: {loss['first']:.4f} -> {loss['last']:.4f}")
    for k in ("consensus_err", "delivered_frac", "deadline_miss_frac",
              "consensus_overhead_frac", "step_s"):
        g = rep.get("gauges", {}).get(k)
        if g:
            print(f"   {k}: mean={g['mean']:.4g} last={g['last']:.4g}")
    if rep["events"]:
        print("   events: " + " ".join(f"{k}={n}" for k, n
                                       in sorted(rep["events"].items())))


def _print_series(runs: list[dict], table: dict) -> None:
    print(f"== bench series: {len(runs)} runs (sha-ordered)")
    print(f"   {'#':>2} {'git_sha':8} {'config':12} {'gates':5} rows")
    for i, run in enumerate(runs):
        rows = series_rows(run.get("payload") or {})
        sps = [r["steps_per_s"] for r in rows.values()
               if r.get("steps_per_s")]
        med = sorted(sps)[len(sps) // 2] if sps else float("nan")
        gates = run.get("gates_ok")
        gates_s = "-" if gates is None else ("ok" if gates else "FAIL")
        print(f"   {i:>2} {_sha8(run.get('git_sha')):8} "
              f"{(run.get('config_hash') or '-'):12.12} {gates_s:5} "
              f"{len(rows):3d} timings, median {med:.2f} steps/s")
    comps = table["comparisons"]
    if not comps:
        print("   (no same-config predecessor to compare against)")
        return
    print("== regressions vs previous same-config run")
    print(f"   {'arch':14.14} {'mode':12.12} {'prev':>7} {'cur':>7} "
          f"{'ratio':>6} {'floor':>6}  verdict")
    for c in comps:
        verdict = "ok" if c["speed_ok"] else "SLOW"
        if not c.get("bytes_ok", True):
            verdict += f" BYTES+{c['d_mb']:.3f}MB"
        print(f"   {c['arch']:14.14} {c['mode']:12.12} "
              f"{c['prev_steps_per_s']:7.2f} {c['steps_per_s']:7.2f} "
              f"{c['ratio']:6.3f} {c['floor']:6.3f}  {verdict}")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _cmd_report(args) -> int:
    sink = args.telemetry or _newest_sink(args.obs_dir)
    if sink:
        _print_health(health_report(sink))
    else:
        print(f"== health: no telemetry-*.jsonl under {args.obs_dir!r} "
              "(run train.py --telemetry)")
    rc = 0
    if os.path.exists(args.series):
        runs = load_series(args.series)
        table = regression_table(runs, noise_tol=args.noise_tol)
        _print_series(runs, table)
        newest = len(runs) - 1
        fresh = [r for r in table["regressions"] if r["run"] == newest]
        stale_gate = any(r.get("gates_ok") is False for r in runs)
        if fresh:
            print(f"REGRESSION: {len(fresh)} timing(s) of run {newest} "
                  "undercut the variance-aware floor")
            rc = 2
        elif stale_gate:
            print("REGRESSION: a series run has gates_ok=false")
            rc = 2
        else:
            print("no regression in the newest run")
    else:
        print(f"== bench series: {args.series} not found")
    if sink and health_report(sink)["schema_problems"]:
        rc = max(rc, 2)
    return rc if args.gate else 0


def _cmd_validate(args) -> int:
    rc = 0
    problems = telemetry.validate_file(args.sink)
    if problems:
        print(f"{args.sink}: {len(problems)} invalid record(s)")
        for p in problems[:20]:
            print(f"  {p}")
        rc = 1
    else:
        n = sum(1 for line in open(args.sink) if line.strip())
        print(f"{args.sink}: {n} records valid ({telemetry.SCHEMA})")
    if args.trace:
        with open(args.trace) as f:
            trace = json.load(f)       # raises on invalid JSON
        cov = telemetry.trace_phase_coverage(trace)
        missing = [ph for ph, n in cov.items() if n == 0]
        print(f"{args.trace}: spans per phase "
              + " ".join(f"{ph}={n}" for ph, n in cov.items()))
        if missing:
            print(f"  MISSING phases: {missing}")
            rc = 1
        overlap = telemetry.trace_has_overlap(trace)
        print(f"  overlap(in-flight vs compute): {overlap}")
        if args.require_overlap and not overlap:
            print("  MISSING overlap")
            rc = 1
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.obs",
        description="consensus observability: health / regression / "
                    "validation over telemetry sinks and the bench series")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rep = sub.add_parser("report", help="health + cross-run regression")
    rep.add_argument("--series", default="BENCH_consensus_step.json",
                     help="append-mode bench series file (the committed "
                          "BENCH_consensus_step.json is the reference's "
                          "and holds no CUDA card timings)")
    rep.add_argument("--telemetry", default=None,
                     help="telemetry JSONL sink (default: newest under "
                          "--obs-dir)")
    rep.add_argument("--obs-dir", default="obs")
    rep.add_argument("--noise-tol", type=float, default=0.9,
                     help="zero-spread steps/s ratio floor; run-to-run "
                          "spread relaxes it (telemetry.timing_gate)")
    rep.add_argument("--gate", action="store_true",
                     help="exit nonzero on a regression in the newest run")

    val = sub.add_parser("validate", help="schema-validate a sink")
    val.add_argument("sink", help="telemetry JSONL path")
    val.add_argument("--trace", default=None,
                     help="also check this Perfetto trace export")
    val.add_argument("--require-overlap", action="store_true",
                     help="fail unless an in-flight span overlaps compute")
    args = ap.parse_args(argv)

    if args.cmd == "report":
        return _cmd_report(args)
    return _cmd_validate(args)


if __name__ == "__main__":
    sys.exit(main())
