"""Telemetry on the port, held to the JAX package.

  * ``WireAccounting`` and the runtime's ``wire_accounting`` equal the
    reference's field for field (plans A and B, per-leaf, uncompressed,
    push-sum, hierarchy, strides, membership), shipped == delivered +
    dropped on floats and tensors, and every full-width
    ``wire_bytes_per_step`` of smollm-135m is the one the records hold, to
    the byte.
  * Both validators give the same verdict and reason on the reference's
    good and bad records; a port sink validates under both.
  * The trainer's ``--telemetry`` on ``--reduced --device cpu`` (packed,
    pipelined over 4 units, async at staleness 1): the sink, every phase
    in the trace, in-flight spans overlapping compute where the reference
    says they do, each phase span inside its exchange window;
    ``health_report`` and ``regression_table`` equal the reference's.
  * Telemetry off is bitwise equal to on (params, shadows, weights,
    in-flight payloads), and with no recorder installed no CUDA event is
    created.
  * The runtime against the reference's (one subprocess with 6 host
    devices, the harness of ``tests/test_torch_membership.py`` with the
    telemetry keys added): per-node ``wire_bytes_shipped``,
    ``saturated_count``, ``resync_fired`` / ``resync_ok``,
    ``staleness_retired`` and the per-level bytes equal the reference's
    under Bernoulli and Gilbert loss on packed, pipelined and async across
    the churn epochs, on pods 2, on the strided per-leaf ring and with
    straggler deadlines; the recorder's schedule equals the reference's.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import telemetry as JTel
from repro.core.distributed import ConsensusConfig as JCfg
from repro.core.distributed import ConsensusRuntime as JRt
from repro.launch import obs as jobs
from repro.models import transformer as JTF
from repro.models.sharding import ParallelContext, local_context
from repro_torch.configs import get_config
from repro_torch.core import telemetry as TTel
from repro_torch.core import tree as T
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.core.topology import MembershipSchedule
from repro_torch.launch import obs, train
from repro_torch.models import transformer as TF
from repro_torch.models.params import meta_params
from test_torch_faults import _delta, _x0
from test_torch_membership import BODY as MEMBERSHIP_BODY
from test_torch_membership import CHURN, PERIOD, REPO, STEPS, check_case

N = 4
PLAN_A = "mixed:norm=int4,embed=int4,*=int8"
PLAN_B = "mixed:embed=topk:k=64,norm=int2,*=int8"
SERIES = os.path.join(REPO, "BENCH_consensus_step.json")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the many small tensor ops of this module only
    contend when the CPU is shared with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_observer():
    """No test leaves a trace observer installed in either package."""
    yield
    TTel.set_trace_observer(None)
    JTel.set_trace_observer(None)


# ---------------------------------------------------------------------------
# wire accounting
# ---------------------------------------------------------------------------

ACCOUNTING = {
    "int8": {}, "planA": {"wire_codec": PLAN_A},
    "planB": {"wire_codec": PLAN_B},
    "per_leaf": {"wire_packing": "per_leaf"},
    "push_sum": {"topology": "directed-ring"},
    "push_sum/per_leaf": {"topology": "directed-ring",
                          "wire_packing": "per_leaf"},
    "pods2": {"hierarchy": 2}, "pods1": {"hierarchy": 1},
    "strides": {"ring_strides": (1, 3), "schedule_period": 2},
    "churn": {"membership": CHURN, "schedule_period": PERIOD},
    "dgd": {"algorithm": "dgd"},
    "compressed_dgd": {"algorithm": "compressed_dgd"},
    "allreduce": {"algorithm": "allreduce"},
}


@pytest.fixture(scope="module")
def reduced_tree():
    jdefs = JTF.build_defs(jreduced(jget_config("smollm-135m")),
                           local_context())
    jp = JTF.init_params(jdefs, jax.random.PRNGKey(0))
    return jp, _x0(N)


@pytest.mark.parametrize("label", list(ACCOUNTING))
def test_wire_accounting_equals_reference(reduced_tree, label):
    """The runtime's accounting, field for field, and its bytes per step
    and per direction, beside the reference runtime's on the same tree."""
    jp, x = reduced_tree
    kw = ACCOUNTING[label]
    jrt = JRt(JCfg(**kw), ParallelContext(tp=1, data_size=N, n_nodes=N,
                                          in_shard_map=False))
    rt = ConsensusRuntime(ConsensusConfig(**kw), N)
    jl, tl = jrt.state_layout(jp), rt.state_layout(x)
    want = jrt.wire_accounting(jl.n_elements, layout=jl)
    got = rt.wire_accounting(tl.n_elements, tl)
    if want is None:
        assert got is None
    else:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.bytes_per_direction == want.bytes_per_direction
    assert rt.wire_bytes_per_step(tl.n_elements, tl) == \
        jrt.wire_bytes_per_step(jl.n_elements, layout=jl)


def test_accounting_constructors_equal_reference(reduced_tree):
    jp, x = reduced_tree
    jrt = JRt(JCfg(wire_codec=PLAN_A), local_context())
    rt = ConsensusRuntime(ConsensusConfig(wire_codec=PLAN_A), N)
    jl, tl = jrt.state_layout(jp), rt.state_layout(x)
    jplan, tplan = jrt.wire_plan_for(jl), rt.wire_plan_for(tl)
    for push in (False, True):
        for rb in (0.0, 1234.5):
            assert dataclasses.asdict(TTel.WireAccounting.for_plan(
                tplan, push_sum=push, resync_bytes_amortized=rb)) == \
                dataclasses.asdict(JTel.WireAccounting.for_plan(
                    jplan, push_sum=push, resync_bytes_amortized=rb))
            assert dataclasses.asdict(TTel.WireAccounting.for_per_leaf(
                tl, push_sum=push, resync_bytes_amortized=rb)) == \
                dataclasses.asdict(JTel.WireAccounting.for_per_leaf(
                    jl, push_sum=push, resync_bytes_amortized=rb))
    for n, size in ((1000, 4), (7, 2)):
        assert dataclasses.asdict(TTel.WireAccounting.uncompressed(
            n, size)) == dataclasses.asdict(
                JTel.WireAccounting.uncompressed(n, size))


def test_shipped_is_delivered_plus_dropped():
    acct = TTel.WireAccounting(payload_bytes=1000, trailer_bytes=4,
                               resync_bytes_amortized=10.0,
                               inner_bytes=5.0)
    assert acct.shipped_per_step == 2 * 1004 + 10.0 + 5.0
    for d in (0, 1, 2, 0.5):
        assert (acct.delivered_bytes(d) + acct.dropped_bytes(d)
                == acct.shipped_payload)
    d = torch.tensor([0.0, 1.0, 2.0, 2.0])
    assert torch.equal(acct.delivered_bytes(d) + acct.dropped_bytes(d),
                       torch.full((4,), acct.shipped_payload))


#: the records' full-width bytes per step (PERF.md §2): smollm-135m, the
#: nodes, and the configuration
FULL_WIDTH = [
    ("int8", 4, {}, 271_160_064),
    ("per_leaf", 4, {"wire_packing": "per_leaf"}, 271_292_160),
    ("planA", 4, {"wire_codec": PLAN_A}, 242_591_208),
    ("planB", 4, {"wire_codec": PLAN_B}, 228_417_512),
    ("strides1,2", 5, {"ring_strides": (1, 2), "schedule_period": 2},
     809_276_160),
    ("churn", 4, {"membership": MembershipSchedule.from_spec(
        "2@1:2", 4).masks, "schedule_period": 4}, 540_218_112),
    ("pods2", 4, {"hierarchy": 2}, 271_160_064 + 538_060_032),
]


@pytest.mark.parametrize("label,n,kw,want", FULL_WIDTH,
                         ids=[c[0] for c in FULL_WIDTH])
def test_full_width_wire_bytes_unchanged(label, n, kw, want):
    defs = TF.build_defs(get_config("smollm-135m"))
    params = T.tree_map(lambda a: a.expand((n,) + a.shape),
                        meta_params(defs.storage))
    rt = ConsensusRuntime(ConsensusConfig(**kw), n)
    layout = rt.state_layout(params)
    assert rt.wire_bytes_per_step(layout.n_elements, layout) == want


# ---------------------------------------------------------------------------
# records and validation
# ---------------------------------------------------------------------------

S = TTel.SCHEMA
#: the reference's good and bad records (``tests/test_telemetry.py``)
RECORDS = [
    {"schema": S, "kind": "meta", "run_id": "r1", "config": {},
     "git_sha": None},
    {"schema": S, "kind": "step", "step": 3,
     "metrics": {"loss": 1.25, "wire_bytes_delivered": 0.0}},
    {"schema": S, "kind": "step", "step": 0,
     "metrics": {"my_gauge": -1.0}, "types": {"my_gauge": "gauge"}},
    {"schema": S, "kind": "event", "event": "resync", "step": 4,
     "data": {"ok": True}},
    {"schema": S, "kind": "event", "event": "run_end", "step": None,
     "data": {}},
    [],
    {"schema": "telemetry/v0", "kind": "meta", "run_id": "r",
     "config": {}},
    {"schema": S, "kind": "span"},
    {"schema": S, "kind": "meta", "run_id": "", "config": {}},
    {"schema": S, "kind": "meta", "run_id": "r", "config": []},
    {"schema": S, "kind": "meta", "run_id": "r", "config": {},
     "git_sha": 3},
    {"schema": S, "kind": "step", "step": -1, "metrics": {"loss": 1.0}},
    {"schema": S, "kind": "step", "step": 1, "metrics": {}},
    {"schema": S, "kind": "step", "step": 1, "metrics": {"mystery": 1.0}},
    {"schema": S, "kind": "step", "step": 1,
     "metrics": {"loss": float("nan")}},
    {"schema": S, "kind": "step", "step": 1,
     "metrics": {"wire_bytes_delivered": -2.0}},
    {"schema": S, "kind": "step", "step": 1, "metrics": {"loss": True}},
    {"schema": S, "kind": "event", "event": "boom", "data": {}},
    {"schema": S, "kind": "event", "event": "resync", "step": -2,
     "data": {}},
    {"schema": S, "kind": "event", "event": "resync", "data": None},
]


def test_validators_agree_with_reference():
    assert (TTel.SCHEMA, TTel.EVENT_KINDS, TTel.SPAN_PHASES,
            TTel.STEP_METRICS) == (JTel.SCHEMA, JTel.EVENT_KINDS,
                                   JTel.SPAN_PHASES, JTel.STEP_METRICS)
    verdicts = [TTel.validate_record(r) for r in RECORDS]
    assert verdicts == [JTel.validate_record(r) for r in RECORDS]
    assert verdicts[:5] == [None] * 5
    assert all(v is not None for v in verdicts[5:])


def test_port_sink_validates_under_both(tmp_path):
    tel = TTel.Telemetry("t1", out_dir=str(tmp_path), config={"steps": 3},
                         git_sha="deadbeef")
    tel.register("my_count", "counter")
    tel.record_step(1, {"loss": 0.5, "wire_bytes_shipped": 100.0,
                        "my_count": 2})
    tel.event("codec_decision", step=1, old="int8", new="int4")
    tel.event("run_end", wall_s=0.1)
    for bad in ({"mystery_metric": 1.0}, {"my_count": -1.0},
                {"loss": float("inf")}):
        with pytest.raises(ValueError):
            tel.record_step(2, bad)
    with pytest.raises(ValueError):
        tel.event("not_an_event")
    tel.close()
    assert TTel.validate_file(tel.path) == []
    assert JTel.validate_file(tel.path) == []
    with open(tel.path, "a") as f:
        f.write("{not json\n" + json.dumps(RECORDS[-1]) + "\n")
    assert TTel.validate_file(tel.path) == JTel.validate_file(tel.path)
    assert len(TTel.validate_file(tel.path)) == 2


def test_schedule_dedup_by_phase_and_unit_like_reference():
    """The reference's recorder keeps the first ``info`` of a ``(phase,
    unit)`` (ROADMAP hazard 20): a later step whose unit has other rows
    (a codec switch, say) leaves the schedule as it was."""
    out = []
    for tel in (TTel, JTel):
        rec = tel.SpanRecorder().install()
        tel.trace_mark("quantize", 0, rows=4)
        tel.trace_mark("quantize", 0, rows=8)
        tel.trace_mark("quantize", 1, rows=8)
        rec.uninstall()
        out.append(rec.schedule)
    assert out[0] == out[1] == [("quantize", 0, {"rows": 4}),
                                ("quantize", 1, {"rows": 8})]


# ---------------------------------------------------------------------------
# the trainer's --telemetry
# ---------------------------------------------------------------------------

TRANSPORTS = {"packed": (), "pipelined4": ("--wire-packing", "pipelined",
                                           "--pipeline-chunks", "4"),
              "async1": ("--wire-packing", "async")}


def run_trainer(tmp_path, label, *extra, steps=4):
    argv = ["--reduced", "--device", "cpu", "--nodes", str(N), "--batch",
            "8", "--seq", "32", "--steps", str(steps), "--telemetry",
            "--telemetry-dir", str(tmp_path), "--run-id", label, *extra]
    hist = train.main(argv)
    return (hist, os.path.join(tmp_path, f"telemetry-{label}.jsonl"),
            os.path.join(tmp_path, f"trace-{label}.json"))


def read_sink(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("label", list(TRANSPORTS))
def test_trainer_telemetry_exports(tmp_path, label):
    hist, sink, trace_path = run_trainer(tmp_path, label,
                                         *TRANSPORTS[label])
    assert TTel.validate_file(sink) == [] == JTel.validate_file(sink)
    recs = read_sink(sink)
    assert recs[0]["kind"] == "meta" and recs[0]["run_id"] == label
    steps = [r for r in recs if r["kind"] == "step"]
    events = [r["event"] for r in recs if r["kind"] == "event"]
    assert [r["step"] for r in steps] == [1, 2, 3, 4]
    assert events == ["wire_plan", "run_end"]
    for r, h in zip(steps, hist):
        m = r["metrics"]
        assert m["wire_bytes_shipped"] == m["wire_bytes_per_step"] > 0
        assert m["saturated_count"] == h["saturated_count"]
        assert 0 < m["consensus_exchange_s"] < m["step_s"]
        if label == "async1":
            assert m["staleness_retired"] == 2.0
    with open(trace_path) as f:
        trace = json.load(f)
    assert trace["otherData"] == {"schema": S, "spans": "host-clock"}
    cov = TTel.trace_phase_coverage(trace)
    assert cov == JTel.trace_phase_coverage(trace)
    assert all(n >= 1 for n in cov.values()), cov
    assert TTel.trace_has_overlap(trace) == (label != "packed")
    assert TTel.trace_has_overlap(trace) == JTel.trace_has_overlap(trace)
    args = ["validate", sink, "--trace", trace_path]
    if label != "packed":
        args.append("--require-overlap")
    assert obs.main(args) == 0 == jobs.main(args)
    # every measured phase lies inside its step's exchange window
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    windows = {e["args"]["step"]: (e["ts"], e["ts"] + e["dur"])
               for e in spans if e["name"].startswith("exchange step")}
    assert sorted(windows) == [2, 3, 4]
    eps = 0.01
    for e in spans:
        if e["name"].split()[0] in ("quantize", "launch", "retire",
                                    "dequant_combine"):
            w0, w1 = windows[e["args"]["step"]]
            assert w0 - eps <= e["ts"] and e["ts"] + e["dur"] <= w1 + eps


def test_health_and_regression_equal_reference(tmp_path):
    _, sink, _ = run_trainer(
        tmp_path, "pods", "--hierarchy", "pods=2", "--link-loss", "0.2",
        "--ring-strides", "1,3", "--schedule-period", "1", steps=3)
    got, want = obs.health_report(sink), jobs.health_report(sink)
    assert got == want
    assert {"wire", "hierarchy_wire"} <= set(got)
    assert got["counters_total"]["resync_fired"] > 0
    runs = obs.load_series(SERIES)
    assert runs == jobs.load_series(SERIES)
    for tol in (0.9, 0.5):
        assert obs.regression_table(runs, noise_tol=tol) == \
            jobs.regression_table(runs, noise_tol=tol)
    for run in runs:
        assert obs.series_rows(run.get("payload") or {}) == \
            jobs.series_rows(run.get("payload") or {})
    assert obs._newest_sink(str(tmp_path)) == sink
    assert obs.main(["report", "--obs-dir", str(tmp_path), "--series",
                     SERIES]) == 0


# ---------------------------------------------------------------------------
# telemetry off == on
# ---------------------------------------------------------------------------

BITWISE = {
    "churn/bernoulli/packed": dict(membership=CHURN, schedule_period=PERIOD,
                                   link_loss=0.2, loss_seed=1),
    "async1/straggle": dict(wire_packing="async", straggle_rate=0.2),
    "pipelined3/directed": dict(wire_packing="pipelined", pipeline_chunks=3,
                                topology="directed-ring", link_loss=0.2),
    "pods2/async1": dict(hierarchy=2, wire_packing="async"),
    "per_leaf/strides": dict(wire_packing="per_leaf", ring_strides=(1, 3),
                             schedule_period=2),
}


def run_port(steps, **kw):
    rt = ConsensusRuntime(ConsensusConfig(**kw), N)
    x = _x0(N)
    state = rt.init_state(x)
    hist = []
    for k in range(1, steps + 1):
        xh = T.tree_map(torch.add, x, _delta(k, N))
        x, state, m = rt.exchange(x, xh, state, k, seed=5)
        hist.append(m)
    return x, state, hist


@pytest.mark.parametrize("label", list(BITWISE))
def test_telemetry_off_is_bitwise_on(label):
    kw = BITWISE[label]
    off = run_port(4, **kw)
    rec = TTel.SpanRecorder().install()
    on = run_port(4, telemetry=True, **kw)
    rec.uninstall()
    assert all(torch.equal(a, b) for a, b in zip(T.tree_leaves(off[0]),
                                                  T.tree_leaves(on[0])))
    assert sorted(off[1]) == sorted(on[1])
    assert all(torch.equal(off[1][k], on[1][k]) for k in off[1])
    keys = ConsensusConfig(telemetry=True, **kw).telemetry_metric_keys()
    for m_off, m_on in zip(off[2], on[2]):
        assert set(m_on) - set(m_off) == set(keys)
        for k, v in m_off.items():
            assert (torch.equal(v, m_on[k]) if torch.is_tensor(v)
                    else v == m_on[k]), k
    marks = {ph for ph, _, _ in rec.schedule}
    assert marks == (set() if kw.get("wire_packing") == "per_leaf" else
                     {"quantize", "launch", "retire", "dequant_combine"})


def test_per_leaf_telemetry_equals_packed():
    """The per-leaf transport (which the membership harness does not
    drive) counts the packed exchange's saturations and resyncs; it ships
    its own, row-padded bytes."""
    kw = dict(ring_strides=(1, 3), schedule_period=2, link_loss=0.3,
              loss_seed=1, resync_retries=1, telemetry=True)
    packed = run_port(4, **kw)
    leaf = run_port(4, wire_packing="per_leaf", **kw)
    for mp, ml in zip(packed[2], leaf[2]):
        for k in ("saturated_count", "resync_fired", "resync_ok",
                  "delivered_frac"):
            assert torch.equal(mp[k], ml[k]), k
        assert torch.all(ml["wire_bytes_shipped"]
                         > mp["wire_bytes_shipped"])
    assert sum(float(m["resync_fired"].sum()) for m in leaf[2]) == 4.0
    assert any(float(m["resync_ok"].sum()) < 4.0 for m in leaf[2][2:3])


def test_no_cuda_event_without_recorder(monkeypatch):
    """With no recorder installed a mark creates no event; a recorder on a
    CUDA device stamps one per mark, ``trace_end`` and window edge."""
    made = []

    class Event:
        def __init__(self, enable_timing=False):
            made.append(enable_timing)

        def record(self):
            pass

    monkeypatch.setattr(torch.cuda, "Event", Event)
    run_port(2, telemetry=True, wire_packing="pipelined", pipeline_chunks=2)
    assert made == []
    rec = TTel.SpanRecorder(device="cuda").install()
    with TTel.exchange_window():
        run_port(1, wire_packing="pipelined", pipeline_chunks=2)
    rec.uninstall()
    # 2 units x (quantize, launch, end, retire, dequant_combine, end) + 2
    assert made == [True] * 14


def test_measured_split_on_the_host_clock():
    """``measure`` splits the window into the phases and the glue; on the
    CPU the stamps are the host clock."""
    rec = TTel.SpanRecorder().install()
    setup = train.build_train_setup(train_reduced(), consensus_nodes=N,
                                    device="cpu", wire_packing="async")
    state = train.init_train_state(setup, 0)
    batch = {"tokens": np.zeros((8, 16), np.int32),
             "labels": np.zeros((8, 16), np.int32)}
    for _ in range(2):
        rec.step_begin()
        state, _ = train.train_step(setup, state, batch)
    split = rec.measure()
    rec.uninstall()
    assert set(split["phases"]) == {"retire", "dequant_combine",
                                    "quantize", "launch"}
    assert split["window_s"] > 0 and split["compute_s"] > 0
    assert split["glue_s"] == pytest.approx(
        split["window_s"] - sum(split["phases"].values()))
    assert split["glue_s"] >= 0


def train_reduced():
    from repro_torch.configs import reduced
    return reduced(get_config("smollm-135m"))


# ---------------------------------------------------------------------------
# the runtime against the reference's
# ---------------------------------------------------------------------------

def _with_telemetry(body: str) -> str:
    """The membership harness with the telemetry keys among the compared
    metrics and both packages' span recorders installed."""
    reps = [
        ('from repro_torch.core import tree as T\n',
         'from repro_torch.core import tree as T\n'
         'from repro.core import telemetry as JTel\n'
         'from repro_torch.core import telemetry as TTel\n'),
        ('+ (["active_nodes"] if cfg.membership is not None else []))',
         '+ (["active_nodes"] if cfg.membership is not None else [])\n'
         '             + list(jrt.cfg.telemetry_metric_keys()))'),
        ('    js = init_f(x0)\n',
         '    js = init_f(x0)\n'
         '    jrec = JTel.SpanRecorder().install()\n'
         '    trec = TTel.SpanRecorder().install()\n'),
        ('    res["zero_payloads"] = rt.zero_payloads\n',
         '    res["zero_payloads"] = rt.zero_payloads\n'
         '    jrec.uninstall(); trec.uninstall()\n'
         '    res["schedule"] = [jrec.schedule, trec.schedule]\n'
         '    res["tkeys"] = [list(cfg.telemetry_metric_keys()),\n'
         '                    list(jrt.cfg.telemetry_metric_keys())]\n'),
    ]
    for old, new in reps:
        assert body.count(old) == 1, old
        body = body.replace(old, new)
    return body


CHURN_KW = dict(membership=CHURN, schedule_period=PERIOD, telemetry=True)
BERN = dict(link_loss=0.2, loss_seed=1, resync_retries=1)
GILBERT = dict(link_loss_model="gilbert:p=0.1,r=0.9", loss_seed=1)
CASES = [
    ("bern/packed", 4, dict(CHURN_KW, **BERN)),
    ("bern/pipelined4", 4, dict(CHURN_KW, wire_packing="pipelined",
                                pipeline_chunks=4, **BERN)),
    ("bern/async1", 4, dict(CHURN_KW, wire_packing="async", **BERN)),
    ("gilbert/packed", 4, dict(CHURN_KW, **GILBERT)),
    ("gilbert/pipelined3", 4, dict(CHURN_KW, wire_packing="pipelined",
                                   pipeline_chunks=3, **GILBERT)),
    ("gilbert/async1", 4, dict(CHURN_KW, wire_packing="async", **GILBERT)),
    ("pods2/bern", 4, dict(hierarchy=2, telemetry=True, **BERN)),
    ("straggle/async1", 4, dict(wire_packing="async", straggle_rate=0.3,
                                straggle_seed=2, telemetry=True)),
    ("strides5/bern", 5, dict(ring_strides=(1, 2), schedule_period=2,
                              telemetry=True, **BERN)),
]
LABELS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    body = (_with_telemetry(MEMBERSHIP_BODY).replace("__DEV__", "6")
            .replace("__STEPS__", str(STEPS)).replace("__CASES__",
                                                      repr(CASES)))
    proc = subprocess.run([sys.executable, "-c", body], capture_output=True,
                          text=True, timeout=900, env=env, cwd=REPO)
    if proc.returncode != 0:
        raise AssertionError(f"subprocess failed:\n{proc.stderr[-4000:]}")
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise AssertionError(f"no RESULT line:\n{proc.stdout[-2000:]}")


@pytest.mark.parametrize("label", LABELS)
def test_telemetry_metrics_equal_reference(reference, label):
    """Every compared metric, the telemetry keys among them, equal per
    node at every step; the rest of the membership harness's contract."""
    r = reference[label]
    check_case(r)
    assert r["tkeys"][0] == r["tkeys"][1] != []


@pytest.mark.parametrize("label", ["bern/packed", "bern/pipelined4",
                                   "bern/async1"])
def test_schedule_equals_reference(reference, label):
    jsched, tsched = reference[label]["schedule"]
    assert tsched == jsched
    assert {s[0] for s in tsched} == {"quantize", "launch", "retire",
                                      "dequant_combine"}
