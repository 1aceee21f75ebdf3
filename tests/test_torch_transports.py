"""The pipelined and async transports and mixed wire plans on the port's
4-node exchange (``repro_torch.core.distributed``).

The port alone, on the reduced smollm-135m tree:
  * pipelined == packed bit for bit (parameters, x_tilde, m_agg, metrics)
    at chunk counts 1, 2, 3, 4 and 7, for uniform int8, plan A and plan B:
    every codec is row-local, so any chunking gives the same bits;
  * async at staleness 0 == packed bit for bit, the in-flight buffers
    passed through untouched;
  * async at staleness 1: the step-1 retire of the zero payloads leaves
    x_tilde and m_agg exactly as they were; from step 2 on a step retires
    the payload the previous step launched;
  * collectives per step are 2 x transfer units; padding rows stay zero.

Against the reference (one subprocess with 4 host devices running
``repro.core.distributed.ConsensusRuntime`` under ``shard_map``, 3 steps,
each started from the reference's own state via
``consensus_state_from_jax``): plan A packed, plan A pipelined over 3
chunks, plan B packed and int8 async at staleness 1.  Payload bytes are
exact; x_tilde, m_agg and x_next within STATE_ULPS of each buffer's
largest magnitude (XLA contracts the decode products into the sums as
FMAs: ROADMAP Queue 3, hazard 4); overflow, wire bytes and collectives
equal.

And the trainer's new flags on ``--reduced --device cpu``.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import tree as T
from repro_torch.core import wire
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.launch import train
from repro_torch.models import transformer as TF
from repro_torch.models.params import meta_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: reference parity over STEPS steps; the port's own identities over
#: SELF_STEPS (every step after the first carries state)
N, STEPS, SELF_STEPS, STATE_ULPS = 4, 3, 2, 2
PLAN_A = "mixed:norm=int4,embed=int4,*=int8"
PLAN_B = "mixed:embed=topk:k=64,norm=int2,*=int8"
WIRES = {"int8": "int8", "planA": PLAN_A, "planB": PLAN_B}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: its many small tensor
    ops only contend when the CPU is shared with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _template():
    return meta_params(TF.build_defs(reduced(get_config("smollm-135m")))
                       .storage)


def _x0(seed=0):
    """Every node's identical start, drawn with numpy."""
    rng = np.random.default_rng(seed)
    return T.tree_map(lambda a: torch.from_numpy(np.broadcast_to(
        (rng.standard_normal(a.shape) * 0.05).astype(np.float32),
        (N,) + a.shape).copy()), _template())


def _delta(k):
    """Step k's optimizer delta per node; a few entries saturate the
    fixed grid."""
    r = np.random.default_rng([1, k])

    def one(a):
        d = (r.standard_normal((N,) + a.shape) * 2e-3).astype(np.float32)
        d.reshape(-1)[::997] *= 300.0
        return torch.from_numpy(d)
    return T.tree_map(one, _template())


def _run(spec, packing="packed", chunks=4, staleness=1, steps=SELF_STEPS,
         mode="fixed"):
    """``steps`` exchanges from x0 with the same deltas and noise seeds:
    (final params, state, metrics per step, state after step 1)."""
    rt = ConsensusRuntime(ConsensusConfig(
        wire_codec=spec, wire_packing=packing, pipeline_chunks=chunks,
        staleness=staleness, quant_mode=mode), N)
    x = _x0()
    state = rt.init_state(x)
    hist, first = [], None
    for k in range(1, steps + 1):
        xh = T.tree_map(torch.add, x, _delta(k))
        x, state, m = rt.exchange(x, xh, state, k, seed=5)
        hist.append({key: (v.tolist() if torch.is_tensor(v) else v)
                     for key, v in m.items()})
        if first is None:
            first = {key: v.clone() for key, v in state.items()}
    return x, state, hist, first


@pytest.fixture(scope="module")
def packed():
    return {name: _run(spec) for name, spec in WIRES.items()}


def _same(a, b) -> bool:
    xa, sa, ha, _ = a
    xb, sb, hb, _ = b
    return (all(torch.equal(p, q) for p, q in zip(T.tree_leaves(xa),
                                                   T.tree_leaves(xb)))
            and all(torch.equal(sa[k], sb[k]) for k in ("x_tilde", "m_agg"))
            and [{k: v for k, v in h.items() if k != "collectives_per_step"}
                 for h in ha]
            == [{k: v for k, v in h.items() if k != "collectives_per_step"}
                for h in hb])


@pytest.mark.parametrize("chunks", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("wire_name", list(WIRES))
def test_pipelined_equals_packed_bitwise(packed, wire_name, chunks):
    got = _run(WIRES[wire_name], "pipelined", chunks)
    assert _same(got, packed[wire_name])
    rt = ConsensusRuntime(ConsensusConfig(
        wire_codec=WIRES[wire_name], wire_packing="pipelined",
        pipeline_chunks=chunks), N)
    layout = rt.state_layout(_x0())
    units = rt.pipeline_chunks_for(layout)
    assert units == rt.wire_plan_for(layout).n_chunks(chunks) >= min(
        chunks, rt.wire_plan_for(layout).n_runs)
    assert {h["collectives_per_step"] for h in got[2]} == {2.0 * units}
    assert {h["collectives_per_step"] for h in packed[wire_name][2]} == {2.0}


@pytest.mark.parametrize("wire_name", list(WIRES))
def test_async_staleness_0_equals_packed_bitwise(packed, wire_name):
    got = _run(WIRES[wire_name], "async", staleness=0)
    assert _same(got, packed[wire_name])
    fly = got[1]["fly_self"]
    assert fly.dtype == torch.uint8 and not fly.any()   # idle, untouched
    for key in wire.INFLIGHT_KEYS:
        assert torch.equal(got[1][key], got[3][key])


@pytest.mark.parametrize("wire_name", ["int8", "planB"])
def test_async_step1_retire_is_a_noop_then_stale_by_one(wire_name):
    spec = WIRES[wire_name]
    rt = ConsensusRuntime(ConsensusConfig(wire_codec=spec,
                                          wire_packing="async"), N)
    x = _x0()
    init = rt.init_state(x)
    layout = rt.state_layout(x)
    nbytes = rt.wire_plan_for(layout).payload_bytes
    assert {key: tuple(v.shape) for key, v in init.items()
            if key in wire.INFLIGHT_KEYS} == {
                key: (N, nbytes) for key in wire.INFLIGHT_KEYS}
    _, st, hist, first = _run(spec, "async")
    for key in ("x_tilde", "m_agg"):
        assert torch.equal(first[key], init[key]), key
    # node i's arrivals are its ring neighbours' launched payloads
    assert torch.equal(first["fly_up"], first["fly_self"].roll(1, 0))
    assert torch.equal(first["fly_dn"], first["fly_self"].roll(-1, 0))
    # step 2 retires step 1's launch: x_tilde moves to the packed step-1
    # shadow, which was encoded against the same (initial) x_tilde
    _, st_packed, _, first_packed = _run(spec, steps=1)
    assert torch.equal(st["x_tilde"], first_packed["x_tilde"])
    assert all(h["collectives_per_step"] == 2.0 for h in hist)
    assert hist[0]["wire_bytes_per_step"] == 2.0 * nbytes


@pytest.mark.parametrize("packing", ["packed", "pipelined", "async"])
def test_padding_rows_stay_zero(packing):
    _, st, _, _ = _run(PLAN_B, packing, chunks=7)
    layout = ConsensusRuntime(ConsensusConfig(wire_codec=PLAN_B),
                              N).state_layout(_x0())
    for key in ("x_tilde", "m_agg"):
        buf = st[key]
        assert not buf[:, layout.n_data_rows:].any()
        for slot in layout.slots:
            tail = buf[:, slot.row_start:slot.row_end].reshape(N, -1)[
                :, slot.size:]
            assert not tail.any(), (key, slot.path)


def test_compressed_dgd_pipelined_equals_packed():
    def run(packing):
        rt = ConsensusRuntime(ConsensusConfig(
            algorithm="compressed_dgd", wire_packing=packing,
            pipeline_chunks=3), N)
        x = _x0()
        xh = T.tree_map(torch.add, x, _delta(1))
        return rt.exchange(x, xh, {}, 1, seed=2)
    (xa, _, ma), (xb, _, mb) = run("packed"), run("pipelined")
    assert all(torch.equal(a, b) for a, b in zip(T.tree_leaves(xa),
                                                  T.tree_leaves(xb)))
    assert (ma["collectives_per_step"], mb["collectives_per_step"]) == \
        (2.0, 6.0)


# ---------------------------------------------------------------------------
# against the reference's ConsensusRuntime
# ---------------------------------------------------------------------------

#: (label, wire_codec, wire_packing, pipeline_chunks)
CASES = [("planA/packed", PLAN_A, "packed", 4),
         ("planA/pipelined3", PLAN_A, "pipelined", 3),
         ("planB/packed", PLAN_B, "packed", 4),
         ("int8/async1", "int8", "async", 4)]

BODY = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax, jax.numpy as jnp, numpy as np, torch
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core.distributed import ConsensusConfig as JCfg
from repro.core.distributed import ConsensusRuntime as JRt
from repro.models import transformer as JT
from repro.models.sharding import ParallelContext, local_context
from repro.models.sharding import shard_map_compat
from repro_torch.core import tree as T
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.models.params import consensus_state_from_jax

torch.set_num_threads(1)
N, STEPS = 4, __STEPS__
mesh = Mesh(np.array(jax.devices()[:N]), ("data",))
ctx = ParallelContext(tp=1, data_size=N, n_nodes=N, in_shard_map=True)
defs = JT.build_defs(jreduced(jget_config("smollm-135m")), local_context())
tmpl = JT.init_params(defs, jax.random.PRNGKey(0))   # structure only
rng = np.random.default_rng(0)
x0 = jax.tree.map(lambda a: np.broadcast_to(
    (rng.standard_normal(a.shape) * 0.05).astype(np.float32),
    (N,) + a.shape).copy(), tmpl)

def delta(k):
    r = np.random.default_rng([1, k])
    def one(a):
        d = (r.standard_normal((N,) + a.shape) * 2e-3).astype(np.float32)
        d.reshape(-1)[::997] *= 300.0
        return d
    return jax.tree.map(one, tmpl)

def ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / np.spacing(np.max(np.abs(b))))

pspec = jax.tree.map(lambda a: P("data"), x0)
mspec = {"overflow_frac": P("data"), "residual_norm": P("data")}
tt = lambda tree: T.tree_map(torch.from_numpy, tree)
out = {}
for label, spec, packing, chunks in __CASES__:
    kw = dict(wire_codec=spec, wire_packing=packing, pipeline_chunks=chunks)
    jrt = JRt(JCfg(**kw), ctx)
    rt = ConsensusRuntime(ConsensusConfig(**kw), N)
    jlayout = jrt.state_layout(jax.tree.map(lambda a: a[0], x0))
    jplan = jrt.wire_plan_for(jlayout)
    layout = rt.state_layout(tt(x0))
    plan = rt.wire_plan_for(layout)
    keys = ["x_tilde", "m_agg"] + (
        ["fly_self", "fly_up", "fly_dn"] if packing == "async" else [])
    cspec = {k: (P("data", None, None) if k in ("x_tilde", "m_agg")
                 else P("data", None)) for k in keys}
    init_f = jax.jit(shard_map_compat(
        lambda p: jax.tree.map(lambda a: a[None], jrt.init_state(p)),
        mesh, in_specs=(pspec,), out_specs=cspec, check=False))
    def jstep(xp, xh, s, k, nz):
        s = jax.tree.map(lambda a: a[0], s)
        xn, s2, m = jrt.exchange(xp, xh, s, k, jax.random.PRNGKey(7),
                                 noise=nz[0])
        return (xn, jax.tree.map(lambda a: a[None], s2),
                {k2: m[k2][None] for k2 in mspec})
    step_f = jax.jit(shard_map_compat(
        jstep, mesh, in_specs=(pspec, pspec, cspec, P(), P("data")),
        out_specs=(pspec, cspec, mspec), check=False))
    js = init_f(x0)
    res = {"payload_equal": [], "ulps": [], "overflow": [], "residual": [],
           "layout": [layout.placement == jlayout.placement,
                      plan.payload_bytes == jplan.payload_bytes]}
    x_prev = x0
    for k in range(1, STEPS + 1):
        xp, xh = x_prev, jax.tree.map(np.add, x_prev, delta(k))
        x_prev = xh
        nz = np.random.default_rng([2, k]).random(
            (N, layout.n_rows, plan.noise_cols()), dtype=np.float32)
        synced = consensus_state_from_jax(
            {key: np.asarray(v) for key, v in js.items()}, N, device="cpu")
        step_k = jrt._step_k(jnp.asarray(k, jnp.int32))
        jxn, js, jm = step_f(xp, xh, js, jnp.asarray(k, jnp.int32), nz)
        txn, ts, tm = rt.exchange(tt(xp), tt(xh), synced, k,
                                  noise=torch.from_numpy(nz))
        if packing == "async":
            # the payloads launched this step, and the ring's arrivals
            same = all(np.array_equal(ts[key].numpy(), np.asarray(js[key]))
                       for key in ("fly_self", "fly_up", "fly_dn"))
        else:
            y = layout.pack(tt(xh)) - synced["x_tilde"]
            same = True
            for i in range(N):
                want = np.asarray(jplan.encode(
                    jlayout.pack(jax.tree.map(lambda a: a[i], xh))
                    - synced["x_tilde"][i].numpy(), jnp.asarray(nz[i]),
                    fixed_step=step_k))
                got = plan.encode(y[i], torch.from_numpy(nz[i]),
                                  rt._step_k(k))
                same = same and np.array_equal(got.numpy(), want)
        res["payload_equal"].append(bool(same))
        res["ulps"].append([ulps(ts["x_tilde"], js["x_tilde"]),
                            ulps(ts["m_agg"], js["m_agg"]),
                            max(ulps(a, b) for a, b in zip(
                                T.tree_leaves(txn),
                                jax.tree_util.tree_leaves(jxn)))])
        res["overflow"].append([tm["overflow_frac"].tolist(),
                                np.asarray(jm["overflow_frac"]).tolist()])
        res["residual"].append([tm["residual_norm"].tolist(),
                                np.asarray(jm["residual_norm"]).tolist()])
    res["wire"] = [tm["wire_bytes_per_step"], jrt.wire_bytes_per_step(
        jlayout.n_elements, layout=jlayout)]
    res["collectives"] = [tm["collectives_per_step"],
                          jrt.collectives_per_step(jlayout.n_leaves,
                                                   layout=jlayout)]
    out[label] = res
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    body = (BODY.replace("__STEPS__", str(STEPS))
            .replace("__CASES__", repr(CASES)))
    proc = subprocess.run([sys.executable, "-c", body], capture_output=True,
                          text=True, timeout=600, env=env, cwd=REPO)
    if proc.returncode != 0:
        raise AssertionError(f"subprocess failed:\n{proc.stderr[-4000:]}")
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise AssertionError(f"no RESULT line:\n{proc.stdout[-2000:]}")


LABELS = [c[0] for c in CASES]


@pytest.mark.parametrize("label", LABELS)
def test_reference_payload_bytes_exact(reference, label):
    r = reference[label]
    assert r["layout"] == [True, True]
    assert r["payload_equal"] == [True] * STEPS


@pytest.mark.parametrize("label", LABELS)
def test_reference_state_within_ulps(reference, label):
    for step, u in enumerate(reference[label]["ulps"]):
        assert max(u) <= STATE_ULPS, (step, u)


@pytest.mark.parametrize("label", LABELS)
def test_reference_metrics_match(reference, label):
    r = reference[label]
    for got, want in r["overflow"]:
        assert got == want
    assert any(x > 0 for got, _ in r["overflow"] for x in got)
    for got, want in r["residual"]:
        assert got == pytest.approx(want, rel=1e-5)
    assert r["wire"][0] == r["wire"][1] > 0
    assert r["collectives"][0] == r["collectives"][1]


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _main(*argv, **kw):
    return train.main(["--reduced", "--device", "cpu", "--nodes", "4",
                       "--batch", "8", "--seq", "32", *argv], **kw)


@pytest.mark.parametrize("argv,collectives", [
    (("--wire-plan", PLAN_A), 2.0),
    (("--wire-plan", PLAN_B, "--wire-packing", "pipelined",
      "--pipeline-chunks", "5"), 10.0),
    (("--wire-packing", "async", "--staleness", "1"), 2.0),
    (("--wire-plan", PLAN_A, "--wire-packing", "async"), 2.0)],
    ids=["planA", "planB-pipelined5", "async", "planA-async"])
def test_trainer_wire_flags_run(argv, collectives):
    hist = _main("--steps", "2", *argv)
    assert all(math.isfinite(h["loss"]) for h in hist)
    assert {h["collectives_per_step"] for h in hist} == {collectives}
    spec = argv[1] if argv[0] == "--wire-plan" else "int8"
    rt = ConsensusRuntime(ConsensusConfig(wire_codec=spec), N)
    params = T.tree_map(lambda a: a.expand((N,) + a.shape), _template())
    layout = rt.state_layout(params)
    assert hist[0]["wire_bytes_per_step"] == rt.wire_bytes_per_step(
        layout.n_elements, layout)
    assert {h["codec"] for h in hist} == {rt.wire_name}


def test_trainer_adaptive_over_a_plan(capsys):
    """Plan mode: the controller starts on the plan as given (its hot tier
    int8), switches the hot slots through the ladder with the cold slots
    pinned, and every step's wire bytes are its plan's, priced on the one
    grouped layout the state keeps."""
    hist, state = _main("--steps", "4", "--wire-plan", PLAN_A,
                        "--wire-codec", "adaptive", "--codec-period", "1",
                        return_state=True)
    codecs = [h["codec"] for h in hist]
    assert codecs[0] == PLAN_A and len(set(codecs)) > 1, codecs
    assert "[codec] step" in capsys.readouterr().out
    params = T.tree_map(lambda a: a.expand((N,) + a.shape), _template())
    layout = ConsensusRuntime(ConsensusConfig(wire_codec=PLAN_A),
                              N).state_layout(params)
    base = ConsensusRuntime(ConsensusConfig(wire_codec=PLAN_A),
                            N).wire_plan_for(layout)
    from repro_torch.core import wireplan
    for h in hist:
        spec = wireplan.parse_spec(h["codec"])
        assert spec.codec_for_path("['embed']['table']") == "int4"
        tier = spec.codec_for_path("['layers'][0]['attn']['wq']")
        assert h["wire_bytes_per_step"] == 2.0 * base.retier_hot(
            tier).payload_bytes
        assert math.isfinite(h["loss"])
    assert state["consensus"]["x_tilde"].shape == (N, layout.n_rows, 512)


def test_trainer_rejects_bad_wire_flags():
    for argv in (["--wire-plan", "mixed:norm=fp8"],
                 ["--wire-plan", "mixed:norm"],
                 ["--wire-codec", "adaptive", "--wire-packing", "async"],
                 ["--wire-codec", "adaptive", "--wire-packing", "per_leaf"],
                 ["--wire-packing", "ragged"],
                 ["--staleness", "2"]):
        with pytest.raises(SystemExit):
            _main("--steps", "1", *argv)
    with pytest.raises(ValueError, match="per-leaf"):
        _main("--steps", "1", "--wire-plan", PLAN_A, "--wire-packing",
              "per_leaf")
    with pytest.raises(ValueError, match="pipeline_chunks"):
        _main("--steps", "1", "--wire-packing", "pipelined",
              "--pipeline-chunks", "0")


def test_adaptive_async_at_staleness_0_runs():
    """Staleness 0 retires nothing across steps, so a codec switch leaves
    the idle in-flight buffers as they were and the run goes on."""
    hist = _main("--steps", "3", "--wire-codec", "adaptive",
                 "--codec-period", "1", "--wire-packing", "async",
                 "--staleness", "0")
    assert len({h["codec"] for h in hist}) > 1
    assert all(math.isfinite(h["loss"]) for h in hist)
