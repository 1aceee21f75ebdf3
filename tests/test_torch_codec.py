"""The port's wire codecs, bit controller, codec exchange and trainer held
to the JAX reference (``repro.core.codec``, ``ConsensusRuntime``).

Mirrors ``tests/test_codec.py``: byte accounting, the ``topk:k=`` grammar,
the overflow counts, and the ``AdaptiveBitController`` cases, run as the
same feedback sequences through both controllers and compared decision for
decision.

The exchange: one subprocess with 4 host devices runs the reference's
``ConsensusRuntime(wire_codec=...)`` under ``shard_map`` and the port's
stacked-node exchange on the same inputs and noise, 3 steps of a 4-node
ring over the reduced smollm-135m tree, for int4, int2 and top-k in fixed
and adaptive mode.  Every step, started from the reference's state: the
payload bytes are exact, ``x_tilde``, ``m_agg`` and ``x_next`` agree within
``STATE_ULPS`` ulps of each buffer's largest magnitude (XLA contracts the
decode products into the sums as FMAs; ROADMAP Queue 3, hazards 4-5), the
overflow fraction and ``wire_bytes_per_step`` are equal.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import json
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as JC
from repro_torch.core import codec as C
from repro_torch.kernels import ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 512
CODECS = ("int4", "int2", "topk")
STEPS = 3
STATE_ULPS = 2


def _mk(n=64, seed=0, spread=1.0):
    rng = np.random.default_rng(seed)
    return rng, (rng.standard_normal((n, BLOCK)) * spread).astype(np.float32)


def _noise(rng, n, codec):
    return rng.random((n, codec.noise_cols(BLOCK)), dtype=np.float32)


# ---------------------------------------------------------------------------
# geometry and the spec grammar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["int8", "int4", "int2", "topk",
                                  "topk:k=16", "topk:k=256"])
def test_payload_byte_accounting_matches_jax(name):
    cd, jcd = C.by_name(name), JC.by_name(name)
    for attr in ("payload_width", "noise_cols", "codes_per_row", "coverage"):
        assert getattr(cd, attr)(BLOCK) == getattr(jcd, attr)(BLOCK), attr
    assert cd.payload_bytes(640) == jcd.payload_bytes(640)
    assert (cd.name, cd.code_max) == (jcd.name, jcd.code_max)
    rng, y = _mk()
    pay = cd.encode_payload(torch.from_numpy(y),
                            torch.from_numpy(_noise(rng, 64, cd)))
    assert pay.shape == (64, cd.payload_width()) and pay.dtype == torch.uint8


def test_topk_k_spec_grammar_and_bytes():
    for k in (16, 32, 64, 128, 256):
        cd = C.by_name(f"topk:k={k}")
        assert cd.k == k and cd.payload_width() == BLOCK // 8 + k + 2
    assert C.by_name("topk:k=64").name == "topk"
    assert C.by_name("topk:k=128").name == "topk:k=128"
    assert C.by_name(C.by_name("topk:k=128").name).k == 128
    with pytest.raises(KeyError, match="topk:k="):
        C.by_name("topk:k=x")
    with pytest.raises(ValueError, match="k must divide"):
        C.by_name("topk:k=63")
    with pytest.raises(KeyError):
        C.by_name("topk:j=64")
    assert C.CODEC_NAMES == JC.CODEC_NAMES
    for name in C.CODEC_NAMES:
        C.by_name(name)
    rng, y = _mk()
    cd = C.by_name("topk:k=128")
    dq = cd.decode_payload(cd.encode_payload(
        torch.from_numpy(y), torch.from_numpy(_noise(rng, 64, cd))))
    assert dq.shape == (64, BLOCK)
    assert int((dq != 0).sum(dim=1).max()) <= 128


def test_runtime_wire_bytes_use_codec_width():
    from repro.core.distributed import ConsensusConfig as JCfg
    from repro.core.distributed import ConsensusRuntime as JRt
    from repro.core.wire import WireLayout as JLayout
    from repro.models.sharding import ParallelContext
    from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
    from repro_torch.core.wire import WireLayout
    n = 40 * BLOCK + 7
    jlayout = JLayout.for_tree({"w": jnp.zeros((n,))})
    layout = WireLayout.for_tree({"w": torch.zeros(n)})
    ctx = ParallelContext(tp=1, data_size=4, n_nodes=4)
    for name in ("int8", "int4", "int2", "topk", "topk:k=256"):
        rt = ConsensusRuntime(ConsensusConfig(wire_codec=name), 4)
        jrt = JRt(JCfg(wire_codec=name), ctx)
        got = rt.wire_bytes_per_step(layout.n_elements, layout)
        assert got == jrt.wire_bytes_per_step(jlayout.n_elements,
                                              layout=jlayout)
        assert got == 2 * layout.n_rows * C.by_name(name).payload_width()
        assert rt.collectives_per_step(1) == 2.0


def test_config_validation():
    from repro_torch.core.distributed import ConsensusConfig
    with pytest.raises(ValueError, match="wire_codec"):
        ConsensusConfig(wire_codec="int3")
    with pytest.raises(ValueError, match="wire_codec"):
        ConsensusConfig(wire_codec="topk:k=63")
    with pytest.raises(ValueError, match="wire_codec"):
        ConsensusConfig(wire_codec="mixed:norm=int3,*=int8")
    assert ConsensusConfig(wire_codec="mixed:norm=int2,*=int8").wire_codec \
        == "mixed:norm=int2,*=int8"
    with pytest.raises(ValueError, match="byte_budget"):
        ConsensusConfig(byte_budget=-1.0)
    with pytest.raises(KeyError):
        C.by_name("fp8")
    with pytest.raises(ValueError, match="k must divide"):
        C.TopKCodec(k=63)
    with pytest.raises(ValueError, match="code_bits"):
        C.SubByteCodec(code_bits=3)
    with pytest.raises(ValueError, match="ladder"):
        C.AdaptiveBitController(ladder=())
    assert C.AdaptiveBitController(plan=object()).plan is not None


# ---------------------------------------------------------------------------
# overflow counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["int8", "int4", "int2", "topk"])
def test_count_clipped_semantics(name):
    """The port's boundary census equals the reference's on the same
    payload bytes, in a grid so fine that everything clips and in the
    adaptive grid, where fine grids rarely sit on the boundary."""
    cd, jcd = C.by_name(name), JC.by_name(name)
    rng, y = _mk(n=32, seed=7)
    noise = _noise(rng, 32, cd)
    total = 32 * cd.codes_per_row(BLOCK)
    for step in (np.float32(1e-12), None):
        pay = np.asarray(jcd.encode_payload(jnp.asarray(y),
                                            jnp.asarray(noise),
                                            fixed_step=step))
        got = float(cd.count_clipped(torch.from_numpy(pay.copy())))
        assert got == float(jcd.count_clipped(jnp.asarray(pay), BLOCK))
        if step is not None:
            assert got > 0.9 * total
        elif name != "int2":
            assert got <= 0.05 * total


@pytest.mark.parametrize("step", [8.0, 1e-6, 1.0, 1e-2, None])
@pytest.mark.parametrize("name", ["int2", "int4", "int8", "topk"])
def test_saturation_census_matches_jax(name, step):
    """Sub-byte grids count ``|y| > code_max * bf16(step)`` from the
    differential; int8 and top-k (and every codec without a fixed grid)
    keep the payload census."""
    cd, jcd = C.by_name(name), JC.by_name(name)
    rng, y = _mk(n=32, seed=8)
    noise = _noise(rng, 32, cd)
    step_j = None if step is None else jnp.float32(step)
    pay = np.asarray(jcd.encode_payload(jnp.asarray(y), jnp.asarray(noise),
                                        fixed_step=step_j))
    got = float(cd.count_saturated(torch.from_numpy(y), step,
                                   torch.from_numpy(pay.copy())))
    assert got == float(jcd.count_saturated(jnp.asarray(y), step_j,
                                            jnp.asarray(pay)))
    if name == "int2" and step == 8.0:
        assert got == 0.0
    if name == "int2" and step == 1e-6:
        assert got > 0.99 * y.size


# ---------------------------------------------------------------------------
# AdaptiveBitController: the reference's cases, decision for decision
# ---------------------------------------------------------------------------

N_ROWS = 640


def _same_decisions(script, **kw):
    """Run ``script(ctl)`` on a port and a reference controller built with
    the same arguments; the returned decision lists must be equal."""
    got = script(C.AdaptiveBitController(**kw))
    want = script(JC.AdaptiveBitController(**kw))
    assert got == want
    return got


def test_controller_budget_filter():
    n = N_ROWS
    int4_bytes = 2 * n * C.by_name("int4").payload_width()
    for budget in (None, int4_bytes, 1.0):
        out = _same_decisions(lambda c: [c.candidates(n), c.initial(n),
                                         c.candidate_table(n)],
                              byte_budget=budget)
    assert out[:2] == [("int2",), "int2"]


def test_controller_initial_and_fidelity_targeting():
    n = N_ROWS
    out = _same_decisions(lambda c: [
        c.initial(n),
        c.target(1, residual_rms=0.01, overflow_frac=0.0, n_rows=n),
        c.target(100, residual_rms=0.01, overflow_frac=0.0, n_rows=n),
        c.target(10, residual_rms=0.01, overflow_frac=0.0, n_rows=n),
        c.target(10, residual_rms=None, overflow_frac=0.0, n_rows=n),
        c.target(10, residual_rms=1e-4, overflow_frac=0.0, n_rows=n,
                 consensus_err=0.01)],
        fixed_step0=0.1, gamma=1.0, headroom=4.0)
    assert out == ["int8", "int2", "int8", "int4", "int2", "int4"]


def test_controller_hysteresis_and_overflow():
    n = N_ROWS
    out = _same_decisions(lambda c: [
        c.initial(n), c.select(1, 0.01, 0.0, n), c.select(1, 0.01, 0.0, n),
        c.select(100, 0.01, 0.0, n)], fixed_step0=0.1, gamma=1.0, patience=2)
    assert out == ["int8", "int8", "int2", "int8"]
    out = _same_decisions(lambda c: [
        c.initial(n), c.select(1, 0.01, 0.0, n),
        c.select(1, 0.01, overflow_frac=0.5, n_rows=n)],
        fixed_step0=0.1, gamma=1.0, patience=1)
    assert out == ["int8", "int2", "int4"]


def test_controller_variance_adaptive_topk_ladder():
    n = N_ROWS
    ladder = tuple(f"topk:k={k}" for k in (16, 32, 64, 128, 256))
    for name in (*ladder, "int2", "int4", "int8"):
        assert (C.AdaptiveBitController._capacity(name)
                == JC.AdaptiveBitController._capacity(name))
    out = _same_decisions(lambda c: [
        c.initial(n), c.select(1, 1e-5, 0.0, n), c.select(2, 1e-5, 0.0, n),
        c.select(3, 2e-3, 0.0, n),
        c.target(4, residual_rms=1.0, overflow_frac=0.0, n_rows=n),
        c.select(5, 1e-5, overflow_frac=0.5, n_rows=n)],
        ladder=ladder, fixed_step0=1e-3, gamma=0.0, headroom=4.0,
        patience=2)
    assert out == ["topk:k=256", "topk:k=256", "topk:k=16", "topk:k=64",
                   "topk:k=256", "topk:k=128"]
    budget = 2 * n * C.by_name("topk:k=64").payload_width()
    out = _same_decisions(lambda c: [c.candidates(n), c.candidate_table(n)],
                          ladder=ladder, byte_budget=budget)
    assert out[0] == ladder[:3]


def test_controller_switches_across_amplified_epochs():
    n = N_ROWS
    trace = _same_decisions(
        lambda c: [c.initial(n)] + [
            c.select(k, residual_rms=0.01, overflow_frac=0.0, n_rows=n)
            for k in (1, 5, 30, 200, 2000)],
        fixed_step0=0.05, gamma=1.0, patience=1, headroom=4.0)
    assert trace[0] == trace[-1] == "int8"
    assert "int2" in trace and "int4" in trace


# ---------------------------------------------------------------------------
# the 4-node exchange against the reference's ConsensusRuntime
# ---------------------------------------------------------------------------

BODY = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax, jax.numpy as jnp, numpy as np, torch
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import codec as JC
from repro.core import wire as jwire
from repro.core.distributed import ConsensusConfig as JCfg
from repro.core.distributed import ConsensusRuntime as JRt
from repro.models import transformer as JT
from repro.models.sharding import ParallelContext, local_context
from repro.models.sharding import shard_map_compat
from repro_torch.core import tree as T
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime

N, STEPS = 4, __STEPS__
mesh = Mesh(np.array(jax.devices()[:N]), ("data",))
ctx = ParallelContext(tp=1, data_size=N, n_nodes=N, in_shard_map=True)
defs = JT.build_defs(jreduced(jget_config("smollm-135m")), local_context())
tmpl = JT.init_params(defs, jax.random.PRNGKey(0))   # structure only
rng = np.random.default_rng(0)
x0 = jax.tree.map(lambda a: np.broadcast_to(
    (rng.standard_normal(a.shape) * 0.05).astype(np.float32),
    (N,) + a.shape).copy(), tmpl)
layout = jwire.WireLayout.for_tree(jax.tree.map(lambda a: a[0], x0))

def delta(k):
    r = np.random.default_rng([1, k])
    def one(a):
        d = (r.standard_normal((N,) + a.shape) * 2e-3).astype(np.float32)
        d.reshape(-1)[::997] *= 300.0      # a few saturate the fixed grid
        return d
    return jax.tree.map(one, tmpl)

def ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / np.spacing(np.max(np.abs(b))))

pspec = jax.tree.map(lambda a: P("data"), x0)
cspec = {"x_tilde": P("data", None, None), "m_agg": P("data", None, None)}
mspec = {"overflow_frac": P("data"), "residual_norm": P("data")}
tt = lambda tree: T.tree_map(torch.from_numpy, tree)
out = {}
for codec in __CODECS__:
    jcodec = JC.by_name(codec)
    cols = jcodec.noise_cols(512)
    for mode in ("fixed", "adaptive"):
        jrt = JRt(JCfg(quant_mode=mode, wire_codec=codec), ctx)
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
        rt = ConsensusRuntime(ConsensusConfig(quant_mode=mode,
                                              wire_codec=codec), N)
        res = {"payload_equal": [], "xt_ulps": [], "m_ulps": [],
               "x_ulps": [], "overflow": [], "residual": []}
        x_prev = x0
        for k in range(1, STEPS + 1):
            xp, xh = x_prev, jax.tree.map(np.add, x_prev, delta(k))
            x_prev = xh
            nz = np.random.default_rng([2, k]).random(
                (N, layout.n_rows, cols), dtype=np.float32)
            synced = {key: torch.from_numpy(np.array(v))
                      for key, v in js.items()}
            step_k = jrt._step_k(jnp.asarray(k, jnp.int32))
            want = [np.asarray(jcodec.encode_payload(
                layout.pack(jax.tree.map(lambda a: a[i], xh))
                - js["x_tilde"][i], jnp.asarray(nz[i]), fixed_step=step_k))
                for i in range(N)]
            tlayout = rt.state_layout(tt(xh))
            y = tlayout.pack(tt(xh)) - synced["x_tilde"]
            got = rt.encode(y, torch.from_numpy(nz), k, tlayout)
            res["payload_equal"].append(all(
                np.array_equal(g.numpy(), w.reshape(-1))
                for g, w in zip(got, want)))
            jxn, js, jm = step_f(xp, xh, js, jnp.asarray(k, jnp.int32), nz)
            txn, ts, tm = rt.exchange(tt(xp), tt(xh), synced, k,
                                      noise=torch.from_numpy(nz))
            res["xt_ulps"].append(ulps(ts["x_tilde"], js["x_tilde"]))
            res["m_ulps"].append(ulps(ts["m_agg"], js["m_agg"]))
            res["x_ulps"].append(max(ulps(a, b) for a, b in zip(
                T.tree_leaves(txn), jax.tree_util.tree_leaves(jxn))))
            res["overflow"].append([tm["overflow_frac"].tolist(),
                                    np.asarray(jm["overflow_frac"]).tolist()])
            res["residual"].append([tm["residual_norm"].tolist(),
                                    np.asarray(jm["residual_norm"]).tolist()])
        res["wire"] = [tm["wire_bytes_per_step"], jrt.wire_bytes_per_step(
            layout.n_elements, layout=layout)]
        out[f"{codec}/{mode}"] = res
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def exchange():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    body = (BODY.replace("__STEPS__", str(STEPS))
            .replace("__CODECS__", repr(CODECS)))
    proc = subprocess.run([sys.executable, "-c", body], capture_output=True,
                          text=True, timeout=600, env=env, cwd=REPO)
    if proc.returncode != 0:
        raise AssertionError(f"subprocess failed:\n{proc.stderr[-4000:]}")
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise AssertionError(f"no RESULT line:\n{proc.stdout[-2000:]}")


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("codec", CODECS)
def test_exchange_payload_bytes_exact(exchange, codec, mode):
    assert exchange[f"{codec}/{mode}"]["payload_equal"] == [True] * STEPS


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("codec", CODECS)
def test_exchange_state_within_ulps(exchange, codec, mode):
    r = exchange[f"{codec}/{mode}"]
    for key in ("xt_ulps", "m_ulps", "x_ulps"):
        assert max(r[key]) <= STATE_ULPS, (key, r[key])


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("codec", CODECS)
def test_exchange_metrics_match(exchange, codec, mode):
    r = exchange[f"{codec}/{mode}"]
    for got, want in r["overflow"]:
        assert got == want
    if mode == "fixed":
        assert any(x > 0 for got, _ in r["overflow"] for x in got)
    for got, want in r["residual"]:
        assert got == pytest.approx(want, rel=1e-5)
    assert r["wire"][0] == r["wire"][1] > 0


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_trainer_adaptive_codec_switches(capsys):
    """A reduced CPU run of ``--wire-codec adaptive --codec-period 1``: the
    controller starts on int8, switches at least once, each step's wire
    bytes are its codec's, and the losses stay finite."""
    from repro_torch.launch import train
    hist = train.main(["--reduced", "--device", "cpu", "--nodes", "4",
                       "--batch", "8", "--seq", "32", "--steps", "4",
                       "--wire-codec", "adaptive", "--codec-period", "1"])
    codecs = [h["codec"] for h in hist]
    assert codecs[0] == "int8" and len(set(codecs)) > 1, codecs
    assert "[codec] step" in capsys.readouterr().out
    rows = hist[0]["wire_bytes_per_step"] / (2 * C.by_name(
        "int8").payload_width())
    for h in hist:
        assert math.isfinite(h["loss"])
        assert h["wire_bytes_per_step"] == \
            2 * rows * C.by_name(h["codec"]).payload_width()


@pytest.mark.parametrize("codec", ["int4", "int2", "topk", "topk:k=16"])
def test_trainer_fixed_codec_runs(codec):
    from repro_torch.launch import train
    hist = train.main(["--reduced", "--device", "cpu", "--nodes", "4",
                       "--batch", "8", "--seq", "32", "--steps", "2",
                       "--wire-codec", codec])
    assert all(math.isfinite(h["loss"]) for h in hist)
    assert {h["codec"] for h in hist} == {C.by_name(codec).name}


def test_trainer_rejects_bad_codec_flags():
    from repro_torch.launch import train
    for argv in (["--wire-codec", "int3"],
                 ["--wire-codec", "adaptive", "--codec-ladder", "int2,fp8"],
                 ["--wire-codec", "adaptive", "--algorithm", "dgd"]):
        with pytest.raises(SystemExit):
            train.main(["--reduced", "--device", "cpu", *argv])


def test_codec_switch_keeps_the_train_state():
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train
    setup = train.build_train_setup(reduced(get_config("smollm-135m")),
                                    consensus_nodes=2, device="cpu")
    state = train.init_train_state(setup, 0)
    swapped = train.with_codec(setup, "topk:k=16")
    assert swapped.consensus.wire_name == C.by_name("topk:k=16").name
    assert setup.consensus.wire_name == "int8"
    assert swapped.defs is setup.defs
    assert ops.BLOCK == BLOCK
    for key, v in swapped.consensus.init_state(state["params"]).items():
        assert torch.equal(v, state["consensus"][key])
