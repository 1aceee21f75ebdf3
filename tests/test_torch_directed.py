"""Directed graphs and push-sum on the port, held to the JAX package.

  * ``repro_torch.core.topology``'s directed half equals the reference's
    exactly: ``directed_ring`` / ``directed_cycle`` /
    ``directed_erdos_renyi`` (W, name, beta, edge and message counts, in-
    and out-neighbours), ``out_degree_weights``, the strong-connectivity
    test, ``push_sum_weights`` and ``DirectedErdosRenyiSchedule`` (the
    numpy draws, rejections included); ``validate_column_stochastic``
    refuses what the reference refuses, with the same message.
  * Push-sum in the reference algorithms: ADC-DGD, CHOCO and CEDAS are
    stepped beside the reference's jitted ``step`` with the reference's
    uniforms on ``directed_erdos_renyi(12, 0.3, seed=1)`` (whose rows do not
    sum to 1) and under ``DirectedErdosRenyiSchedule(8, 0.3, horizon=12)``,
    each step from the reference's state: the shadows and the transmitted
    maximum bitwise, ``x`` and ``ps_w`` within STATE_ULPS.  DGD, DGD^t and
    Eq. (5) mix a directed matrix as the reference does.  ``run`` reports
    the de-biased ``x_final`` and ``ps_w_final``, and bills one message
    per directed edge.  The reference's claims (``tests/
    test_consensus_paper.py``) hold on the port.
  * The runtime's directed ring and push-sum against the reference's
    ``ConsensusRuntime`` (one subprocess with 4 host devices, the runner of
    ``tests/test_torch_faults.py``): packed with and without 20% loss,
    pipelined over 3 units, async at staleness 1 and per-leaf under loss,
    plan A with a forward weight of 0.1, a re-wired directed ring (strides
    1 and 3) with failing resyncs, and push-sum forced on the symmetric
    ring.  Payload bytes (the push-sum trailer included) exact; state
    within 2 ulps per step; ``ps_w`` stays exactly 1; delivered bytes,
    wire bytes and collectives equal.
  * The trainer's ``--topology directed-ring`` and ``--forward-weight`` on
    ``--reduced --device cpu``.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import math

import jax
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.core import consensus as JK
from repro.core import problems as JP
from repro.core import topology as JT
from repro_torch.core import compression as C
from repro_torch.core import consensus as K
from repro_torch.core import problems as P
from repro_torch.core import topology as T
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.launch import train
from test_torch_faults import check_reference_case, reference_results

STEPS = 12
STATE_ULPS = 4
RUN_RTOL = 1e-3
N_RT = 4


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


# ---------------------------------------------------------------------------
# directed topologies
# ---------------------------------------------------------------------------

DIRECTED = [
    ("directed_ring", (4,), {}), ("directed_ring", (9,),
                                  {"forward_weight": 0.4}),
    ("directed_ring", (5,), {"self_weight": 0.3}), ("directed_ring", (1,), {}),
    ("directed_cycle", (5,), {}), ("directed_cycle", (2,), {}),
    ("directed_erdos_renyi", (12, 0.3), {"seed": 1}),
    ("directed_erdos_renyi", (20, 0.3), {"seed": 1}),
    ("directed_erdos_renyi", (6, 0.2), {"seed": 4,
                                        "ensure_connected": False}),
]


def same_directed(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got.name == want.name
    np.testing.assert_array_equal(got.w, want.w)
    assert got.beta == want.beta
    assert (got.n, got.n_edges, got.n_messages, got.is_directed) == (
        want.n, want.n_edges, want.n_messages, want.is_directed)
    for fn in ("neighbors", "in_neighbors", "out_neighbors"):
        assert [getattr(got, fn)(i) for i in range(got.n)] == \
            [getattr(want, fn)(i) for i in range(want.n)], fn


@pytest.mark.parametrize("fn,args,kw", DIRECTED,
                         ids=[f"{c[0]}{c[1]}{c[2] or ''}" for c in DIRECTED])
def test_directed_constructors_equal_reference(fn, args, kw):
    same_directed(getattr(T, fn)(*args, **kw), getattr(JT, fn)(*args, **kw))


def test_directed_helpers_equal_reference():
    rng = np.random.default_rng(3)
    for _ in range(20):
        adj = rng.random((7, 7)) < 0.3
        np.testing.assert_array_equal(T.out_degree_weights(adj, 0.4),
                                      JT.out_degree_weights(adj, 0.4))
        assert T.is_strongly_connected(adj) == JT.is_strongly_connected(adj)
    a = T.directed_erdos_renyi_graph(9, 0.4, np.random.default_rng(5))
    b = JT.directed_erdos_renyi_graph(9, 0.4, np.random.default_rng(5))
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError) as got:
        T.out_degree_weights(a, 1.0)
    with pytest.raises(ValueError) as want:
        JT.out_degree_weights(b, 1.0)
    assert str(got.value) == str(want.value)
    for kw in ({"self_weight": 0.0}, {"forward_weight": 0.6}):
        with pytest.raises(ValueError) as got:
            T.directed_ring(4, **kw)
        with pytest.raises(ValueError) as want:
            JT.directed_ring(4, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(RuntimeError, match="strongly connected"):
        T.directed_erdos_renyi(6, 0.0)


def _bad_column_matrices():
    return {"square": np.ones((2, 3)) / 3,
            "negative": np.array([[1.2, 0.0], [-0.2, 1.0]]),
            "columns": np.array([[0.5, 0.5], [0.4, 0.5]]),
            "diagonal": np.array([[0.0, 0.5], [1.0, 0.5]]),
            "ok": np.array([[0.5, 0.2], [0.5, 0.8]])}


@pytest.mark.parametrize("case", list(_bad_column_matrices()))
def test_validate_column_stochastic_refuses_what_the_reference_refuses(case):
    w = _bad_column_matrices()[case]
    try:
        JT.validate_column_stochastic(w)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            T.validate_column_stochastic(w)
        assert str(got.value) == str(e)
        return
    T.validate_column_stochastic(w)
    assert case == "ok"


@pytest.mark.parametrize("kw", [dict(n=8, p=0.3, horizon=12, seed=0),
                                dict(n=20, p=0.3, horizon=40, seed=0),
                                dict(n=6, p=0.15, horizon=9, seed=2,
                                     ensure_connected=False)])
def test_directed_schedule_equals_reference(kw):
    n = kw.pop("n")
    got = T.DirectedErdosRenyiSchedule(n, **kw)
    want = JT.DirectedErdosRenyiSchedule(n, **kw)
    assert got.name == want.name and got.period == want.period
    np.testing.assert_array_equal(got.stack, want.stack)
    assert [m.name for m in got.matrices] == [m.name for m in want.matrices]
    assert got.is_directed and want.is_directed
    assert (got.n_edges, got.n_messages, got.beta) == (
        want.n_edges, want.n_messages, want.beta)
    np.testing.assert_array_equal(got.messages_per_step(30),
                                  want.messages_per_step(30))
    np.testing.assert_array_equal(T.push_sum_weights(got, horizon=50),
                                  JT.push_sum_weights(want, horizon=50))
    np.testing.assert_array_equal(T.push_sum_weights(got),
                                  JT.push_sum_weights(want))
    same = T.schedule_by_name("directed_erdos_renyi", n=n, **kw)
    np.testing.assert_array_equal(same.stack, got.stack)


def test_push_sum_weights_of_matrix_lists():
    mats = [T.directed_erdos_renyi(6, 0.5, seed=s) for s in range(3)]
    jmats = [JT.directed_erdos_renyi(6, 0.5, seed=s) for s in range(3)]
    for horizon in (None, 7):
        got = T.push_sum_weights(mats, horizon)
        np.testing.assert_array_equal(got, JT.push_sum_weights(jmats,
                                                               horizon))
        np.testing.assert_allclose(got.sum(axis=1), 6.0, rtol=1e-12)
        assert got.min() > 0.0
    ring = T.push_sum_weights([T.directed_ring(6)], horizon=200)
    np.testing.assert_allclose(ring, 1.0, atol=1e-12)


# ---------------------------------------------------------------------------
# push-sum in the reference algorithms
# ---------------------------------------------------------------------------

COMPRESSORS = {
    "rr1": (JC.RandomizedRounding(1.0), C.RandomizedRounding(1.0)),
    "int8-fixed": (JC.Int8BlockQuantizer(512, "fixed", 1e-3),
                   C.Int8BlockQuantizer(512, "fixed", 1e-3)),
}


def _algs(name, jmix, tmix, comp):
    jc, tc = COMPRESSORS[comp] if comp else (None, None)
    js, ts = JK.StepSize(0.02, 0.5), K.StepSize(0.02, 0.5)
    if name == "adc_dgd":
        return JK.ADCDGD(jmix, jc, js), K.ADCDGD(tmix, tc, ts)
    if name.startswith("cedas"):
        st = int(name[-1])
        return (JK.CEDAS(jmix, jc, js, staleness=st),
                K.CEDAS(tmix, tc, ts, staleness=st))
    if name == "choco":
        return JK.CHOCOGossip(jmix, jc, js), K.CHOCOGossip(tmix, tc, ts)
    if name == "dgd":
        return JK.DGD(jmix, js), K.DGD(tmix, ts)
    if name == "dgd_t":
        return JK.DGDt(jmix, js, t=3), K.DGDt(tmix, ts, t=3)
    return JK.CompressedDGD(jmix, jc, js), K.CompressedDGD(tmix, tc, ts)


def _mixing(label):
    if label == "der12":
        return (JT.directed_erdos_renyi(12, 0.3, seed=1),
                T.directed_erdos_renyi(12, 0.3, seed=1))
    return (JT.DirectedErdosRenyiSchedule(8, 0.3, horizon=12, seed=0),
            T.DirectedErdosRenyiSchedule(8, 0.3, horizon=12, seed=0))


def _uniforms(talg, tprob, key):
    """The reference's uniforms for one step key, as the port takes them."""
    shape = talg.uniform_shape(tprob)
    if shape is None:
        return None
    node_keys = jax.random.split(key, tprob.n_nodes)
    return torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.uniform(k, shape[1:]))(node_keys)))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = np.spacing(np.float32(max(np.max(np.abs(b)), 1e-30)))
    return float(np.max(np.abs(a - b)) / scale)


#: (algorithm, compressor, mixing)
PARITY = [("adc_dgd", "int8-fixed", "der12"),
          ("adc_dgd", "rr1", "dsched8"),
          ("choco", "int8-fixed", "der12"),
          ("choco", "rr1", "dsched8"),
          ("cedas1", "int8-fixed", "der12"),
          ("cedas1", "rr1", "dsched8"),
          ("cedas0", "int8-fixed", "der12"),
          ("dgd", None, "der12"),
          ("dgd_t", None, "dsched8"),
          ("compressed_dgd", "rr1", "der12")]


@pytest.mark.parametrize("alg,comp,mix", PARITY,
                         ids=["-".join(map(str, p)) for p in PARITY])
def test_push_sum_step_parity_with_jitted_reference(alg, comp, mix):
    jmix, tmix = _mixing(mix)
    n = tmix.n
    jprob = JP.paper_circle_problem(n, dim=64)
    tprob = P.paper_circle_problem(n, dim=64, device="cpu")
    jalg, talg = _algs(alg, jmix, tmix, comp)
    sched = isinstance(tmix, T.TopologySchedule)
    stack = np.asarray(jmix.stack, np.float32) if sched else None
    jstep = jax.jit(lambda st, key, w: jalg.step(st, jprob, key, w=w))
    jst = jalg.init(jprob)
    tst0 = talg.init(tprob)
    assert sorted(tst0) == sorted(jst)
    assert ("ps_w" in jst) == (alg in ("adc_dgd", "choco", "cedas1",
                                       "cedas0"))
    keys = jax.random.split(jax.random.PRNGKey(11), STEPS)
    exact = {"x_tilde", "d_fly", "x_hat"}
    for i in range(STEPS):
        w = stack[i % len(stack)] if sched else None
        tst = {k: (int(v) if k == "k" else torch.from_numpy(np.array(v)))
               for k, v in jst.items()}
        tnew, tm = talg.step(tst, tprob, _uniforms(talg, tprob, keys[i]),
                             w=None if w is None else torch.from_numpy(w))
        jst, jm = jstep(jst, keys[i], w)
        assert np.float32(tm["alpha"]) == np.asarray(jm["alpha"]), i
        assert float(tm["max_transmitted"]) == float(
            jm["max_transmitted"]), i
        assert sorted(tnew) == sorted(jst)
        for name in set(tnew) - {"k"}:
            got, want = tnew[name].numpy(), np.asarray(jst[name])
            if name in exact:
                np.testing.assert_array_equal(got, want, f"{name} step {i}")
            else:
                assert _ulps(got, want) <= STATE_ULPS, (name, i)


@pytest.mark.parametrize("alg", ["adc_dgd", "choco", "cedas1", "dgd"])
def test_run_with_push_sum_matches_reference_run(alg):
    """``run`` on the directed ER draw (12 nodes), 60 steps from the same
    key: bytes exact (one message per directed edge), metrics of the
    de-biased iterate, ``x_final`` and ``ps_w_final`` within RUN_RTOL."""
    jmix, tmix = _mixing("der12")
    jprob = JP.paper_circle_problem(12, dim=64)
    tprob = P.paper_circle_problem(12, dim=64, device="cpu")
    jalg, talg = _algs(alg, jmix, tmix, "int8-fixed" if alg != "dgd"
                       else None)
    n = 60
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    want = JK.run(jalg, jprob, n, key=3)
    got = K.run(talg, tprob, n, key=3,
                uniforms=lambda i: _uniforms(talg, tprob, keys[i]))
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["bytes"], want["bytes"])
    assert got["bytes"][0] == tmix.n_messages * (
        talg.compressor.wire_bytes(64) if alg != "dgd" else 8.0 * 64)
    for name in ("obj", "grad_norm", "consensus", "max_tx", "x_final") + (
            ("ps_w_final",) if alg != "dgd" else ()):
        np.testing.assert_allclose(got[name], want[name], rtol=RUN_RTOL,
                                   atol=1e-6, err_msg=name)


def test_push_sum_claims_on_the_port():
    """The reference's claims (``tests/test_consensus_paper.py``): ADC-DGD
    and CEDAS with push-sum converge on directed graphs, the weights stay
    positive and mass-conserving, exactly uniform on doubly stochastic
    circulants; the ratio de-biases gossip whose raw average is biased."""
    prob = P.paper_4node(device="cpu")
    comp = C.RandomizedRounding(1.0)
    steps = 3000
    ref = K.run(K.ADCDGD(T.paper_fig3(), comp, K.StepSize(0.01)), prob,
                steps, key=0)
    x_ref = ref["x_final"].mean(axis=0)
    for mix in (T.directed_ring(4), T.directed_cycle(4),
                T.directed_erdos_renyi(4, 0.6, seed=3)):
        r = K.run(K.ADCDGD(mix, comp, K.StepSize(0.01)), prob, steps,
                  key=0)
        ps = r["ps_w_final"]
        assert ps.min() > 0.0 and ps.sum() == pytest.approx(4.0, rel=1e-5)
        assert r["grad_norm"][-200:].mean() < 0.15, mix.name
        assert r["consensus"][-1] < 0.1, mix.name
        assert np.abs(r["x_final"].mean(axis=0) - x_ref).max() < 0.06
        if np.allclose(mix.w.sum(axis=1), 1.0):
            np.testing.assert_allclose(ps, 1.0, atol=1e-5)
    r = K.run(K.CEDAS(T.directed_ring(4), comp, K.StepSize(0.01)), prob,
              steps, key=0)
    assert r["ps_w_final"].sum() == pytest.approx(4.0, rel=1e-5)
    assert r["grad_norm"][-200:].mean() < 0.5
    mix = T.directed_erdos_renyi(6, 0.5, seed=1)
    assert not np.allclose(mix.w.sum(axis=1), 1.0)
    x = np.random.default_rng(0).normal(size=6)
    mean, w = x.mean(), np.ones(6)
    for _ in range(400):
        x, w = mix.w @ x, mix.w @ w
    assert np.abs(x - mean).max() > 1e-2
    np.testing.assert_allclose(x / w, mean, atol=1e-12)


# ---------------------------------------------------------------------------
# the runtime's directed ring against the reference's
# ---------------------------------------------------------------------------

PLAN_A = "mixed:norm=int4,embed=int4,*=int8"
DIR = dict(topology="directed-ring")
LOSS = dict(link_loss=0.2, loss_seed=1)
CASES = [("directed/packed", dict(DIR)),
         ("directed/packed/loss", dict(DIR, **LOSS)),
         ("directed/pipelined3/loss", dict(DIR, wire_packing="pipelined",
                                           pipeline_chunks=3, **LOSS)),
         ("directed/async1/loss", dict(DIR, wire_packing="async", **LOSS)),
         ("directed/per_leaf/loss", dict(DIR, wire_packing="per_leaf",
                                         **LOSS)),
         ("directed/planA/fw0.1", dict(DIR, wire_codec=PLAN_A,
                                       forward_weight=0.1)),
         ("directed/strides1,3/loss", dict(DIR, ring_strides=(1, 3),
                                           schedule_period=2,
                                           resync_retries=1, **LOSS)),
         ("ring/push_sum", dict(push_sum=True, link_loss=0.0))]
LABELS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def reference():
    return reference_results(N_RT, CASES)


@pytest.mark.parametrize("label", LABELS)
def test_reference_directed_exchange(reference, label):
    check_reference_case(reference[label])


def test_reference_directed_accounting(reference):
    """The push-sum trailer adds 4 bytes per direction; the resync of the
    re-wired ring adds the two scalar weight transfers (amortized); some
    of its handshakes fail."""
    plain = ConsensusRuntime(ConsensusConfig(), N_RT)
    from test_torch_faults import _x0
    layout = plain.state_layout(_x0(N_RT))
    payload = plain.wire_plan_for(layout).payload_bytes
    assert reference["directed/packed"]["wire"][0] == 2.0 * (payload + 4)
    assert reference["ring/push_sum"]["wire"][0] == 2.0 * (payload + 4)
    assert reference["directed/strides1,3/loss"]["collectives"][0] == \
        2.0 + (2.0 + 2.0) / 2
    assert reference["directed/per_leaf/loss"]["collectives"][0] == \
        4.0 * layout.n_leaves + 2.0
    ok = np.array(reference["directed/strides1,3/loss"]["resync_ok"])
    assert ok.any() and not ok.all()


def test_directed_transports_equal_bitwise_on_the_port():
    """Directed ring under loss on the port alone: packed == pipelined
    (3 units) == async at staleness 0 == per-leaf bit for bit, and the
    push-sum weight stays exactly 1 on every node."""
    from test_torch_faults import run_port, same_run
    kw = dict(DIR, **LOSS)
    base = run_port(3, n=N_RT, **kw)
    keys = ("x_tilde", "m_agg", "ps_w", "ps_nbr")
    for extra in ({"wire_packing": "pipelined", "pipeline_chunks": 3},
                  {"wire_packing": "async", "staleness": 0},
                  {"wire_packing": "per_leaf"}):
        assert same_run(base, run_port(3, n=N_RT, **kw, **extra), keys), \
            extra
    assert torch.equal(base[1]["ps_w"], torch.ones(N_RT, 1))
    assert all(h["push_sum_weight"] == [1.0] * N_RT for h in base[2])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_trainer_directed_ring(capsys):
    hist = train.main(["--reduced", "--device", "cpu", "--nodes", "4",
                       "--batch", "8", "--seq", "32", "--steps", "3",
                       "--topology", "directed-ring", "--link-loss", "0.2"])
    assert all(math.isfinite(h["loss"]) for h in hist)
    assert [h["push_sum_weight"] for h in hist] == [1.0] * 3
    out = capsys.readouterr().out
    assert "push_sum_weight=1" in out and "delivered_frac=" in out
    hist = train.main(["--reduced", "--device", "cpu", "--nodes", "4",
                       "--batch", "8", "--seq", "32", "--steps", "2",
                       "--topology", "directed-ring", "--forward-weight",
                       "0.1", "--wire-packing", "per_leaf"])
    assert all(math.isfinite(h["loss"]) for h in hist)
    for argv in (["--topology", "star"], ["--forward-weight", "0.1"],
                 ["--topology", "directed-ring", "--forward-weight", "0.7"],
                 ["--topology", "directed-ring", "--algorithm", "dgd"]):
        with pytest.raises((SystemExit, ValueError)):
            train.main(["--reduced", "--device", "cpu", "--nodes", "4",
                        "--batch", "8", "--steps", "1", *argv])
