"""Time-varying topology schedules in the paper's reference algorithms
(``repro_torch.core.topology`` schedules, ``consensus.run``'s ``W^(k)``),
held to the JAX package.

  * ``PeriodicSchedule``, ``ErdosRenyiSchedule`` and
    ``RandomGeometricSchedule`` stacks equal the reference's exactly for
    the same seed (the numpy draws, connectivity rejections included, and
    with ``ensure_connected=False``); so do the names, ``indices_for``,
    ``edges_per_step``, ``messages_per_step``, ``beta`` and
    ``schedule_by_name``'s schedules.
  * Step parity under a schedule: each algorithm is stepped beside the
    reference's jitted ``step`` with the same ``W^(k)`` (the schedule's
    float32 stack row ``run`` gathers) and the reference's uniforms, each
    step started from the reference's state; the exact shadows (ADC-DGD's
    and CEDAS's ``x_tilde``, CHOCO's ``x_hat``) and the transmitted
    maximum bitwise, ``x`` within STATE_ULPS (ROADMAP Queue 3, hazard 8).
  * ``run`` under a schedule: cumulative bytes exactly the reference's
    (each step billed for its matrix's messages), the metrics within
    RUN_RTOL, the stack copied to the device once.
  * The reference's behaviours (``tests/test_schedule.py``) on the port:
    identity ADC-DGD is DGD under a schedule (bit for bit here), and
    ADC-DGD converges under periodic and i.i.d. random schedules.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
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

STEPS = 12
STATE_ULPS = 4
RUN_RTOL = 1e-3

#: (label, builder) with a builder taking a topology module, so that both
#: packages build the same schedule
SCHEDULES = [
    ("periodic", lambda t: t.PeriodicSchedule([t.ring(8), t.torus(2, 4)],
                                              dwell=3)),
    ("er", lambda t: t.ErdosRenyiSchedule(8, p=0.4, horizon=12, seed=0)),
    ("rgg", lambda t: t.RandomGeometricSchedule(8, radius=0.6, horizon=12,
                                                seed=1)),
    ("er-disconnected", lambda t: t.ErdosRenyiSchedule(
        12, p=0.08, horizon=24, seed=3, ensure_connected=False)),
    ("rgg-disconnected", lambda t: t.RandomGeometricSchedule(
        10, radius=0.3, horizon=16, seed=2, ensure_connected=False)),
    # the card's paper-path schedules (chip_smoke.py phase_paper)
    ("periodic20", lambda t: t.PeriodicSchedule([t.ring(20), t.torus(4, 5)],
                                                dwell=5)),
    ("er20", lambda t: t.ErdosRenyiSchedule(20, p=0.35, horizon=500,
                                            seed=11)),
]


def _same_schedule(a, b, n_steps=29):
    assert a.name == b.name and a.period == b.period and a.n == b.n
    np.testing.assert_array_equal(a.stack, b.stack)
    assert [m.name for m in a.matrices] == [m.name for m in b.matrices]
    assert a.n_edges == b.n_edges and a.n_messages == b.n_messages
    assert a.beta == b.beta and a.is_directed == b.is_directed is False
    for fn in ("indices_for", "edges_per_step", "messages_per_step"):
        np.testing.assert_array_equal(getattr(a, fn)(n_steps),
                                      getattr(b, fn)(n_steps))


@pytest.mark.parametrize("build", [s[1] for s in SCHEDULES],
                         ids=[s[0] for s in SCHEDULES])
def test_schedule_equals_reference(build):
    got, want = build(T), build(JT)
    _same_schedule(got, want)
    got.validate()
    for i in (0, 1, got.period, 2 * got.period + 1):
        np.testing.assert_array_equal(got.matrix_at(i).w,
                                      want.matrix_at(i).w)


def test_disconnected_samples_kept_when_not_enforced():
    sched = T.ErdosRenyiSchedule(12, p=0.08, horizon=24, seed=3,
                                 ensure_connected=False)
    assert not all(T.is_connected(m.w != 0) for m in sched.matrices)
    assert max(m.beta for m in sched.matrices) >= 1.0 - 1e-9
    with pytest.raises(RuntimeError, match="connected"):
        T.ErdosRenyiSchedule(12, p=0.0, horizon=1)
    with pytest.raises(ValueError, match="dwell"):
        T.PeriodicSchedule([T.ring(4)], dwell=0)


def test_schedule_by_name_and_as_schedule():
    for name, kw in (("static:ring", dict(n=6)), ("ring_torus", dict(n=8)),
                     ("ring_torus", dict(n=8, dwell=2)),
                     ("erdos_renyi", dict(n=6, p=0.5, horizon=4)),
                     ("rgg", dict(n=6, radius=0.7, horizon=3, seed=4))):
        _same_schedule(T.schedule_by_name(name, **kw),
                       JT.schedule_by_name(name, **kw))
    got = T.schedule_by_name("directed_erdos_renyi", n=4, p=0.5)
    want = JT.schedule_by_name("directed_erdos_renyi", n=4, p=0.5)
    np.testing.assert_array_equal(got.stack, want.stack)
    assert got.name == want.name and got.is_directed and want.is_directed
    with pytest.raises(KeyError):
        T.schedule_by_name("nope", n=4)
    with pytest.raises(ValueError, match="even"):
        T.schedule_by_name("ring_torus", n=7)
    s = T.as_schedule(T.ring(5))
    assert isinstance(s, T.StaticSchedule) and s.period == 1
    assert T.as_schedule(s) is s
    with pytest.raises(TypeError):
        T.as_schedule("ring")


# ---------------------------------------------------------------------------
# step parity with the jitted reference under a schedule
# ---------------------------------------------------------------------------

COMPRESSORS = {
    "rr1": (JC.RandomizedRounding(1.0), C.RandomizedRounding(1.0)),
    "int8-fixed": (JC.Int8BlockQuantizer(512, "fixed", 1e-3),
                   C.Int8BlockQuantizer(512, "fixed", 1e-3)),
}


def _algs(name, jmix, tmix, comp):
    jc, tc = COMPRESSORS[comp] if comp else (None, None)
    js, ts = JK.StepSize(0.02, 0.0), K.StepSize(0.02, 0.0)
    if name == "adc_dgd":
        return JK.ADCDGD(jmix, jc, js), K.ADCDGD(tmix, tc, ts)
    if name.startswith("cedas"):
        st = int(name[-1])
        return (JK.CEDAS(jmix, jc, js, staleness=st),
                K.CEDAS(tmix, tc, ts, staleness=st))
    if name == "dgd":
        return JK.DGD(jmix, js), K.DGD(tmix, ts)
    if name == "dgd_t":
        return JK.DGDt(jmix, js, t=3), K.DGDt(tmix, ts, t=3)
    if name == "compressed_dgd":
        return JK.CompressedDGD(jmix, jc, js), K.CompressedDGD(tmix, tc, ts)
    return JK.CHOCOGossip(jmix, jc, js), K.CHOCOGossip(tmix, tc, ts)


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


#: (algorithm, compressor, schedule label)
PARITY = [
    ("adc_dgd", "rr1", "er"),
    ("adc_dgd", "int8-fixed", "periodic"),
    ("dgd", None, "er"),
    ("dgd_t", None, "periodic"),
    ("compressed_dgd", "rr1", "er"),
    ("choco", "rr1", "periodic"),
    ("cedas1", "int8-fixed", "er"),
    ("cedas0", "rr1", "periodic"),
]


@pytest.mark.parametrize("alg,comp,sched", PARITY,
                         ids=["-".join(map(str, p)) for p in PARITY])
def test_step_parity_under_a_schedule(alg, comp, sched):
    build = dict(SCHEDULES)[sched]
    jmix, tmix = build(JT), build(T)
    jprob = JP.paper_circle_problem(8, dim=64)
    tprob = P.paper_circle_problem(8, dim=64, device="cpu")
    jalg, talg = _algs(alg, jmix, tmix, comp)
    stack = np.asarray(jmix.stack, np.float32)
    idx = tmix.indices_for(STEPS)
    jstep = jax.jit(lambda st, key, w: jalg.step(st, jprob, key, w=w))
    jst = jalg.init(jprob)
    keys = jax.random.split(jax.random.PRNGKey(11), STEPS)
    exact = ({"x_tilde", "d_fly", "x_hat"} if comp else set())
    for i in range(STEPS):
        w = stack[idx[i]]
        tst = {k: (int(v) if k == "k" else torch.from_numpy(np.array(v)))
               for k, v in jst.items()}
        tnew, tm = talg.step(tst, tprob, _uniforms(talg, tprob, keys[i]),
                             w=torch.from_numpy(w))
        jst, jm = jstep(jst, keys[i], w)
        assert np.float32(tm["alpha"]) == np.asarray(jm["alpha"]), i
        assert float(tm["max_transmitted"]) == float(
            jm["max_transmitted"]), i
        for name in set(tnew) - {"k"}:
            got, want = tnew[name].numpy(), np.asarray(jst[name])
            if name in exact:
                np.testing.assert_array_equal(got, want, f"{name} step {i}")
            else:
                assert _ulps(got, want) <= STATE_ULPS, (name, i)


def test_default_w_of_a_schedule_is_its_first_matrix():
    sched = dict(SCHEDULES)["periodic"](T)
    prob = P.paper_circle_problem(8, dim=4, device="cpu")
    a, b = K.DGD(sched, K.StepSize(0.02)), K.DGD(sched.matrix_at(0),
                                                 K.StepSize(0.02))
    st = a.init(prob)
    assert torch.equal(a.step(st, prob)[0]["x"], b.step(st, prob)[0]["x"])


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

def test_run_bytes_follow_the_per_step_messages():
    """Ring (8 edges) and full graph (28 edges) alternating: each step is
    billed for its own matrix, as the reference bills it."""
    n = 8
    sched = T.PeriodicSchedule([T.ring(n), T.fully_connected(n)])
    jsched = JT.PeriodicSchedule([JT.ring(n), JT.fully_connected(n)])
    prob = P.decentralized_linear_regression(n_nodes=n, dim=4, seed=0,
                                             device="cpu")
    jprob = JP.decentralized_linear_regression(n_nodes=n, dim=4, seed=0)
    r = K.run(K.DGD(sched, K.StepSize(0.01)), prob, 4)
    want = JK.run(JK.DGD(jsched, JK.StepSize(0.01)), jprob, 4)
    np.testing.assert_array_equal(r["bytes"], want["bytes"])
    per_elem = 8.0 * prob.dim
    np.testing.assert_array_equal(
        r["bytes"], np.cumsum([2 * 8 * per_elem, 2 * 28 * per_elem] * 2))
    for name in ("obj", "grad_norm", "consensus", "x_final"):
        np.testing.assert_allclose(r[name], want[name], rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_run_under_random_schedule_matches_reference_run():
    """ADC-DGD int8 over the Erdős-Rényi schedule, 60 steps from the same
    key: bytes exact, metrics within RUN_RTOL, the schedule's stack copied
    to the device once and every step's W a row of it."""
    jmix, tmix = dict(SCHEDULES)["er"](JT), dict(SCHEDULES)["er"](T)
    jprob = JP.paper_circle_problem(8, dim=64)
    tprob = P.paper_circle_problem(8, dim=64, device="cpu")
    jalg, talg = _algs("adc_dgd", jmix, tmix, "int8-fixed")
    n = 60
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    want = JK.run(jalg, jprob, n, key=3)
    seen = []
    step = talg.step

    def spy(state, problem, u=None, w=None):
        seen.append(w)
        return step(state, problem, u, w)

    object.__setattr__(talg, "step", spy)
    got = K.run(talg, tprob, n, key=3,
                uniforms=lambda i: _uniforms(talg, tprob, keys[i]))
    assert len({w.untyped_storage().data_ptr() for w in seen}) == 1
    stack = torch.as_tensor(tmix.stack, dtype=torch.float32)
    assert all(torch.equal(w, stack[i % tmix.period])
               for i, w in enumerate(seen))
    np.testing.assert_array_equal(got["bytes"], want["bytes"])
    for name in ("obj", "grad_norm", "consensus", "max_tx", "x_final"):
        np.testing.assert_allclose(got[name], want[name], rtol=RUN_RTOL,
                                   atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# the reference's behaviours on the port (tests/test_schedule.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", ["periodic", "er"])
def test_adc_identity_compressor_equals_dgd_under_schedule(label):
    sched = dict(SCHEDULES)[label](T)
    prob = P.decentralized_linear_regression(n_nodes=8, dim=16, seed=0,
                                             device="cpu")
    ss = K.StepSize(0.05, 0.0)
    a = K.run(K.ADCDGD(sched, C.IdentityCompressor(), ss), prob, 400)
    d = K.run(K.DGD(sched, ss), prob, 400)
    np.testing.assert_array_equal(a["x_final"], d["x_final"])


def test_adc_converges_under_time_varying_topology():
    n, steps = 10, 3000
    prob = P.paper_circle_problem(n, seed=0, device="cpu")
    comp = C.RandomizedRounding(delta=1.0)
    ss = K.StepSize(0.02, 0.5)
    for sched in (T.PeriodicSchedule([T.ring(n), T.torus(2, n // 2)],
                                     dwell=5),
                  T.ErdosRenyiSchedule(n, p=0.35, horizon=steps, seed=7)):
        r = K.run(K.ADCDGD(sched, comp, ss, gamma=1.0), prob, steps, key=9)
        assert r["grad_norm"][-100:].mean() < 0.05, sched.name
        assert r["consensus"][-100:].mean() < 0.05, sched.name
