"""The paper's reference algorithms on the port, held to the JAX package.

Step parity.  Each algorithm is stepped beside the reference's ``step``
under ``jit`` (as ``run``'s ``scan`` compiles it) for STEPS steps, each
step started from the reference's own state, on ``paper_4node`` (the
paper's Fig. 3 matrix) and ``paper_circle_problem(5, dim=64)`` (a ring).
The port's uniforms are the reference's draws: ``jax.random.uniform`` of
the per-node keys ``jax.random.split(key_k, N)`` that ``_per_node_keys``
makes from step k's key of ``jax.random.split(key, n_steps)``.  Contract:
  * the shadows that integrate the transmitted codes (ADC-DGD's and
    CEDAS's ``x_tilde`` and in-flight ``d_fly``, CHOCO's ``x_hat``) and the
    largest transmitted magnitude are bitwise equal: the codes are exact;
  * the step size is bitwise equal (gamma 0.6 and eta 0.75 included: the
    compiled ``k**gamma`` and ``alpha0 * pow(k, -eta)``);
  * ``x`` within STATE_ULPS ulps of its largest magnitude: XLA contracts
    ``W x - alpha g`` into fused multiply-adds and sums the small matmul
    in another order.
With the identity compressor the port's ADC-DGD integrates ``x`` itself
(the reference's round trip ``k y / k`` rounds), so there ``x_tilde`` is
held to STATE_ULPS too.

Whole runs: ``run`` beside the reference's ``run`` from the same key, for
an int8 run (free running, so a last-bit difference may move a stochastic
rounding: metrics within RUN_RTOL) and an identity run.

The paper's claims on the port alone mirror ``tests/test_consensus_paper.py``
(Fig. 1, Thm 1-3, the gamma phase transition, Fig. 6 bytes, network sizes
3-20, high-dimensional regression, CEDAS), drawing the port's own uniforms;
there, identity ADC-DGD equals DGD and CEDAS at staleness 0 equals ADC-DGD
bit for bit.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
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
from repro_torch.core import theory
from repro_torch.core import topology as T

STEPS = 20
STATE_ULPS = 4
RUN_RTOL = 1e-3


def _problems(name):
    if name == "4node":
        return JP.paper_4node(), P.paper_4node(device="cpu"), \
            JT.paper_fig3(), T.paper_fig3()
    return (JP.paper_circle_problem(5, dim=64),
            P.paper_circle_problem(5, dim=64, device="cpu"),
            JT.ring(5), T.ring(5))


COMPRESSORS = {
    "rr1": (JC.RandomizedRounding(1.0), C.RandomizedRounding(1.0)),
    "int8-fixed": (JC.Int8BlockQuantizer(512, "fixed", 1e-3),
                   C.Int8BlockQuantizer(512, "fixed", 1e-3)),
    "int8-adaptive": (JC.Int8BlockQuantizer(512, "adaptive"),
                      C.Int8BlockQuantizer(512, "adaptive")),
    "identity": (JC.IdentityCompressor(), C.IdentityCompressor()),
}


def _algs(name, jmix, tmix, comp, gamma, eta):
    jc, tc = COMPRESSORS[comp] if comp else (None, None)
    js, ts = JK.StepSize(0.02, eta), K.StepSize(0.02, eta)
    if name == "adc_dgd":
        return (JK.ADCDGD(jmix, jc, js, gamma=gamma),
                K.ADCDGD(tmix, tc, ts, gamma=gamma))
    if name.startswith("cedas"):
        st = int(name[-1])
        return (JK.CEDAS(jmix, jc, js, gamma=gamma, staleness=st),
                K.CEDAS(tmix, tc, ts, gamma=gamma, staleness=st))
    if name == "dgd":
        return JK.DGD(jmix, js), K.DGD(tmix, ts)
    if name == "dgd_t":
        return JK.DGDt(jmix, js, t=3), K.DGDt(tmix, ts, t=3)
    if name == "compressed_dgd":
        return JK.CompressedDGD(jmix, jc, js), K.CompressedDGD(tmix, tc, ts)
    if name == "choco":
        return JK.CHOCOGossip(jmix, jc, js), K.CHOCOGossip(tmix, tc, ts)
    return JK.CentralizedGD(js), K.CentralizedGD(ts)


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


#: (algorithm, problem, compressor, gamma, eta)
PARITY = [
    ("adc_dgd", "4node", "rr1", 1.0, 0.0),
    ("adc_dgd", "4node", "rr1", 0.6, 0.75),
    ("adc_dgd", "circle5", "int8-fixed", 1.0, 0.0),
    ("adc_dgd", "circle5", "int8-adaptive", 0.6, 0.0),
    ("adc_dgd", "circle5", "identity", 1.0, 0.0),
    ("dgd", "4node", None, 1.0, 0.75),
    ("dgd", "circle5", None, 1.0, 0.0),
    ("dgd_t", "circle5", None, 1.0, 0.0),
    ("compressed_dgd", "4node", "rr1", 1.0, 0.0),
    ("compressed_dgd", "circle5", "int8-adaptive", 1.0, 0.0),
    ("choco", "4node", "rr1", 1.0, 0.0),
    ("choco", "circle5", "int8-fixed", 1.0, 0.75),
    ("cedas0", "circle5", "int8-fixed", 0.6, 0.0),
    ("cedas1", "4node", "rr1", 1.0, 0.0),
    ("cedas1", "circle5", "int8-fixed", 0.6, 0.0),
    ("centralized", "circle5", None, 1.0, 0.0),
]


@pytest.mark.parametrize("alg,prob,comp,gamma,eta", PARITY,
                         ids=["-".join(map(str, p)) for p in PARITY])
def test_step_parity_with_jitted_reference(alg, prob, comp, gamma, eta):
    jprob, tprob, jmix, tmix = _problems(prob)
    jalg, talg = _algs(alg, jmix, tmix, comp, gamma, eta)
    jstep = jax.jit(lambda st, key: jalg.step(st, jprob, key))
    jst = jalg.init(jprob)
    keys = jax.random.split(jax.random.PRNGKey(11), STEPS)
    exact = {"x_tilde", "d_fly", "x_hat"} if comp != "identity" else set()
    for i in range(STEPS):
        tst = {k: (int(v) if k == "k" else torch.from_numpy(np.array(v)))
               for k, v in jst.items()}
        tnew, tm = talg.step(tst, tprob, _uniforms(talg, tprob, keys[i]))
        jst, jm = jstep(jst, keys[i])
        assert tnew["k"] == int(jst["k"])
        assert np.float32(tm["alpha"]) == np.asarray(jm["alpha"]), i
        assert float(tm["max_transmitted"]) == float(
            jm["max_transmitted"]), i
        for name in set(tnew) - {"k"}:
            got, want = tnew[name].numpy(), np.asarray(jst[name])
            if name in exact:
                np.testing.assert_array_equal(got, want, f"{name} step {i}")
            else:
                assert _ulps(got, want) <= STATE_ULPS, (name, i)


def test_noninteger_gamma_moves_the_uncompiled_step():
    """gamma 0.6 and eta 0.75 exercise the fault the step parity holds:
    the uncompiled float32 ``alpha0 / k**eta`` differs from the compiled
    ``alpha0 * pow(k, -eta)`` at some of these steps, and the port's
    ``StepSize`` equals the compiled one at all of them."""
    ks = np.arange(1, 2001, dtype=np.float32)
    jit_alpha = np.asarray(jax.jit(jax.vmap(JK.StepSize(0.02, 0.75)))(ks))
    plain = np.float32(0.02) / ks ** np.float32(0.75)
    assert (plain != jit_alpha).any()
    np.testing.assert_array_equal(
        np.array([K.StepSize(0.02, 0.75)(k) for k in ks], np.float32),
        jit_alpha)


def _reference_uniforms(talg, tprob, key, n_steps):
    keys = jax.random.split(jax.random.PRNGKey(key), n_steps)
    return lambda i: _uniforms(talg, tprob, keys[i])


@pytest.mark.parametrize("comp", ["int8-fixed", "identity"])
def test_run_matches_reference_run(comp):
    jprob, tprob, jmix, tmix = _problems("circle5")
    jalg, talg = _algs("adc_dgd", jmix, tmix, comp, 1.0, 0.5)
    n = 200
    want = JK.run(jalg, jprob, n, key=3)
    got = K.run(talg, tprob, n, key=3,
                uniforms=_reference_uniforms(talg, tprob, 3, n))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["bytes"], want["bytes"])
    for name in ("obj", "grad_norm", "consensus", "max_tx", "x_final"):
        np.testing.assert_allclose(got[name], want[name], rtol=RUN_RTOL,
                                   atol=1e-6, err_msg=name)
    # alpha: eta 0.5 compiles to alpha0 * rsqrt(k), and XLA's CPU rsqrt
    # approximates; the port's reciprocal square root is correctly rounded
    ks = np.arange(1, n + 1, dtype=np.float32)
    approx = np.asarray(jax.jit(jax.lax.rsqrt)(ks))
    exact = (1.0 / np.sqrt(ks.astype(np.float64))).astype(np.float32)
    np.testing.assert_array_equal(want["alpha"], np.float32(0.02) * approx)
    np.testing.assert_array_equal(got["alpha"], np.float32(0.02) * exact)


# ---------------------------------------------------------------------------
# the paper's claims on the port alone (mirrors test_consensus_paper.py)
# ---------------------------------------------------------------------------

COMP = C.RandomizedRounding(delta=1.0)
ALPHA = 0.02
N_STEPS = 3000


@pytest.fixture(scope="module")
def four_node():
    return P.paper_4node(device="cpu"), T.paper_fig3()


def test_fig1_direct_compression_fails_adc_converges(four_node):
    prob, mix = four_node
    bad = K.run(K.CompressedDGD(mix, COMP, K.StepSize(ALPHA)), prob,
                N_STEPS, key=0)
    good = K.run(K.ADCDGD(mix, COMP, K.StepSize(ALPHA), gamma=1.0), prob,
                 N_STEPS, key=0)
    tail_bad, tail_good = bad["grad_norm"][-200:], good["grad_norm"][-200:]
    assert tail_bad.mean() > 20 * tail_good.mean()
    assert tail_bad.std() > 10 * tail_good.std()


def test_adc_with_identity_compressor_equals_dgd_bitwise(four_node):
    """sigma = 0: ADC-DGD reproduces DGD's trajectory bit for bit."""
    prob, mix = four_node
    a = K.run(K.ADCDGD(mix, C.IdentityCompressor(), K.StepSize(ALPHA)),
              prob, 500, key=0)
    d = K.run(K.DGD(mix, K.StepSize(ALPHA)), prob, 500, key=0)
    for name in ("x_final", "grad_norm", "consensus", "obj"):
        np.testing.assert_array_equal(a[name], d[name], name)


def test_thm2_constant_step_matches_dgd_error_ball(four_node):
    prob, mix = four_node
    adc = K.run(K.ADCDGD(mix, COMP, K.StepSize(ALPHA), gamma=1.0), prob,
                N_STEPS, key=1)
    dgd = K.run(K.DGD(mix, K.StepSize(ALPHA)), prob, N_STEPS, key=1)
    assert adc["grad_norm"][-100:].mean() < \
        3 * dgd["grad_norm"][-100:].mean() + 1e-3
    x_star_obj = float(prob.global_obj(torch.as_tensor(
        prob.x_star, dtype=torch.float32)))
    assert adc["obj"][-1] == pytest.approx(x_star_obj, abs=5e-2)


def test_thm3_diminishing_step_converges(four_node):
    prob, mix = four_node
    r = K.run(K.ADCDGD(mix, COMP, K.StepSize(ALPHA, eta=0.5), gamma=1.0),
              prob, 6000, key=2)
    assert r["grad_norm"][-50:].mean() < 5e-3
    g2 = r["grad_norm"].astype(np.float64) ** 2
    early, late = g2[200:600].mean(), g2[-1000:].mean()
    assert early / late > (5500 / 400) ** 0.4


def test_thm1_consensus_error_ball(four_node):
    prob, mix = four_node
    r = K.run(K.ADCDGD(mix, COMP, K.StepSize(ALPHA), gamma=1.0), prob,
              N_STEPS, key=3)
    tail = r["consensus"][-100:].mean()
    x_bar = torch.as_tensor(r["x_final"].mean(axis=0))
    grads = prob.grad_fn(x_bar.expand(prob.n_nodes, prob.dim))
    big_d = float(torch.linalg.vector_norm(grads, dim=1).max())
    assert tail < theory.error_ball_radius(ALPHA, big_d, mix.beta)


def test_gamma_phase_transition():
    """Fig. 7: larger gamma converges faster within (1/2, 1], no gain past
    1; Fig. 8: the transmitted magnitude grows with gamma.

    As the paper's figure, over a Monte-Carlo ensemble: TRIALS independent
    copies of the 4-node problem ride along as coordinates (the quadratic
    and the compressor act on each coordinate alone), so one run gives
    E||grad||^2 over the trials, read as its root over the last 100
    steps.  One trial alone is too noisy for the 0.8-vs-1.0 order: its
    tail mean spreads over 0.001-0.007 at gamma 0.8."""
    trials = 200
    prob = P.quadratic_problem(
        np.repeat([[-4.0], [2.0], [2.0], [5.0]], trials, 1),
        np.repeat([[0.0], [0.2], [-0.3], [0.1]], trials, 1), device="cpu")
    mix = T.paper_fig3()
    end, max_tx = {}, {}
    for gamma in (0.6, 0.8, 1.0, 1.2):
        r = K.run(K.ADCDGD(mix, COMP, K.StepSize(ALPHA), gamma=gamma), prob,
                  N_STEPS, key=4)
        end[gamma] = np.sqrt(np.mean(
            r["grad_norm"][-100:].astype(np.float64) ** 2) / trials)
        max_tx[gamma] = r["max_tx"].max()
    assert end[0.6] > end[0.8] > end[1.0] * 0.9
    assert end[1.2] > end[1.0] * 0.5
    assert max_tx[1.2] >= max_tx[0.8]
    assert theory.theoretical_rate_exponent(0.6, 0.0) == 0.6


def test_fig6_communication_efficiency(four_node):
    prob, mix = four_node
    adc = K.ADCDGD(mix, COMP, K.StepSize(ALPHA), gamma=1.0)
    dgd = K.DGD(mix, K.StepSize(ALPHA))
    assert dgd.bytes_per_iteration(prob) == 4 * adc.bytes_per_iteration(prob)
    dgdt = K.DGDt(mix, K.StepSize(ALPHA), t=3)
    assert dgdt.bytes_per_iteration(prob) == 3 * dgd.bytes_per_iteration(prob)
    jprob, jmix = JP.paper_4node(), JT.paper_fig3()
    for t_alg, j_alg in (
            (adc, JK.ADCDGD(jmix, JC.RandomizedRounding(1.0),
                            JK.StepSize(ALPHA))),
            (dgdt, JK.DGDt(jmix, JK.StepSize(ALPHA), t=3)),
            (K.ADCDGD(mix, C.Int8BlockQuantizer(), K.StepSize(ALPHA)),
             JK.ADCDGD(jmix, JC.Int8BlockQuantizer(), JK.StepSize(ALPHA)))):
        assert t_alg.bytes_per_iteration(prob) == \
            j_alg.bytes_per_iteration(jprob)


def test_dgdt_larger_error_ball_and_cached_matrix(four_node):
    prob, mix = four_node
    d1 = K.run(K.DGD(mix, K.StepSize(ALPHA)), prob, N_STEPS, key=5)
    d3 = K.run(K.DGDt(mix, K.StepSize(ALPHA), t=3), prob, N_STEPS, key=5)
    assert d3["grad_norm"][-100:].mean() > d1["grad_norm"][-100:].mean()
    alg = K.DGDt(mix, K.StepSize(ALPHA), t=3)
    np.testing.assert_array_equal(
        alg._w_eff, np.linalg.matrix_power(np.asarray(mix.w), 3))
    state = alg.init(prob)
    new, _ = alg.step(state, prob)
    w3 = torch.as_tensor(alg._w_eff, dtype=torch.float32)
    assert torch.equal(new["x"], w3 @ state["x"]
                       - ALPHA * prob.grad_fn(state["x"]))


@pytest.mark.parametrize("n", [3, 5, 10, 20])
def test_network_size_scaling(n):
    """Fig. 10: the circle system converges for n = 3, 5, 10, 20."""
    prob = P.paper_circle_problem(n, seed=0, device="cpu")
    r = K.run(K.ADCDGD(T.ring(n), COMP, K.StepSize(0.01, eta=0.5),
                       gamma=1.0), prob, 4000, key=6)
    assert r["grad_norm"][-50:].mean() < 0.05, n


def test_high_dimensional_consensus():
    prob = P.decentralized_linear_regression(n_nodes=8, dim=128, seed=0,
                                             device="cpu")
    r = K.run(K.ADCDGD(T.ring(8), C.RandomizedRounding(delta=0.01),
                       K.StepSize(1.0), gamma=1.0), prob, 3000, key=7)
    x_bar = r["x_final"].mean(axis=0)
    err = np.linalg.norm(x_bar - prob.x_star) / np.linalg.norm(prob.x_star)
    assert err < 0.05


def test_2node_motivating_example():
    prob = P.paper_2node(device="cpu")
    adc = K.run(K.ADCDGD(T.ring(2), COMP, K.StepSize(0.05, eta=0.5)), prob,
                4000, key=8)
    assert abs(adc["x_final"].mean() - prob.x_star[0]) < 0.05


def test_cedas_staleness0_equals_adcdgd_bitwise(four_node):
    prob, mix = four_node
    a = K.run(K.CEDAS(mix, COMP, K.StepSize(ALPHA), staleness=0), prob, 800,
              key=0)
    b = K.run(K.ADCDGD(mix, COMP, K.StepSize(ALPHA)), prob, 800, key=0)
    for name in ("x_final", "grad_norm", "consensus", "obj"):
        np.testing.assert_array_equal(a[name], b[name], name)


def test_cedas_one_step_stale_converges(four_node):
    prob, mix = four_node
    r = K.run(K.CEDAS(mix, COMP, K.StepSize(0.01), staleness=1), prob,
              N_STEPS, key=0)
    g = r["grad_norm"]
    assert np.isfinite(g).all()
    assert g[-200:].mean() < g[:200].mean() / 10
    assert r["consensus"][-200:].mean() < 1.0


def test_by_name_validation_and_unported_paths(four_node):
    prob, mix = four_node
    alg = K.by_name("cedas", mix, K.StepSize(ALPHA), COMP, staleness=1)
    assert alg.name == "cedas"
    with pytest.raises(ValueError, match="staleness"):
        K.by_name("cedas", mix, K.StepSize(ALPHA), COMP, staleness=2)
    with pytest.raises(ValueError, match="mix_step"):
        K.by_name("cedas", mix, K.StepSize(ALPHA), COMP, mix_step=1.5)
    adc = K.by_name("adc_dgd", mix, K.StepSize(ALPHA), COMP)
    assert alg.bytes_per_iteration(prob) == adc.bytes_per_iteration(prob)
    for name in ("dgd", "dgd_t", "compressed_dgd", "choco", "centralized_gd"):
        assert K.by_name(name, mix, K.StepSize(ALPHA), COMP).name in (
            name, "choco_gossip")
    with pytest.raises(KeyError):
        K.by_name("nope", mix, K.StepSize(ALPHA))
    # elastic membership and the two-level hierarchy run
    r = K.run_elastic(K.ADCDGD(mix, COMP, K.StepSize(ALPHA)), prob, 6,
                      T.MembershipSchedule.from_spec("1@1:2", 4),
                      schedule_period=2)
    assert r["active_nodes"].tolist() == [4, 4, 3, 3, 4, 4]
    assert np.isfinite(r["x_final"]).all()
    assert K.pod_problem(prob, 2).n_nodes == 2
    h = K.run_hierarchical(prob, 2, 6, compressor=COMP,
                           stepsize=K.StepSize(ALPHA))
    assert h["x_final"].shape == (4, prob.dim) and h["pod_size"] == 2
    np.testing.assert_array_equal(h["x_final"][0::2], h["x_final"][1::2])
    from repro_torch.core import wire, wireplan
    plan = wireplan.parse_spec("int8").build(
        wire.WireLayout.for_tree({"w": torch.zeros(prob.dim)}))
    on_plan = K.on_wire_plan("adc_dgd", mix, plan, K.StepSize(ALPHA))
    assert isinstance(on_plan.compressor, wireplan.WirePlanCompressor)
    # directed mixing runs push-sum, as the reference's does
    directed = K.ADCDGD(T.directed_ring(4), COMP, K.StepSize(ALPHA))
    jdirected = JK.ADCDGD(JT.directed_ring(4), JC.RandomizedRounding(1.0),
                          JK.StepSize(ALPHA))
    assert directed.push_sum and jdirected.push_sum
    assert directed.bytes_per_iteration(prob) == \
        jdirected.bytes_per_iteration(JP.paper_4node())
    # time-varying schedules are ported, undirected and directed alike
    sched = T.PeriodicSchedule((T.ring(4), T.chain(4)))
    assert K.DGD(sched, K.StepSize(ALPHA)).mixing.period == 2
    dsched = K.DGD(T.DirectedErdosRenyiSchedule(4, p=0.5, horizon=2),
                   K.StepSize(ALPHA)).mixing
    np.testing.assert_array_equal(dsched.stack, JT.DirectedErdosRenyiSchedule(
        4, p=0.5, horizon=2).stack)


def test_theory_functions_equal_reference():
    from repro.core import theory as jtheory
    v = 1.0 / np.arange(1, 500) ** 0.7
    assert theory.fit_loglog_rate(v) == jtheory.fit_loglog_rate(v)
    assert theory.error_ball_radius(0.1, 2.0, 0.5) == \
        jtheory.error_ball_radius(0.1, 2.0, 0.5)
    assert theory.max_constant_stepsize(0.2, 3.0) == \
        jtheory.max_constant_stepsize(0.2, 3.0)
    assert theory.theoretical_rate_exponent(1.2, 0.5) == \
        jtheory.theoretical_rate_exponent(1.2, 0.5)


@pytest.mark.parametrize("name", ["linreg", "logreg", "circle"])
def test_problems_equal_reference(name):
    """The same draws give the same float32 data: objectives and gradients
    agree to float32 summation order."""
    if name == "linreg":
        jp = JP.decentralized_linear_regression(6, 40, seed=2)
        tp = P.decentralized_linear_regression(6, 40, seed=2, device="cpu")
    elif name == "logreg":
        jp = JP.decentralized_logistic_regression(6, 40, seed=2)
        tp = P.decentralized_logistic_regression(6, 40, seed=2,
                                                 device="cpu")
    else:
        jp = JP.paper_circle_problem(7, seed=3, dim=33)
        tp = P.paper_circle_problem(7, seed=3, dim=33, device="cpu")
    assert (tp.n_nodes, tp.dim, tp.name) == (jp.n_nodes, jp.dim, jp.name)
    if jp.x_star is not None:
        np.testing.assert_array_equal(tp.x_star, jp.x_star)
    x = np.random.default_rng(0).normal(size=(jp.n_nodes, jp.dim)).astype(
        np.float32) * 0.3
    xt = torch.from_numpy(x)
    for got, want in (
            (tp.grad_fn(xt), jax.jit(jp.grad_fn)(jnp.asarray(x))),
            (tp.global_grad(xt[0]), jax.jit(jp.global_grad)(x[0])),
            (tp.global_obj(xt[0]), jax.jit(jp.global_obj)(x[0])),
            (tp.mean_grad_norm(xt), jp.mean_grad_norm(jnp.asarray(x))),
            (tp.consensus_error(xt), jp.consensus_error(jnp.asarray(x)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=1e-6)


def test_fig1_contrast_at_the_smoke_configuration():
    """The card's ``phase_paper`` contrast at a CPU size: the paper's
    largest circle (n = 20) at P = 2,048 (the card runs P = 2^22), int8
    adaptive, 500 steps of StepSize(0.01, eta=0.5).  Direct compression's
    iterate stays a noise ball away from uncompressed DGD's while
    ADC-DGD's compression error dies out: at the last step ADC-DGD is at
    least 10x closer to DGD.  The consensus error cannot show it here:
    DGD's own error ball alpha D / (1 - beta) dominates it at 500 steps,
    for all three algorithms alike."""
    prob = P.paper_circle_problem(20, seed=0, dim=2048, device="cpu")
    comp = C.Int8BlockQuantizer(mode="adaptive")
    step = K.StepSize(0.01, eta=0.5)
    mix = T.paper_circle(20)
    dgd = K.run(K.DGD(mix, step), prob, 500, key=0)
    adc = K.run(K.ADCDGD(mix, comp, step), prob, 500, key=0)
    cdgd = K.run(K.CompressedDGD(mix, comp, step), prob, 500, key=0)
    off = {name: np.linalg.norm(r["x_final"] - dgd["x_final"])
           for name, r in (("adc", adc), ("cdgd", cdgd))}
    assert off["cdgd"] >= 10 * off["adc"]
    assert adc["consensus"][-1] <= cdgd["consensus"][-1]
    assert adc["consensus"][-1] == pytest.approx(dgd["consensus"][-1],
                                                 rel=1e-3)
