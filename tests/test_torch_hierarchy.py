"""Two-level hierarchical consensus on the port, held to the JAX package.

  * ``HierarchySpec`` (``core/hierarchy.py``) equals the reference's:
    parsing, the divisibility refusal, the inner average's groups, the
    inner fp32 bytes and ``describe``; ``topology.hierarchical_mixing``
    equals the reference's matrix exactly.
  * ``consensus.pod_problem`` and ``run_hierarchical`` at pods = n, 2 and
    1 (and 3 of 6) beside the reference's jitted ``run_hierarchical`` from
    the same key, the port fed the reference's per-pod uniforms: the
    bytes (inner, outer, total) and the step sizes equal, ``x_final``
    within RUN_ULPS; pods = n is ``run`` on ``ring(n)`` bit for bit.
    pods = 1 is held to the reference's ``run_hierarchical``, not to the
    exact-GD recurrence, which the reference itself misses by an ulp on
    this jax (ROADMAP Queue 3, hazard 2).
  * The runtime's hierarchy against the reference's ``ConsensusRuntime``
    (the runner of ``tests/test_torch_membership.py``: one subprocess with
    6 host devices, meshes of 4 and 6): pods 2 of 4 packed, pipelined over
    3 units, async at staleness 1, plan B and under 20% loss; pods 2 of 6
    (m = 3); membership over 3 pods of 6 nodes, packed on plan A and async
    at staleness 1; pods 1 of 4 (the
    allreduce) and 4 of 4 (the flat ring).  Each pod's inner mean against
    the reference's own ``_pod_mean_delta``, bitwise (at m = 3 too: the
    members' deltas added in member order, then ``s * f32(1/3)`` and the
    add contracted into one fused multiply-add, as XLA compiles the
    reference's ``s / 3``); payload bytes exact; state within STATE_ULPS per step; pod
    members bitwise replicas; wire bytes and collectives equal (3 per
    step at pods 2 of 4, packed).
  * The port alone: pods = n is the flat ring and pods = 1 the
    ``allreduce`` exchange bit for bit; the exchange launches one encode
    and one combine per pod.
  * The trainer's ``--hierarchy`` on ``--reduced --device cpu``.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.core import consensus as JK
from repro.core import hierarchy as JH
from repro.core import problems as JP
from repro.core import topology as JT
from repro_torch.core import compression as C
from repro_torch.core import consensus as K
from repro_torch.core import hierarchy as H
from repro_torch.core import problems as P
from repro_torch.core import topology as T
from repro_torch.core import tree as TR
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.launch import train
from test_torch_faults import PLAN_A, same_run
from test_torch_membership import (check_case, reference_results,
                                   run_port)

STATE_ULPS, RUN_ULPS = 2, 4
STEPS = 4
PLAN_B = "mixed:embed=topk:k=64,norm=int2,*=int8"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# HierarchySpec and the Kronecker mixing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [1, 2, 4, "pods=2", " pods=3 ", "pods=two",
                                  "rings=2", 0, "pods=0"])
def test_hierarchy_spec_equals_reference(spec):
    try:
        want = JH.HierarchySpec.from_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            H.HierarchySpec.from_spec(spec)
        assert str(got.value) == str(e)
        return
    got = H.HierarchySpec.from_spec(spec)
    assert got.pods == want.pods
    assert H.HierarchySpec.from_spec(got) is got
    for n in (4, 6, 8, 12):
        try:
            m = want.pod_size(n)
        except ValueError as e:
            with pytest.raises(ValueError) as err:
                got.pod_size(n)
            assert str(err.value) == str(e)
            continue
        assert got.pod_size(n) == m
        assert got.describe(n) == want.describe(n)
        for fsdp in (1, 2):
            assert got.pod_psum_groups(n, fsdp) == \
                want.pod_psum_groups(n, fsdp)
        for elems in (1000, 33_554_432):
            assert got.inner_bytes_per_step(elems, n) == \
                want.inner_bytes_per_step(elems, n)


@pytest.mark.parametrize("outer,m", [("ring4", 3), ("ring4", 1),
                                     ("fig3", 2), ("ring5", 4)])
def test_hierarchical_mixing_equals_reference(outer, m):
    mk = {"ring4": lambda M: M.ring(4, 0.5), "ring5": lambda M: M.ring(5),
          "fig3": lambda M: M.paper_fig3()}[outer]
    got = T.hierarchical_mixing(mk(T), m)
    want = JT.hierarchical_mixing(mk(JT), m)
    np.testing.assert_array_equal(got.w, want.w)
    assert got.name == want.name
    assert got.beta == pytest.approx(mk(T).beta, abs=1e-9)
    with pytest.raises(ValueError, match=">= 1"):
        T.hierarchical_mixing(mk(T), 0)


# ---------------------------------------------------------------------------
# pod_problem and run_hierarchical
# ---------------------------------------------------------------------------

def _quad(n, dim=6, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 2.0, size=(n, dim))
    b = rng.normal(size=(n, dim))
    return (JP.quadratic_problem(a, b),
            P.quadratic_problem(a, b, device="cpu"))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = np.spacing(np.float32(max(np.max(np.abs(b)), 1e-30)))
    return float(np.max(np.abs(a - b)) / scale)


def test_pod_problem_equals_reference():
    jp, tp = _quad(6, dim=5)
    for pods in (2, 3):
        jpp, tpp = JK.pod_problem(jp, pods), K.pod_problem(tp, pods)
        assert (tpp.n_nodes, tpp.dim, tpp.name) == (jpp.n_nodes, jpp.dim,
                                                    jpp.name)
        x = np.random.default_rng(1).normal(size=(pods, 5)).astype(
            np.float32)
        np.testing.assert_allclose(
            tpp.grad_fn(torch.from_numpy(x)).numpy(),
            np.asarray(jax.jit(jpp.grad_fn)(x)), rtol=2e-6, atol=1e-6)
        xb = x[0]
        np.testing.assert_allclose(
            tpp.global_obj(torch.from_numpy(xb)).numpy(),
            np.asarray(jpp.global_obj(xb)), rtol=2e-6)
    with pytest.raises(ValueError, match="does not divide"):
        K.pod_problem(tp, 4)


HIER = [(4, 4), (4, 2), (4, 1), (6, 2), (6, 3), (6, 1)]


@pytest.mark.parametrize("n,pods", HIER, ids=[f"{p}of{n}" for n, p in HIER])
def test_run_hierarchical_matches_reference(n, pods):
    jp, tp = _quad(n)
    steps = 30
    keys = jax.random.split(jax.random.PRNGKey(3), steps)
    want = JK.run_hierarchical(jp, pods, steps,
                               compressor=JC.RandomizedRounding(0.05),
                               stepsize=JK.StepSize(0.05, 0.6), gamma=1.0,
                               key=3)
    shape = (tp.dim,)
    # eta 0.6: at 0.5 XLA's rsqrt moves a step size by an ulp (ROADMAP
    # Queue 3, hazard 1)

    def uniforms(i):
        if pods == 1:                    # the identity compressor
            return None
        node_keys = jax.random.split(keys[i], pods)
        return torch.from_numpy(np.array(jax.vmap(
            lambda k: jax.random.uniform(k, shape))(node_keys)))

    got = K.run_hierarchical(tp, pods, steps,
                             compressor=C.RandomizedRounding(0.05),
                             stepsize=K.StepSize(0.05, 0.6), gamma=1.0,
                             key=3, uniforms=uniforms)
    assert sorted(got) == sorted(want)
    assert (got["pods"], got["pod_size"]) == (want["pods"],
                                              want["pod_size"])
    for name in ("bytes", "bytes_inner", "bytes_outer", "alpha"):
        np.testing.assert_array_equal(got[name], want[name], name)
    if pods > 1:
        np.testing.assert_array_equal(got["max_tx"], want["max_tx"])
    assert got["x_final"].shape == (n, tp.dim)
    assert _ulps(got["x_final"], want["x_final"]) <= RUN_ULPS
    for name in ("obj", "grad_norm", "consensus"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    m = n // pods
    np.testing.assert_array_equal(got["x_final"][::m].repeat(m, axis=0),
                                  got["x_final"])


def test_run_hierarchical_identities_on_the_port():
    """pods = n is the flat compressed ring bit for bit; pods = 1 sends
    nothing on the outer wire and keeps every node in consensus; pods = 2
    converges with the inner/outer byte split."""
    _, prob = _quad(4)
    comp = C.RandomizedRounding(delta=0.05)
    ss = K.StepSize(0.05, 0.5)
    hier = K.run_hierarchical(prob, 4, 30, compressor=comp, stepsize=ss,
                              key=3)
    flat = K.run(K.ADCDGD(T.ring(4, 0.5), comp, ss), prob, 30, key=3)
    for name in ("grad_norm", "consensus", "obj", "bytes", "x_final"):
        np.testing.assert_array_equal(hier[name], flat[name], name)
    assert not np.any(hier["bytes_inner"])
    one = K.run_hierarchical(prob, 1, 25, stepsize=ss, key=9)
    assert float(np.max(one["consensus"])) == 0.0
    assert not np.any(one["bytes_outer"])
    two = K.run_hierarchical(prob, 2, 300, compressor=comp,
                             stepsize=K.StepSize(0.1, 0.5), key=5)
    assert np.mean(two["grad_norm"][-10:]) < 0.05 * two["grad_norm"][0]
    np.testing.assert_array_equal(two["bytes"],
                                  two["bytes_outer"] + two["bytes_inner"])
    x0 = np.arange(4 * prob.dim, dtype=np.float32).reshape(4, -1) * 0.0 + 1
    a = K.run_hierarchical(prob, 2, 5, compressor=comp, stepsize=ss, key=1,
                           x0=x0)
    b = K.run_hierarchical(prob, 2, 5, compressor=comp, stepsize=ss, key=1,
                           x0=x0[0])
    np.testing.assert_array_equal(a["x_final"], b["x_final"])


# ---------------------------------------------------------------------------
# the runtime against the reference's
# ---------------------------------------------------------------------------

CASES = [
    ("pods2of4/packed", 4, dict(hierarchy=2)),
    ("pods2of4/pipelined3", 4, dict(hierarchy=2, wire_packing="pipelined",
                                    pipeline_chunks=3)),
    ("pods2of4/async1", 4, dict(hierarchy=2, wire_packing="async")),
    ("pods2of4/planB", 4, dict(hierarchy="pods=2", wire_codec=PLAN_B)),
    ("pods2of4/loss0.2", 4, dict(hierarchy=2, link_loss=0.2, loss_seed=3)),
    ("pods2of6/packed", 6, dict(hierarchy=2)),
    ("pods3of6/churn", 6, dict(hierarchy=3, schedule_period=1, membership=(
        (True,) * 3, (True, False, True), (True,) * 3),
        wire_codec=PLAN_A)),
    ("pods3of6/churn async1", 6, dict(
        hierarchy=3, schedule_period=1, wire_packing="async", membership=(
            (True,) * 3, (True, False, True), (True,) * 3))),
    ("pods1of4", 4, dict(hierarchy=1)),
    ("pods4of4", 4, dict(hierarchy=4))]
LABELS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def reference():
    return reference_results(CASES, steps=STEPS)


@pytest.mark.parametrize("label", LABELS)
def test_reference_exchange_under_hierarchy(reference, label):
    check_case(reference[label], steps=STEPS)
    r = reference[label]
    # each pod's inner mean equals the reference's bitwise, at m = 3 too
    assert r["pod_mean_ulps"] == ([0.0] * STEPS if label.startswith(
        ("pods2of", "pods3of")) else []), r["pod_mean_ulps"]


def test_reference_hierarchy_accounting(reference):
    """Collectives per step: 3 at pods 2 of 4 (1 inner + 2 outer), 3 x 2
    + 1 pipelined over 3 units, 3 x 11 leaves at pods 1 of 4 (the
    rotation all-reduce), 2 at pods 4 of 4; wire bytes: the outer payload plus the
    inner fp32 all-reduce, the inner level alone at one pod."""
    col = {label: reference[label]["collectives"][0] for label in LABELS}
    assert col["pods2of4/packed"] == 3.0
    assert col["pods2of4/pipelined3"] == 7.0
    assert col["pods1of4"] == 33.0 and col["pods4of4"] == 2.0
    rt = ConsensusRuntime(ConsensusConfig(hierarchy=2), 4)
    flat = ConsensusRuntime(ConsensusConfig(), 4)
    from test_torch_faults import _x0
    layout = rt.state_layout(_x0(4))
    inner = 2.0 * 0.5 * 4.0 * layout.n_elements
    assert reference["pods2of4/packed"]["wire"][0] == \
        flat.wire_bytes_per_step(layout.n_elements, layout) + inner
    assert reference["pods1of4"]["wire"][0] == 2.0 * 0.75 * 4.0 * \
        layout.n_elements
    assert reference["pods2of4/loss0.2"]["zero_payloads"] > 0
    assert reference["pods3of6/churn"]["active"][1] == [0, 2]


def test_degenerate_pods_equal_flat_and_allreduce():
    """pods = n is the flat ring (packed and async) and pods = 1 the
    ``allreduce`` exchange, bit for bit; pods = 2 keeps every pod's two
    members bitwise equal and launches one encode per pod."""
    for extra in ({}, {"wire_packing": "async"}):
        flat = run_port(3, **extra)
        h4 = run_port(3, hierarchy=4, **extra)
        keys = ("x_tilde", "m_agg") + (("fly_self", "fly_up", "fly_dn")
                                       if extra else ())
        assert same_run(flat, h4, keys), extra
    ar = run_port(3, algorithm="allreduce")
    h1 = run_port(3, hierarchy=1)
    assert same_run(ar, h1, ())
    assert h1[2][0]["collectives_per_step"] == 3.0 * 11
    seen = []
    real = ConsensusRuntime._encode_unit

    def spy(self, plan, unit, y, noise, step_k, nodes, *a, **kw):
        seen.append(list(nodes))
        return real(self, plan, unit, y, noise, step_k, nodes, *a, **kw)

    ConsensusRuntime._encode_unit = spy
    try:
        h2 = run_port(3, hierarchy=2, wire_packing="async")
    finally:
        ConsensusRuntime._encode_unit = real
    assert seen == [[0, 1]] * 3
    for a in TR.tree_leaves(h2[0]):
        assert torch.equal(a[0::2], a[1::2])
    for key in ("x_tilde", "m_agg", "fly_self"):
        assert torch.equal(h2[1][key][0::2], h2[1][key][1::2])


def test_trainer_hierarchy(capsys):
    """``--hierarchy pods=3`` on 6 nodes with pod 1 out for the second
    step: collectives 1 inner + 2 outer + 2 for the resync, active pods
    3, 2, 3; pods that do not tile the nodes fail at the CLI."""
    hist = train.main(["--reduced", "--device", "cpu", "--nodes", "6",
                       "--batch", "12", "--seq", "32", "--steps", "3",
                       "--hierarchy", "pods=3", "--node-failures", "1@1:2",
                       "--schedule-period", "1"])
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert [h["collectives_per_step"] for h in hist] == [5.0] * 3
    assert [h["active_nodes"] for h in hist] == [3.0, 2.0, 3.0]
    out = capsys.readouterr().out
    assert "hierarchy[3 pods x 2 nodes" in out
    for argv in (["--hierarchy", "pods=3"], ["--hierarchy", "two"],
                 ["--hierarchy", "pods=2", "--wire-packing", "per_leaf"],
                 ["--hierarchy", "pods=2", "--algorithm", "dgd"]):
        with pytest.raises((SystemExit, ValueError)):
            train.main(["--reduced", "--device", "cpu", "--nodes", "4",
                        "--batch", "8", "--steps", "1", *argv])
