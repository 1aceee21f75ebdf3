"""Elastic membership on the port, held to the JAX package.

  * ``MembershipSchedule`` equals the reference's exactly: masks from
    specs, clamping, ``epoch_events``, the survivors' mixing (Metropolis-
    Hastings and ring rules), the push-sum handoff, the rejoin sources and
    the masks of ``NodeFailureModel``.
  * ``consensus.run_elastic`` (rules ``metropolis`` and ``ring``, push-sum
    on and off, RandomizedRounding and int8 blocks) beside the reference's
    jitted ``run_elastic`` from the same key, the port fed the reference's
    per-node uniforms, free running over RUN_STEPS steps across two
    outages: the transmitted maximum (the codes) and the step sizes
    bitwise, ``x_final`` and ``ps_w_final`` within RUN_ULPS, the
    active counts and the bytes equal, the metrics within METRIC_RTOL.
  * The runtime under membership against the reference's
    ``ConsensusRuntime`` (one subprocess with 6 host devices, meshes of 4
    and 5 of them; each step started from the reference's own state): the
    reference's churn masks (node 2 out for the second of three epochs of
    PERIOD steps) on packed, pipelined over 3 units, async at staleness 0
    and 1, with Bernoulli loss 0.2 and burst loss, and on 5 nodes at
    strides (1, 2), where the 4 survivors fall back to stride 1.  The
    neighbour tables equal the reference's ring permutations; payload
    bytes exact (an inactive node sends none); state within STATE_ULPS
    per step; an inactive node's parameters and shadows frozen bitwise;
    ``active_nodes``, overflow, delivered bytes, wire bytes and
    collectives equal.
  * The port alone: a single all-active mask gives the bits of no
    membership; packed == pipelined == async at staleness 0 under churn;
    the hole epoch encodes and combines 3 of 4 nodes; the resyncs fire at
    the epoch boundaries until the mask has clamped.
  * The trainer's ``--node-failures`` on ``--reduced --device cpu``.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.core import consensus as JK
from repro.core import faults as JF
from repro.core import problems as JP
from repro.core import topology as JT
from repro_torch.core import compression as C
from repro_torch.core import consensus as K
from repro_torch.core import faults as F
from repro_torch.core import problems as P
from repro_torch.core import topology as T
from repro_torch.core import tree as TR
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.launch import train
from test_torch_faults import _delta, _x0, same_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATE_ULPS = 2
RUN_STEPS, RUN_ULPS, METRIC_RTOL = 16, 4, 1e-5
#: the reference's churn scenario (``benchmarks/consensus_step.py``
#: ``CHURN_MASKS``) at a period of 2: node 2 out at steps 3-4, resyncs at
#: steps 3 and 5, the mask clamped from step 5 on
ALL4 = (True,) * 4
CHURN = (ALL4, (True, True, False, True), ALL4)
PERIOD, STEPS = 2, 6


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
# MembershipSchedule
# ---------------------------------------------------------------------------

SPECS = [("2@1:3;0@4:6", 6, None), ("2@1:3;4@1:2", 6, None),
         ("2@1:2", 4, None), ("2@1:3", 6, 10), ("0@0:2;1@2:4", 3, None),
         ("3@1:3;7@2:4", 20, None)]


def same_schedule(got, want):
    assert got.masks == want.masks
    assert (got.n_nodes, got.n_epochs, got.is_static) == (
        want.n_nodes, want.n_epochs, want.is_static)
    assert got.epoch_events() == want.epoch_events()
    for e in range(want.n_epochs + 2):
        assert got.mask_at(e) == want.mask_at(e)
        assert got.active_indices(e) == want.active_indices(e)
        assert got.rejoiners_at(e) == want.rejoiners_at(e)
        for rule in ("metropolis", "ring"):
            for sw in (0.5, 0.3):
                g = got.mixing_at(e, self_weight=sw, rule=rule)
                w = want.mixing_at(e, self_weight=sw, rule=rule)
                np.testing.assert_array_equal(g.w, w.w)
                assert g.name == w.name
        if e >= 1:
            np.testing.assert_array_equal(got.handoff_at(e),
                                          want.handoff_at(e))
            assert got.rejoin_sources_at(e) == want.rejoin_sources_at(e)


@pytest.mark.parametrize("spec,n,epochs", SPECS,
                         ids=[f"{s}/{n}" for s, n, _ in SPECS])
def test_membership_schedule_equals_reference(spec, n, epochs):
    same_schedule(T.MembershipSchedule.from_spec(spec, n, epochs),
                  JT.MembershipSchedule.from_spec(spec, n, epochs))


def test_membership_schedule_static_failures_and_refusals():
    same_schedule(T.MembershipSchedule.static(5),
                  JT.MembershipSchedule.static(5))
    for seed in (7, 8):
        fm, jfm = (F.NodeFailureModel(0.6, 0.4, seed=seed),
                   JF.NodeFailureModel(0.6, 0.4, seed=seed))
        same_schedule(T.MembershipSchedule.from_failure_model(fm, 6, 20),
                      JT.MembershipSchedule.from_failure_model(jfm, 6, 20))
    # a full swap: no node active through the change
    swap = ((True, True, False, False), (False, False, True, True))
    same_schedule(T.MembershipSchedule(swap), JT.MembershipSchedule(swap))
    m = T.MembershipSchedule.from_spec("2@1:3", 6)
    with pytest.raises(ValueError) as got:
        m.mixing_at(1, rule="star")
    with pytest.raises(ValueError) as want:
        JT.MembershipSchedule.from_spec("2@1:3", 6).mixing_at(1, rule="star")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="epoch >= 1"):
        m.handoff_at(0)
    assert T._nearest_active(2, (True, False, False, True)) == \
        JT._nearest_active(2, (True, False, False, True))


# ---------------------------------------------------------------------------
# run_elastic
# ---------------------------------------------------------------------------

def _uniforms(talg, tprob, key):
    shape = talg.uniform_shape(tprob)
    node_keys = jax.random.split(key, tprob.n_nodes)
    return torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.uniform(k, shape[1:]))(node_keys)))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = np.spacing(np.float32(max(np.max(np.abs(b)), 1e-30)))
    return float(np.max(np.abs(a - b)) / scale)


ELASTIC = [(rule, push, comp) for rule in ("metropolis", "ring")
           for push in (False, True) for comp in ("rr", "int8")]


@pytest.mark.parametrize("rule,push,comp", ELASTIC,
                         ids=[f"{r}-{'push' if p else 'plain'}-{c}"
                              for r, p, c in ELASTIC])
def test_run_elastic_matches_reference(rule, push, comp):
    n = 6
    jp = JP.paper_circle_problem(n, seed=0, dim=8)
    tp = P.paper_circle_problem(n, seed=0, dim=8, device="cpu")
    jc, tc = ((JC.RandomizedRounding(0.05), C.RandomizedRounding(0.05))
              if comp == "rr" else
              (JC.Int8BlockQuantizer(512, "fixed", 1e-3),
               C.Int8BlockQuantizer(512, "fixed", 1e-3)))
    ja = JK.ADCDGD(JT.ring(n, 0.5), jc, JK.StepSize(0.05, 0.6))
    ta = K.ADCDGD(T.ring(n, 0.5), tc, K.StepSize(0.05, 0.6))
    spec = "2@1:3;4@2:3"
    kw = dict(schedule_period=3, rule=rule, push_sum=push, key=3)
    want = JK.run_elastic(ja, jp, RUN_STEPS,
                          JT.MembershipSchedule.from_spec(spec, n), **kw)
    keys = jax.random.split(jax.random.PRNGKey(3), RUN_STEPS)
    got = K.run_elastic(ta, tp, RUN_STEPS,
                        T.MembershipSchedule.from_spec(spec, n),
                        uniforms=lambda i: _uniforms(ta, tp, keys[i]), **kw)
    assert sorted(got) == sorted(want)
    for name in ("max_tx", "alpha", "active_nodes", "bytes"):
        np.testing.assert_array_equal(got[name], want[name], name)
    assert got["active_nodes"].tolist() == [6] * 3 + [5] * 3 + [4] * 3 + \
        [6] * 7
    names = ("x_final",) + (("ps_w_final",) if push else ())
    for name in names:
        assert _ulps(got[name], want[name]) <= RUN_ULPS, name
    for name in ("obj", "grad_norm", "consensus"):
        np.testing.assert_allclose(got[name], want[name], rtol=METRIC_RTOL,
                                   atol=1e-7, err_msg=name)


def _fixture(n=6, dim=8):
    prob = P.paper_circle_problem(n, seed=0, dim=dim, device="cpu")
    alg = K.ADCDGD(T.ring(n, 0.5), C.RandomizedRounding(0.05),
                   K.StepSize(0.05, 0.6), gamma=1.0)
    return prob, alg


def test_run_elastic_claims_on_the_port():
    """The reference's claims (``tests/test_membership.py``) on the port:
    a static mask reproduces ``run`` (ring rule) bit for bit; after an
    outage the consensus error contracts back to the static run's level
    and churn bills fewer bytes; push-sum's handoff keeps the mass: the
    weights sum to the active count and stay positive."""
    prob, alg = _fixture()
    r_el = K.run_elastic(alg, prob, 40, T.MembershipSchedule.static(6),
                         schedule_period=4, rule="ring", key=3)
    r_ref = K.run(alg, prob, 40, key=3)
    np.testing.assert_array_equal(r_el["x_final"], r_ref["x_final"])
    np.testing.assert_array_equal(r_el["consensus"], r_ref["consensus"])
    np.testing.assert_array_equal(r_el["bytes"], r_ref["bytes"])
    mem = T.MembershipSchedule.from_spec("2@1:3", 6, n_epochs=10)
    r_ch = K.run_elastic(alg, prob, 120, mem, schedule_period=6, key=3)
    r_st = K.run(alg, prob, 120, key=3)
    assert r_ch["active_nodes"][6] == 5.0 and r_ch["active_nodes"][-1] == 6
    assert r_ch["consensus"][-1] < 0.3 * r_ch["consensus"][0]
    assert r_ch["consensus"][-1] < 5.0 * max(r_st["consensus"][-1], 1e-3)
    assert abs(r_ch["obj"][-1] - r_st["obj"][-1]) < 0.05 * abs(
        r_st["obj"][-1])
    assert r_ch["bytes"][-1] < r_st["bytes"][-1]
    r = K.run_elastic(alg, prob, 120, mem, schedule_period=6, push_sum=True,
                      key=3)
    assert all(np.isfinite(v).all() for v in r.values())
    assert r["consensus"][-1] < 0.3 * r["consensus"][0]
    # mixing and handoff conserve the weights' sum; each rejoin re-seeds
    # one weight at 1 (the reference's warm restart): 6 + 1, to float32
    # rounding over 120 steps
    assert (r["ps_w_final"] > 0).all()
    assert abs(float(r["ps_w_final"].sum()) - 7.0) < 7.0 * 5e-6
    with pytest.raises(ValueError, match="adc_dgd only"):
        K.run_elastic(K.DGD(T.ring(6), K.StepSize(0.05)), prob, 2, mem)
    with pytest.raises(ValueError, match="schedule_period"):
        K.run_elastic(alg, prob, 2, mem, schedule_period=0)


# ---------------------------------------------------------------------------
# against the reference's ConsensusRuntime
# ---------------------------------------------------------------------------

#: the reference-side runner: runs ``__CASES__`` (label, node count,
#: ConsensusConfig keywords) for ``__STEPS__`` steps on both runtimes,
#: each step started from the reference's state
BODY = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=__DEV__"
import json
import jax, jax.numpy as jnp, numpy as np, torch
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import distributed as JD
from repro.core.distributed import ConsensusConfig as JCfg
from repro.core.distributed import ConsensusRuntime as JRt
from repro.models import transformer as JT
from repro.models.sharding import ParallelContext, local_context
from repro.models.sharding import shard_map_compat
from repro_torch.core import tree as T
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.models.params import consensus_state_from_jax

torch.set_num_threads(1)
STEPS = __STEPS__
defs = JT.build_defs(jreduced(jget_config("smollm-135m")), local_context())
tmpl = JT.init_params(defs, jax.random.PRNGKey(0))   # structure only

def ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / np.spacing(np.max(np.abs(b))))

tt = lambda tree: T.tree_map(torch.from_numpy, tree)
out = {}
for label, N, kw in __CASES__:
    mesh = Mesh(np.array(jax.devices()[:N]), ("data",))
    ctx = ParallelContext(tp=1, data_size=N, n_nodes=N, in_shard_map=True)
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

    jrt = JRt(JCfg(**kw), ctx)
    rt = ConsensusRuntime(ConsensusConfig(**kw), N)
    cfg = rt.cfg
    m, rl = rt.pod_size, rt.ring_len
    packing = cfg.wire_packing
    jlayout = jrt.state_layout(jax.tree.map(lambda a: a[0], x0))
    layout = rt.state_layout(tt(x0))
    plan = rt.wire_plan_for(layout)
    jplan = jrt.wire_plan_for(jlayout)
    keys = ["x_tilde", "m_agg"] + (["fly_self", "fly_up", "fly_dn"]
                                   if packing == "async" else [])
    mkeys = (["overflow_frac", "residual_norm"]
             + (["wire_bytes_delivered", "delivered_frac"]
                if cfg.faults_enabled else [])
             + (["active_nodes"] if cfg.membership is not None else []))
    cspec = {k: (P("data", None, None) if k in ("x_tilde", "m_agg")
                 else P("data", None)) for k in keys}
    mspec = {k: P("data") for k in mkeys}
    pspec = jax.tree.map(lambda a: P("data"), x0)
    init_f = jax.jit(shard_map_compat(
        lambda p: jax.tree.map(lambda a: a[None], jrt.init_state(p)),
        mesh, in_specs=(pspec,), out_specs=cspec, check=False))
    def jstep(xp, xh, s, k, nz):
        s = jax.tree.map(lambda a: a[0], s)
        xn, s2, mt = jrt.exchange(xp, xh, s, k, jax.random.PRNGKey(7),
                                  noise=nz[0])
        return (xn, jax.tree.map(lambda a: a[None], s2),
                {k2: mt[k2][None] for k2 in mkeys})
    step_f = jax.jit(shard_map_compat(
        jstep, mesh, in_specs=(pspec, pspec, cspec, P(), P("data")),
        out_specs=(pspec, cspec, mspec), check=False))
    pod_f = None
    if m > 1 and rl > 1:
        pod_f = jax.jit(shard_map_compat(
            jrt._pod_mean_delta, mesh, in_specs=(pspec, pspec),
            out_specs=pspec, check=False))
    sent, pods_seen = [], []
    encode, pod_mean = rt._encode_unit, rt._pod_mean_delta
    def spy(*a, **k):
        pays = encode(*a, **k)
        sent.append([None if p is None else p.clone() for p in pays])
        return pays
    def pod_spy(*a):
        got = pod_mean(*a)
        pods_seen.append(got)
        return got
    rt._encode_unit, rt._pod_mean_delta = spy, pod_spy

    def tables(stride, mask):
        # the reference's own ring permutations, as element tables
        left, right = [None] * rl, [None] * rl
        for side, shift in ((left, stride), (right, -stride)):
            for src, tgt in JD._flat_ring_perm_masked(ctx, shift, mask,
                                                      group=m):
                side[tgt // m] = src // m
        return left, right

    js = init_f(x0)
    res = {"payload_equal": [], "ulps": [], "metrics_equal": [],
           "tables_equal": [], "frozen": [], "replicas": [],
           "pod_mean_ulps": [], "resync": [], "active": [],
           "layout": [layout.placement == jlayout.placement,
                      plan.payload_bytes == jplan.payload_bytes]}
    tinit = rt.init_state(tt(x0))
    res["init_equal"] = sorted(tinit) == sorted(keys) and all(
        np.array_equal(tinit[k].numpy(), np.asarray(js[k])) for k in keys)
    x_prev = x0
    for k in range(1, STEPS + 1):
        xp, xh = x_prev, jax.tree.map(np.add, x_prev, delta(k))
        # one draw per ring element, shared by a pod's members
        nz = np.repeat(np.random.default_rng([2, k]).random(
            (rl, layout.n_rows, plan.noise_cols()), dtype=np.float32),
            m, axis=0)
        synced = consensus_state_from_jax(
            {key: np.asarray(v) for key, v in js.items()}, N, device="cpu")
        step_k = jrt._step_k(jnp.asarray(k, jnp.int32))
        jxn, js, jm = step_f(xp, xh, js, jnp.asarray(k, jnp.int32), nz)
        del sent[:], pods_seen[:]
        txn, ts, tm = rt.exchange(tt(xp), tt(xh), synced, k,
                                  noise=torch.from_numpy(nz))
        x_prev = jax.tree.map(np.asarray, jxn)
        wiring = rt.wiring_at(k)
        mask = rt.mask_at(k)
        res["tables_equal"].append(
            list(tables(rt.stride_at(k), mask))
            == [list(wiring.left), list(wiring.right)])
        res["resync"].append(rt.resync_at(k))
        res["active"].append(wiring.active)
        xh_pm = xh
        if pod_f is not None:
            xh_pm = jax.tree.map(np.asarray, pod_f(xp, xh))
            res["pod_mean_ulps"].append(max(
                ulps(a.numpy(), b[::m]) for a, b in zip(
                    T.tree_leaves(pods_seen[0]),
                    jax.tree_util.tree_leaves(xh_pm))))
        reps = [e * m for e in range(rl)]
        same = True
        if rl <= 1:
            same = not sent
        elif packing == "async" and cfg.staleness == 1:
            fly = {key: ts[key].numpy()[::m] for key in
                   ("fly_self", "fly_up", "fly_dn")}
            xt_new = ts["x_tilde"].numpy()
            for e in range(rl):
                i = reps[e]
                if e in wiring.active:
                    want = np.asarray(jplan.encode(
                        jlayout.pack(jax.tree.map(lambda a: a[i], xh_pm))
                        - xt_new[i], jnp.asarray(nz[i]), fixed_step=step_k))
                else:
                    want = np.zeros_like(fly["fly_self"][e])
                same = same and np.array_equal(fly["fly_self"][e], want)
                for key, tab in (("fly_up", wiring.left),
                                 ("fly_dn", wiring.right)):
                    src = (np.zeros_like(want) if tab[e] is None
                           else fly["fly_self"][tab[e]])
                    same = same and np.array_equal(fly[key][e], src)
            res.setdefault("fly_off", []).append(float(
                (np.asarray(ts["fly_self"].numpy())
                 != np.asarray(js["fly_self"])).mean()))
        else:
            for e in range(rl):
                i = reps[e]
                got = [u[e] for u in sent]
                if e not in wiring.active:
                    same = same and all(g is None for g in got)
                    continue
                want = np.asarray(jplan.encode(
                    jlayout.pack(jax.tree.map(lambda a: a[i], xh_pm))
                    - synced["x_tilde"][i].numpy(), jnp.asarray(nz[i]),
                    fixed_step=step_k))
                same = same and np.array_equal(
                    np.concatenate([g.numpy() for g in got]), want)
        res["payload_equal"].append(bool(same))
        res["ulps"].append([
            max(ulps(a, b) for a, b in zip(
                T.tree_leaves(txn), jax.tree_util.tree_leaves(jxn))),
            ulps(ts["x_tilde"], js["x_tilde"]),
            ulps(ts["m_agg"], js["m_agg"])])
        # an inactive element's nodes keep parameters and shadows bitwise
        frozen = True
        for e in wiring.inactive:
            for i in range(e * m, (e + 1) * m):
                frozen = frozen and all(
                    np.array_equal(a.numpy()[i], b[i]) for a, b in zip(
                        T.tree_leaves(txn), jax.tree_util.tree_leaves(xp)))
                frozen = frozen and all(np.array_equal(
                    ts[key][i].numpy(), synced[key][i].numpy())
                    for key in ("x_tilde", "m_agg"))
        res["frozen"].append(frozen)
        # pod members are replicas of the pod's outer exchange (one pod
        # runs the rotation all-reduce, whose sum order is per node)
        res["replicas"].append(rl <= 1 or all(
            np.array_equal(a.numpy()[e * m + j], a.numpy()[e * m])
            for a in T.tree_leaves(txn) + [ts[k2] for k2 in keys]
            for e in range(rl) for j in range(m)))
        res["metrics_equal"].append({
            key: (np.allclose(tm[key].numpy(), np.asarray(jm[key]),
                              rtol=1e-5, atol=0) if key == "residual_norm"
                  else np.array_equal(np.asarray(tm[key].numpy(),
                                                 np.float32),
                                      np.asarray(jm[key])))
            for key in mkeys})
    res["wire"] = [tm["wire_bytes_per_step"], jrt.wire_bytes_per_step(
        jlayout.n_elements, layout=jlayout)]
    res["collectives"] = [tm["collectives_per_step"],
                          jrt.collectives_per_step(jlayout.n_leaves,
                                                   layout=jlayout)]
    res["zero_payloads"] = rt.zero_payloads
    out[label] = res
print("RESULT " + json.dumps(out))
"""


def reference_results(cases, steps=STEPS, devices=6):
    """Run ``cases`` (label, nodes, config keywords) on both runtimes in
    one subprocess with ``devices`` host devices."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    body = (BODY.replace("__DEV__", str(devices))
            .replace("__STEPS__", str(steps))
            .replace("__CASES__", repr(cases)))
    proc = subprocess.run([sys.executable, "-c", body], capture_output=True,
                          text=True, timeout=900, env=env, cwd=REPO)
    if proc.returncode != 0:
        raise AssertionError(f"subprocess failed:\n{proc.stderr[-4000:]}")
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise AssertionError(f"no RESULT line:\n{proc.stdout[-2000:]}")


#: largest share of an async payload's bytes that may differ from the
#: reference's launch (ROADMAP Queue 3, hazards 4 and 13)
MAX_FLY_OFF = 1e-5


def check_case(r, steps=STEPS, state_ulps=STATE_ULPS):
    """The shared contract of one case of ``BODY``."""
    assert r["layout"] == [True, True]
    assert r["init_equal"]
    assert all(r["tables_equal"]), r["tables_equal"]
    assert r["payload_equal"] == [True] * steps
    assert max(r.get("fly_off", [0.0])) <= MAX_FLY_OFF, r["fly_off"]
    for step, u in enumerate(r["ulps"]):
        assert max(u) <= state_ulps, (step + 1, u)
    assert all(r["frozen"]) and all(r["replicas"])
    for step, m in enumerate(r["metrics_equal"]):
        assert all(m.values()), (step + 1, m)
    assert r["wire"][0] == r["wire"][1] > 0
    assert r["collectives"][0] == r["collectives"][1]


CHURN_KW = dict(membership=CHURN, schedule_period=PERIOD)
CASES = [
    ("churn/packed", 4, dict(CHURN_KW)),
    ("churn/pipelined3", 4, dict(CHURN_KW, wire_packing="pipelined",
                                 pipeline_chunks=3)),
    ("churn/async0", 4, dict(CHURN_KW, wire_packing="async", staleness=0)),
    ("churn/async1", 4, dict(CHURN_KW, wire_packing="async")),
    ("churn/bernoulli0.2", 4, dict(CHURN_KW, link_loss=0.2, loss_seed=1,
                                   resync_retries=1)),
    ("churn/burst", 4, dict(CHURN_KW,
                            link_loss_model="gilbert:p=0.1,r=0.9",
                            loss_seed=1, wire_packing="async")),
    ("churn5/strides1,2", 5, dict(
        membership=((True,) * 5, (True, True, False, True, True),
                    (True,) * 5), schedule_period=PERIOD,
        ring_strides=(1, 2)))]
LABELS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def reference():
    return reference_results(CASES)


@pytest.mark.parametrize("label", LABELS)
def test_reference_exchange_under_membership(reference, label):
    check_case(reference[label])


def test_reference_churn_wiring(reference):
    """The hole epoch leaves node 2 out, the resyncs land at the epoch
    boundaries (steps 3 and 5, not after the clamp), and on 5 nodes the 4
    survivors of stride 2 fall back to stride 1 (the reference's table)."""
    r = reference["churn/packed"]
    assert r["active"] == [[0, 1, 2, 3]] * 2 + [[0, 1, 3]] * 2 + \
        [[0, 1, 2, 3]] * 2
    assert r["resync"] == [False, False, True, False, True, False]
    s = reference["churn5/strides1,2"]
    assert s["active"][2] == [0, 1, 3, 4]
    rt = ConsensusRuntime(ConsensusConfig(**CASES[-1][2]), 5)
    hole = rt.wiring_at(3)
    assert rt.stride_at(3) == 2
    assert hole.left == (4, 0, None, 1, 3) and hole.right == (1, 3, None,
                                                              4, 0)
    assert reference["churn/bernoulli0.2"]["zero_payloads"] > 0


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def run_port(steps, n=4, **kw):
    """``steps`` exchanges of the reduced tree from a shared x0: (final
    params, state, metrics per step, runtime)."""
    rt = ConsensusRuntime(ConsensusConfig(**kw), n)
    x = _x0(n)
    state = rt.init_state(x)
    hist = []
    for k in range(1, steps + 1):
        xh = TR.tree_map(torch.add, x, _delta(k, n))
        x, state, m = rt.exchange(x, xh, state, k, seed=5)
        hist.append({key: (v.tolist() if torch.is_tensor(v) else v)
                     for key, v in m.items()})
    return x, state, hist, rt


def test_all_active_mask_is_bitwise_no_membership():
    """A single all-active mask runs the membership machinery (and adds
    ``active_nodes``) yet gives the bits of ``membership=None``, on the
    packed and the async transports; on async it keeps the ring views."""
    for extra in ({}, {"wire_packing": "async"},
                  {"wire_packing": "pipelined", "pipeline_chunks": 3}):
        none = run_port(3, **extra)
        allm = run_port(3, membership=(ALL4,), **extra)
        keys = ("x_tilde", "m_agg") + (("fly_self", "fly_up", "fly_dn")
                                       if extra.get("wire_packing")
                                       == "async" else ())
        assert same_run(none, allm, keys), extra
        assert [h["active_nodes"] for h in allm[2]] == [[4.0] * 4] * 3
        assert "active_nodes" not in none[2][0]
        assert not allm[3].cfg.schedule_varying


def test_churn_transports_equal_and_launches():
    """Under churn packed == pipelined (3 units) == async at staleness 0
    bitwise; the hole epoch encodes and combines nodes 0, 1 and 3 only
    (one launch each per unit), and node 2 keeps its parameters and
    shadows bitwise through it."""
    calls = []
    real = ConsensusRuntime._retire

    def spy(self, plan, unit, own, left, right, xt, mb, outs, nodes):
        calls.append((self._k, list(nodes)))
        return real(self, plan, unit, own, left, right, xt, mb, outs, nodes)

    ConsensusRuntime._retire = spy
    try:
        runs = {}
        for label, extra in (("packed", {}),
                             ("pipelined", {"wire_packing": "pipelined",
                                            "pipeline_chunks": 3}),
                             ("async0", {"wire_packing": "async",
                                         "staleness": 0})):
            rt = ConsensusRuntime(ConsensusConfig(**CHURN_KW, **extra), 4)
            x = _x0(4)
            state = rt.init_state(x)
            snaps = []
            for k in range(1, STEPS + 1):
                rt._k = k
                xh = TR.tree_map(torch.add, x, _delta(k, 4))
                x, state, m = rt.exchange(x, xh, state, k, seed=5)
                snaps.append((TR.tree_map(lambda a: a[2].clone(), x),
                              state["x_tilde"][2].clone()))
            runs[label] = (x, state, snaps)
            if label == "packed":
                packed_calls = list(calls)
    finally:
        ConsensusRuntime._retire = real
    base = runs["packed"]
    for label, r in runs.items():
        assert same_run((base[0], base[1]), (r[0], r[1])), label
    # node 2 frozen through its outage (steps 3-4), moving again after
    snaps = base[2]
    for k in (3, 4):
        assert all(torch.equal(a, b) for a, b in zip(
            TR.tree_leaves(snaps[k - 1][0]), TR.tree_leaves(snaps[1][0])))
        assert torch.equal(snaps[k - 1][1], snaps[1][1])
    assert not torch.equal(snaps[4][1], snaps[1][1])
    by_step = {}
    for k, nodes in packed_calls:
        by_step.setdefault(k, []).append(nodes)
    assert by_step[3] == [[0, 1, 3]] and by_step[2] == [[0, 1, 2, 3]]
    rt = ConsensusRuntime(ConsensusConfig(**CHURN_KW), 4)
    assert [rt.resync_at(k) for k in range(1, 10)] == [
        False, False, True, False, True, False, False, False, False]
    strided = ConsensusRuntime(ConsensusConfig(
        **CHURN_KW, ring_strides=(1, 3)), 4)
    assert [strided.resync_at(k) for k in (3, 5, 7, 9)] == [True] * 4


def test_trainer_node_failures(capsys):
    """``--node-failures`` on the reduced model: the step line shows
    ``active_nodes`` (4, 4, 3, 3, 4), ``resync`` at steps 3 and 5, the
    reference's amortized resync bytes; bad specs fail at the CLI."""
    hist = train.main(["--reduced", "--device", "cpu", "--nodes", "4",
                       "--batch", "8", "--seq", "32", "--steps", "5",
                       "--node-failures", "2@1:2", "--schedule-period", "2",
                       "--wire-packing", "async"])
    assert [h["active_nodes"] for h in hist] == [4, 4, 3, 3, 4]
    assert [h["resync"] for h in hist] == [False, False, True, False, True]
    assert all(np.isfinite(h["loss"]) for h in hist)
    out = capsys.readouterr().out
    assert "active_nodes=3" in out and "membership over 4" in out
    for argv in (["--node-failures", "9@1:2"],
                 ["--node-failures", "2@1"],
                 ["--node-failures", "0@1:2;1@1:2;2@1:2"],
                 ["--node-failures", "2@1:2", "--wire-packing", "per_leaf"],
                 ["--node-failures", "2@1:2", "--topology",
                  "directed-ring"]):
        with pytest.raises((SystemExit, ValueError)):
            train.main(["--reduced", "--device", "cpu", "--nodes", "4",
                        "--batch", "8", "--steps", "1", *argv])
