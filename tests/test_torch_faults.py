"""Unreliable links on the port: ``repro_torch.core.prng``,
``repro_torch.core.faults`` and the exchange's loss, straggler and
bounded-retry resync machinery (``repro_torch.core.distributed``), held to
the JAX package.

  * ``prng`` is ``jax.random`` bit for bit: ``PRNGKey`` of several seeds
    (negative and above 2**32 included), ``fold_in`` chains over 32-bit
    steps and nodes, and ``uniform`` of a scalar and of shapes (the
    ``(horizon, 2)`` draw of the burst model among them).
  * Every host mask of ``faults`` equals the reference's: the Bernoulli and
    straggler keep masks, the resync masks, the Gilbert-Elliott table at
    horizon 64 and ``NodeFailureModel.active_mask_host``; so do
    ``parse_loss_spec`` and the models' refusals.
  * ``ConsensusConfig`` refuses what the reference refuses, membership and
    hierarchy included.
  * The port alone, on 5 stacked nodes of the reduced smollm-135m tree at
    loss 0.2: ``link_loss=0.0`` gives the bits of ``None``; packed ==
    pipelined == async at staleness 0 == per-leaf bit for bit under loss;
    the zero payloads read equal the keep mask's drops per transfer unit.
  * Against the reference (one subprocess with 5 host devices running
    ``repro.core.distributed.ConsensusRuntime`` under ``shard_map``, STEPS
    steps, each started from the reference's own state via
    ``consensus_state_from_jax``), at ring strides (1, 2), period 2, loss
    0.2 with one resync retry (so that some handshakes at steps 3 and 5
    fail): int8 packed, pipelined over 3 units, async at staleness 1 with
    20% straggler deadlines, per-leaf, and plan A packed under burst loss.
    Payload bytes exact (on async, the launch is the reference's encode of
    the port's own retired shadow, whose bytes may differ from the
    reference's launch in MAX_FLY_OFF of them: hazard 4); x_tilde, m_agg
    and x_next within STATE_ULPS per step; delivered bytes, delivered
    fraction, deadline misses, overflow, wire bytes and collectives equal
    (the residual norm, summed in another order, within 1e-5).
  * The trainer's ``--link-loss``, ``--loss-seed``, ``--link-loss-model``,
    ``--resync-retries``, ``--straggle`` and ``--straggle-seed`` on
    ``--reduced --device cpu``.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as JF
from repro_torch.configs import get_config, reduced
from repro_torch.core import faults as F
from repro_torch.core import prng
from repro_torch.core import tree as T
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.launch import train
from repro_torch.models import transformer as TF
from repro_torch.models.params import meta_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, STEPS, STATE_ULPS = 5, 5, 2
PLAN_A = "mixed:norm=int4,embed=int4,*=int8"
#: the lossy time-varying ring every runtime case starts from
LOSSY = dict(ring_strides=(1, 2), schedule_period=2, link_loss=0.2,
             loss_seed=1, resync_retries=1)
SEEDS = [0, 1, 7, 2**31 - 1, 2**32 + 5, -3]


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
# the counter-based PRNG
# ---------------------------------------------------------------------------

def _jkey(seed, *data):
    k = jax.random.PRNGKey(seed)
    for d in data:
        k = jax.random.fold_in(k, jnp.int32(d))
    return k


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_equals_jax_random(seed):
    assert prng.prng_key(seed) == tuple(
        int(v) for v in np.asarray(jax.random.PRNGKey(seed)))
    for data in ((0,), (3, 1, 2), (2**31 - 1, 0, 4), (-2**31, 7),
                 (123456789, 1, 99999)):
        want = _jkey(seed, *data)
        assert prng.fold_chain(seed, *data) == tuple(
            int(v) for v in np.asarray(want))
        for shape in ((), (64, 2), (7,), (3, 5, 2)):
            got = prng.uniform(prng.fold_chain(seed, *data), shape)
            assert got.dtype == np.float32 and got.shape == shape
            assert got.tobytes() == np.asarray(
                jax.random.uniform(want, shape)).tobytes(), (data, shape)


def test_prng_batched_keys_and_the_documented_draw():
    """A batch of keys draws one uniform per key, each the scalar draw of
    its own key; ``PRNGKey(7)`` folded by 3, 1, 2 draws 0.65273464."""
    base = prng.fold_chain(5, 11)
    keys = prng.fold_in(prng.fold_in(base, np.array([0, 1])[:, None]),
                        np.arange(4)[None, :])
    got = prng.uniform(keys)
    want = np.array([[np.asarray(jax.random.uniform(_jkey(5, 11, d, v)))
                      for v in range(4)] for d in range(2)])
    assert got.shape == (2, 4) and got.tobytes() == want.tobytes()
    assert prng.uniform(prng.fold_chain(7, 3, 1, 2)) == np.float32(
        0.65273464)


# ---------------------------------------------------------------------------
# the fault models' host masks
# ---------------------------------------------------------------------------

STEPS_MASK = [0, 1, 17, 2**31 - 1]


@pytest.mark.parametrize("seed", [0, 2**31 - 1, -7])
@pytest.mark.parametrize("rate", [0.0, 0.2, 0.6])
def test_bernoulli_and_straggler_masks_equal_reference(seed, rate):
    for cls in ("LossModel", "StragglerModel"):
        got = getattr(F, cls)(rate, seed)
        want = getattr(JF, cls)(rate, seed)
        np.testing.assert_array_equal(got.keep_mask_host(N, STEPS_MASK),
                                      want.keep_mask_host(N, STEPS_MASK))
        np.testing.assert_array_equal(
            got.keep_mask_host(3, [4, 9], directions=1),
            want.keep_mask_host(3, [4, 9], directions=1))
        for retries in (1, 3):
            np.testing.assert_array_equal(
                got.resync_keep_host(N, [3, 5], retries),
                want.resync_keep_host(N, [3, 5], retries))
        assert got.keep(9, 1, 2) == bool(want.keep(9, 1, 2))
        assert got.resync_keep(3, 4, 2) == tuple(
            bool(v) for v in want.resync_keep(3, 4, 2))
        assert got.describe() == want.describe()
        assert got.expected_delivered_frac() == \
            want.expected_delivered_frac()


def test_loss_and_straggler_draws_are_independent():
    loss = F.LossModel(0.5, 3).keep_mask_host(N, range(1, 40))
    late = F.StragglerModel(0.5, 3).keep_mask_host(N, range(1, 40))
    assert not np.array_equal(loss, late)


@pytest.mark.parametrize("spec", [dict(p=0.1, r=0.9), dict(p=0.3, r=0.2),
                                  dict(p=0.5, r=0.5, h=0.7, g=0.05)])
def test_gilbert_table_equals_reference(spec):
    got = F.GilbertElliottLoss(seed=4, n_nodes=N, horizon=64, **spec)
    want = JF.GilbertElliottLoss(seed=4, n_nodes=N, horizon=64, **spec)
    np.testing.assert_array_equal(got._keep_table, want._keep_table)
    steps = [1, 2, 63, 64, 65, 200]
    np.testing.assert_array_equal(got.keep_mask_host(N, steps),
                                  want.keep_mask_host(N, steps))
    np.testing.assert_array_equal(got.resync_keep_host(N, [3, 5], 2),
                                  want.resync_keep_host(N, [3, 5], 2))
    assert got.keep(65, 1, 3) == bool(want.keep(65, 1, 3))
    assert got.describe() == want.describe()
    with pytest.raises(ValueError, match="n_nodes"):
        got.keep_mask_host(N + 1, [1])


@pytest.mark.parametrize("rates", [(0.3, 0.5), (0.6, 0.2), (0.0, 1.0)])
def test_node_failure_masks_equal_reference(rates):
    for seed in (0, 9):
        got = F.NodeFailureModel(*rates, seed=seed, min_active=3)
        want = JF.NodeFailureModel(*rates, seed=seed, min_active=3)
        np.testing.assert_array_equal(got.active_mask_host(6, 12),
                                      want.active_mask_host(6, 12))


SPECS = ["bernoulli", " gilbert:p=0.1,r=0.9 ", "gilbert:p=0.2,r=0.5,h=0.8",
         "gilbert:r=0.5,p=0.2,g=0.1", "gilbert", "gilbert:", "gilbert:p=0.1",
         "gilbert:p=0.1,r=x", "gilbert:p=0.1,q=0.2", "markov:p=0.1,r=0.2",
         "gilbert:p=0.1,r"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_loss_spec_equals_reference(spec):
    try:
        want = JF.parse_loss_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            F.parse_loss_spec(spec)
        assert str(got.value) == str(e)
        return
    assert F.parse_loss_spec(spec) == want


@pytest.mark.parametrize("ctor", [
    lambda m: m.LossModel(1.0), lambda m: m.LossModel(-0.1),
    lambda m: m.GilbertElliottLoss(p=0.0, r=0.5, n_nodes=2),
    lambda m: m.GilbertElliottLoss(p=0.1, r=1.5, n_nodes=2),
    lambda m: m.GilbertElliottLoss(p=0.1, r=0.5, h=2.0, n_nodes=2),
    lambda m: m.GilbertElliottLoss(p=0.1, r=0.5),
    lambda m: m.GilbertElliottLoss(p=0.1, r=0.5, n_nodes=2, horizon=0),
    lambda m: m.NodeFailureModel(1.0), lambda m: m.NodeFailureModel(0.1, 2.0),
    lambda m: m.NodeFailureModel(0.1, min_active=1),
    lambda m: m.LossModel(0.1).resync_keep(1, 0, 0),
    lambda m: m.NodeFailureModel(0.1, min_active=4).active_mask_host(3, 2)])
def test_fault_models_refuse_what_the_reference_refuses(ctor):
    with pytest.raises(ValueError) as want:
        ctor(JF)
    with pytest.raises(ValueError) as got:
        ctor(F)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# ConsensusConfig
# ---------------------------------------------------------------------------

BAD_CONFIGS = [
    dict(topology="star"), dict(topology="directed-ring", push_sum=False),
    dict(forward_weight=0.1), dict(topology="directed-ring",
                                   forward_weight=0.5),
    dict(link_loss=1.0), dict(link_loss_model="markov"),
    dict(link_loss=0.1, link_loss_model="gilbert:p=0.1,r=0.5"),
    dict(resync_retries=0), dict(straggle_rate=0.1),
    dict(wire_packing="async", staleness=1, straggle_rate=1.5),
    dict(wire_packing="async", staleness=0, straggle_rate=0.1),
    dict(algorithm="dgd", link_loss=0.1),
    dict(algorithm="compressed_dgd", topology="directed-ring"),
    dict(algorithm="dgd", push_sum=True)]


@pytest.mark.parametrize("kw", BAD_CONFIGS,
                         ids=[",".join(f"{k}={v}" for k, v in c.items())
                              for c in BAD_CONFIGS])
def test_config_refuses_what_the_reference_refuses(kw):
    from repro.core.distributed import ConsensusConfig as JCfg
    with pytest.raises(ValueError) as want:
        JCfg(**kw)
    with pytest.raises(ValueError) as got:
        ConsensusConfig(**kw)
    assert str(got.value) == str(want.value)


def test_config_helpers_equal_reference():
    from repro.core.distributed import ConsensusConfig as JCfg
    for kw in (dict(), dict(topology="directed-ring"),
               dict(topology="directed-ring", forward_weight=0.1,
                    self_weight=0.4),
               dict(push_sum=True), dict(link_loss=0.0),
               dict(link_loss_model="gilbert:p=0.1,r=0.9"),
               dict(wire_packing="async", straggle_rate=0.2)):
        got, want = ConsensusConfig(**kw), JCfg(**kw)
        assert got.in_weights == want.in_weights
        assert got.push_sum_enabled == want.push_sum_enabled
        assert got.loss_enabled == want.loss_enabled
        assert got.faults_enabled == want.faults_enabled
        gm, wm = got.loss_model_for(N), want.loss_model_for(N)
        assert (gm is None) == (wm is None)
        if gm is not None:
            assert gm.describe() == wm.describe()
        assert (got.straggler_model is None) == (want.straggler_model
                                                 is None)


MEMBERSHIP_CONFIGS = [
    dict(membership=((True, True, True),)),
    dict(membership=((True, True, False, True), (True,) * 4),
         wire_packing="async"),
    dict(hierarchy=2), dict(hierarchy="pods=3"),
    dict(hierarchy=2, membership=((True, False, True),)),
    dict(membership=()), dict(membership=((True, False, False),)),
    dict(membership=((True, True), (True, True, True))),
    dict(membership=[(True, True)]),
    dict(membership=((True, True),), wire_packing="per_leaf"),
    dict(membership=((True, True),), push_sum=True),
    dict(membership=((True, True),), topology="directed-ring"),
    dict(membership=((True, True),), algorithm="dgd"),
    dict(hierarchy=2, algorithm="allreduce"),
    dict(hierarchy=2, topology="directed-ring"),
    dict(hierarchy=2, push_sum=True),
    dict(hierarchy=2, wire_packing="per_leaf"),
    dict(hierarchy="rings=2"), dict(hierarchy=0)]


def test_membership_and_hierarchy_not_yet_ported():
    """Membership and hierarchy are ported: ``ConsensusConfig`` accepts
    what the reference accepts (the spec normalized alike) and refuses
    what it refuses, with the same exception class and message; so do
    ``MembershipSchedule`` and the runtime's pod and mask checks."""
    from repro.core import topology as JT
    from repro.core.distributed import ConsensusConfig as JCfg
    from repro_torch.core import topology
    for kw in MEMBERSHIP_CONFIGS:
        try:
            want = JCfg(**kw)
        except Exception as e:          # noqa: BLE001 - compared below
            with pytest.raises(type(e)) as got:
                ConsensusConfig(**kw)
            assert str(got.value) == str(e), kw
            continue
        got = ConsensusConfig(**kw)
        assert got.membership == want.membership, kw
        assert (got.hierarchy is None) == (want.hierarchy is None), kw
        if got.hierarchy is not None:
            assert got.hierarchy.pods == want.hierarchy.pods
        assert got.schedule_varying == want.schedule_varying, kw
    for args in [(((True, True),),), (((True, False),),),
                 (((True, True), (True, True, True)),), ((),)]:
        try:
            want = JT.MembershipSchedule(*args)
        except Exception as e:          # noqa: BLE001 - compared below
            with pytest.raises(type(e)) as got:
                topology.MembershipSchedule(*args)
            assert str(got.value) == str(e)
            continue
        assert topology.MembershipSchedule(*args).masks == want.masks
    for spec, n in (("9@1:2", 4), ("1@2:2", 4), ("1-2", 4), (";", 4),
                    ("1@1:2", 4), ("0@0:3;3@1:2", 4)):
        try:
            want = JT.MembershipSchedule.from_spec(spec, n)
        except Exception as e:          # noqa: BLE001 - compared below
            with pytest.raises(type(e)) as got:
                topology.MembershipSchedule.from_spec(spec, n)
            assert str(got.value) == str(e)
            continue
        assert topology.MembershipSchedule.from_spec(spec, n).masks == \
            want.masks
    with pytest.raises(ValueError, match="does not divide"):
        ConsensusRuntime(ConsensusConfig(hierarchy=3), 4)
    with pytest.raises(ValueError, match="covers 4 ring elements"):
        ConsensusRuntime(ConsensusConfig(hierarchy=2,
                                         membership=((True,) * 4,)), 4)


# ---------------------------------------------------------------------------
# the port's exchange alone
# ---------------------------------------------------------------------------

def _template():
    return meta_params(TF.build_defs(reduced(get_config("smollm-135m")))
                       .storage)


def _x0(n=N):
    """Every node's identical start, drawn with numpy."""
    rng = np.random.default_rng(0)
    return T.tree_map(lambda a: torch.from_numpy(np.broadcast_to(
        (rng.standard_normal(a.shape) * 0.05).astype(np.float32),
        (n,) + a.shape).copy()), _template())


def _delta(k, n=N):
    """Step k's optimizer delta per node; a few entries saturate the
    fixed grid."""
    r = np.random.default_rng([1, k])

    def one(a):
        d = (r.standard_normal((n,) + a.shape) * 2e-3).astype(np.float32)
        d.reshape(-1)[::997] *= 300.0
        return torch.from_numpy(d)
    return T.tree_map(one, _template())


def run_port(steps, n=N, **kw):
    """``steps`` exchanges from x0 with the same deltas and noise seeds:
    (final params, state, metrics per step, runtime)."""
    rt = ConsensusRuntime(ConsensusConfig(**kw), n)
    x = _x0(n)
    state = rt.init_state(x)
    hist = []
    for k in range(1, steps + 1):
        xh = T.tree_map(torch.add, x, _delta(k, n))
        x, state, m = rt.exchange(x, xh, state, k, seed=5)
        hist.append({key: (v.tolist() if torch.is_tensor(v) else v)
                     for key, v in m.items()})
    return x, state, hist, rt


def same_run(a, b, keys=("x_tilde", "m_agg")):
    return (all(torch.equal(p, q) for p, q in zip(T.tree_leaves(a[0]),
                                                   T.tree_leaves(b[0])))
            and all(torch.equal(a[1][k], b[1][k]) for k in keys))


def test_zero_loss_is_bitwise_lossless():
    """``link_loss=0.0`` runs the loss machinery (and the resync draws)
    and gives exactly the bits of ``None``; it adds the delivered
    metrics, all at full delivery."""
    base = dict(ring_strides=(1, 2), schedule_period=2)
    for extra in ({}, {"wire_packing": "async"},
                  {"wire_packing": "per_leaf"}):
        none = run_port(3, **base, **extra)
        zero = run_port(3, link_loss=0.0, **base, **extra)
        assert same_run(none, zero), extra
        assert zero[3].zero_payloads == 0
        assert all(h["delivered_frac"] == [1.0] * N for h in zero[2])
        assert "delivered_frac" not in none[2][0]


def test_transports_equal_bitwise_under_loss():
    """packed == pipelined (3 units) == async at staleness 0 == per-leaf
    under 20% loss with failing resyncs, and every transport reads one
    zero payload per dropped arrival per transfer unit."""
    runs = {"packed": run_port(STEPS, **LOSSY),
            "pipelined3": run_port(STEPS, wire_packing="pipelined",
                                   pipeline_chunks=3, **LOSSY),
            "async0": run_port(STEPS, wire_packing="async", staleness=0,
                               **LOSSY),
            "per_leaf": run_port(STEPS, wire_packing="per_leaf", **LOSSY)}
    base = runs["packed"]
    mask = F.LossModel(0.2, 1).keep_mask_host(N, range(1, STEPS + 1))
    drops = int((~mask).sum())
    assert drops > 0
    layout = base[3].state_layout(_x0())
    for name, r in runs.items():
        assert same_run(base, r), name
        assert [h["delivered_frac"] for h in r[2]] == \
            (mask.sum(axis=1) / 2.0).tolist(), name
        units = {"pipelined3": r[3].pipeline_chunks_for(layout),
                 "per_leaf": layout.n_leaves}.get(name, 1)
        assert r[3].zero_payloads == units * drops, name


# ---------------------------------------------------------------------------
# against the reference's ConsensusRuntime
# ---------------------------------------------------------------------------

#: the reference-side runner: runs ``__CASES__`` (label, ConsensusConfig
#: keywords) at ``__N__`` nodes for ``__STEPS__`` steps on both runtimes
BODY = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=__N__"
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
N, STEPS = __N__, __STEPS__
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
tt = lambda tree: T.tree_map(torch.from_numpy, tree)
out = {}
for label, kw in __CASES__:
    jrt = JRt(JCfg(**kw), ctx)
    rt = ConsensusRuntime(ConsensusConfig(**kw), N)
    cfg = rt.cfg
    packing = cfg.wire_packing
    push = cfg.push_sum_enabled
    jlayout = jrt.state_layout(jax.tree.map(lambda a: a[0], x0))
    layout = rt.state_layout(tt(x0))
    plan = rt.wire_plan_for(layout)
    jplan = jrt.wire_plan_for(jlayout)
    keys = (["x_tilde", "m_agg"] + (["ps_w", "ps_nbr"] if push else [])
            + (["fly_self", "fly_up", "fly_dn"] if packing == "async"
               else []))
    mkeys = (["overflow_frac", "residual_norm"]
             + (["push_sum_weight"] if push else [])
             + (["wire_bytes_delivered", "delivered_frac"]
                if cfg.faults_enabled else [])
             + (["deadline_miss_frac"] if cfg.straggle_rate is not None
                else []))
    cspec = {k: (P("data", None, None) if k in ("x_tilde", "m_agg")
                 else P("data", None)) for k in keys}
    mspec = {k: P("data") for k in mkeys}
    init_f = jax.jit(shard_map_compat(
        lambda p: jax.tree.map(lambda a: a[None], jrt.init_state(p)),
        mesh, in_specs=(pspec,), out_specs=cspec, check=False))
    def jstep(xp, xh, s, k, nz):
        s = jax.tree.map(lambda a: a[0], s)
        xn, s2, m = jrt.exchange(xp, xh, s, k, jax.random.PRNGKey(7),
                                 noise=nz[0])
        return (xn, jax.tree.map(lambda a: a[None], s2),
                {k2: m[k2][None] for k2 in mkeys})
    step_f = jax.jit(shard_map_compat(
        jstep, mesh, in_specs=(pspec, pspec, cspec, P(), P("data")),
        out_specs=(pspec, cspec, mspec), check=False))
    sent = []
    encode = rt._encode_unit
    def spy(*a, **k):
        pays = encode(*a, **k)
        sent.append([p.clone() for p in pays])
        return pays
    rt._encode_unit = spy
    js = init_f(x0)
    res = {"payload_equal": [], "ulps": [], "metrics_equal": [],
           "weights_equal": [], "init_equal": None,
           "layout": [layout.placement == jlayout.placement,
                      plan.payload_bytes == jplan.payload_bytes]}
    tinit = rt.init_state(tt(x0))
    res["init_equal"] = sorted(tinit) == sorted(keys) and all(
        np.array_equal(tinit[k].numpy(), np.asarray(js[k])) for k in keys)
    x_prev = x0
    for k in range(1, STEPS + 1):
        xp, xh = x_prev, jax.tree.map(np.add, x_prev, delta(k))
        nz = np.random.default_rng([2, k]).random(
            (N, layout.n_rows, plan.noise_cols()), dtype=np.float32)
        synced = consensus_state_from_jax(
            {key: np.asarray(v) for key, v in js.items()}, N, device="cpu")
        step_k = jrt._step_k(jnp.asarray(k, jnp.int32))
        jxn, js, jm = step_f(xp, xh, js, jnp.asarray(k, jnp.int32), nz)
        del sent[:]
        txn, ts, tm = rt.exchange(tt(xp), tt(xh), synced, k,
                                  noise=torch.from_numpy(nz))
        x_prev = jax.tree.map(np.asarray, jxn)
        if packing == "async":
            # the launched payload encodes against the port's own retired
            # shadow (within ulps of the reference's, hazard 4): its bytes
            # are the reference's encode of that differential, and the ring
            # hands node i the payloads of i - s and i + s
            fly = ts["fly_self"].numpy()
            ps = ts["ps_w"].numpy() if push else None
            same = True
            for i in range(N):
                xh_i = jlayout.pack(jax.tree.map(lambda a: a[i], xh))
                if push:
                    xh_i = xh_i * ps[i, 0]
                want = np.asarray(jplan.encode(
                    xh_i - ts["x_tilde"][i].numpy(), jnp.asarray(nz[i]),
                    fixed_step=step_k))
                if push:
                    want = np.concatenate([want, ps[i].view(np.uint8)])
                st = rt.stride_at(k)
                same = (same and np.array_equal(fly[i], want)
                        and np.array_equal(ts["fly_up"][i].numpy(),
                                           fly[(i - st) % N])
                        and np.array_equal(ts["fly_dn"][i].numpy(),
                                           fly[(i + st) % N]))
            res.setdefault("fly_off", []).append(
                float((fly != np.asarray(js["fly_self"])).mean()))
        elif packing != "per_leaf":
            # the bytes each node put on the wire: its units' payloads in
            # order, the push-sum trailer on the last
            ps = synced["ps_w"].numpy() if push else None
            same = True
            for i in range(N):
                xh_i = jlayout.pack(jax.tree.map(lambda a: a[i], xh))
                if push:
                    xh_i = xh_i * ps[i, 0]
                want = np.asarray(jplan.encode(
                    xh_i - synced["x_tilde"][i].numpy(), jnp.asarray(nz[i]),
                    fixed_step=step_k))
                if push:
                    want = np.concatenate([want, ps[i].view(np.uint8)])
                got = np.concatenate([u[i].numpy() for u in sent])
                same = same and np.array_equal(got, want)
        else:
            same = True     # held through x_next: a code off is a grid step
        res["payload_equal"].append(bool(same))
        u = [max(ulps(a, b) for a, b in zip(
            T.tree_leaves(txn), jax.tree_util.tree_leaves(jxn))),
             ulps(ts["x_tilde"], js["x_tilde"]),
             ulps(ts["m_agg"], js["m_agg"])]
        res["ulps"].append(u)
        if push:
            res["weights_equal"].append(all(
                np.array_equal(ts[key].numpy(), np.asarray(js[key]))
                for key in ("ps_w", "ps_nbr")))
        # the residual norm sums in another order: held to 1e-5 relative
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
    if jrt.loss is not None:
        res["drops_by_step"] = (~jrt.loss.keep_mask_host(
            N, np.arange(STEPS + 1))).sum(axis=(1, 2)).tolist()
        res["resync_ok"] = jrt.loss.resync_keep_host(
            N, [3, 5], cfg.resync_retries).all(axis=1).tolist()
    if jrt.straggler is not None:
        res["late_by_step"] = (~jrt.straggler.keep_mask_host(
            N, np.arange(STEPS + 1))).tolist()
        res["lost_by_step"] = (~jrt.loss.keep_mask_host(
            N, np.arange(STEPS + 1))).tolist()
    res["units"] = (layout.n_leaves if packing == "per_leaf"
                    else rt.pipeline_chunks_for(layout))
    out[label] = res
print("RESULT " + json.dumps(out))
"""


def reference_results(n, cases, steps=STEPS):
    """Run ``cases`` on both runtimes in one subprocess with ``n`` host
    devices: the per-case result dicts of ``BODY``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    body = (BODY.replace("__N__", str(n)).replace("__STEPS__", str(steps))
            .replace("__CASES__", repr(cases)))
    proc = subprocess.run([sys.executable, "-c", body], capture_output=True,
                          text=True, timeout=900, env=env, cwd=REPO)
    if proc.returncode != 0:
        raise AssertionError(f"subprocess failed:\n{proc.stderr[-4000:]}")
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise AssertionError(f"no RESULT line:\n{proc.stdout[-2000:]}")


#: (label, ConsensusConfig keywords)
CASES = [("int8/packed", dict(LOSSY)),
         ("int8/pipelined3", dict(LOSSY, wire_packing="pipelined",
                                  pipeline_chunks=3)),
         ("int8/async1+straggle", dict(LOSSY, wire_packing="async",
                                       straggle_rate=0.2, straggle_seed=3)),
         ("int8/per_leaf", dict(LOSSY, wire_packing="per_leaf")),
         ("planA/packed/gilbert", dict(
             LOSSY, wire_codec=PLAN_A, link_loss=None,
             link_loss_model="gilbert:p=0.1,r=0.9"))]
LABELS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def reference():
    return reference_results(N, CASES)


#: largest share of an async payload's bytes that may differ from the
#: reference's: the launch encodes against the port's retired shadow,
#: within an ulp of the reference's (ROADMAP Queue 3, hazard 4), and an
#: ulp can move a stochastic rounding
MAX_FLY_OFF = 1e-5


def check_reference_case(r, steps=STEPS):
    """The shared contract of one case of ``BODY``."""
    assert r["layout"] == [True, True]
    assert r["init_equal"]
    assert r["payload_equal"] == [True] * steps
    assert max(r.get("fly_off", [0.0])) <= MAX_FLY_OFF, r["fly_off"]
    for step, u in enumerate(r["ulps"]):
        assert max(u) <= STATE_ULPS, (step + 1, u)
    assert all(r["weights_equal"])
    for step, m in enumerate(r["metrics_equal"]):
        assert all(m.values()), (step + 1, m)
    assert r["wire"][0] == r["wire"][1] > 0
    assert r["collectives"][0] == r["collectives"][1]


@pytest.mark.parametrize("label", LABELS)
def test_reference_exchange_under_loss(reference, label):
    check_reference_case(reference[label])


def test_reference_cases_exercise_drops_and_failed_resyncs(reference):
    """At loss 0.2 with one retry some payloads drop and some resync
    handshakes fail (and some succeed), and each transport read exactly
    one zero payload per drop per transfer unit: eager transports the
    drops of steps 1..5, async those of the launch steps 0..4 with the
    missed deadlines."""
    r = reference["int8/packed"]
    ok = np.array(r["resync_ok"])
    assert ok.any() and not ok.all()
    for label in ("int8/packed", "int8/pipelined3", "int8/per_leaf"):
        r = reference[label]
        assert r["zero_payloads"] == r["units"] * sum(
            r["drops_by_step"][1:])
    r = reference["int8/async1+straggle"]
    lost = np.array(r["lost_by_step"])[:STEPS]
    late = np.array(r["late_by_step"])[:STEPS]
    assert late.any()
    assert r["zero_payloads"] == int((lost | late).sum())
    assert reference["planA/packed/gilbert"]["zero_payloads"] > 0


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_trainer_fault_flags(capsys):
    hist = train.main(["--reduced", "--device", "cpu", "--nodes", str(N),
                       "--batch", "10", "--seq", "32", "--steps", "4",
                       "--ring-strides", "1,2", "--schedule-period", "2",
                       "--link-loss", "0.2", "--loss-seed", "1",
                       "--resync-retries", "1"])
    assert all(math.isfinite(h["loss"]) for h in hist)
    mask = F.LossModel(0.2, 1).keep_mask_host(N, range(1, 5))
    assert [h["delivered_frac"] for h in hist] == pytest.approx(
        (mask.sum(axis=1) / 2.0).mean(axis=1).tolist())
    assert "delivered_frac=" in capsys.readouterr().out
    hist = train.main(["--reduced", "--device", "cpu", "--nodes", "4",
                       "--batch", "8", "--seq", "32", "--steps", "3",
                       "--wire-packing", "async", "--straggle", "0.3",
                       "--straggle-seed", "2", "--link-loss-model",
                       "gilbert:p=0.1,r=0.9"])
    assert all(math.isfinite(h["loss"]) for h in hist)
    assert all("deadline_miss_frac" in h for h in hist)
    for argv in (["--link-loss", "1.5"], ["--straggle", "0.1"],
                 ["--link-loss-model", "markov"],
                 ["--link-loss", "0.1", "--link-loss-model",
                  "gilbert:p=0.1,r=0.9"],
                 ["--resync-retries", "0"]):
        with pytest.raises((SystemExit, ValueError)):
            train.main(["--reduced", "--device", "cpu", "--nodes", "4",
                        "--batch", "8", "--steps", "1", *argv])
