"""Elastic membership, the two-level hierarchy and ``--checkpoint-dir`` over
processes: each node a rank of a gloo group.

A rank must compute the stacked runtime's row bit for bit under every
membership schedule and pod count (``tests/torch_ring_elastic_work.py``
holds the ranks' work; every tensor is compared through the SHA-1 of its
bytes).  Held here, on the CPU, on reduced smollm-135m:

* 11 exchanges on 4 ranks and 2 on 6, 3 steps each: the two options the
  process ring once refused, under the names it refused them by
  ("membership": the churn masks of ``test_torch_membership.py`` re-wired
  every step, the hole at step 2, the rejoin at step 3, resyncs at both,
  on the packed transport; "hierarchy": pods of 2, packed); the churn
  masks on pipelined over 3 units, async at staleness 0 and 1 and under
  the burst channel; pods of 2 on pipelined, async s1 and plan B; pods 4
  (the flat ring) and 1 (the all-reduce); pods of 3 on 6 ranks and pods
  of 2 on 6 ranks under a pod mask.  Each rank's x_next, state, metrics, payloads and zero payloads
  against the stacked rows; every arrival against what the rank's peers
  sent (the peers against the stacked wiring: member j of the neighbouring
  pods); the bytes each transfer kind sent against the static accounting
  (an inactive rank 0 bytes, the inner level at m > 2 ``m / 2`` times its
  ring all-reduce model: ROADMAP hazard 56); an inactive rank's parameters
  and shadows bitwise through its hole, and on the async transport its
  zero payloads;
* a rank that skips a slot for an epoch and then uses it (the gloo tags
  derive from the transfer's key);
* the ranks against the JAX reference through ``test_torch_membership.
  py``'s harness (``ConsensusRuntime`` under ``shard_map``, which dumps its
  outputs per step for them): one case of that file (churn, async s1) and
  one of ``test_torch_hierarchy.py`` (pods 2 of 4, packed), at those files'
  tolerances, the ranks' peers against the reference's ring permutations;
* the reference's own refusals (membership or hierarchy with the per-leaf
  transport, push-sum or the directed ring) raise on the ring with its
  messages;
* the 4-rank trainer CLI with ``--checkpoint-dir`` (packed, async s1):
  the file byte for byte the stacked trainer's, each rank's rows loaded
  back bitwise, the stacked file loaded onto the ring; the trainer with
  ``--wire-codec adaptive`` (a codec switch mid-run), ``--microbatches 2``,
  ``--compute-dtype bfloat16`` and ``--telemetry`` (one sink per rank)
  against the stacked trainer bitwise;
* ``python -m torch.distributed.run --nproc-per-node 4 -m
  repro_torch.launch.train --process-ring`` with ``--node-failures`` and
  with ``--hierarchy pods=2`` against the stacked CLI.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import concurrent.futures
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import torch_ring_elastic_work as E
import torch_ring_work as W
from test_torch_hierarchy import CASES as HIER_CASES
from test_torch_hierarchy import STATE_ULPS as HIER_ULPS
from test_torch_membership import BODY as MEMBERSHIP_BODY
from test_torch_membership import CASES as MEMBERSHIP_CASES
from test_torch_membership import CHURN, MAX_FLY_OFF
from test_torch_membership import STATE_ULPS as MEMBERSHIP_ULPS
from test_torch_membership import STEPS as MEMBERSHIP_STEPS
from test_torch_ring import _step_lines

from repro.core.distributed import ConsensusConfig as JConfig
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.launch import train
from repro_torch.launch.mesh import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = {4: E.EXCHANGES4, 6: E.EXCHANGES6}
NAMES = [name for table in GROUPS.values() for name in table]
SIZE = {name: n for n, table in GROUPS.items() for name in table}
KW = {name: kw for table in GROUPS.values() for name, kw in table.items()}
MEMBERSHIP = [name for name in NAMES if "membership" in KW[name]]
ASYNC_S1 = [name for name in NAMES
            if KW[name].get("wire_packing") == "async"
            and KW[name].get("staleness", 1) == 1]
assert E.CHURN == CHURN

# ---- the reference cases, each with its file's state tolerance -------------
#: (label, ConsensusConfig keywords, STATE_ULPS of its file): 4 nodes each
REFERENCE = [
    (label, kw, ulps) for cases, want, ulps in (
        (MEMBERSHIP_CASES, "churn/async1", MEMBERSHIP_ULPS),
        (HIER_CASES, "pods2of4/packed", HIER_ULPS))
    for label, n, kw in cases if label == want and n == 4]
assert len(REFERENCE) == 2
REF_LABELS = [c[0] for c in REFERENCE]
REF_STEPS = MEMBERSHIP_STEPS

#: the reference's refusals the ring keeps (membership or hierarchy with
#: the per-leaf transport, push-sum or the directed ring)
REFUSALS = {f"{what} {how}": dict(opt, **extra)
            for what, opt in (("membership", dict(membership=(
                (True,) * 4, (True, False, True, True)))),
                              ("hierarchy", dict(hierarchy=2)))
            for how, extra in (("per_leaf", dict(wire_packing="per_leaf")),
                               ("push-sum", dict(push_sum=True)),
                               ("directed", dict(topology="directed-ring")))}

#: written into the membership harness after each reference step: its
#: outputs, its ring permutations of the step, and on a packed wire each
#: node's payload as the reference encodes it (from the pod mean)
_DUMP = r"""
        _d = {f"x{i}": np.asarray(a) for i, a in
              enumerate(jax.tree_util.tree_leaves(jxn))}
        _d.update({"s_" + key: np.asarray(v) for key, v in js.items()})
        _d.update({"m_" + key: np.asarray(v) for key, v in jm.items()})
        for _key, _s in (("perm_up", 1), ("perm_dn", -1)):
            _d[_key] = np.asarray(JD._flat_ring_perm_masked(
                ctx, _s * rt.stride_at(k), rt.mask_at(k), group=m))
        if packing != "async":
            _xh = (xh if pod_f is None
                   else jax.tree.map(np.asarray, pod_f(xp, xh)))
            _d["pay"] = np.stack([np.asarray(jplan.encode(
                jlayout.pack(jax.tree.map(lambda a: a[i], _xh))
                - synced["x_tilde"][i].numpy(), jnp.asarray(nz[i]),
                fixed_step=step_k)) for i in range(N)])
        np.savez(os.path.join(__DUMP__, label.replace("/", "_")
                              + f"-{k}.npz"), **_d)
"""
_STEP_LINE = ("        jxn, js, jm = step_f(xp, xh, js, "
              "jnp.asarray(k, jnp.int32), nz)\n")
assert MEMBERSHIP_BODY.count(_STEP_LINE) == 1


def _reference_runner(dump: str) -> str:
    body = (MEMBERSHIP_BODY.replace(_STEP_LINE, _STEP_LINE + _DUMP)
            .replace("__DUMP__", repr(dump))
            .replace("__DEV__", "4")
            .replace("__STEPS__", str(REF_STEPS))
            .replace("__CASES__", repr([(label, 4, kw) for label, kw, _ in
                                        REFERENCE])))
    done, failed = (os.path.join(dump, n) for n in ("DONE", "FAILED"))
    return ("import traceback\n"
            "try:\n"
            f"    exec(compile({body!r}, 'reference', 'exec'))\n"
            "except BaseException:\n"
            f"    open({failed!r}, 'w').write(traceback.format_exc())\n"
            "    raise\n"
            f"open({done!r}, 'w').close()\n")


# ---- fixtures --------------------------------------------------------------
def _stacked_runs(ckpt_dirs: dict, done: str, tel_dir: str) -> dict:
    """Every stacked counterpart (in a thread of the test process while the
    ranks run): the checkpointed trainers first (their files are what the
    ranks load last), then the exchanges, the flat ring and the all-reduce
    that pods 4 and 1 must equal, and the flags trainer."""
    try:
        out = {"ckpt": {name: E.ckpt_run(extra, ckpt_dirs[name])
                        for name, extra in E.CKPT_RUNS.items()}}
    except BaseException:
        open(done + ".failed", "w").close()
        raise
    open(done, "w").close()
    out["exchanges"] = {name: E.run_exchanges(KW[name], SIZE[name])
                        for name in NAMES}
    out["flat"] = E.run_exchanges({}, 4)
    out["allreduce"] = E.run_exchanges(dict(algorithm="allreduce"), 4)
    out["flags"] = E.flags_run(tel_dir)
    return out


@pytest.fixture(scope="module")
def groups():
    """The 4-rank group (beside it the reference in its own subprocess,
    dumping for the ranks' last phase), then the 6-rank group; meanwhile
    the stacked runs (``groups["stacked"]``).  Everything written lies in
    a temporary directory removed when the groups are done."""
    with tempfile.TemporaryDirectory(prefix="ring-elastic-") as tmp:
        return _groups(tmp)


def _groups(tmp: str) -> dict:
    dump = os.path.join(tmp, "reference")
    os.makedirs(dump)
    ckpt_dirs = {how: {name: os.path.join(tmp, f"{how}-{name}")
                       for name in E.CKPT_RUNS}
                 for how in ("stacked", "ring")}
    done = os.path.join(tmp, "stacked-done")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _reference_runner(dump)],
                            env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        stacked = pool.submit(_stacked_runs, ckpt_dirs["stacked"], done,
                              os.path.join(tmp, "tel-stacked"))
        try:
            out = {4: run_ranks(E.ring4_work, 4, ckpt_dirs, done,
                                os.path.join(tmp, "tel-ring"), dump,
                                [c[:2] for c in REFERENCE], REF_STEPS,
                                list(REFUSALS.items()), timeout_s=900)}
            _, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"the reference failed:\n{err[-4000:]}")
        out[6] = run_ranks(E.ring6_work, 6, timeout_s=600)
        out["stacked"] = stacked.result(timeout=600)
    return out


def _ranks(groups, name):
    return [rank["exchanges"][name] for rank in groups[SIZE[name]]]


def _pod_size(name) -> int:
    return ConsensusRuntime(ConsensusConfig(**KW[name]),
                            SIZE[name]).pod_size


# ---- the exchanges ---------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_exchange_equals_stacked_rows(groups, name):
    """Each rank's x_next, state and per-node metrics are the stacked rows;
    each payload it encoded is its element's (its pod's under hierarchy;
    none where the rank is inactive); the ranks read the stacked run's
    zero payloads (each member of a pod its pod's)."""
    want = groups["stacked"]["exchanges"][name]["steps"]
    ranks = _ranks(groups, name)
    m = _pod_size(name)
    for r, rank in enumerate(ranks):
        assert rank["pending"] == 0
        for k, (w, g) in enumerate(zip(want, rank["steps"]), start=1):
            where = f"rank {r}, step {k}"
            assert [x[r] for x in w["x"]] == [x[0] for x in g["x"]], \
                f"x_next, {where}"
            assert w["state"].keys() == g["state"].keys(), where
            for key in w["state"]:
                assert w["state"][key][r] == g["state"][key][0], \
                    f"{key}, {where}"
            assert w["metrics"].keys() == g["metrics"].keys(), where
            for key, v in w["metrics"].items():
                row = [v[r]] if isinstance(v, list) else v
                assert row == g["metrics"][key], f"metric {key}, {where}"
            assert w["static"] == g["static"], where
            assert len(w["pays"]) == len(g["pays"]), where
            for unit, (a, b) in enumerate(zip(w["pays"], g["pays"])):
                assert b == [a[r // m]], f"payload {unit}, {where}"
            assert (w["stride"], w["resync"]) == (g["stride"], g["resync"])
    for k, w in enumerate(want):
        assert sum(rank["steps"][k]["zero"] for rank in ranks) == \
            m * w["zero"]


@pytest.mark.parametrize("name", NAMES)
def test_arrivals_are_the_peers_payloads(groups, name):
    """Every ring transfer delivered rank r what its two peers sent, and the
    peers are the stacked wiring's: member ``r % m`` of the left and right
    elements of the step's (compacted) ring; the pod sum delivered the
    other members' deltas.  The active ranks made the same transfers in
    the same order; an inactive rank made none."""
    ranks = _ranks(groups, name)
    n, m = SIZE[name], _pod_size(name)
    rt = ConsensusRuntime(ConsensusConfig(**KW[name]), n)
    for k in range(W.STEPS):
        wiring = rt.wiring_at(k + 1)
        steps = [rank["steps"][k] for rank in ranks]
        kinds = [[t["kind"] for t in st["transfers"]] for st in steps]
        for r, st in enumerate(steps):
            e, j = divmod(r, m)
            if wiring.left[e] is None:
                assert st["peers"] is None and not st["transfers"], (r, k)
                continue
            assert kinds[r] == kinds[0] and kinds[r], (r, k, kinds)
            left = wiring.left[e] * m + j
            right = wiring.right[e] * m + j
            if KW[name].get("hierarchy") != 1:
                assert st["peers"] == (left, right), (r, k + 1)
            for t, tr in enumerate(st["transfers"]):
                if tr["kind"] == "pod":
                    base = r - j
                    want = [steps[base + (j - q) % m]["transfers"][t]["sent"]
                            for q in range(1, m)]
                elif tr["kind"] == "allreduce":
                    want = [steps[(r - q) % n]["transfers"][t]["sent"]
                            for q in range(1, n)]
                else:
                    want = [steps[left]["transfers"][t]["sent"],
                            steps[right]["transfers"][t]["sent"]]
                assert tr["got"] == want, (r, k + 1, t, tr["kind"])


@pytest.mark.parametrize("name", NAMES)
def test_bytes_sent_are_the_static_accounting(groups, name):
    """An active rank put the static accounting's payload bytes on the ring
    per step, the resync's fp32 shadows apart at resync steps; the inner
    level's deltas are ``HierarchySpec.inner_bytes_per_step`` at m = 2 and
    ``m / 2`` times it at m = 3 (each member receives m - 1 deltas, the
    accounting's ring all-reduce moves 2 (m - 1) / m of one: ROADMAP
    hazard 56); one pod's all-reduce sends ``n / 2`` times its model
    (hazard 49).  An inactive rank sent nothing."""
    n, m = SIZE[name], _pod_size(name)
    rt = ConsensusRuntime(ConsensusConfig(**KW[name]), n)
    x0, _ = W.exchange_inputs(n)
    layout = rt.state_layout(x0)
    acct = rt.wire_accounting(layout.n_elements, layout)
    resync_step = acct.resync_bytes_amortized * rt.cfg.schedule_period
    for rank in _ranks(groups, name):
        for st in rank["steps"]:
            b = dict(st["bytes"])
            if rt.ring_len <= 1:                      # one pod
                assert b == {"allreduce": acct.inner_bytes * n / 2}, b
                continue
            if not st["active"]:
                assert b == {}, b
                continue
            assert b.pop("pod", 0) == acct.inner_bytes * max(m, 2) / 2, b
            assert b.pop("resync", 0) == (resync_step if st["resync"]
                                          else 0), b
            assert sum(b.values()) == acct.shipped_payload, b


@pytest.mark.parametrize("name", MEMBERSHIP)
def test_inactive_rank_keeps_its_state_and_sends_nothing(groups, name):
    """Where a rank's element is out, it encodes nothing, posts nothing
    (``test_arrivals_are_the_peers_payloads``) and comes out with the
    parameters and shadows it went in with, bitwise; its metrics read 0;
    it is out at least once."""
    n, m = SIZE[name], _pod_size(name)
    rt = ConsensusRuntime(ConsensusConfig(**KW[name]), n)
    holes = 0
    for r, rank in enumerate(_ranks(groups, name)):
        for k, st in enumerate(rank["steps"]):
            if rt.wiring_at(k + 1).left[r // m] is not None:
                continue
            holes += 1
            assert k >= 1                   # every run starts whole
            before = rank["steps"][k - 1]
            assert st["x"] == before["x"], (r, k + 1)
            for key in ("x_tilde", "m_agg"):
                assert st["state"][key] == before["state"][key]
            assert all(p == [None] for p in st["pays"])
            assert st["metrics"]["residual_norm"] == [0.0]
            assert st["metrics"]["overflow_frac"] == [0.0]
    assert holes >= m


@pytest.mark.parametrize("name", ASYNC_S1)
def test_async_flight_of_active_and_inactive_ranks(groups, name):
    """On the async transport at staleness 1 an active rank's exchange
    returns with its payload on the wire (the state completes at
    ``land``); an inactive rank posts nothing, and its three in-flight
    payloads are zeros of its own making."""
    n, m = SIZE[name], _pod_size(name)
    rt = ConsensusRuntime(ConsensusConfig(**KW[name]), n)
    x0, _ = W.exchange_inputs(n)
    nbytes = rt.wire_plan_for(rt.state_layout(x0)).payload_bytes
    zero = W._h(torch.zeros(nbytes, dtype=torch.uint8))
    for r, rank in enumerate(_ranks(groups, name)):
        assert rank["pending"] == 0
        for k, st in enumerate(rank["steps"], start=1):
            assert st["landed"]
            if rt.wiring_at(k).left[r // m] is not None:
                assert st["in_flight"], (r, k)
                assert st["missing"] == ["fly_dn", "fly_up"]
                continue
            assert not st["in_flight"] and not st["missing"], (r, k)
            for key in ("fly_self", "fly_up", "fly_dn"):
                assert st["state"][key] == [zero], (r, k, key)


def test_churn_transports_and_degenerate_pods(groups):
    """Over ranks churn packed ("membership") == pipelined == async
    staleness 0 (x_next and shadows); pods 4 is the flat ring and pods 1
    the all-reduce, bit for bit, against the stacked flat and all-reduce
    runs; the burst channel drops payloads."""
    def last(name):
        st = [rank["exchanges"][name]["steps"][-1] for rank in groups[4]]
        return [(s["x"], s["state"]["x_tilde"], s["state"]["m_agg"])
                for s in st]
    assert last("membership") == last("churn pipelined 3") == \
        last("churn async s0")
    for ring, stacked in (("pods 4", "flat"), ("pods 1", "allreduce")):
        want = groups["stacked"][stacked]["steps"]
        for r, rank in enumerate(groups[4]):
            for w, g in zip(want, rank["exchanges"][ring]["steps"]):
                assert [x[0] for x in g["x"]] == [x[r] for x in w["x"]]
                for key in w["state"]:
                    assert g["state"][key][0] == w["state"][key][r]
    steps = groups["stacked"]["exchanges"]["churn burst"]["steps"]
    assert sum(st["zero"] for st in steps) > 0


def test_gloo_tags_align_when_a_rank_skips_a_slot(groups):
    """Rank 2 sits out slot "b" while ranks 0, 1 and 3 use it on their
    compacted ring, then every rank uses slot "c" and slot "b" again: every
    arrival is the peer's value (with tags by order of first use, rank 2's
    "c" would carry another tag than the others'), and every rank derived
    one tag for one key."""
    ranks = [rank["tags"] for rank in groups[4]]
    compact = {0: (3, 1), 1: (0, 3), 3: (1, 0)}
    for r, got in enumerate(ranks):
        ring = ((r - 1) % 4, (r + 1) % 4)
        assert got["got"] == [ring, compact.get(r), ring, ring], r
    assert len({got["tag_b"] for got in ranks}) == 1


@pytest.mark.parametrize("name", list(REFUSALS))
def test_reference_refusals_raise_on_the_ring(groups, name):
    try:
        JConfig(**REFUSALS[name])
    except ValueError as e:
        want = str(e)
    for rank in groups[4]:
        assert rank["refusals"][name] == want


# ---- against the reference -------------------------------------------------
def _ulps(rows) -> float:
    diff = max(d for d, _ in rows)
    ref = max(mag for _, mag in rows)
    return float(np.float32(diff) / np.spacing(np.float32(ref)))


@pytest.mark.parametrize("label", REF_LABELS)
def test_ranks_within_ulps_of_reference(groups, label):
    ulps = dict((c[0], c[2]) for c in REFERENCE)[label]
    ranks = [rank["reference"][label] for rank in groups[4]]
    for k in range(REF_STEPS):
        steps = [rank[k] for rank in ranks]
        n_leaves = len(steps[0]["x"])
        got = [max(_ulps([st["x"][i] for st in steps])
                   for i in range(n_leaves)),
               _ulps([st["x_tilde"] for st in steps]),
               _ulps([st["m_agg"] for st in steps])]
        assert max(got) <= ulps, (k + 1, got)


@pytest.mark.parametrize("label", REF_LABELS)
def test_ranks_payloads_equal_reference(groups, label):
    """Packed: each active rank's payload is the reference's encode of its
    pod mean, exactly, and an inactive rank encodes nothing.  Async: its
    three payloads differ from the reference's in at most MAX_FLY_OFF of
    the bytes (hazard 4)."""
    ranks = [rank["reference"][label] for rank in groups[4]]
    for k in range(REF_STEPS):
        steps = [rank[k] for rank in ranks]
        if "pay_equal" in steps[0]:
            assert all(st["pay_equal"] for st in steps), k + 1
        if "fly" in steps[0]:
            off = sum(d for st in steps for d, _ in st["fly"])
            total = sum(t for st in steps for _, t in st["fly"])
            assert off / total <= MAX_FLY_OFF, (k + 1, off, total)


@pytest.mark.parametrize("label", REF_LABELS)
def test_ranks_peers_metrics_and_holes_equal_reference(groups, label):
    """Each rank's peers are its sources in the reference's ring
    permutations (``_flat_ring_perm_masked(..., group=m)``); an inactive
    rank is none's target and keeps its state bitwise; the metrics
    (``active_nodes`` among them) equal the reference's; pod members come
    out bitwise equal."""
    kw = {c[0]: c[1] for c in REFERENCE}[label]
    m = ConsensusRuntime(ConsensusConfig(**kw), 4).pod_size
    ranks = [rank["reference"][label] for rank in groups[4]]
    holes = 0
    for k in range(REF_STEPS):
        for r, rank in enumerate(ranks):
            st = rank[k]
            assert st["peers"][0] == st["peers"][1], (r, k + 1)
            assert st["metrics"] and all(st["metrics"].values()), \
                (r, k + 1, st["metrics"])
            if not st["active"]:
                holes += 1
                assert st["frozen"], (r, k + 1)
            assert st["x_digest"] == ranks[r - r % m][k]["x_digest"]
    assert holes == (2 if label.startswith("churn") else 0)


# ---- the trainers ----------------------------------------------------------
@pytest.mark.parametrize("name", list(E.CKPT_RUNS))
def test_ring_checkpoint_is_the_stacked_file(groups, name):
    """The trainer over ranks with ``--checkpoint-dir`` trains the stacked
    trainer's bits and writes one file, the stacked run's byte for
    byte."""
    want = groups["stacked"]["ckpt"][name]
    lead = groups[4][0]["ckpt"][name]
    assert (lead["file"], lead["size"]) == (want["file"], want["size"])
    for r, rank in enumerate(groups[4]):
        got = rank["ckpt"][name]
        assert got["losses"] == want["losses"]
        for key, rows in want["final"].items():
            if key == "step":
                assert got["final"][key] == rows
            elif key in ("params", "opt"):
                assert [a[0] for a in got["final"][key]] == \
                    [a[r] for a in rows], key
            else:
                assert got["final"][key][0] == rows[r], key


@pytest.mark.parametrize("name", list(E.CKPT_RUNS))
def test_ring_checkpoint_loads_back_and_from_stacked(groups, name):
    """Each rank loads its own rows of its run's file back, bitwise its
    final state, and the same rows of the stacked run's file; the stacked
    loader reads the whole file back to the stacked state."""
    for rank in groups[4]:
        got = rank["ckpt"][name]
        assert got["loaded"] == got["final"] == got["from_stacked"]
        assert got["loaded_step"] == got["from_stacked_step"] == 3
    want = groups["stacked"]["ckpt"][name]
    assert want["loaded"] == want["final"]


@pytest.mark.parametrize("what", ["losses", "codecs", "final", "sinks"])
def test_trainer_flags_bitwise_stacked(groups, what):
    """``--wire-codec adaptive`` (int8, then int4 after the switch at step
    2), ``--microbatches 2``, ``--compute-dtype bfloat16`` and
    ``--telemetry`` over ranks: the stacked trainer's losses, codecs and
    final state bitwise, and one valid sink per rank whose step records
    and events are the stacked sink's."""
    want = groups["stacked"]["flags"]
    assert want["codecs"] == ["int8", "int8", "int4"]
    for r, rank in enumerate(groups[4]):
        got = rank["flags"]
        if what == "final":
            for key, rows in want["final"].items():
                if key == "step":
                    assert got["final"][key] == rows
                elif key in ("params", "opt"):
                    assert [a[0] for a in got["final"][key]] == \
                        [a[r] for a in rows], key
                else:
                    assert got["final"][key][0] == rows[r], key
        elif what == "sinks":
            assert got["sink"] == f"telemetry-flags-rank{r}.jsonl"
            assert got["sink_errors"] == [] == want["sink_errors"]
            assert got["sink_losses"] == want["sink_losses"]
            assert got["sink_events"] == want["sink_events"]
        else:
            assert got[what] == want[what]


# ---- the CLI ---------------------------------------------------------------
CLI = ["--device", "cpu", "--reduced", "--batch", "8", "--seq", "32"]
CLI_RUNS = {"node-failures": ["--steps", "3", "--node-failures", "2@1:2",
                              "--schedule-period", "1"],
            "hierarchy": ["--steps", "2", "--hierarchy", "pods=2"]}


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_torchrun_cli_matches_stacked(capsys, name):
    argv = [*CLI, *CLI_RUNS[name]]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--process-ring", *argv], capture_output=True, text=True,
        timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ring_lines = _step_lines(proc.stdout)
    train.main([*argv, "--nodes", "4"])
    stacked_lines = _step_lines(capsys.readouterr().out)
    assert len(ring_lines) == len(stacked_lines) == int(argv[argv.index(
        "--steps") + 1])
    keys = ["loss", "wire_bytes_per_step", "collectives_per_step",
            "consensus_err", "overflow_frac", "residual_norm"]
    keys += (["active_nodes", "resync", "ring_stride"]
             if name == "node-failures" else [])
    for got, want in zip(ring_lines, stacked_lines):
        for key in keys:
            assert got[key] == want[key], key
    if name == "node-failures":
        assert [line["active_nodes"] for line in ring_lines] == \
            ["4", "3", "4"]
    assert "[setup] " in proc.stdout
