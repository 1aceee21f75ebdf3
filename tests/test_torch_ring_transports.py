"""The async and per-leaf transports, ring strides, faults and the directed
push-sum ring over processes: each node a rank of a gloo group.

A rank must compute the stacked runtime's row bit for bit on every option
the process ring runs (``tests/torch_ring_work.py`` holds the ranks' work;
every tensor is compared through the SHA-1 of its bytes).  Held here, on
the CPU, for 3 exchanges each on reduced smollm-135m:

* 14 exchanges on 4 ranks (the async transport at staleness 1 and 0, on
  plan B and on the adaptive grid; per-leaf ADC and compressed_dgd; ring
  strides (1, 3) re-wired every step; link loss 0.2 with one resync retry;
  the Gilbert burst channel; straggler deadlines; the directed ring and
  push-sum on packed, async and per-leaf), 6 on 5 ranks (strides (1, 2):
  packed, pipelined over 3 units, async, per-leaf, dgd, compressed_dgd)
  and async on 2
  ranks, where both neighbours are one rank: each rank's x_next, state,
  metrics, payloads (or per-leaf codes and scales) and zero payloads read
  against the stacked rows; every arrival against what the neighbour at
  the step's stride sent; the bytes each transfer kind sent against the
  static accounting, the resync's fp32 shadows apart; and on the async
  transport the state without ``fly_up`` / ``fly_dn`` until ``land``;
* the ranks against the JAX reference (``ConsensusRuntime`` under
  ``shard_map`` on 4 host devices, the harness of ``test_torch_faults.py``
  with the reference's noise, started each step from the reference's own
  state) on cases of ``test_torch_transports.py`` (int8 async s1),
  ``test_torch_perleaf.py`` (per-leaf), ``test_torch_strides.py`` (async
  under strides) and ``test_torch_directed.py`` (directed push-sum under
  loss: per-leaf, async, strides with a failing resync), at those files'
  tolerances: payload bytes exact (an async launch within MAX_FLY_OFF of
  the reference's), state within STATE_ULPS, push-sum weights and metrics
  equal;
* 3 steps of the 4-rank trainer on async s1 (with the exchange probe on
  the live state after step 2: the state bitwise unchanged across it) and
  on the per-leaf directed push-sum ring under loss, against the stacked
  trainer bitwise;
* ``python -m torch.distributed.run --nproc-per-node 2 -m
  repro_torch.launch.train --process-ring --wire-packing async`` against
  the stacked CLI.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import concurrent.futures
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

import torch_ring_work as W
from test_torch_directed import CASES as DIRECTED_CASES
from test_torch_faults import BODY as FAULTS_BODY
from test_torch_faults import MAX_FLY_OFF
from test_torch_faults import STATE_ULPS as FAULTS_ULPS
from test_torch_perleaf import STATE_ULPS as PERLEAF_ULPS
from test_torch_ring import CLI, _step_lines
from test_torch_strides import CASES as STRIDES_CASES
from test_torch_strides import STATE_ULPS as STRIDES_ULPS
from test_torch_transports import CASES as TRANSPORTS_CASES
from test_torch_transports import STATE_ULPS as TRANSPORTS_ULPS

from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.launch import train
from repro_torch.launch.mesh import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = {4: W.EXCHANGES4, 5: W.EXCHANGES5, 2: W.EXCHANGES2}
NAMES = [name for table in GROUPS.values() for name in table]
SIZE = {name: n for n, table in GROUPS.items() for name in table}
KW = {name: kw for table in GROUPS.values() for name, kw in table.items()}
ASYNC_S1 = [name for name in NAMES
            if KW[name].get("wire_packing") == "async"
            and KW[name].get("staleness", 1) == 1]

# ---- the reference cases, each with its file's state tolerance -------------
_T = {c[0]: c for c in TRANSPORTS_CASES}["int8/async1"]
#: (label, ConsensusConfig keywords, STATE_ULPS of the file it comes from)
REFERENCE = [
    ("transports int8/async1", dict(wire_codec=_T[1], wire_packing=_T[2],
                                     pipeline_chunks=_T[3]),
     TRANSPORTS_ULPS),
    ("perleaf adc_dgd/per_leaf/fixed", dict(quant_mode="fixed",
                                            wire_packing="per_leaf"),
     PERLEAF_ULPS),
    # the strides file's async case, at the 4-rank strides (1, 3)
    ("strides int8/async1", dict(dict(STRIDES_CASES)["int8/async1"],
                                 **W.STRIDES4), STRIDES_ULPS),
    *[(f"directed {label}", kw, FAULTS_ULPS) for label, kw in DIRECTED_CASES
      if label in ("directed/per_leaf/loss", "directed/async1/loss",
                   "directed/strides1,3/loss")]]
REF_N, REF_STEPS = 4, W.STEPS
assert len(REFERENCE) == 6
REF_LABELS = [c[0] for c in REFERENCE]

#: written into the harness after each reference step: its outputs (x_next
#: leaves, state, metrics) and on a packed wire each node's payload as the
#: reference encodes it
_DUMP = r"""
        _d = {f"x{i}": np.asarray(a) for i, a in
              enumerate(jax.tree_util.tree_leaves(jxn))}
        _d.update({"s_" + key: np.asarray(v) for key, v in js.items()})
        _d.update({"m_" + key: np.asarray(v) for key, v in jm.items()})
        if packing not in ("async", "per_leaf"):
            _ps = synced["ps_w"].numpy() if push else None
            _p = []
            for i in range(N):
                _x = jlayout.pack(jax.tree.map(lambda a: a[i], xh))
                if push:
                    _x = _x * _ps[i, 0]
                _w = np.asarray(jplan.encode(
                    _x - synced["x_tilde"][i].numpy(), jnp.asarray(nz[i]),
                    fixed_step=step_k))
                if push:
                    _w = np.concatenate([_w, _ps[i].view(np.uint8)])
                _p.append(_w)
            _d["pay"] = np.stack(_p)
        np.savez(os.path.join(__DUMP__, label.replace("/", "_")
                              + f"-{k}.npz"), **_d)
"""
_STEP_LINE = ("        jxn, js, jm = step_f(xp, xh, js, "
              "jnp.asarray(k, jnp.int32), nz)\n")
assert FAULTS_BODY.count(_STEP_LINE) == 1


def _reference_runner(dump: str) -> str:
    body = (FAULTS_BODY.replace(_STEP_LINE, _STEP_LINE + _DUMP)
            .replace("__DUMP__", repr(dump))
            .replace("__N__", str(REF_N))
            .replace("__STEPS__", str(REF_STEPS))
            .replace("__CASES__", repr([(label, kw) for label, kw, _ in
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
def _stacked_runs() -> dict:
    """Every case's and trainer's stacked run (in a thread of the test
    process while the ranks run)."""
    return {"exchanges": {name: W.run_exchanges(KW[name], SIZE[name])
                          for name in NAMES},
            "train": {name: W.train_run(kw, 4)
                      for name, kw in W.TRAINERS.items()}}


@pytest.fixture(scope="module")
def groups():
    """The 4-rank group (beside it the reference in its own subprocess,
    dumping ~1.4 GB for the ranks' last phase into a temporary directory
    removed when the groups are done), then the 5- and 2-rank groups;
    meanwhile the stacked runs (``groups["stacked"]``)."""
    with tempfile.TemporaryDirectory(prefix="ring-reference-") as dump:
        return _groups(dump)


def _groups(dump: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _reference_runner(dump)],
                            env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        stacked = pool.submit(_stacked_runs)
        try:
            out = {4: run_ranks(W.ring4_work, 4, dump,
                                [(label, kw) for label, kw, _ in REFERENCE],
                                REF_STEPS, timeout_s=900)}
            _, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"the reference failed:\n{err[-4000:]}")
        out[5] = run_ranks(W.ring5_work, 5, timeout_s=600)
        out[2] = run_ranks(W.ring2_work, 2, timeout_s=600)
        out["stacked"] = stacked.result(timeout=600)
    return out


def _ranks(groups, name):
    return [rank["exchanges"][name] for rank in groups[SIZE[name]]]


# ---- the exchanges ---------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_exchange_equals_stacked_rows(groups, name):
    want = groups["stacked"]["exchanges"][name]["steps"]
    ranks = _ranks(groups, name)
    n = SIZE[name]
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
            # each payload the rank encoded is the stacked row's
            assert len(w["pays"]) == len(g["pays"]), where
            for unit, (a, b) in enumerate(zip(w["pays"], g["pays"])):
                assert b == [a[r]], f"payload {unit}, {where}"
            # per leaf: node j's codes and scales are call j of the leaf
            assert len(w["leaves"]) == n * len(g["leaves"]), where
            for i, got in enumerate(g["leaves"]):
                assert got == w["leaves"][i * n + r], f"leaf {i}, {where}"
            assert (w["stride"], w["resync"]) == (g["stride"], g["resync"])
    # a rank reads the zero payloads of its own arrivals
    for k, w in enumerate(want):
        assert sum(rank["steps"][k]["zero"] for rank in ranks) == w["zero"]


@pytest.mark.parametrize("name", NAMES)
def test_arrivals_are_the_neighbours_payloads(groups, name):
    """Every transfer (payloads, codes and scales, shadows, weights)
    delivered rank r what ranks r - s and r + s sent, s the step's
    stride; the ranks made the same transfers in the same order."""
    ranks = _ranks(groups, name)
    n = SIZE[name]
    for k in range(W.STEPS):
        steps = [rank["steps"][k] for rank in ranks]
        kinds = [[t["kind"] for t in st["transfers"]] for st in steps]
        assert all(kd == kinds[0] for kd in kinds) and kinds[0], kinds
        s = steps[0]["stride"]
        for r, st in enumerate(steps):
            for t, tr in enumerate(st["transfers"]):
                assert tr["got"] == [
                    steps[(r - s) % n]["transfers"][t]["sent"],
                    steps[(r + s) % n]["transfers"][t]["sent"]], \
                    (r, k + 1, t, tr["kind"])


@pytest.mark.parametrize("name", NAMES)
def test_bytes_sent_are_the_static_accounting(groups, name):
    """The bytes each rank put on the wire per step are the static
    accounting's (payloads, trailers, the per-leaf weight); a resync's
    fp32 shadows (and push-sum weights) are sent apart, at resync steps
    only."""
    n = SIZE[name]
    rt = ConsensusRuntime(ConsensusConfig(**KW[name]), n)
    x0, _ = W.exchange_inputs(n)
    layout = rt.state_layout(x0)
    acct = rt.wire_accounting(layout.n_elements, layout)
    resync_step = (0.0 if acct is None else acct.resync_bytes_amortized
                   * rt.cfg.schedule_period)
    for rank in _ranks(groups, name):
        for st in rank["steps"]:
            sent = {k: v for k, v in st["bytes"].items() if k != "resync"}
            static = st["static"]["wire_bytes_per_step"]
            assert sum(sent.values()) == static - (
                0.0 if acct is None else acct.resync_bytes_amortized), st
            want = resync_step if st["resync"] and acct is not None else 0
            assert st["bytes"].get("resync", 0) == want, st


@pytest.mark.parametrize("name", ASYNC_S1)
def test_async_state_is_complete_only_once_landed(groups, name):
    """On the async transport at staleness 1 each exchange returns with
    its payload on the wire and the state without its arrivals; ``land``
    completes it, and nothing is left in flight at the end."""
    for rank in _ranks(groups, name):
        assert rank["pending"] == 0
        for st in rank["steps"]:
            assert st["in_flight"] and st["landed"]
            assert st["missing"] == ["fly_dn", "fly_up"]
            assert {"fly_self", "fly_up", "fly_dn"} <= set(st["state"])


def test_other_transports_leave_nothing_in_flight(groups):
    for name in NAMES:
        if name in ASYNC_S1:
            continue
        for rank in _ranks(groups, name):
            assert not any(st["in_flight"] for st in rank["steps"]), name


def test_faults_drop_and_fail_resyncs(groups):
    """The lossy cases do drop payloads, and some resync handshakes fail
    (and some land), so the ranks' receiver-side reads are exercised."""
    for name in ("link loss", "burst loss", "stragglers",
                 "directed async loss", "directed per_leaf loss adaptive"):
        steps = groups["stacked"]["exchanges"][name]["steps"]
        assert sum(st["zero"] for st in steps) > 0, name
    rt = ConsensusRuntime(ConsensusConfig(**KW["link loss"]), 4)
    ok = np.concatenate([rt.resync_ok(k) for k in range(2, W.STEPS + 1)])
    assert ok.any() and not ok.all()


# ---- against the reference -------------------------------------------------
def _ulps(rows) -> float:
    """The harness's ulps over every node: the largest difference over the
    spacing at the largest magnitude."""
    diff = max(d for d, _ in rows)
    ref = max(m for _, m in rows)
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
    """Packed: each rank's payload is the reference's encode, exactly.
    Async: its launched payload and both arrivals differ from the
    reference's in at most MAX_FLY_OFF of the bytes (the launch encodes
    against the port's retired shadow, within an ulp of the reference's:
    ROADMAP Queue 3, hazard 4).  Per-leaf: held through x_next."""
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
def test_ranks_weights_and_metrics_equal_reference(groups, label):
    for rank in groups[4]:
        for k, st in enumerate(rank["reference"][label], start=1):
            assert st["weights"], k
            assert st["metrics"] and all(st["metrics"].values()), \
                (k, st["metrics"])


# ---- the trainers ----------------------------------------------------------
@pytest.mark.parametrize("what", ["losses", "final"])
@pytest.mark.parametrize("name", list(W.TRAINERS))
def test_ring_trainer_bitwise_stacked(groups, name, what):
    want = groups["stacked"]["train"][name]
    for r, rank in enumerate(groups[4]):
        got = rank["train"][name]
        if what == "losses":
            assert got["losses"] == want["losses"]
        else:
            assert got["final"].keys() == want["final"].keys()
            for key, w in want["final"].items():
                rows = ([leaf[r] for leaf in w] if key == "params"
                        else w[r])
                g = ([leaf[0] for leaf in got["final"][key]]
                     if key == "params" else got["final"][key][0])
                assert g == rows, (r, key)


def test_probe_leaves_the_async_state_bitwise(groups):
    """The exchange probe on the live async state (after step 2) leaves
    the state bitwise as it was and nothing in flight; the run then goes
    on to the stacked trainer's bits (``test_ring_trainer_bitwise_
    stacked``), so the live flight was as it would have been."""
    for rank in groups[4]:
        got = rank["train"]["async"]
        assert got["before_probe"] == got["after_probe"]
        assert not got["in_flight_after_probe"]
        assert got["probe"]["consensus_exchange_s"] > 0.0


def test_torchrun_cli_async_matches_stacked(capsys):
    argv = [*CLI, "--wire-packing", "async"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--process-ring", *argv], capture_output=True, text=True,
        timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ring_lines = _step_lines(proc.stdout)
    hist = train.main([*argv, "--nodes", "2"])
    stacked_lines = _step_lines(capsys.readouterr().out)
    assert len(ring_lines) == len(stacked_lines) == 2
    for got, want, h in zip(ring_lines, stacked_lines, hist):
        for key in ("loss", "wire_bytes_per_step", "collectives_per_step",
                    "consensus_err", "overflow_frac", "residual_norm"):
            assert got[key] == want[key], key
        # this step's launch, both directions
        assert int(got["wire_bytes_sent"]) == h["wire_bytes_per_step"]
    # step 1 retires the zero payloads (nothing carried); step 2 retires
    # the flight step 1 posted
    assert float(ring_lines[0]["wire_flight_s"]) == 0.0
    assert float(ring_lines[1]["wire_flight_s"]) > 0.0
    assert float(ring_lines[1]["wire_flight_s"]) >= float(
        ring_lines[1]["wire_wait_s"])
