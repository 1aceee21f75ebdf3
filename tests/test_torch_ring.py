"""The consensus ring over processes: each node a rank of a gloo group.

Every rank of a ``torch.distributed`` group holds one node
(``launch.mesh``, ``models.sharding``) and its payloads really cross the
wire to its ring neighbours; a rank must compute the stacked runtime's row
bit for bit.  Held here, on the CPU:

* the collectives on 2, 3 and 4 ranks (``ppermute_ring`` at +1 and -1,
  both neighbours at once, ``node_group_sum``, ``gather_nodes``) against
  the stacked index and rotation sum; at 2 ranks both neighbours are the
  other rank;
* two exchanges on 4 ranks for every algorithm, codec and transport the
  process ring runs: each rank's own payloads, its two arrivals,
  ``x_tilde``, ``m_agg``, ``x_next`` and metrics against the stacked
  runtime's rows on the same inputs (the noise each rank draws is the
  stacked draw's row);
* 3 steps of the 4-rank trainer on reduced smollm-135m against the JAX
  composition that ``test_torch_train.py`` builds, at that file's
  tolerances, and bitwise against the stacked port trainer;
* the CLI's ``--nodes`` must equal the world size (the transports, faults
  and topologies over ranks: ``test_torch_ring_transports.py``; membership,
  hierarchy and checkpoints: ``test_torch_ring_elastic.py``);
* ``python -m torch.distributed.run --nproc-per-node 2 -m
  repro_torch.launch.train --process-ring --device cpu --reduced`` against
  the stacked CLI.

Each group of ranks is started once (``launch.mesh.run_ranks``: spawned
processes, a ``file://`` rendezvous, no TCP port of ours) and runs every
case it serves; the JAX composition runs beside the ranks in its own
subprocess.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_train import (BODY, FIXED_STEP0, LOSS_RTOL, MAX_FRAC_OFF,
                              MAX_GRID_STEPS, STEPS)

from repro_torch.configs import get_config, reduced
from repro_torch.core import tree as T
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.launch import train
from repro_torch.launch.mesh import make_process_context, run_ranks
from repro_torch.models.params import init_params, params_from_jax
from repro_torch.models.sharding import (ParallelContext, local_context,
                                         make_context)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
#: the JAX composition's run (``test_torch_train.py``'s BODY)
LR, B, S = 1e-2, 8, 64
COLLECTIVES = ("ppermute+1", "ppermute-1", "both neighbours",
               "node_group_sum", "gather_nodes")

#: every algorithm, codec and transport of the process ring; each run
#: also tracks the consensus error (a node sum over the ring)
EXCHANGES = {
    "int8 packed": {},
    "int8 pipelined 3": dict(wire_packing="pipelined", pipeline_chunks=3),
    "int8 adaptive packed": dict(quant_mode="adaptive"),
    "int8 adaptive pipelined 3": dict(quant_mode="adaptive",
                                      wire_packing="pipelined",
                                      pipeline_chunks=3),
    "int4 packed": dict(wire_codec="int4"),
    "int4 pipelined 3": dict(wire_codec="int4", wire_packing="pipelined",
                             pipeline_chunks=3),
    "int2 packed": dict(wire_codec="int2"),
    "topk packed": dict(wire_codec="topk"),
    "topk pipelined 3": dict(wire_codec="topk", wire_packing="pipelined",
                             pipeline_chunks=3),
    "mixed pipelined 3": dict(
        wire_codec="mixed:embed=topk:k=64,norm=int2,*=int8",
        wire_packing="pipelined", pipeline_chunks=3),
    "dgd": dict(algorithm="dgd"),
    "allreduce": dict(algorithm="allreduce"),
    "compressed_dgd packed": dict(algorithm="compressed_dgd"),
    "compressed_dgd pipelined 3": dict(algorithm="compressed_dgd",
                                       wire_packing="pipelined",
                                       pipeline_chunks=3),
}
EXCHANGE_STEPS = 2


# ---- the ranks' work -------------------------------------------------------
def _collectives(ctx) -> dict:
    """Each collective's result on this rank beside the stacked one's row
    (a (n, 5, 7) tensor drawn from a seed; this rank holds row ``rank``)."""
    n, r = ctx.total_consensus_nodes, ctx.rank
    full = torch.randn((n, 5, 7), generator=torch.Generator().manual_seed(3))
    x = full[r:r + 1].clone()
    stacked = local_context()
    got = {"ppermute+1": (ctx.ppermute_ring(x, 1),
                          stacked.ppermute_ring(full, 1)[r:r + 1]),
           "ppermute-1": (ctx.ppermute_ring(x, -1),
                          stacked.ppermute_ring(full, -1)[r:r + 1])}
    left, right = ctx.ring_start(x, "both").wait()
    got["both neighbours"] = (torch.cat([left, right]), torch.cat([
        stacked.ppermute_ring(full, 1)[r:r + 1],
        stacked.ppermute_ring(full, -1)[r:r + 1]]))
    got["node_group_sum"] = (ctx.node_group_sum(x),
                             stacked.node_group_sum(full)[r:r + 1])
    got["gather_nodes"] = (ctx.gather_nodes(x), full)
    return {k: bool(torch.equal(a, b)) for k, (a, b) in got.items()}


def _exchange_inputs(n: int):
    """Reduced smollm-135m's x0 shared by ``n`` nodes and two optimizer
    steps' worth of distinct per-node perturbations, from seeds."""
    defs = train.build_train_setup(reduced(get_config("smollm-135m")),
                                   consensus_nodes=n, device="cpu").defs
    x0 = init_params(defs.storage, 0, "cpu", n_nodes=n)
    g = torch.Generator().manual_seed(11)
    deltas = [T.tree_map(lambda a: 1e-3 * torch.randn(a.shape, generator=g),
                         x0) for _ in range(EXCHANGE_STEPS)]
    return x0, deltas


def _record(rt) -> list:
    """Record every transfer unit's own payloads the runtime encodes."""
    log, encode = [], rt._encode_unit

    def rec(*args, **kw):
        pays = encode(*args, **kw)
        log.append([None if p is None else p.clone() for p in pays])
        return pays
    rt._encode_unit = rec
    return log


def _run_exchanges(kw: dict, ctx=None) -> list:
    """``EXCHANGE_STEPS`` exchanges of ``kw``'s runtime, stacked (``ctx``
    None) or as this rank's row: per step (x_next leaves, state, metrics,
    own payloads, arrivals in the order they were waited for, x_prev
    leaves)."""
    x, deltas = _exchange_inputs(N)
    rt = ConsensusRuntime(ConsensusConfig(track_consensus_error=True, **kw),
                          N, ctx=ctx)
    arrivals = []
    if ctx is not None:
        r = ctx.rank
        x = T.tree_map(lambda a: a[r:r + 1].clone(), x)
        deltas = [T.tree_map(lambda a: a[r:r + 1].clone(), d)
                  for d in deltas]
        start = ctx.ring.start

        def rec_start(*args, **kws):
            flight = start(*args, **kws)
            wait = flight.wait
            flight.wait = lambda: arrivals.append(
                [t.clone() for t in wait()]) or wait()
            return flight
        ctx.ring.start = rec_start
    pays = _record(rt)
    state = rt.init_state(x)
    out = []
    for k in range(1, EXCHANGE_STEPS + 1):
        del pays[:], arrivals[:]
        half = T.tree_map(torch.add, x, deltas[k - 1])
        prev = T.tree_leaves(x)
        x, state, m = rt.exchange(x, half, state, k, seed=5)
        out.append((T.tree_leaves(x), dict(state),
                    {k2: v for k2, v in m.items() if torch.is_tensor(v)},
                    list(pays), list(arrivals), prev))
    if ctx is not None:
        ctx.ring.start = start
    return out


def _refusals(ctx) -> dict:
    """The CLI's refusal of a ``--nodes`` other than the world size (None
    if it did not raise)."""
    out = {}
    try:
        train.main(["--process-ring", "--device", "cpu", "--reduced",
                    "--nodes", str(N + 1), "--steps", "1"])
        out["--nodes"] = None
    except SystemExit as e:
        out["--nodes"] = str(e)
    return out


def _noise(k: int, rows: int) -> np.ndarray:
    """``test_torch_train.py``'s noise of step ``k``."""
    return np.random.default_rng([5, k]).random((N, rows, 512),
                                                dtype=np.float32)


def _train(p0_leaves: list, ctx=None) -> dict:
    """``STEPS`` steps of the port trainer from the JAX x0 on
    ``test_torch_train.py``'s batches and noise: stacked, or this rank's
    node.  Final parameters, shadows and every step's node losses."""
    from repro_torch.data import SyntheticLMDataset
    setup = train.build_train_setup(
        reduced(get_config("smollm-135m")),
        consensus_nodes=None if ctx is not None else N, lr=LR,
        device="cpu", ctx=ctx)
    treedef = T.tree_flatten(setup.defs.storage)[1]
    p0 = T.tree_unflatten(treedef, p0_leaves)
    state = train.init_train_state(setup, params=params_from_jax(
        p0, setup.defs.storage, device="cpu",
        n_nodes=setup.consensus.n_local))
    rows = setup.consensus.state_layout(state["params"]).n_rows
    ds = SyntheticLMDataset(setup.cfg.vocab_size, S, B, n_shards=N)
    losses = []
    for k in range(1, STEPS + 1):
        noise = torch.from_numpy(_noise(k, rows))
        if ctx is not None:
            noise = noise[ctx.rank:ctx.rank + 1]
        state, m = train.train_step(setup, state,
                                    ds.global_batch_arrays(k - 1),
                                    noise=noise)
        losses.append((m["loss"], m["node_loss"].tolist()))
    return {"params": T.tree_leaves(state["params"]),
            "x_tilde": state["consensus"]["x_tilde"],
            "m_agg": state["consensus"]["m_agg"], "losses": losses}


def _wait_for(path: str, proc, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if proc is not None and proc.poll() is not None:
            raise AssertionError("the JAX composition exited before "
                                 "writing its x0")
        if time.monotonic() > deadline:
            raise AssertionError(f"no {path} after {timeout_s} s")
        time.sleep(0.2)


def _ring_work(p0_path: str) -> dict:
    """Everything the 4-rank group runs; the trainer last, once the JAX
    composition has written its x0."""
    ctx = make_process_context("cpu")
    out = {"collectives": _collectives(ctx),
           "exchanges": {name: _run_exchanges(kw, ctx)
                         for name, kw in EXCHANGES.items()},
           "refused": _refusals(ctx)}
    _wait_for(p0_path, None, 300)
    out["train"] = _train(list(np.load(p0_path).values()), ctx)
    return out


def _collective_work() -> dict:
    return _collectives(make_process_context("cpu"))


# ---- fixtures --------------------------------------------------------------
#: test_torch_train.py's composition, writing x0 as soon as it is drawn and
#: the reference's final state and losses at the end
JAX_BODY = BODY[:BODY.index("# ---- the port")].replace(
    "p0 = jax.device_get(JT.init_params(ldefs, jax.random.PRNGKey(0)))",
    "p0 = jax.device_get(JT.init_params(ldefs, jax.random.PRNGKey(0)))\n"
    "np.savez('__P0__.tmp.npz', *[np.asarray(a) for a in "
    "jax.tree_util.tree_leaves(p0)])\n"
    "os.replace('__P0__.tmp.npz', '__P0__')") + r"""
np.savez('__OUT__', *[np.asarray(a) for a in jax.tree_util.tree_leaves(x)],
         x_tilde=np.asarray(js["x_tilde"]), jlosses=np.asarray(jlosses))
print("DONE")
"""
assert "__P0__" in JAX_BODY


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """The 4-rank run, the stacked port trainer and the JAX composition."""
    tmp = tmp_path_factory.mktemp("ring")
    p0_path, out_path = str(tmp / "p0.npz"), str(tmp / "jax.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    body = (JAX_BODY.replace("__STEPS__", str(STEPS))
            .replace("__P0__", p0_path).replace("__OUT__", out_path))
    proc = subprocess.Popen([sys.executable, "-c", body], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        ranks = run_ranks(_ring_work, N, p0_path, timeout_s=600)
        _wait_for(p0_path, proc, 300)
        stacked = _train(list(np.load(p0_path).values()))
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"JAX composition failed:\n{err[-4000:]}")
    jax_out = np.load(out_path)
    n_leaves = len(stacked["params"])
    return {"ranks": ranks, "stacked": stacked,
            "jax": {"params": [jax_out[f"arr_{i}"] for i in range(n_leaves)],
                    "x_tilde": jax_out["x_tilde"],
                    "jlosses": jax_out["jlosses"]}}


@pytest.fixture(scope="module")
def stacked_exchanges():
    return {}


@pytest.fixture(scope="module", params=[2, 3, 4])
def collectives(request, ring):
    if request.param == N:
        return [r["collectives"] for r in ring["ranks"]]
    return run_ranks(_collective_work, request.param, timeout_s=300)


# ---- tests -----------------------------------------------------------------
@pytest.mark.parametrize("op", COLLECTIVES)
def test_collectives_equal_stacked(collectives, op):
    assert all(r[op] for r in collectives), [r[op] for r in collectives]


@pytest.mark.parametrize("name", list(EXCHANGES))
def test_exchange_equals_stacked_rows(ring, stacked_exchanges, name):
    if name not in stacked_exchanges:
        stacked_exchanges[name] = _run_exchanges(EXCHANGES[name])
    want = stacked_exchanges[name]
    alg = EXCHANGES[name].get("algorithm", "adc_dgd")
    for r, rank in enumerate(ring["ranks"]):
        got = rank["exchanges"][name]
        for k, ((xw, sw, mw, pw, _, prev), (xg, sg, mg, pg, ag, _)) in \
                enumerate(zip(want, got), start=1):
            where = f"rank {r}, step {k}"
            assert all(torch.equal(a[r:r + 1], b) for a, b in zip(xw, xg)), \
                f"x_next, {where}"
            assert sw.keys() == sg.keys()
            for key in sw:
                assert torch.equal(sw[key][r:r + 1], sg[key]), \
                    f"{key}, {where}"
            assert mw.keys() == mg.keys()
            for key in mw:
                w = mw[key][r:r + 1] if mw[key].dim() == 1 else mw[key]
                assert torch.equal(w, mg[key]), f"metric {key}, {where}"
            # the exchange's transfers, then one node sum per leaf (the
            # consensus error)
            n_ex = {"adc_dgd": len(pw), "dgd": len(prev),
                    "compressed_dgd": 1, "allreduce": len(prev)}[alg]
            assert len(ag) == n_ex + len(prev)
            if alg == "adc_dgd":
                # the payloads each unit put on the wire, and the two that
                # arrived: the stacked payloads of rows r, r - 1 and r + 1
                assert len(pg) == len(pw) > 0
                for unit, (own, arr) in enumerate(zip(pg, ag)):
                    assert torch.equal(own[0], pw[unit][r]), \
                        f"payload unit {unit}, {where}"
                    assert torch.equal(arr[0], pw[unit][(r - 1) % N])
                    assert torch.equal(arr[1], pw[unit][(r + 1) % N])
            elif alg == "dgd":
                # every leaf of both neighbours' parameters arrived
                for leaf, arr in zip(prev, ag):
                    assert torch.equal(arr[0], leaf[(r - 1) % N][None])
                    assert torch.equal(arr[1], leaf[(r + 1) % N][None])


def test_pipelined_exchange_sends_every_unit(ring):
    units = [len(step[3]) for step in
             ring["ranks"][0]["exchanges"]["int8 pipelined 3"]]
    assert units == [3] * EXCHANGE_STEPS


def test_cli_nodes_must_equal_world(ring):
    for rank in ring["ranks"]:
        assert "must equal the world size" in rank["refused"]["--nodes"]


def test_ring_trainer_losses_match_jax(ring):
    jl = ring["jax"]["jlosses"]
    for rank in ring["ranks"]:
        for (_, node_losses), want in zip(rank["train"]["losses"], jl):
            assert node_losses == pytest.approx(list(want), rel=LOSS_RTOL)


@pytest.mark.parametrize("what", ["params", "x_tilde"])
def test_ring_trainer_within_grid_steps_of_jax(ring, what):
    ranks = [r["train"] for r in ring["ranks"]]
    if what == "params":
        got = [np.concatenate([r["params"][i].numpy() for r in ranks])
               for i in range(len(ranks[0]["params"]))]
        want = ring["jax"]["params"]
    else:
        got = [np.concatenate([r["x_tilde"].numpy() for r in ranks])]
        want = [ring["jax"]["x_tilde"]]
    d = [np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
         for a, b in zip(got, want)]
    assert max(x.max() for x in d) <= MAX_GRID_STEPS * FIXED_STEP0
    assert (sum(int((x > 1e-5).sum()) for x in d)
            / sum(x.size for x in d)) <= MAX_FRAC_OFF


@pytest.mark.parametrize("what", ["params", "x_tilde", "m_agg", "losses"])
def test_ring_trainer_bitwise_stacked(ring, what):
    st = ring["stacked"]
    for r, rank in enumerate(ring["ranks"]):
        got = rank["train"]
        if what == "params":
            assert all(torch.equal(a[r:r + 1], b)
                       for a, b in zip(st["params"], got["params"]))
        elif what == "losses":
            assert got["losses"] == st["losses"]
        else:
            assert torch.equal(st[what][r:r + 1], got[what])


def test_context_refuses_tp_and_fsdp():
    """FSDP and a stacked context with tp > 1 are refused; a process grid
    with tp 2 places rank r at node r // 2, model index r % 2, and sends
    its ring transfers to the ranks of its model index."""
    for kw in (dict(tp=2), dict(data_size=8)):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            make_context(4, **kw)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ParallelContext(tp=2)
    ctx = local_context()
    assert not ctx.process_ring and ctx.total_consensus_nodes == 1
    for r in range(8):
        node, m = r // 2, r % 2
        grid = ParallelContext(tp=2, n_nodes=4, data_size=4, group=object(),
                               rank=node, tp_rank=m, tp_group=object())
        assert grid.global_rank == r
        assert grid.ring.size == 8 and grid.tp_comm.index == m
        left, right = grid.neighbours(1)
        assert [grid.grid_rank(left), grid.grid_rank(right)] == [
            ((node - 1) % 4) * 2 + m, ((node + 1) % 4) * 2 + m]


def test_process_context_needs_the_launcher(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        make_process_context("cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(ValueError, match="at least 2"):
        make_process_context("cpu")


CLI = ["--device", "cpu", "--reduced", "--steps", "2", "--batch", "4",
       "--seq", "32"]


def _step_lines(text: str) -> list[dict]:
    out = []
    for line in text.splitlines():
        if line.startswith("step "):
            out.append(dict(kv.split("=", 1) for kv in line.split()[2:]
                            if "=" in kv))
    return out


def test_torchrun_cli_matches_stacked(capsys):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--process-ring", *CLI], capture_output=True, text=True,
        timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ring_lines = _step_lines(proc.stdout)
    hist = train.main([*CLI, "--nodes", "2"])
    stacked_lines = _step_lines(capsys.readouterr().out)
    assert len(ring_lines) == len(stacked_lines) == 2
    for got, want, h in zip(ring_lines, stacked_lines, hist):
        for key in ("loss", "wire_bytes_per_step", "collectives_per_step",
                    "consensus_err", "overflow_frac", "residual_norm"):
            assert got[key] == want[key], key
        # the measured wire: both payloads of 2 ranks' one transfer unit
        assert int(got["wire_bytes_sent"]) == h["wire_bytes_per_step"]
        assert float(got["wire_s"]) > 0.0
