"""The ranks' work of ``test_torch_ring_transports.py``.

A module of its own, free of JAX: ``launch.mesh.run_ranks`` spawns each
rank, which imports the module of the function it runs, so the ranks
import this one and never the reference.  The stacked runs of the test
process use the same functions with no context.

Every tensor is recorded as the SHA-1 of its bytes (``_h``): a rank's row
equals the stacked row bit for bit iff the digests agree, and the records
that cross back from the ranks stay small.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import hashlib
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import tree as T
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.kernels import ops as kops
from repro_torch.launch import train
from repro_torch.launch.mesh import make_process_context
from repro_torch.models import transformer as TF
from repro_torch.models.params import init_params, meta_params

#: exchanges per case (the first async retire is of the zero payloads, so
#: step 3 retires a payload launched against a state a real retire moved)
STEPS = 3
PLAN_B = "mixed:embed=topk:k=64,norm=int2,*=int8"
DIRECTED = dict(topology="directed-ring")
LOSS = dict(link_loss=0.2, loss_seed=1)
#: strides (1, 3) on 4 ranks, re-wired every step: steps 2 and 3 resync
STRIDES4 = dict(ring_strides=(1, 3), schedule_period=1)
#: strides (1, 2) on 5 ranks (on 4, stride 2 would split the ring)
STRIDES5 = dict(ring_strides=(1, 2), schedule_period=1)

#: the exchanges of the 4-rank group: the options the process ring took
#: up (each name as the ring once refused it), then the transports under
#: codecs, grids, faults and topologies
EXCHANGES4 = {
    "async": dict(wire_packing="async"),
    "async s0": dict(wire_packing="async", staleness=0),
    "per_leaf": dict(wire_packing="per_leaf"),
    "ring strides": dict(STRIDES4),
    "link loss": dict(STRIDES4, resync_retries=1, **LOSS),
    "burst loss": dict(link_loss_model="gilbert:p=0.3,r=0.5",
                       wire_packing="pipelined", pipeline_chunks=3),
    "stragglers": dict(wire_packing="async", straggle_rate=0.2,
                       straggle_seed=3),
    "directed ring": dict(DIRECTED),
    "push-sum": dict(push_sum=True, link_loss=0.0),
    "planB async": dict(wire_codec=PLAN_B, wire_packing="async"),
    "async adaptive grid": dict(wire_packing="async", quant_mode="adaptive"),
    "compressed_dgd per_leaf": dict(algorithm="compressed_dgd",
                                    wire_packing="per_leaf"),
    "directed async loss": dict(DIRECTED, wire_packing="async", **LOSS),
    "directed per_leaf loss adaptive": dict(DIRECTED, wire_packing="per_leaf",
                                            quant_mode="adaptive", **LOSS),
}
#: the 5-rank group: every transport, dgd and compressed_dgd under
#: strides (1, 2)
EXCHANGES5 = {
    "strides packed": dict(STRIDES5),
    "strides pipelined 3": dict(STRIDES5, wire_packing="pipelined",
                                pipeline_chunks=3),
    "strides async": dict(STRIDES5, wire_packing="async"),
    "strides per_leaf": dict(STRIDES5, wire_packing="per_leaf"),
    "strides dgd": dict(STRIDES5, algorithm="dgd"),
    "strides compressed_dgd": dict(STRIDES5, algorithm="compressed_dgd"),
}
#: the 2-rank group: both ring neighbours are one rank (ROADMAP hazard 48)
EXCHANGES2 = {"async on 2 ranks": dict(wire_packing="async")}

#: the trainers: 3 steps of reduced smollm-135m on 4 ranks
TRAIN_B, TRAIN_S, TRAIN_LR = 8, 32, 1e-2
TRAINERS = {
    "async": dict(wire_packing="async"),
    "directed per_leaf loss": dict(wire_packing="per_leaf",
                                   topology="directed-ring", link_loss=0.2,
                                   loss_seed=1),
}
#: the step after which the async trainer runs the exchange probe
PROBE_AFTER = 2


def _h(t: torch.Tensor) -> str:
    """SHA-1 of a tensor's bytes."""
    a = t.detach().contiguous().cpu()
    return hashlib.sha1(a.reshape(-1).view(torch.uint8).numpy()
                        .tobytes()).hexdigest()


def _rows(t: torch.Tensor, n_local: int) -> list:
    return [_h(t[i]) for i in range(n_local)]


def exchange_inputs(n: int):
    """Reduced smollm-135m's x0 shared by ``n`` nodes and ``STEPS``
    optimizer steps' worth of distinct per-node perturbations, from
    seeds."""
    defs = train.build_train_setup(reduced(get_config("smollm-135m")),
                                   consensus_nodes=n, device="cpu").defs
    x0 = init_params(defs.storage, 0, "cpu", n_nodes=n)
    g = torch.Generator().manual_seed(11)
    deltas = [T.tree_map(lambda a: 1e-3 * torch.randn(a.shape, generator=g),
                         x0) for _ in range(STEPS)]
    return x0, deltas


class _Recorder:
    """Within the block: each payload the runtime encodes (per node, a
    digest), each per-leaf ``quantize_blocks`` call's codes and scales,
    and under a process context each ring transfer (its slot's kind, the
    digest of what was sent and of the two tensors received)."""

    def __init__(self, rt, ctx):
        self.rt, self.ctx = rt, ctx
        self.pays, self.leaves, self.transfers = [], [], []

    def clear(self):
        del self.pays[:], self.leaves[:], self.transfers[:]

    def __enter__(self):
        rt, rec = self.rt, self
        encode = rt._encode_unit

        def encode_spy(*args, **kw):
            out = encode(*args, **kw)
            rec.pays.append([None if p is None else _h(p) for p in out])
            return out
        rt._encode_unit = encode_spy
        self.quantize = kops.quantize_blocks

        def quantize_spy(*args, **kw):
            codes, scales = rec.quantize(*args, **kw)
            rec.leaves.append((_h(codes), _h(scales)))
            return codes, scales
        kops.quantize_blocks = quantize_spy
        if self.ctx is not None:
            ring = self.ctx.ring
            self.start = start = ring.start

            def start_spy(x, sends, recvs, slot=0, into=None):
                entry = {"kind": slot[0] if isinstance(slot, tuple)
                         else slot, "sent": _h(x), "got": None}
                rec.transfers.append(entry)
                flight = start(x, sends, recvs, slot, into)
                wait = flight.wait

                def wait_spy():
                    got = wait()
                    if entry["got"] is None:
                        entry["got"] = [_h(t) for t in got]
                    return got
                flight.wait = wait_spy
                return flight
            ring.start = start_spy
        return self

    def __exit__(self, *exc):
        kops.quantize_blocks = self.quantize
        del self.rt._encode_unit
        if self.ctx is not None:
            del self.ctx.ring.start
        return False


def run_exchanges(kw: dict, n: int, ctx=None) -> dict:
    """``STEPS`` exchanges of ``kw``'s runtime on ``n`` nodes, stacked
    (``ctx`` None) or as this rank's node.  Per step: digests of each
    node's x_next leaves, state entries (after the async flight landed),
    payloads and per-leaf codes and scales; the metrics; the transfers and
    the bytes each kind of transfer sent (ranks); whether the state was
    incomplete until ``land``.  And the zero payloads read, the transfers
    still pending at the end."""
    x, deltas = exchange_inputs(n)
    rt = ConsensusRuntime(ConsensusConfig(**kw), n, ctx=ctx)
    nl = rt.n_local
    if ctx is not None:
        r = ctx.rank
        x = T.tree_map(lambda a: a[r:r + 1].clone(), x)
        deltas = [T.tree_map(lambda a: a[r:r + 1].clone(), d)
                  for d in deltas]
    state = rt.init_state(x)
    steps = []
    with _Recorder(rt, ctx) as rec:
        for k in range(1, STEPS + 1):
            rec.clear()
            if ctx is not None:
                ctx.ring.reset_stats()
            half = T.tree_map(torch.add, x, deltas[k - 1])
            z0 = rt.zero_payloads
            x, state, m = rt.exchange(x, half, state, k, seed=5)
            in_flight = rt.in_flight
            missing = sorted({"fly_up", "fly_dn"} - set(state))
            rt.land()
            step = {"x": [_rows(a, nl) for a in T.tree_leaves(x)],
                    "state": {key: _rows(v, nl) for key, v in state.items()},
                    "metrics": {key: v.tolist() for key, v in m.items()
                                if torch.is_tensor(v)},
                    "static": {key: v for key, v in m.items()
                               if not torch.is_tensor(v)},
                    "pays": list(rec.pays), "leaves": list(rec.leaves),
                    "transfers": [dict(t) for t in rec.transfers],
                    "stride": rt.stride_at(k), "resync": rt.resync_at(k),
                    "zero": rt.zero_payloads - z0,
                    "in_flight": in_flight, "missing": missing,
                    "landed": not rt.in_flight}
            if ctx is not None:
                step["bytes"] = {kind: v["bytes_sent"] for kind, v in
                                 ctx.ring.read_stats().items()}
            steps.append(step)
    return {"steps": steps,
            "pending": None if ctx is None else ctx.ring.pending}


def train_run(kw: dict, n: int, ctx=None, probe_after=None) -> dict:
    """3 steps of the reduced smollm-135m trainer (``train_step``) with
    ``kw``'s consensus, stacked on ``n`` nodes or as this rank's node:
    each step's node losses and the final parameters' and consensus
    state's digests per node.  With ``probe_after`` the exchange probe
    (``measure_consensus_overhead``) runs on the live state after that
    step, and the digests of the state just before and just after it are
    kept, with whether anything was in flight after it."""
    from repro_torch.data import SyntheticLMDataset
    setup = train.build_train_setup(
        reduced(get_config("smollm-135m")),
        consensus_nodes=None if ctx is not None else n, lr=TRAIN_LR,
        device="cpu", ctx=ctx, **kw)
    state = train.init_train_state(setup, 0)
    ds = SyntheticLMDataset(setup.cfg.vocab_size, TRAIN_S, TRAIN_B,
                            n_shards=n)
    nl = setup.consensus.n_local
    out = {"losses": []}

    def digests(st):
        return {"params": [_rows(a, nl) for a in T.tree_leaves(st["params"])],
                **{key: _rows(v, nl) for key, v in st["consensus"].items()}}
    for k in range(1, STEPS + 1):
        state, m = train.train_step(setup, state,
                                    ds.global_batch_arrays(k - 1))
        out["losses"].append(m["node_loss"].tolist())
        if k == probe_after:
            setup.consensus.land()
            out["before_probe"] = digests(state)
            out["probe"] = train.measure_consensus_overhead(
                setup, state, 1.0, repeats=1)
            out["after_probe"] = digests(state)
            out["in_flight_after_probe"] = (
                setup.consensus.in_flight
                or (ctx is not None and ctx.ring.pending > 0))
    setup.consensus.land()
    out["final"] = digests(state)
    return out


# ---- against the reference's dumps ----------------------------------------
def _template():
    return meta_params(TF.build_defs(reduced(get_config("smollm-135m")))
                       .storage)


def ref_x0(n: int):
    """The reference harness's x0 (``test_torch_faults.BODY``): every
    node's identical start, drawn with numpy."""
    rng = np.random.default_rng(0)
    return T.tree_map(lambda a: torch.from_numpy(np.broadcast_to(
        (rng.standard_normal(a.shape) * 0.05).astype(np.float32),
        (n,) + a.shape).copy()), _template())


def ref_delta(k: int, n: int):
    """The harness's optimizer delta of step k per node; a few entries
    saturate the fixed grid."""
    r = np.random.default_rng([1, k])

    def one(a):
        d = (r.standard_normal((n,) + a.shape) * 2e-3).astype(np.float32)
        d.reshape(-1)[::997] *= 300.0
        return torch.from_numpy(d)
    return T.tree_map(one, _template())


def wait_for(path: str, failed: str, timeout_s: float) -> None:
    """Until ``path`` exists; raises when ``failed`` does (the writer's
    traceback) or after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if os.path.exists(failed):
            with open(failed) as f:
                raise RuntimeError(f"the reference failed:\n{f.read()}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {timeout_s} s")
        time.sleep(0.2)


def _gap(a: torch.Tensor, b: np.ndarray) -> tuple[float, float]:
    """(largest |a - b|, largest |b|): the parts of the harness's ulps,
    whose spacing is taken at the largest magnitude over every node."""
    a = a.numpy().astype(np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b))), float(np.max(np.abs(b)))


def hold_to_reference(ctx, ref_dir: str, cases: list, steps: int) -> dict:
    """This rank's exchanges of a reference harness's ``cases`` (label,
    ConsensusConfig keywords): the harness of ``test_torch_faults.py`` or
    of ``test_torch_membership.py``, each patched to dump its per-step
    outputs under ``ref_dir``.  Each step starts from the reference's own
    parameters and state (the dump of the step before; x0 and the
    runtime's initial state at step 1), delta and noise (one draw per
    ring element, a pod's members sharing it), as the harness starts the
    stacked port, and is held against the reference's outputs: per step
    the gaps of x_next (per leaf), x_tilde and m_agg, whether the
    push-sum weights and the metrics equal the reference's, the payload
    against the reference's encode (packed: an inactive rank encodes
    nothing; on the async transport the state's three payloads against
    the reference's, counting differing bytes); with the membership
    harness's ring permutations dumped, this rank's peers beside its
    sources there; the digests of x_next (pod replicas), and where the
    rank is inactive whether its parameters and shadows came out bitwise
    as they went in."""
    wait_for(os.path.join(ref_dir, "DONE"),
             os.path.join(ref_dir, "FAILED"), 900)
    r, n = ctx.rank, ctx.total_consensus_nodes
    out = {}
    for label, kw in cases:
        rt = ConsensusRuntime(ConsensusConfig(**kw), n, ctx=ctx)
        cfg, m, rl = rt.cfg, rt.pod_size, rt.ring_len
        x0 = T.tree_map(lambda a: a[r:r + 1].clone(), ref_x0(n))
        treedef = T.tree_flatten(x0)[1]
        layout = rt.state_layout(x0)
        plan = rt.wire_plan_for(layout)
        mkeys = (["overflow_frac", "residual_norm"]
                 + (["push_sum_weight"] if cfg.push_sum_enabled else [])
                 + (["wire_bytes_delivered", "delivered_frac"]
                    if cfg.faults_enabled else [])
                 + (["deadline_miss_frac"] if cfg.straggle_rate is not None
                    else [])
                 + (["active_nodes"] if cfg.membership is not None else []))
        res = []
        prev, dump = x0, None
        stem = os.path.join(ref_dir, label.replace("/", "_"))
        for k in range(1, steps + 1):
            if dump is None:
                state = rt.init_state(prev)
            else:
                prev = T.tree_unflatten(treedef, [
                    torch.from_numpy(np.array(dump[f"x{i}"][r:r + 1]))
                    for i in range(len(T.tree_leaves(x0)))])
                state = {key[2:]: torch.from_numpy(
                    np.array(dump[key][r:r + 1])) for key in dump
                    if key.startswith("s_")}
            half = T.tree_map(torch.add, prev, T.tree_map(
                lambda a: a[r:r + 1].clone(), ref_delta(k, n)))
            nz = np.random.default_rng([2, k]).random(
                (rl, layout.n_rows, plan.noise_cols()),
                dtype=np.float32)[r // m:r // m + 1]
            sent = []
            encode = rt._encode_unit

            def spy(*a, **kw2):
                pays = encode(*a, **kw2)
                if pays[0] is not None:
                    sent.append(pays[0].clone())
                return pays
            rt._encode_unit = spy
            xn, st, mt = rt.exchange(prev, half, state, k,
                                     noise=torch.from_numpy(nz))
            rt.land()
            del rt._encode_unit
            dump = np.load(f"{stem}-{k}.npz")
            view = rt.view(rt.wiring_at(k))
            n_leaves = len(T.tree_leaves(xn))
            step = {"x": [_gap(a[0], dump[f"x{i}"][r]) for i, a in
                          enumerate(T.tree_leaves(xn))],
                    "x_tilde": _gap(st["x_tilde"][0], dump["s_x_tilde"][r]),
                    "m_agg": _gap(st["m_agg"][0], dump["s_m_agg"][r]),
                    "weights": all(np.array_equal(
                        st[key][0].numpy(), dump["s_" + key][r])
                        for key in ("ps_w", "ps_nbr")
                        if cfg.push_sum_enabled),
                    "x_digest": [_h(a[0]) for a in T.tree_leaves(xn)],
                    "active": bool(view.active), "metrics": {}}
            assert n_leaves == sum(key.startswith("x") for key in dump)
            if "perm_up" in dump:
                up = {int(t): int(s) for s, t in dump["perm_up"]}
                dn = {int(t): int(s) for s, t in dump["perm_dn"]}
                step["peers"] = [view.peers,
                                 (up[r], dn[r]) if r in up else None]
            for key in mkeys:
                got = mt[key][0].numpy().astype(np.float32)
                want = np.asarray(dump["m_" + key][r], np.float32)
                step["metrics"][key] = bool(
                    np.allclose(got, want, rtol=1e-5, atol=0)
                    if key == "residual_norm" else np.array_equal(got, want))
            if not view.active:
                step["frozen"] = (
                    all(torch.equal(a, b) for a, b in zip(
                        T.tree_leaves(xn), T.tree_leaves(prev)))
                    and all(torch.equal(st[key], state[key])
                            for key in ("x_tilde", "m_agg")))
            if cfg.wire_packing == "async":
                step["fly"] = [
                    (int((st[key][0].numpy() != dump["s_" + key][r]).sum()),
                     int(dump["s_" + key][r].size))
                    for key in ("fly_self", "fly_up", "fly_dn")]
            elif "pay" in dump:
                step["pay_equal"] = (
                    not sent if not view.active else
                    bool(np.array_equal(torch.cat(sent).numpy(),
                                        dump["pay"][r])))
            res.append(step)
        out[label] = res
    return out


# ---- the ranks' entry points ------------------------------------------------
def ring4_work(ref_dir: str, ref_cases: list, ref_steps: int) -> dict:
    """Everything the 4-rank group runs: the exchanges, the refusals, the
    trainers (the async one with the probe), then the reference holding,
    once the reference's dumps are written."""
    ctx = make_process_context("cpu")
    out = {"exchanges": {name: run_exchanges(kw, 4, ctx)
                         for name, kw in EXCHANGES4.items()},
           "train": {name: train_run(kw, 4, ctx, PROBE_AFTER
                                     if name == "async" else None)
                     for name, kw in TRAINERS.items()}}
    out["reference"] = hold_to_reference(ctx, ref_dir, ref_cases, ref_steps)
    out["pending"] = ctx.ring.pending
    return out


def ring5_work() -> dict:
    ctx = make_process_context("cpu")
    return {"exchanges": {name: run_exchanges(kw, 5, ctx)
                          for name, kw in EXCHANGES5.items()}}


def ring2_work() -> dict:
    ctx = make_process_context("cpu")
    return {"exchanges": {name: run_exchanges(kw, 2, ctx)
                          for name, kw in EXCHANGES2.items()}}
