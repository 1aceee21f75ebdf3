"""The ranks' work of ``test_torch_ring_elastic.py``.

A module of its own, free of JAX (the ranks that ``launch.mesh.run_ranks``
spawns import it): elastic membership, the two-level hierarchy and
``--checkpoint-dir`` over ranks.  The stacked runs of the test process use
the same functions with no context.  Tensors are recorded as SHA-1 digests
(``torch_ring_work._h``).
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import os

import torch

import torch_ring_work as W
from repro_torch import checkpoint
from repro_torch.core import telemetry
from repro_torch.core import tree as T
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.launch import train
from repro_torch.launch.mesh import make_process_context

ALL4 = (True,) * 4
#: ``test_torch_membership.CHURN`` (node 2 out for the second of three
#: epochs), re-wired every step: the hole at step 2, the rejoin at step 3,
#: resyncs at both
CHURN = (ALL4, (True, True, False, True), ALL4)
CHURN_KW = dict(membership=CHURN, schedule_period=1)
PLAN_B = W.PLAN_B

#: the 4-rank group's exchanges: the two options the process ring once
#: refused, each under the name it was refused by ("membership": the churn
#: masks on the packed transport; "hierarchy": pods of 2, packed), then the
#: churn masks on the other transports and the burst channel, and the pod
#: ring
EXCHANGES4 = {
    "membership": dict(CHURN_KW),
    "hierarchy": dict(hierarchy="pods=2"),
    "churn pipelined 3": dict(CHURN_KW, wire_packing="pipelined",
                              pipeline_chunks=3),
    "churn async s0": dict(CHURN_KW, wire_packing="async", staleness=0),
    "churn async s1": dict(CHURN_KW, wire_packing="async"),
    # loss seed 5: the channel drops arrivals retired at steps 1 and 3
    "churn burst": dict(CHURN_KW, wire_packing="async", loss_seed=5,
                        link_loss_model="gilbert:p=0.1,r=0.9"),
    "pods 2 pipelined 3": dict(hierarchy=2, wire_packing="pipelined",
                               pipeline_chunks=3),
    "pods 2 async s1": dict(hierarchy=2, wire_packing="async"),
    "pods 2 plan B": dict(hierarchy=2, wire_codec=PLAN_B),
    "pods 4": dict(hierarchy=4),
    "pods 1": dict(hierarchy=1),
}
#: the 6-rank group: pods of 3 (hazard 15's fused multiply-add) and pods of
#: 2 under a pod mask (pod 1's two members out at step 2)
EXCHANGES6 = {
    "pods 2 of 6": dict(hierarchy=2),
    "pods 3 of 6 pod mask": dict(hierarchy=3, schedule_period=1,
                                 membership=((True,) * 3,
                                             (True, False, True),
                                             (True,) * 3)),
}

#: the trainers' command line (reduced smollm-135m, 3 steps on 4 nodes)
TRAIN_ARGV = ["--reduced", "--device", "cpu", "--steps", "3", "--batch",
              "8", "--seq", "32"]
#: the checkpointed trainers: a save at the last step
CKPT_RUNS = {"packed": [], "async s1": ["--wire-packing", "async"]}
#: the trainer flags no other ring test holds: the adaptive controller
#: (``with_codec`` after step 2: int8 -> int4), gradient accumulation,
#: bfloat16 and one telemetry sink per rank
FLAGS_ARGV = ["--wire-codec", "adaptive", "--codec-period", "1",
              "--microbatches", "2", "--compute-dtype", "bfloat16"]


def run_exchanges(kw: dict, n: int, ctx=None) -> dict:
    """``torch_ring_work.run_exchanges`` plus, per step, this rank's peers
    (``RingView.peers``; None stacked) and active flag."""
    out = W.run_exchanges(kw, n, ctx)
    rt = ConsensusRuntime(ConsensusConfig(**kw), n, ctx=ctx)
    for k, st in enumerate(out["steps"], start=1):
        v = rt.view(rt.wiring_at(k))
        st["peers"] = v.peers if ctx is not None else None
        st["active"] = v.active
    return out


def digests(state: dict) -> dict:
    """Per node: the digests of a train state's parameters (each leaf),
    optimizer state leaves and consensus entries, and its step."""
    nl = T.tree_leaves(state["params"])[0].shape[0]
    return {"params": [W._rows(a, nl) for a in T.tree_leaves(state["params"])],
            "opt": [W._rows(a, nl) for a in T.tree_leaves(state["opt"])
                    if torch.is_tensor(a)],
            **{key: W._rows(v, nl) for key, v in state["consensus"].items()},
            "step": state["step"]}


def _file_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def ckpt_run(extra: list, out_dir: str, ctx=None) -> dict:
    """The trainer CLI with ``extra``, saving at its last step into
    ``out_dir``: stacked on 4 nodes or as this rank.  The final state's
    digests, each step's node losses, the file's SHA-1 and size (rank 0 or
    stacked), and the state loaded back from it (this rank's rows)."""
    argv = [*TRAIN_ARGV, *extra, "--checkpoint-dir", out_dir,
            "--checkpoint-every", "3"]
    argv += ["--process-ring"] if ctx is not None else ["--nodes", "4"]
    hist, state = train.main(argv, return_state=True)
    out = {"final": digests(state),
           "losses": [h["node_loss"].tolist() for h in hist]}
    path = os.path.join(out_dir, "step_00000003.npz")
    if ctx is None or ctx.rank == 0:
        out["file"] = W._h(torch.frombuffer(bytearray(_file_bytes(path)),
                                            dtype=torch.uint8))
        out["size"] = os.path.getsize(path)
    loaded, step = checkpoint.load_checkpoint(out_dir, state, ctx=ctx)
    out["loaded"], out["loaded_step"] = digests(loaded), step
    return out


def _sink(path: str) -> dict:
    """A telemetry sink's step records' losses (by step) and its events'
    names in order."""
    import json
    steps, events = {}, []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec["kind"] == "step":
                steps[rec["step"]] = rec["metrics"].get("loss")
            elif rec["kind"] == "event":
                events.append(rec["event"])
    return {"sink_losses": steps, "sink_events": events}


def flags_run(tel_dir: str, ctx=None) -> dict:
    """The trainer CLI with ``FLAGS_ARGV`` and ``--telemetry`` into
    ``tel_dir``: the step lines' codecs and node losses, the final state's
    digests and this rank's telemetry sink (its records and whether it
    validates)."""
    argv = [*TRAIN_ARGV, *FLAGS_ARGV, "--telemetry", "--telemetry-dir",
            tel_dir, "--run-id", "flags"]
    argv += ["--process-ring"] if ctx is not None else ["--nodes", "4"]
    hist, state = train.main(argv, return_state=True)
    sink = os.path.join(tel_dir, "telemetry-flags" + (
        "" if ctx is None else f"-rank{ctx.rank}") + ".jsonl")
    return {"final": digests(state),
            "codecs": [h["codec"] for h in hist],
            "losses": [h["node_loss"].tolist() for h in hist],
            "sink": os.path.basename(sink),
            "sink_errors": telemetry.validate_file(sink), **_sink(sink)}


def tag_work(ctx) -> dict:
    """A rank that skips a slot for an epoch and then uses it: every rank
    posts on slot "a" (the shift ring), ranks 0, 1 and 3 on slot "b" over
    their compacted ring while rank 2 is out, every rank on slot "c", then
    every rank on slot "b" over the whole ring.  Per phase the ranks whose
    values arrived from the left and from the right (None where the rank
    sat out), and the tag each rank derived for slot "b"'s key."""
    r = ctx.rank
    compact = {0: (3, 1), 1: (0, 3), 3: (1, 0)}
    got = []
    for phase, (slot, peers) in enumerate(
            (("a", None), ("b", compact.get(r, False)), ("c", None),
             ("b", None))):
        if peers is False:
            got.append(None)
            continue
        x = torch.full((5,), float(10 * phase + r))
        left, right = ctx.ring_start(x, slot, peers=peers).wait()
        got.append((int(left[0]) - 10 * phase, int(right[0]) - 10 * phase))
    key = ("b", (5,), torch.float32, "cpu", 2, 2)
    return {"got": got, "tag_b": ctx.ring.tag(key)}


def refusal_work(ctx, refusals: list) -> dict:
    """Each (name, ConsensusConfig keywords) of ``refusals`` as a runtime of
    this rank: the ``ValueError`` message it raises (None if none)."""
    out = {}
    for name, kw in refusals:
        try:
            ConsensusRuntime(ConsensusConfig(**kw), 4, ctx=ctx)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def ring4_work(ckpt_dirs: dict, stacked_done: str, tel_dir: str,
               ref_dir: str, ref_cases: list, ref_steps: int,
               refusals: list) -> dict:
    """Everything the 4-rank group runs: the gloo tag case, the refusals,
    the exchanges, the checkpointed trainers into ``ckpt_dirs["ring"]``
    (each file loaded back, then the stacked run's file of
    ``ckpt_dirs["stacked"]`` once the test process has written it), the
    flags trainer, then the reference holding."""
    ctx = make_process_context("cpu")
    out = {"tags": tag_work(ctx), "refusals": refusal_work(ctx, refusals),
           "exchanges": {name: run_exchanges(kw, 4, ctx)
                         for name, kw in EXCHANGES4.items()},
           "ckpt": {}}
    for name, extra in CKPT_RUNS.items():
        out["ckpt"][name] = ckpt_run(extra, ckpt_dirs["ring"][name], ctx)
    # a stacked checkpoint onto the ring: this rank's rows of the stacked
    # run's file
    W.wait_for(stacked_done, stacked_done + ".failed", 600)
    for name in CKPT_RUNS:
        template = _template_state(CKPT_RUNS[name], ctx)
        state, step = checkpoint.load_checkpoint(ckpt_dirs["stacked"][name],
                                                 template, ctx=ctx)
        out["ckpt"][name]["from_stacked"] = digests(state)
        out["ckpt"][name]["from_stacked_step"] = step
    out["flags"] = flags_run(tel_dir, ctx)
    out["reference"] = W.hold_to_reference(ctx, ref_dir, ref_cases,
                                           ref_steps)
    out["pending"] = ctx.ring.pending
    return out


def ring6_work() -> dict:
    ctx = make_process_context("cpu")
    return {"exchanges": {name: run_exchanges(kw, 6, ctx)
                          for name, kw in EXCHANGES6.items()}}


def _template_state(extra: list, ctx) -> dict:
    """A fresh train state of the checkpointed trainer's setup (this
    rank's rows): the structure a checkpoint loads into."""
    from repro_torch.configs import get_config, reduced
    setup = train.build_train_setup(
        reduced(get_config("smollm-135m")), device="cpu", ctx=ctx,
        wire_packing="async" if extra else "packed")
    return train.init_train_state(setup, 1)
