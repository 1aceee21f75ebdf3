"""Decentralized training on one device: consensus nodes on a stacked axis.

Counterpart of ``repro.launch.train``.  One training step k does, for the
``N`` consensus nodes held as a leading axis of every parameter:

    per node i: loss_i, grad_i = forward/backward of ``Transformer`` on
                node i's shard of the global batch
    x_half     = optimizer step on every node (lr = schedule(k))
    x_next     = ConsensusRuntime.exchange(params, x_half, ...)  (ADC-DGD)

The reference runs each node on its own device inside ``shard_map``.
``--process-ring`` runs one node per process instead, each a rank of a
gloo group started by ``python -m torch.distributed.run --nproc-per-node
N`` (``launch.mesh``): the rank trains its node on its rows of the global
batch, and the exchange's payloads cross the wire to its ring neighbours
(``models.sharding.StagedRing``), so each rank computes the stacked
trainer's row bit for bit; the ranks' losses and per-node metrics are
gathered, and rank 0 prints the step lines, with the exchange's measured
wire beside the static wire bytes (``_wire_stats``).  ``--nodes`` must
then equal the world size or be absent.  The ranks run on
``cuda:<LOCAL_RANK>``, or all on the one ``--device`` named (``cuda:0``,
``cpu``).  Every transport, stride schedule, fault, topology, membership
schedule (``--node-failures``: an inactive rank sends nothing) and
``--hierarchy`` (each pod's members add their deltas over the group, then
run the outer exchange as replicas) runs there, and ``--checkpoint-dir``
writes one file, the global state, byte for byte the stacked run's
(``checkpoint.save_checkpoint`` with the context: rank 0 gathers the
ranks' rows leaf by leaf).

``--algorithm compressed_dgd`` runs the paper's Eq. (5) negative control
instead of ADC-DGD.  ``--wire-packing`` picks the transport: ``packed``
(one payload per node and step), ``pipelined`` (``--pipeline-chunks``
transfer units), ``async`` (one step stale at ``--staleness 1``) or
``per_leaf`` (the per-leaf reference transport of the int8 wire).
``--ring-strides 1,2 --schedule-period P`` makes the ring time-varying:
its stride cycles through the list, each held P steps, and every step
that re-wires it rebuilds ``m_agg`` from the new neighbours (a resync);
the step line then names the epoch's stride and marks a resync.
``--topology directed-ring`` (``--forward-weight``) makes the ring
column-stochastic and the exchange push-sum; ``--link-loss`` (with
``--loss-seed``, or ``--link-loss-model gilbert:p=..,r=..`` for burst
loss), ``--resync-retries`` and, on the async transport, ``--straggle``
(``--straggle-seed``) inject the reference's seeded faults; the step line
then shows ``delivered_frac`` (and ``push_sum_weight``,
``deadline_miss_frac``).  ``--node-failures 'node@start:end[;...]'``
takes nodes out of the ring for schedule epochs [start, end) of
``--schedule-period`` steps (elastic membership: the survivors form a
compacted ring and the step line shows ``active_nodes``); ``--hierarchy
pods=P`` runs two-level consensus (each pod of nodes/P nodes averages its
optimizer delta in fp32, then the pods run the compressed exchange on the
pod ring, whose elements ``--node-failures`` then indexes).

``--microbatches M`` accumulates each node's gradient over M slices of its
shard (the first slice's, then each later one's added in order, times
f32(1/M), as the reference's compiled ``g / M``).  ``--checkpoint-dir``
with ``--checkpoint-every E`` saves the whole train state after every E-th
step (``repro_torch.checkpoint``; on the async transport over ranks the
step's flight lands first); a run resumes through ``load_checkpoint``
(over ranks with the context: each rank reads its rows) and
:func:`train_step`.  ``--telemetry`` writes the
``telemetry/v1`` sink ``<--telemetry-dir>/telemetry-<--run-id>.jsonl``
(step records, host events) and the Perfetto trace ``trace-<run id>.json``
whose exchange spans are measured on the device (``core.telemetry``), and
turns on the exchange's telemetry metrics; ``python -m
repro_torch.launch.obs validate <sink> --trace <trace>`` checks both.

The wire codec is ``--wire-codec int8|int4|int2|topk|topk:k=<int>``, or
``adaptive``: then an ``AdaptiveBitController`` re-selects it every
``--codec-period`` steps from the epoch's mean residual, overflow and
consensus error, and the runtime's codec is swapped while the train state
(fp32 shadows, which no codec changes) is kept.  ``--wire-plan
"mixed:pattern=codec,..."`` gives each leaf its own codec (it overrides
``--wire-codec``); with ``--wire-codec adaptive`` the controller then
moves the plan's hot slots through the ladder and pins the others.

``--compute-dtype bfloat16`` declares the parameters and runs the model
in bfloat16, as the reference's production configuration does (the
optimizer's update is float32 arithmetic rounded once, the wire packs
every leaf as float32, ``x_tilde`` and ``m_agg`` stay float32, and the
new parameters come back in bfloat16); ``--remat full|dots|none`` picks
what the backward recomputes (``models.transformer``: the default
``full``, the reference trainer's ``remat=True``, keeps only each
period's input; ``none`` keeps every activation).

``--periods P`` cuts the model's depth to P periods of its layer pattern
and keeps every width (a full-width model that does not fit the card at
full depth on several nodes).  For the mixture-of-experts archs
(``--arch granite-moe-3b-a800m`` or ``deepseek-moe-16b``) each node's
loss adds ``router_aux_weight`` times the router's load-balance loss, and
the step metrics report its node mean as ``aux`` (0 for dense models;
absent with ``--microbatches`` > 1, as in the reference).  The
state-space archs train the same way (``--arch mamba2-1.3b``: 48 'M'
layers, 2.6 M payload rows per node, so ``--periods 8`` on 4 nodes of
one card); their chunked scan needs ``--seq`` to be a multiple of
``min(ssm_chunk, seq)``.  whisper-small (``--arch whisper-small``) trains
with the encoder in the graph: each sequence carries its synthetic frames
``(encoder_frames, d_model)``, drawn by the data stub from its first
``seq + 1`` tokens, so ``--seq`` must be at least ``encoder_frames - 1``
(1,503 at full size; ValueError otherwise, where the reference fails in a
numpy broadcast).

CLI (runs on ``cuda`` unless ``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --algorithm adc_dgd --nodes 4 --batch 16 --seq 512 --steps 5 \\
        --wire-codec int4
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
        --periods 8 --nodes 4 --batch 16 --seq 512 --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small \\
        --nodes 4 --batch 4 --seq 1536 --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --nodes 4 --batch 16 --seq 512 --steps 3 --compute-dtype bfloat16 \\
        --remat dots
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train --process-ring --device cuda:0 \\
        --batch 16 --seq 512 --steps 5
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import subprocess
import time
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save_checkpoint
from repro_torch.core import codec as wcodec
from repro_torch.core import telemetry
from repro_torch.core import tree as T
from repro_torch.core import wireplan
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.core.f32 import recip
from repro_torch.core.hierarchy import HierarchySpec
from repro_torch.core.topology import MembershipSchedule
from repro_torch.data.pipeline import node_rows
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import init_params, meta_params
from repro_torch.models.sharding import ParallelContext
from repro_torch.optim import by_name as opt_by_name
from repro_torch.optim.schedules import (constant_schedule,
                                         cosine_warmup_schedule,
                                         inverse_power_schedule)

__all__ = ["TrainSetup", "build_train_setup", "with_codec",
           "init_train_state", "train_step", "build_exchange_probe",
           "measure_consensus_overhead", "main"]


@dataclasses.dataclass
class TrainSetup:
    cfg: ModelConfig
    defs: TF.ModelDefs
    consensus: ConsensusRuntime
    optimizer: Any
    schedule: Any
    n_nodes: int
    device: torch.device
    seed: int = 0            # consensus quantization-noise seed
    microbatches: int = 1    # gradient-accumulation slices per node
    compute_dtype: torch.dtype = torch.float32
    remat: bool | str = True  # True | "dots" | False (models.transformer)


#: the CLI's names of the compute dtypes and of the ``remat`` choices (the
#: reference's ``dryrun.py`` names)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
REMATS = {"full": True, "dots": "dots", "none": False}


def build_train_setup(cfg: ModelConfig, *, consensus_nodes: int | None = None,
                      algorithm: str = "adc_dgd", gamma: float = 1.0,
                      quant_mode: str = "fixed", fixed_step0: float = 1e-3,
                      optimizer: str = "sgd", schedule: str = "constant",
                      lr: float = 1e-2, eta: float = 0.5, warmup: int = 100,
                      total_steps: int = 1000,
                      track_consensus_error: bool = False,
                      wire_codec: str = "int8",
                      byte_budget: float | None = None,
                      wire_packing: str = "packed", pipeline_chunks: int = 4,
                      staleness: int = 1,
                      ring_strides: tuple[int, ...] = (1,),
                      schedule_period: int = 1,
                      topology: str = "ring",
                      forward_weight: float | None = None,
                      link_loss: float | None = None, loss_seed: int = 0,
                      link_loss_model: str = "bernoulli",
                      resync_retries: int = 3,
                      straggle_rate: float | None = None,
                      straggle_seed: int = 0,
                      membership: tuple | None = None,
                      hierarchy=None, telemetry: bool = False,
                      microbatches: int = 1, seed: int = 0,
                      compute_dtype=torch.float32, remat: bool | str = True,
                      device=None,
                      ctx: ParallelContext | None = None) -> TrainSetup:
    """Everything static about a run.  ``wire_codec`` is a codec name or a
    ``mixed:`` plan spec; ``membership`` per-epoch masks of active ring
    elements (``MembershipSchedule.masks``), ``hierarchy`` a pod count,
    ``"pods=P"`` or a ``HierarchySpec``; ``telemetry`` turns on the
    exchange's telemetry metrics; ``microbatches`` splits each node's batch
    for gradient accumulation.  ``compute_dtype`` and ``remat`` are the
    reference's, with its defaults (float32, full recompute).  ``device``
    defaults to ``cuda`` (raising when there is none); pass
    ``device="cpu"`` for the plain PyTorch path.  ``consensus_nodes``
    defaults to 4.  A process context ``ctx`` (``launch.mesh.
    make_process_context``) runs this rank's node of a ring of its world
    size (``consensus_nodes`` must then be that or None) on its
    device."""
    if ctx is not None and ctx.process_ring:
        world = ctx.total_consensus_nodes
        if consensus_nodes not in (None, world):
            raise ValueError(f"consensus_nodes={consensus_nodes}, but the "
                             f"process ring has {world} ranks")
        consensus_nodes = world
        if device is None:
            device = ctx.device
    elif consensus_nodes is None:
        consensus_nodes = 4
    dev = resolve_device(device)
    ccfg = ConsensusConfig(algorithm=algorithm, gamma=gamma,
                           quant_mode=quant_mode, fixed_step0=fixed_step0,
                           track_consensus_error=track_consensus_error,
                           wire_codec=wire_codec, byte_budget=byte_budget,
                           wire_packing=wire_packing,
                           pipeline_chunks=pipeline_chunks,
                           staleness=staleness,
                           ring_strides=tuple(ring_strides),
                           schedule_period=schedule_period,
                           topology=topology, forward_weight=forward_weight,
                           link_loss=link_loss, loss_seed=loss_seed,
                           link_loss_model=link_loss_model,
                           resync_retries=resync_retries,
                           straggle_rate=straggle_rate,
                           straggle_seed=straggle_seed,
                           membership=membership, hierarchy=hierarchy,
                           telemetry=telemetry)
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    if schedule == "constant":
        sched = constant_schedule(lr)
    elif schedule == "inverse_power":
        sched = inverse_power_schedule(lr, eta)
    elif schedule == "cosine":
        sched = cosine_warmup_schedule(lr, warmup, total_steps)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    TF.check_remat(remat)
    return TrainSetup(cfg=cfg, defs=TF.build_defs(cfg, dtype=compute_dtype),
                      consensus=ConsensusRuntime(ccfg, consensus_nodes,
                                                 ctx=ctx),
                      optimizer=opt_by_name(optimizer), schedule=sched,
                      n_nodes=consensus_nodes, device=dev, seed=seed,
                      microbatches=microbatches, compute_dtype=compute_dtype,
                      remat=remat)


def with_codec(setup: TrainSetup, name: str) -> TrainSetup:
    """The same setup with the consensus runtime's wire codec (or plan
    spec) swapped for ``name``.  The train state carries over: its packed
    shadows are fp32 and no codec changes them, and the buffer keeps the
    setup's leaf placement (a tier change moves codecs, never rows)."""
    rt = setup.consensus
    rt.land()              # the state is complete before a new runtime
    cfg = dataclasses.replace(rt.cfg, wire_codec=name)
    return dataclasses.replace(
        setup, consensus=ConsensusRuntime(cfg, setup.n_nodes,
                                          layout_spec=rt.layout_spec,
                                          ctx=rt.ctx))


def init_train_state(setup: TrainSetup, seed: int = 0,
                     params: Any = None) -> dict:
    """A fresh train state: every node starts from the same random x0
    (drawn from ``seed``), or from ``params`` (a stacked tree, e.g. from
    ``models.params.params_from_jax``) when given, which must lie on
    ``setup.device``.  Under a process context the tree holds the rank's
    one node (a leading axis of 1): a row of the stacked draw."""
    if params is None:
        params = init_params(setup.defs.storage, seed, setup.device,
                             n_nodes=setup.consensus.n_local)
    wrong = {str(a.device) for a in T.tree_leaves(params)
             if a.device.type != setup.device.type}
    if wrong:
        raise ValueError(f"params lie on {sorted(wrong)}, the setup runs on "
                         f"{setup.device}")
    return {"params": params,
            "opt": setup.optimizer.init(params),
            "consensus": setup.consensus.init_state(params),
            "step": 0}


def _node_grads(setup: TrainSetup, params: Any, batch: dict,
                auxes: list | None = None):
    """Per-node forward/backward: (losses (N,), stacked gradient tree).

    Node i's ``Transformer`` shares its parameters' storage with slice i
    of the stacked tree, and only one microbatch's activations are alive
    at a time.  Node i trains on its rows of the global batch
    (``data.pipeline.node_rows``); under a process context the rank's one
    node, on the rows of node ``rank``.  With ``microbatches`` M > 1 node
    i's shard splits into M slices: its gradient and loss are the first
    slice's, each later one's added in order, times f32(1/M) (what the
    reference's ``g / M`` compiles to; exact at a power of two).  With M = 1 each node's
    auxiliary loss (the MoE router's, 0 for dense models) is appended to
    ``auxes`` when a list is given; the reference reports it only then."""
    n, m = setup.n_nodes, setup.microbatches
    rt = setup.consensus
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"global batch {b} does not split over {n} nodes")
    bn = b // n
    first = rt.ctx.rank if rt.ctx.process_ring else 0
    if bn % m:
        raise ValueError(f"node batch {bn} does not split into {m} "
                         "microbatches")
    bm = bn // m
    inv_m = float(recip(m))
    grads = T.tree_map(torch.empty_like, params)
    g_leaves = T.tree_leaves(grads)
    losses = []
    for i in range(rt.n_local):
        rows = node_rows(b, n, first + i)
        model = TF.Transformer(setup.defs,
                               T.tree_map(lambda a: a[i], params),
                               compute_dtype=setup.compute_dtype,
                               remat=setup.remat)
        leaves = T.tree_leaves(model.tree())
        for j in range(m):
            lo = rows.start + j * bm
            mb = {k: torch.as_tensor(v[lo:lo + bm], device=setup.device)
                  for k, v in batch.items()}
            loss_j, parts = model(mb)
            gs = torch.autograd.grad(loss_j, leaves)
            if m == 1 and auxes is not None:
                auxes.append(parts["aux"].detach())
            for dst, g in zip(g_leaves, gs):
                (dst[i].copy_ if j == 0 else dst[i].add_)(g)
            loss = loss_j.detach() if j == 0 else loss + loss_j.detach()
        if m > 1:
            for dst in g_leaves:
                dst[i].mul_(inv_m)
            loss = loss * inv_m
        losses.append(loss)
    return torch.stack(losses), grads


def train_step(setup: TrainSetup, state: dict, batch: dict,
               noise: torch.Tensor | None = None) -> tuple[dict, dict]:
    """One decentralized step.  ``batch`` holds the global batch (numpy or
    tensors), split across nodes in order; ``noise`` optionally injects
    the exchange's quantization noise.  Returns (new state, metrics).
    Under a process context the nodes' losses and per-node metrics are
    gathered from every rank, so each rank's metrics are the stacked
    trainer's."""
    k = state["step"] + 1
    auxes = []
    ctx = setup.consensus.ctx
    losses, grads = _node_grads(setup, state["params"], batch, auxes)
    lr_k = setup.schedule(k)
    x_half, opt_state = setup.optimizer.step(state["opt"], state["params"],
                                             grads, lr_k)
    del grads
    with telemetry.exchange_window():
        x_next, cons, cmetrics = setup.consensus.exchange(
            state["params"], x_half, state["consensus"], k, seed=setup.seed,
            noise=noise)
    losses = ctx.gather_nodes(losses)
    metrics = {"loss": _host(losses.mean()), "node_loss": losses,
               "lr": lr_k}
    if auxes and setup.cfg.router_aux_weight:
        metrics["aux"] = _host(ctx.gather_nodes(torch.stack(auxes)).mean())
    rt = setup.consensus
    if rt.cfg.algorithm == "adc_dgd":
        metrics["codec"] = rt.wire_name
    if rt.cfg.schedule_varying:
        metrics["ring_stride"] = rt.stride_at(k)
        metrics["resync"] = (rt.cfg.algorithm == "adc_dgd"
                             and rt.resync_at(k))
    for name, v in cmetrics.items():
        if torch.is_tensor(v) and v.dim() == 1:
            v = ctx.gather_nodes(v)        # the per-node vectors
        metrics[name] = _host(v.mean()) if torch.is_tensor(v) else float(v)
    return ({"params": x_next, "opt": opt_state, "consensus": cons,
             "step": k}, metrics)


def _host(v: torch.Tensor) -> float:
    """A scalar metric read to the host; NaN on the ``meta`` device, which
    holds no values (a dry run)."""
    return float("nan") if v.is_meta else float(v)


def build_exchange_probe(setup: TrainSetup):
    """The consensus exchange alone (no forward or backward): the
    numerator of the ``consensus_overhead_frac`` metric (exchange time /
    step time).  ``probe(params, cons_state, k)`` runs the trainer's
    ``ConsensusRuntime.exchange`` of step ``k`` with ``x_half = params``
    and returns its ``(x_next, new consensus state, metrics)``.  Returns
    None when the setup runs no ``adc_dgd`` exchange (another algorithm,
    or one node).

    The exchange writes its kernels' outputs into buffers it allocates and
    never into the state it is given, so the probe runs on the live state
    and leaves it bitwise as it was (no clone: a clone of the parameters
    and shadows would not fit beside the largest trainers on one card).
    It reads the same host masks as the step (keyed by step, stateless)
    and restores the runtime's ``zero_payloads`` count and the telemetry's
    span observer: a measurement, not a step of the run.  On the async
    transport over ranks the run's flight lands first and the probe's
    exchange runs aside (``ConsensusRuntime.aside``): its own flight lands
    in its own state before the probe returns (its wire is in the time),
    so the live state and the run's next retire are as they were; the
    step after the probe finds its flight landed (a wait of 0)."""
    rt = setup.consensus
    if rt.cfg.algorithm != "adc_dgd" or setup.n_nodes <= 1:
        return None

    def probe(params, cons_state, k: int):
        zero, obs = rt.zero_payloads, telemetry.trace_observer()
        telemetry.set_trace_observer(None)
        try:
            with rt.aside():
                return rt.exchange(params, params, cons_state, k,
                                   seed=setup.seed)
        finally:
            rt.zero_payloads = zero
            telemetry.set_trace_observer(obs)

    return probe


def measure_consensus_overhead(setup: TrainSetup, state: dict,
                               step_time_s: float | None,
                               repeats: int = 5) -> dict:
    """Time the exchange alone against the measured full-step time.

    Returns ``{"consensus_exchange_s": median of ``repeats`` probe calls
    after a warm one, each between two synchronizes}`` plus, when a step
    time is given, ``{"consensus_overhead_frac": exchange / step}``, the
    reference's keys; ``{}`` when the setup runs no ``adc_dgd`` exchange
    (:func:`build_exchange_probe`).  The exchange of step ``state["step"]
    + 1`` on the live state, which it leaves unchanged."""
    probe = build_exchange_probe(setup)
    if probe is None:
        return {}
    k = state["step"] + 1
    dev = setup.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    times = []
    for r in range(repeats + 1):                   # the first one warms
        sync()
        t = time.perf_counter()
        out = probe(state["params"], state["consensus"], k)
        sync()
        del out
        if r:
            times.append(time.perf_counter() - t)
    res = {"consensus_exchange_s": float(np.median(times))}
    if step_time_s:
        res["consensus_overhead_frac"] = (res["consensus_exchange_s"]
                                          / step_time_s)
    return res


def main(argv=None, *, return_state: bool = False):
    """Command-line entry point; returns the per-step metrics (and the
    final train state when ``return_state``)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import SyntheticLMDataset

    ap = argparse.ArgumentParser(description="decentralized LM training "
                                 "(PyTorch port, one device)")
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", help="smoke-size model")
    ap.add_argument("--periods", type=int, default=None,
                    help="cut the depth to this many periods of the layer "
                         "pattern (widths unchanged), as serve's --periods")
    ap.add_argument("--algorithm", default="adc_dgd",
                    choices=["adc_dgd", "dgd", "compressed_dgd", "allreduce",
                             "none"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--nodes", type=int, default=None,
                    help="consensus nodes (default 1; under --process-ring "
                         "the world size, which it must equal if given)")
    ap.add_argument("--process-ring", action="store_true",
                    help="one node per rank of a gloo group (start with "
                         "python -m torch.distributed.run --nproc-per-node "
                         "N); the payloads cross the wire between ranks")
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch, split evenly over the nodes")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--quant-mode", default="fixed",
                    choices=["fixed", "adaptive"])
    ap.add_argument("--wire-packing", default="packed",
                    choices=["packed", "pipelined", "per_leaf", "async"],
                    help="consensus wire transport: one payload for the "
                         "whole tree, --pipeline-chunks transfer units, the "
                         "one-step-stale exchange, or the per-leaf "
                         "reference transport (int8 codes and scales per "
                         "leaf); all give the same bits but async")
    ap.add_argument("--pipeline-chunks", type=int, default=4,
                    help="transfer units of --wire-packing pipelined")
    ap.add_argument("--staleness", type=int, default=1, choices=[0, 1],
                    help="--wire-packing async: 1 retires the previous "
                         "step's payload; 0 is the packed exchange")
    ap.add_argument("--ring-strides", default="1",
                    help="comma-separated node-ring strides cycled per "
                         "schedule epoch (time-varying topology), e.g. 1,2")
    ap.add_argument("--schedule-period", type=int, default=1,
                    help="steps between ring re-wirings")
    ap.add_argument("--topology", default="ring",
                    choices=["ring", "directed-ring"],
                    help="consensus graph of the node ring: directed-ring "
                         "is column-stochastic only and switches the "
                         "exchange to push-sum (ratio) consensus")
    ap.add_argument("--forward-weight", type=float, default=None,
                    help="directed-ring upstream in-weight in "
                         "(0, 1 - self_weight); default 2(1-w_ii)/3")
    ap.add_argument("--link-loss", type=float, default=None,
                    help="per-directed-edge Bernoulli packet-loss rate in "
                         "[0, 1); dropped payloads fall back to the stale "
                         "x_tilde estimate")
    ap.add_argument("--loss-seed", type=int, default=0,
                    help="seed of the deterministic loss masks")
    ap.add_argument("--link-loss-model", default="bernoulli",
                    help="link-loss process: 'bernoulli' (i.i.d., rate from "
                         "--link-loss) or 'gilbert:p=..,r=..[,h=..][,g=..]' "
                         "(a two-state Markov burst-loss channel)")
    ap.add_argument("--resync-retries", type=int, default=3,
                    help="bounded retransmit attempts of the epoch resync "
                         "handshake under link loss (a failed handshake "
                         "keeps the stale m_agg one more epoch)")
    ap.add_argument("--straggle", type=float, default=None,
                    help="per-node-direction deadline-miss rate in [0, 1) "
                         "for --wire-packing async: an in-flight payload "
                         "that misses its one-step deadline is treated as "
                         "dropped")
    ap.add_argument("--straggle-seed", type=int, default=0,
                    help="seed of the deterministic straggler masks")
    ap.add_argument("--node-failures", default=None,
                    help="elastic membership 'node@start:end[;...]': the "
                         "node is inactive for schedule epochs [start, end) "
                         "of --schedule-period steps, e.g. '2@1:3;0@4:6'; "
                         "the survivors form a compacted ring (under "
                         "--hierarchy the masks index pods)")
    ap.add_argument("--hierarchy", default=None,
                    help="two-level consensus 'pods=P': every pod of "
                         "nodes/P consecutive nodes averages its optimizer "
                         "delta in fp32, then the P pods run the compressed "
                         "exchange on the pod ring; pods=nodes is the flat "
                         "ring, pods=1 the allreduce")
    ap.add_argument("--wire-codec", default="int8",
                    help="payload codec of the exchange: int8 | int4 | int2 "
                         "| topk | topk:k=<int> | adaptive; 'adaptive' hands "
                         "the choice to the AdaptiveBitController, which "
                         "re-selects it every --codec-period steps from the "
                         "residual, overflow and consensus-error feedback "
                         "and --byte-budget")
    ap.add_argument("--wire-plan", default=None,
                    help="wire plan spec: a codec name or "
                         "'mixed:pattern=codec,...' mapping leaf paths to "
                         "codecs, e.g. 'mixed:norm=int2,embed=int4,*=int8'; "
                         "overrides --wire-codec, and with --wire-codec "
                         "adaptive the controller moves the plan's hot "
                         "slots and pins the rest")
    ap.add_argument("--codec-ladder", default=None,
                    help="comma-separated codecs the adaptive controller "
                         "chooses from, lowest fidelity first (default "
                         "int2,int4,int8)")
    ap.add_argument("--byte-budget", type=float, default=None,
                    help="bytes/step ring budget (both directions) for the "
                         "adaptive controller's candidate filter")
    ap.add_argument("--codec-period", type=int, default=25,
                    help="steps per adaptive-controller epoch")
    ap.add_argument("--seed", type=int, default=0,
                    help="run seed: parameter init AND the consensus "
                         "quantization-noise stream")
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--schedule", default="constant",
                    choices=["constant", "inverse_power", "cosine"])
    ap.add_argument("--compute-dtype", default="float32",
                    choices=sorted(DTYPES),
                    help="dtype of the parameters and of the model's "
                         "arithmetic (the reference's compute_dtype)")
    ap.add_argument("--remat", default="full", choices=list(REMATS),
                    help="what the backward recomputes: full (keep each "
                         "period's input), dots (also the products without "
                         "batch dimensions) or none")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation slices of each node's "
                         "shard (its batch must divide evenly)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save the whole train state here (npz + "
                         "manifest, repro_torch.checkpoint)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save after every N-th step (0: never)")
    ap.add_argument("--telemetry", action="store_true",
                    help="telemetry/v1 step records and host events to "
                         "<--telemetry-dir>/telemetry-<run id>.jsonl and a "
                         "Perfetto trace of measured exchange spans to "
                         "trace-<run id>.json; also turns on the "
                         "exchange's telemetry metrics.  The records' "
                         "consensus_exchange_s / consensus_overhead_frac "
                         "are each step's measured exchange window (its "
                         "spans); the step lines of an adc_dgd run print "
                         "the exchange probe's instead (the exchange "
                         "alone, median of 5, against the median step)")
    ap.add_argument("--telemetry-dir", default="obs",
                    help="sink directory for --telemetry")
    ap.add_argument("--run-id", default=None,
                    help="telemetry run id (default: a wall-clock stamp)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    ctx = None
    if args.process_ring:
        from repro_torch.launch.mesh import make_process_context
        ctx = make_process_context(args.device)
        world = ctx.total_consensus_nodes
        if args.nodes not in (None, world):
            raise SystemExit(f"--nodes {args.nodes}: the process ring has "
                             f"{world} ranks (--nodes must equal the world "
                             "size or be absent)")
        args.nodes = world
    elif args.nodes is None:
        args.nodes = 1
    # rank 0 speaks for the ring
    say = print if ctx is None or ctx.rank == 0 else (lambda *a, **k: None)
    # float32 products in full float32 (the reference's precision), never
    # TF32: PyTorch's default, stated here because the parity rests on it
    torch.backends.cuda.matmul.allow_tf32 = False

    try:
        strides = tuple(int(s) for s in args.ring_strides.split(","))
    except ValueError:
        raise SystemExit(f"--ring-strides: comma-separated integers, got "
                         f"{args.ring_strides!r}") from None
    adaptive = args.wire_codec == "adaptive"
    if adaptive and args.algorithm != "adc_dgd":
        raise SystemExit("--wire-codec adaptive requires adc_dgd")
    if adaptive and args.wire_packing == "per_leaf":
        raise SystemExit("--wire-codec adaptive requires the packed, "
                         "pipelined or async transport (per_leaf is "
                         "int8-only)")
    if adaptive and args.wire_packing == "async" and args.staleness == 1:
        # a switch changes the payload's size: the payload in flight was
        # encoded on the old wire and cannot be retired on the new one
        raise SystemExit("--wire-codec adaptive cannot run on --wire-packing "
                         "async with --staleness 1: a codec switch changes "
                         "the in-flight payload's size")
    ladder = (tuple(s.strip() for s in args.codec_ladder.split(",")
                    if s.strip())
              if args.codec_ladder else wcodec.AdaptiveBitController.ladder)
    try:                                  # fail at the CLI, clearly
        for name in ladder if adaptive else (args.wire_codec,):
            wcodec.by_name(name)
        plan_spec = (wireplan.parse_spec(args.wire_plan)
                     if args.wire_plan else None)
    except (KeyError, ValueError) as e:
        raise SystemExit(f"--wire-codec/--codec-ladder/--wire-plan: "
                         f"{e.args[0]}") from None
    if args.microbatches < 1 or args.batch % (args.nodes
                                              * args.microbatches):
        raise SystemExit(f"--microbatches {args.microbatches}: the global "
                         f"batch {args.batch} must split evenly over "
                         f"{args.nodes} nodes x {args.microbatches} "
                         "microbatches")
    hierarchy = None
    membership = None
    epoch_events = {}
    try:                                  # fail at the CLI, clearly
        if args.hierarchy:
            hierarchy = HierarchySpec.from_spec(args.hierarchy)
            hierarchy.pod_size(args.nodes)
        if args.node_failures:
            # under hierarchy the masks index the pods of the outer ring
            sched = MembershipSchedule.from_spec(
                args.node_failures, args.nodes if hierarchy is None
                else hierarchy.pods)
            membership = sched.masks
            epoch_events = {ev["epoch"]: ev for ev in sched.epoch_events()}
    except ValueError as e:
        raise SystemExit(f"--hierarchy/--node-failures: {e}") from None
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.periods is not None:
        if not 1 <= args.periods <= cfg.n_periods:
            raise SystemExit(f"--periods must be in [1, {cfg.n_periods}]")
        cfg = dataclasses.replace(cfg, n_periods=args.periods)
    ds_kw = {}
    if cfg.frontend == "audio_frames":
        if args.seq + 1 < cfg.encoder_frames:
            raise ValueError(
                f"--seq {args.seq}: {cfg.arch_id}'s data stub draws its "
                f"{cfg.encoder_frames} frames from the first seq + 1 "
                f"tokens, so --seq must be at least "
                f"{cfg.encoder_frames - 1}")
        ds_kw = dict(enc_frames=cfg.encoder_frames, d_model=cfg.d_model)
    controller = None

    def spec_for(tier: str) -> str:
        """A ladder tier as the wire the setup is built with: the tier
        itself, or in plan mode the plan with its hot slots moved to it
        (the built plan's hot codec, so a rule that matches no slot
        cannot take the tier)."""
        if plan_spec is None:
            return tier
        hot = None if controller.plan is None else controller.plan.hot_codec
        return plan_spec.with_hot_tier(tier, hot=hot).to_string()

    wire = args.wire_codec
    if plan_spec is not None:
        wire = plan_spec.to_string()
    setup = build_train_setup(
        cfg, consensus_nodes=args.nodes, algorithm=args.algorithm,
        gamma=args.gamma, quant_mode=args.quant_mode,
        optimizer=args.optimizer, schedule=args.schedule, lr=args.lr,
        total_steps=args.steps, seed=args.seed, device=args.device,
        track_consensus_error=(args.algorithm != "allreduce"),
        wire_codec="int8" if adaptive and plan_spec is None else wire,
        byte_budget=args.byte_budget, wire_packing=args.wire_packing,
        pipeline_chunks=args.pipeline_chunks, staleness=args.staleness,
        ring_strides=strides, schedule_period=args.schedule_period,
        topology=args.topology, forward_weight=args.forward_weight,
        link_loss=args.link_loss, loss_seed=args.loss_seed,
        link_loss_model=args.link_loss_model,
        resync_retries=args.resync_retries, straggle_rate=args.straggle,
        straggle_seed=args.straggle_seed, membership=membership,
        hierarchy=hierarchy, telemetry=args.telemetry,
        microbatches=args.microbatches,
        compute_dtype=DTYPES[args.compute_dtype], remat=REMATS[args.remat],
        ctx=ctx)
    if hierarchy is not None:
        say(f"[setup] {hierarchy.describe(args.nodes)}")
    if membership is not None:
        say(f"[setup] membership over {len(membership[0])} ring elements,"
              f" {len(membership)} epochs of {args.schedule_period} steps: "
              f"active {[sum(m) for m in membership]}")
    if adaptive:
        ccfg = setup.consensus.cfg
        controller = wcodec.AdaptiveBitController(
            ladder=ladder, byte_budget=ccfg.byte_budget, gamma=ccfg.gamma,
            fixed_step0=ccfg.fixed_step0)
        params = meta_params(setup.defs.storage)
        params = T.tree_map(lambda a: a.expand((args.nodes,) + a.shape),
                            params)
        layout = setup.consensus.state_layout(params)
        n_rows, n_elements = layout.n_rows, layout.n_elements
        if plan_spec is not None and not plan_spec.is_uniform:
            # plan mode: price the grouped buffer the runtime ships
            controller.plan = setup.consensus.wire_plan_for(layout)
        codec_name = spec_for(controller.initial(n_rows))
        setup = with_codec(setup, codec_name)
        say(f"[codec] controller start: {codec_name} "
              f"(budget={ccfg.byte_budget})")
    state = init_train_state(setup, args.seed)
    tel = None
    if args.telemetry:
        run_id = args.run_id or time.strftime("%Y%m%d-%H%M%S")
        if ctx is not None:
            run_id += f"-rank{ctx.rank}"
        tel = telemetry.Telemetry(
            run_id,
            out_dir=args.telemetry_dir, config=dict(vars(args)),
            git_sha=_git_sha(), spans=True, device=setup.device)
        say(f"[telemetry] -> {tel.path}")
        _wire_plan_event(tel, setup, state, 0, hierarchy, args)
        if membership is not None:
            tel.event("membership_epoch", step=0, epoch=0,
                      active=int(sum(membership[0])),
                      mask=list(membership[0]))
    ds = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch,
                            n_shards=args.nodes, **ds_kw)
    history = []
    overhead, overhead_setup = {}, None
    ep_res, ep_ovf, ep_ce = [], [], []
    step_times, exchange_s = [], []
    prev_epoch = 0
    t0 = time.time()
    for step in range(args.steps):
        batch = ds.global_batch_arrays(step)
        ts = time.perf_counter()
        if tel is not None:
            tel.spans.step_begin()
        if ctx is not None:
            ctx.ring.reset_stats()
        state, metrics = train_step(setup, state, batch)
        if setup.device.type == "cuda":
            torch.cuda.synchronize(setup.device)
        metrics["step_s"] = dur = time.perf_counter() - ts
        if ctx is not None:
            metrics.update(_wire_stats(ctx))
        if step >= 1:
            step_times.append(dur)
        if tel is not None:
            # the first step's window holds the kernels' first loads
            split = (tel.spans.record_step_window(step + 1, ts, dur)
                     if step >= 1 else tel.spans.measure())
            if "window_s" in split:
                metrics["consensus_exchange_s"] = split["window_s"]
                metrics["consensus_overhead_frac"] = split["window_s"] / dur
                if step >= 1:
                    exchange_s.append(split["window_s"])
            tel.record_step(step + 1, {
                k: v for k, v in metrics.items()
                if k in telemetry.STEP_METRICS})
            if metrics.get("resync_fired", 0.0) > 0.0:
                tel.event("resync", step=step + 1,
                          ok=metrics.get("resync_ok", 0.0) > 0.5)
            if membership is not None:
                e = min((step + 1) // args.schedule_period,
                        len(membership) - 1)
                if e != prev_epoch:
                    ev = epoch_events.get(e, {})
                    tel.event("membership_epoch", step=step + 2, epoch=e,
                              active=int(sum(membership[e])),
                              mask=list(membership[e]),
                              joined=ev.get("joined", []),
                              departed=ev.get("departed", []))
                    prev_epoch = e
        history.append(metrics)
        shown = dict(metrics)
        if step_times and args.algorithm == "adc_dgd":
            # the exchange alone against the median step, on the live
            # state; the probe is measured again only when the codec
            # re-tier gave a new setup (the reference's rule)
            if overhead_setup is not setup:
                overhead = measure_consensus_overhead(
                    setup, state, statistics.median(step_times))
                overhead_setup = setup
            elif overhead:
                overhead["consensus_overhead_frac"] = (
                    overhead["consensus_exchange_s"]
                    / statistics.median(step_times))
            shown.update(overhead)
        shown = " ".join(f"{k}={v}" if isinstance(v, (str, bool, int))
                         else f"{k}={v:.4g}" for k, v in shown.items()
                         if k not in ("loss", "node_loss"))
        say(f"step {step:5d} loss={metrics['loss']:.4f} {shown}",
              flush=True)
        if (args.checkpoint_dir and args.checkpoint_every
                and (step + 1) % args.checkpoint_every == 0):
            setup.consensus.land()      # the async state, complete
            save_checkpoint(args.checkpoint_dir, step + 1, state, ctx=ctx)
        if controller is None:
            continue
        ep_res.append(metrics["residual_norm"])
        ep_ovf.append(metrics["overflow_frac"])
        if "consensus_err" in metrics:
            # squared disagreement summed over the tree -> per-element RMS
            ep_ce.append(float(np.sqrt(max(metrics["consensus_err"], 0.0)
                                       / max(n_elements, 1))))
        if (step + 1) % args.codec_period == 0:
            res, ovf = float(np.mean(ep_res)), float(np.mean(ep_ovf))
            ce = float(np.mean(ep_ce)) if ep_ce else None
            tier = controller.select(
                next_step=step + 2, residual_rms=res, overflow_frac=ovf,
                n_rows=n_rows, consensus_err=ce)
            new = spec_for(tier)
            if tel is not None:
                tel.event("codec_decision", step=step + 1, old=codec_name,
                          new=new, tier=tier, residual_rms=res,
                          overflow_frac=ovf, consensus_rms=ce,
                          candidates=controller.candidate_table(n_rows))
            if new != codec_name:
                say(f"[codec] step {step + 1}: {codec_name} -> {new} "
                      f"(residual_rms={res:.3g}, overflow={ovf:.3g}"
                      + (f", consensus_rms={ce:.3g}" if ce is not None
                         else "") + ")")
                if tel is not None and controller.plan is not None:
                    tel.event("plan_retier", step=step + 1,
                              old=codec_name, new=new, tier=tier)
                codec_name, setup = new, with_codec(setup, new)
                if tel is not None:
                    _wire_plan_event(tel, setup, state, step + 2,
                                     hierarchy, args)
            ep_res, ep_ovf, ep_ce = [], [], []
    # the async transport over ranks: the last step's flight lands, so the
    # state is complete and nothing is on the wire when the run ends
    setup.consensus.land()
    say(f"done: {args.steps} steps in {time.time() - t0:.1f}s")
    if tel is not None:
        run_end = {"wall_s": time.time() - t0,
                   "steps_per_s": (1.0 / statistics.median(step_times)
                                   if step_times else None)}
        if exchange_s:
            run_end["consensus_exchange_s"] = statistics.median(exchange_s)
            run_end["consensus_overhead_frac"] = (
                run_end["consensus_exchange_s"]
                / statistics.median(step_times))
        tel.event("run_end", step=args.steps, **run_end)
        tel.close()
        say(f"[telemetry] wrote {tel.path} and {tel.trace_path}")
    return (history, state) if return_state else history


def _wire_stats(ctx: ParallelContext) -> dict:
    """The measured wire of the step's exchange, from the ring's stats
    since the step began (``models.sharding.StagedRing``; call after a
    synchronize):

    * ``wire_s``: per kind of transfer, host seconds from posting its
      first transfer of the step to the return of the last wait of one
      posted in the step, summed over kinds (on the async transport only
      the resync's: its payload is waited in the next step);
    * ``wire_wait_s``: the host's time blocked in the step's waits.  On
      the async transport this is the retire's wait for the flight the
      previous step posted (and at a resync the shadows' transfer): whether
      the wire is hidden is read here, ~0 when it is;
    * ``wire_flight_s``: posted-to-landed of the flight the step retired
      (posted in the previous step, landed when its wait returned; 0 on
      the other transports);
    * ``wire_d2h_s`` / ``wire_h2d_s``: the staging copies, CUDA events;
    * ``wire_bytes_sent``: the payload bytes the step posted (on the async
      transport this step's launch; under hierarchy with the inner level's
      fp32 deltas), and ``wire_resync_bytes_sent`` apart: a resync's fp32
      shadows (and push-sum weights);
    * ``wire_inner_s``: the hierarchy's inner level (the pod sum's
      transfers, from the first post to the last wait; 0 without it);
    * ``consensus_err_wire_s``: the consensus error's node sum (a metric,
      left out of the others)."""
    all_stats = ctx.ring.read_stats()
    metric = all_stats.pop("consensus_err", None)
    resync = all_stats.get("resync")
    inner = all_stats.get("pod")
    stats = list(all_stats.values())
    return {"wire_s": sum(v["wire_s"] for v in stats),
            "wire_wait_s": sum(v["wait_s"] for v in stats),
            "wire_flight_s": sum(v["carried_s"] for v in stats),
            "wire_d2h_s": sum(v["d2h_s"] for v in stats),
            "wire_h2d_s": sum(v["h2d_s"] for v in stats),
            "wire_bytes_sent": sum(v["bytes_sent"] for k, v in
                                   all_stats.items() if k != "resync"),
            "wire_resync_bytes_sent": 0 if resync is None
            else resync["bytes_sent"],
            "wire_inner_s": 0.0 if inner is None else inner["wire_s"],
            "consensus_err_wire_s": 0.0 if metric is None
            else metric["wire_s"]}


def _git_sha() -> str | None:
    """The commit of the checkout this module lies in, or None where there
    is no git or no repository."""
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=5,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def _wire_plan_event(tel, setup: TrainSetup, state: dict, at_step: int,
                     hierarchy, args) -> None:
    """The shipped wire's geometry as a ``wire_plan`` event: the layout,
    the byte accounting, the plan's runs and the reference's fallback
    fragment count (the port launches every fragment's kernel), the loss
    channel and the straggler model."""
    rt = setup.consensus
    if rt.cfg.algorithm != "adc_dgd":
        return
    layout = rt.state_layout(state["params"])
    acct = rt.wire_accounting(layout.n_elements, layout)
    data = dict(codec=rt.wire_name, layout=layout.describe(),
                wire_bytes_per_step=acct.shipped_per_step,
                shipped_payload=acct.shipped_payload,
                trailer_bytes=acct.trailer_bytes,
                inner_bytes=acct.inner_bytes)
    if hierarchy is not None:
        data["hierarchy"] = hierarchy.describe(args.nodes)
    if rt.cfg.wire_packing != "per_leaf":
        plan = rt.wire_plan_for(layout)
        data["plan"] = plan.describe()
        data["fallback_fragments"] = plan.fallback_fragments(
            rt.cfg.pipeline_chunks if rt.cfg.wire_packing == "pipelined"
            else None)
    if rt.loss is not None:
        data["channel"] = rt.loss.describe()
    if rt.straggler is not None:
        data["straggler"] = rt.straggler.describe()
    tel.event("wire_plan", step=at_step, **data)


if __name__ == "__main__":
    main()
