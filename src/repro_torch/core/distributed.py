"""ADC-DGD consensus runtime over consensus nodes stacked on one device.

Port of ``repro.core.distributed``.  The reference runs one consensus node
per device inside ``shard_map`` and moves the wire payload with
``ppermute``; here the ``N`` nodes are a leading axis of every tensor, and
a ring transfer is an index: ``ppermute(+1)`` hands node ``i`` the payload
of node ``i-1`` ("left"), ``ppermute(-1)`` that of node ``i+1`` ("right").
Payloads stay a list of per-node tensors and the neighbours' entries are
passed as they are: nothing is copied for the "transfer" (but the async
transport's two wrap rows), and the kernels write their outputs in place
into the exchange's buffers.

The wire is a :class:`~repro_torch.core.wireplan.WirePlan`: a codec name
(``int8``, ``int4``, ``int2``, ``topk[:k=<int>]``) is a uniform plan, a
``mixed:pattern=codec,...`` spec gives each leaf its own codec, and then
the packed buffer groups same-codec leaves (``grouped_placement``).  Per
step k of ``adc_dgd`` (paper Algorithm 2, amplification folded into the
quantizer grid), for every node i:

    y_i    = pack(x_half_i) - x_tilde_i
    pay_i  = plan.encode(y_i, noise_i, step_k)   (one launch per codec run)
    x_tilde_i, m_agg_i, comb_i = codec.decode_combine(
                 pay_i, pay_{i-1}, pay_{i+1}, x_tilde_i, m_agg_i)
                                                 (one launch per codec run)
    x_next_i = comb_i + (x_half_i - x_prev_i)           (per leaf)

``step_k = fixed_step0 / k**gamma`` in fixed mode, the per-row absmax grid
in adaptive mode.  ``dgd`` (uncompressed mixing), ``allreduce`` (exact mean
of the optimizer delta) and ``none`` (isolated nodes) are the baselines;
``compressed_dgd`` (paper Eq. (5), the negative control) mixes the
neighbours' int8-compressed parameters themselves, on the undecayed grid
``fixed_step0``, with the node's own parameters uncompressed.

Transports (``wire_packing``), all giving the same bits from the same
noise buffer:
  ``packed``     one flat payload per node and step;
  ``pipelined``  the plan's ``pipeline_chunks`` transfer units, chunk c+1
                 encoded before chunk c is retired (the reference's
                 emission order, on the current stream);
  ``async``      one step stale (``staleness`` 1): step k first retires
                 the payloads launched at step k-1, then encodes against
                 the drained shadow and carries the payloads in the state;
                 ``staleness`` 0 is the packed exchange;
  ``per_leaf``   the reference transport of the int8 wire: per leaf one
                 quantize launch (codes and scales as two tensors) and one
                 combine launch per node, four ring transfers per leaf.
Time-varying ring (``ring_strides``, ``schedule_period``): the ring's
stride cycles through ``ring_strides``, each held ``schedule_period``
steps, so step k talks to nodes i - s and i + s with
``s = ring_strides[((k - 1) // schedule_period) % len(ring_strides)]``.
``m_agg = sum_j W_ij x_tilde_j`` holds only for a fixed neighbour set, so
on the first step of every epoch but the first (the resync) ``adc_dgd``
rebuilds it exactly from the new neighbours' fp32 ``x_tilde`` before the
combine consumes it; the wire accounting amortizes that exchange.

Faults (``link_loss`` / ``link_loss_model``, ``straggle_rate``,
``resync_retries``; ``core.faults``): one host keep mask ``(2, N)`` per
step says which payloads arrive (row 0 from upstream i - s, row 1 from
downstream i + s; async keys it by the launch step k - 1 and ANDs the
straggler deadlines).  A dropped payload is read as the all-zero payload
of its size (one zero buffer per transfer unit, never a write into the
sender's buffer), which every codec decodes to a zero differential: the
receiver keeps its stale estimate.  A resync whose bounded-retry
handshake fails in either direction keeps the node's stale ``m_agg``.
``link_loss=None`` runs none of this; ``0.0`` runs it and gives the same
bits.

Directed ring (``topology="directed-ring"``): in-weights ``(w_fwd,
w_bwd)`` from upstream and downstream.  The symmetric kernels mix both
sides at ``side = (w_fwd + w_bwd) / 2``; the correction ``t = f32(w_fwd -
side) * (d_l - d_r)`` of the two decoded arrivals (plain PyTorch, per node
and in row blocks) is added to ``m_agg`` and the combine.  Push-sum: the
state carries ``ps_w`` ``(N, 1)`` and the last-seen neighbour weights
``ps_nbr`` ``(N, 2)``; the wire carries ``x_half * ps_w`` and ``ps_w`` as a
4-byte trailer on the last transfer unit's payload; ``ps_w' = ps_w +
(w_fwd (w_l - ps_w) + w_bwd (w_r - ps_w))`` (exact, so 1 stays 1 on the
homogeneous ring) and the combine is de-biased by ``ps_w'``.  A dropped
or failed-resync weight is the stale ``ps_nbr``.

Elastic membership (``membership``: per-epoch masks of active ring
elements, the last mask held once reached): the survivors form a
compacted ring in active-position order, at the epoch's stride (stride 1
where the stride has no meaning on the smaller ring), read from one
neighbour table per (stride, mask) (:meth:`ConsensusRuntime.wiring_at`).
An inactive element freezes its parameters and shadows bitwise, sends
nothing and receives nothing, and its per-node metrics read 0; the
exchange encodes and combines only the active elements.  The resync fires
at the first step of every epoch after the first (with one stride, until
the mask has clamped) and rebuilds ``m_agg`` over the new active set.

Two-level hierarchy (``hierarchy``: ``pods`` groups of ``m`` consecutive
nodes, ``core.hierarchy``): every pod first averages its optimizer delta
in fp32 (``x_prev + sum_pod(x_half - x_prev) / m``), then the pods run the
compressed exchange on the pod ring, whose elements the loss model and
membership masks index.  Pod members are bitwise replicas of their
representative (all nodes share x0), so the exchange runs on the
representatives' rows alone, one launch per pod, and its results are
copied to the members.  ``pods == n`` is the flat ring; ``pods == 1`` is
the ``allreduce`` exchange.

Process ring (``ctx``, ``models.sharding``): under a process context each
rank holds one node, every tensor has a leading axis of 1, and the
neighbours' payloads really cross the wire, at the stride of the step's
epoch: each transfer unit's payload is posted to both ring neighbours in
its ``launch`` (a device-to-host copy into a pinned buffer, then the gloo
sends) and waited for in its ``retire`` (then a host-to-device copy), so
on the pipelined transport unit c's transfer is in flight while unit c+1
is encoded.  The per-leaf transport posts each leaf's codes and scales
(two transfers to both neighbours: the reference's four ``ppermute``) in
the leaf's launch, leaf i+1 before leaf i is retired.  The async
transport posts step k's payload and returns: the transfer stays in
flight across the step boundary, and its two arrivals join the state
(``fly_up``, ``fly_dn``) only when it has landed (:meth:`ConsensusRuntime.
land`), which step k+1's retire does first.  A resync moves the shadow
over the ring (fp32 ``x_tilde`` at the new stride: per unit, per leaf, or
the drained shadow on the async transport) and push-sum's fresh weights
as a scalar transfer.  A fault is read at the receiver: every payload is
still sent, and the rank reads an arrival its column of the host's keep
mask drops (or whose straggler deadline it misses) as the zero payload.
The node sums (``allreduce``, ``consensus_err``) go through ``ctx.
node_group_sum`` in the stacked sum's rotation order, and each rank draws
only its own noise, so a rank computes the stacked runtime's row bit for
bit.  Every transfer takes its peers from the step's :class:`Wiring` seen
from the rank (:class:`RingView`): under a membership mask an inactive
rank encodes, sends and receives nothing and keeps its shadows and
parameters bitwise (on the async transport it retires zero payloads of its
own making, as the stacked masked gather hands it), and each resync moves
the fp32 ``x_tilde`` over the new wiring.  Under hierarchy every member of
pod p first adds the other members' fp32 deltas in member order
(``ctx.pod_sums``: point-to-point transfers inside the pod), then runs the
outer exchange as its pod's replica: member j talks to member j of the
neighbouring pods, draws its pod's noise and reads its pod's column of the
fault masks, so every member holds the stacked representative's bits.
Over a tensor-parallel grid (``ctx.tp`` > 1) each rank holds its node's
tp-local leaves: the packed buffer is built from them (the reference's
``consensus_wire_layout`` of the local shard), the noise is seeded per
node and never per model index (the reference's ``_device_key``), so a
leaf replicated over the node's ranks receives the same bits on each, and
every transfer goes to the rank of the neighbouring node that has the
same model index; ``consensus_err`` is summed over the tp group as the
reference sums it.  There the runtime runs the default config (``adc_dgd``
packed int8 at stride 1, fixed or adaptive ``quant_mode``) and ``dgd``,
``allreduce`` and ``none``; every other option raises
``NotImplementedError`` (ROADMAP Queue 1 item 5d).
The process ring runs every algorithm, codec, transport, stride schedule,
fault, topology, membership schedule and hierarchy of the stacked
runtime.

Telemetry (``telemetry``, ``core.telemetry``): every ADC return path adds
the reference's extra per-node metrics (``telemetry_metric_keys``), all
read from ``wire_accounting``; off or on, the exchange computes the same
bits.  The packed, pipelined and async exchanges call ``trace_mark`` where
each phase's work starts (quantize, launch, retire, dequant_combine, in
the reference's order and with its ``info``) and ``trace_end`` where it
ends; an installed ``SpanRecorder`` times them with CUDA events.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import codec as wire_codec
from repro_torch.core import faults, telemetry
from repro_torch.core import tree as T
from repro_torch.core import wire, wireplan
from repro_torch.core.f32 import over_power, recip
from repro_torch.core.hierarchy import HierarchySpec
from repro_torch.kernels import ops as kops
from repro_torch.models.sharding import ParallelContext, local_context

__all__ = ["ConsensusConfig", "ConsensusRuntime", "HierarchySpec", "RingView",
           "Wiring", "noise_seed"]

ALGORITHMS = ("adc_dgd", "dgd", "compressed_dgd", "allreduce", "none")
WIRE_PACKINGS = ("packed", "pipelined", "per_leaf", "async")
TOPOLOGIES = ("ring", "directed-ring")
#: rows of the directed correction's plain decode per launch: bounds its
#: temporaries to a few tens of MB whatever the payload
_DECODE_ROWS = 16384


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    algorithm: str = "adc_dgd"     # adc_dgd | dgd | compressed_dgd |
                                   # allreduce | none
    gamma: float = 1.0             # amplification exponent (paper gamma)
    self_weight: float = 0.5       # ring W_ii; each side gets (1 - W_ii)/2
    quant_mode: str = "fixed"      # fixed (paper-faithful) | adaptive
    fixed_step0: float = 1e-3      # Delta_0; effective step = Delta_0 / k^gamma
    track_consensus_error: bool = False
    wire_codec: str = "int8"       # a codec name or a "mixed:..." plan spec
    byte_budget: float | None = None   # bytes/step target (the controller)
    wire_packing: str = "packed"   # packed | pipelined | per_leaf | async
    pipeline_chunks: int = 4       # transfer units of the pipelined wire
    staleness: int = 1             # async: 1 retires step k-1's payload
    #: time-varying ring: the stride cycles through ``ring_strides``, each
    #: held ``schedule_period`` steps; (1,) is the paper's static ring
    ring_strides: tuple[int, ...] = (1,)
    schedule_period: int = 1       # steps between ring re-wirings
    wire_dtype: torch.dtype = torch.float32   # the dgd baseline's wire
    #: "ring" (symmetric) or "directed-ring" (column-stochastic in-weights
    #: forward_weight from upstream, 1 - self_weight - forward_weight from
    #: downstream; push-sum)
    topology: str = "ring"
    forward_weight: float | None = None   # None: 2 (1 - self_weight) / 3
    #: Bernoulli loss rate per directed edge; None runs no loss machinery,
    #: 0.0 runs it and drops nothing
    link_loss: float | None = None
    loss_seed: int = 0
    #: "bernoulli" (rate from link_loss) or "gilbert:p=..,r=..[,h=..][,g=..]"
    link_loss_model: str = "bernoulli"
    resync_retries: int = 3        # bounded retransmits of a lossy resync
    straggle_rate: float | None = None    # async deadline-miss rate
    straggle_seed: int = 0
    #: None: on iff the topology is directed; True forces the weight
    #: machinery on the symmetric ring (where the weight stays 1)
    push_sum: bool | None = None
    #: per-epoch masks of active ring elements (``MembershipSchedule.
    #: masks``); epoch e uses ``masks[min(e, len - 1)]``.  None runs no
    #: membership machinery; a single all-active mask gives its bits
    membership: tuple | None = None
    #: two-level consensus: a HierarchySpec, an int pod count or "pods=P"
    #: (normalized to a HierarchySpec); None is the flat ring
    hierarchy: Any = None
    #: the exchange's extra per-node metrics (``telemetry_metric_keys``);
    #: off or on, the exchange computes the same bits and launches the
    #: same kernels
    telemetry: bool = False

    def __post_init__(self):
        if not self.ring_strides:
            raise ValueError("ring_strides must be non-empty")
        if self.schedule_period < 1:
            raise ValueError(f"schedule_period must be >= 1, got "
                             f"{self.schedule_period}")
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm must be one of {ALGORITHMS} (the "
                             f"ported subset), got {self.algorithm!r}")
        if self.quant_mode not in ("fixed", "adaptive"):
            raise ValueError(f"quant_mode must be 'fixed' or 'adaptive', "
                             f"got {self.quant_mode!r}")
        if not 0.0 < self.self_weight <= 1.0:
            raise ValueError(f"self_weight must be in (0, 1], got "
                             f"{self.self_weight}")
        if self.wire_packing not in WIRE_PACKINGS:
            raise ValueError(f"wire_packing must be one of {WIRE_PACKINGS}, "
                             f"got {self.wire_packing!r}")
        if self.pipeline_chunks < 1:
            raise ValueError(f"pipeline_chunks must be >= 1, got "
                             f"{self.pipeline_chunks}")
        if self.staleness not in (0, 1):
            raise ValueError(f"staleness must be 0 or 1, got "
                             f"{self.staleness}")
        if self.wire_packing == "async" and self.algorithm != "adc_dgd":
            raise ValueError(
                "wire_packing='async' is the one-step-stale ADC exchange; "
                f"algorithm={self.algorithm!r} does not support it")
        try:
            spec = wireplan.parse_spec(self.wire_codec)
        except (KeyError, ValueError) as e:
            raise ValueError(f"wire_codec={self.wire_codec!r}: "
                             f"{e.args[0]}") from None
        if self.wire_packing == "per_leaf" and spec.uniform_codec != "int8":
            raise ValueError(
                f"wire_codec={self.wire_codec!r} requires the packed, "
                "pipelined or async transport; the per-leaf reference path "
                "speaks one uniform int8 wire per leaf")
        if self.algorithm == "compressed_dgd" and spec.uniform_codec != "int8":
            raise ValueError(
                "compressed_dgd (the Eq. (5) negative control) is pinned "
                f"to the int8 wire; got wire_codec={self.wire_codec!r}")
        if self.byte_budget is not None and self.byte_budget <= 0:
            raise ValueError(f"byte_budget must be positive, got "
                             f"{self.byte_budget}")
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"topology must be 'ring' or 'directed-ring', "
                             f"got {self.topology!r}")
        directed = self.topology == "directed-ring"
        if directed and self.push_sum is False:
            raise ValueError(
                "directed-ring mixing is column-stochastic only; disabling "
                "push_sum would leave the iterates biased — drop "
                "push_sum=False or use topology='ring'")
        if self.forward_weight is not None:
            if not directed:
                raise ValueError("forward_weight only applies to the "
                                 "directed-ring topology")
            if not 0.0 < self.forward_weight < 1.0 - self.self_weight:
                raise ValueError(
                    f"forward_weight must be in (0, 1 - self_weight) = "
                    f"(0, {1.0 - self.self_weight}), got "
                    f"{self.forward_weight}")
        if self.link_loss is not None and not 0.0 <= self.link_loss < 1.0:
            raise ValueError(f"link_loss must be in [0, 1), got "
                             f"{self.link_loss}")
        loss_spec = faults.parse_loss_spec(self.link_loss_model)  # raises
        if loss_spec["kind"] != "bernoulli" and self.link_loss is not None:
            raise ValueError(
                "link_loss sets the Bernoulli rate; the gilbert burst "
                "model takes its parameters in link_loss_model — set one "
                "or the other, not both")
        if self.resync_retries < 1:
            raise ValueError(f"resync_retries must be >= 1, got "
                             f"{self.resync_retries}")
        if self.straggle_rate is not None:
            if not 0.0 <= self.straggle_rate < 1.0:
                raise ValueError(f"straggle_rate must be in [0, 1), got "
                                 f"{self.straggle_rate}")
            if self.wire_packing != "async" or self.staleness != 1:
                raise ValueError(
                    "straggler deadlines are a property of the one-step-"
                    "stale transport: straggle_rate requires "
                    "wire_packing='async' with staleness=1")
        if self.membership is not None:
            masks = self.membership
            if (not masks or not all(isinstance(m, tuple) for m in masks)
                    or len({len(m) for m in masks}) != 1):
                raise ValueError(
                    "membership must be a non-empty tuple of equal-length "
                    "per-epoch mask tuples (MembershipSchedule.masks)")
            for e, m in enumerate(masks):
                if sum(bool(b) for b in m) < 2:
                    raise ValueError(
                        f"membership epoch {e} keeps "
                        f"{sum(bool(b) for b in m)} active nodes; the "
                        "surviving ring needs >= 2")
            if self.wire_packing == "per_leaf":
                raise ValueError(
                    "membership requires the packed/pipelined/async "
                    "transports; the per-leaf reference path predates "
                    "elasticity")
            if self.push_sum_enabled or directed:
                raise ValueError(
                    "runtime membership supports the symmetric ring only; "
                    "push-sum mass handoff under churn is reference-side "
                    "(topology.MembershipSchedule.handoff_at + "
                    "consensus.run_elastic)")
        if self.hierarchy is not None:
            object.__setattr__(
                self, "hierarchy", HierarchySpec.from_spec(self.hierarchy))
            if self.algorithm != "adc_dgd":
                raise ValueError(
                    "hierarchy composes the inner all-reduce with the "
                    "compressed adc_dgd outer exchange; algorithm="
                    f"{self.algorithm!r} does not support it")
            if directed or self.push_sum_enabled:
                raise ValueError(
                    "hierarchical consensus supports the symmetric outer "
                    "ring only; directed/push-sum pod rings are a "
                    "follow-up (ROADMAP)")
            if self.wire_packing == "per_leaf":
                raise ValueError(
                    "hierarchy requires the packed/pipelined/async "
                    "transports; the per-leaf reference path predates it")
        if ((directed or self.push_sum or self.link_loss is not None
             or loss_spec["kind"] != "bernoulli"
             or self.straggle_rate is not None
             or self.membership is not None)
                and self.algorithm != "adc_dgd"):
            raise ValueError(
                "directed topology, push_sum, link loss, straggler "
                "deadlines and membership are features of the adc_dgd "
                f"wire; algorithm={self.algorithm!r} does not support them")

    @property
    def side_weight(self) -> float:
        return (1.0 - self.self_weight) / 2.0

    @property
    def in_weights(self) -> tuple[float, float]:
        """(upstream, downstream) receive weights: ``side_weight`` twice on
        the symmetric ring, (forward, backward) on the directed one."""
        if self.topology == "directed-ring":
            fwd = (2.0 * (1.0 - self.self_weight) / 3.0
                   if self.forward_weight is None else self.forward_weight)
            return (fwd, (1.0 - self.self_weight) - fwd)
        return (self.side_weight, self.side_weight)

    @property
    def push_sum_enabled(self) -> bool:
        if self.push_sum is not None:
            return self.push_sum
        return self.topology == "directed-ring"

    @property
    def loss_enabled(self) -> bool:
        """Any link-loss machinery (Bernoulli or burst)?"""
        return (self.link_loss is not None
                or faults.parse_loss_spec(self.link_loss_model)["kind"]
                != "bernoulli")

    @property
    def faults_enabled(self) -> bool:
        """Anything that can drop a payload (loss or straggler deadlines):
        the gate of the delivered-bytes metrics."""
        return self.loss_enabled or self.straggle_rate is not None

    def loss_model_for(self, n_nodes: int):
        """The configured loss model bound to ``n_nodes`` ring elements
        (the Gilbert-Elliott model realizes one chain per directed edge),
        or None."""
        spec = faults.parse_loss_spec(self.link_loss_model)
        if spec["kind"] == "gilbert":
            return faults.GilbertElliottLoss(
                p=spec["p"], r=spec["r"], h=spec["h"], g=spec["g"],
                seed=self.loss_seed, n_nodes=n_nodes)
        if self.link_loss is None:
            return None
        return faults.LossModel(rate=self.link_loss, seed=self.loss_seed)

    @property
    def straggler_model(self):
        if self.straggle_rate is None:
            return None
        return faults.StragglerModel(rate=self.straggle_rate,
                                     seed=self.straggle_seed)

    @property
    def schedule_varying(self) -> bool:
        """Does the wiring (stride or membership) ever change at an epoch
        boundary?  This is what makes the ``m_agg`` resync necessary."""
        return (len(self.ring_strides) > 1
                or (self.membership is not None
                    and len(self.membership) > 1))

    def telemetry_metric_keys(self) -> tuple:
        """The extra metric keys every return path of the ADC exchange
        gives when ``telemetry`` is on (the reference's list)."""
        if not self.telemetry or self.algorithm != "adc_dgd":
            return ()
        keys = ["wire_bytes_shipped", "saturated_count"]
        if self.hierarchy is not None:
            keys += ["wire_bytes_inner", "wire_bytes_outer"]
        if self.schedule_varying:
            keys += ["resync_fired", "resync_ok"]
        if self.wire_packing == "async" and self.staleness == 1:
            keys.append("staleness_retired")
        return tuple(keys)


def noise_seed(seed: int, step: int, node: int) -> int:
    """Generator seed of node ``node``'s quantization noise at ``step`` of
    run ``seed``: distinct for every (run, step, node)."""
    state = np.random.SeedSequence([seed, step, node]).generate_state(
        1, np.uint64)
    return int(state[0] & np.uint64(0x7FFF_FFFF_FFFF_FFFF))


@dataclasses.dataclass(frozen=True)
class Wiring:
    """One epoch's ring over the ring elements (nodes, or pods under
    hierarchy): ``left[i]`` is the element whose payload ``ppermute(+s)``
    delivers to element i (upstream), ``right[i]`` the one ``ppermute(-s)``
    delivers (downstream); both None for an inactive element, which
    receives nothing.  ``mask`` is None when every element is active (the
    plain shift ring ``i -+ s``); ``n_active`` counts the mask's active
    elements (all of them without membership)."""

    stride: int
    left: tuple
    right: tuple
    mask: tuple | None
    n_active: int

    @property
    def active(self) -> list[int]:
        return [i for i, j in enumerate(self.left) if j is not None]

    @property
    def inactive(self) -> list[int]:
        return [i for i, j in enumerate(self.left) if j is None]

    @classmethod
    def build(cls, n: int, stride: int, mask=None) -> "Wiring":
        """The ring of ``n`` elements at ``stride``, compacted over the
        active elements of ``mask`` in active-position order.  A stride
        with no meaning on the smaller ring (``s % m == 0``, or ``gcd(s,
        m) > 1``, which would split the survivors) falls back to 1.  An
        all-active mask is the unmasked ring."""
        if mask is None or all(mask):
            return cls(stride, tuple((i - stride) % n for i in range(n)),
                       tuple((i + stride) % n for i in range(n)), None,
                       n if mask is None else len(mask))
        active = [v for v, a in enumerate(mask) if a]
        m = len(active)
        s_eff = abs(stride) % m
        if s_eff == 0 or math.gcd(s_eff, m) != 1:
            s_eff = 1
        pos = {v: p for p, v in enumerate(active)}
        left = tuple(active[(pos[i] - s_eff) % m] if i in pos else None
                     for i in range(n))
        right = tuple(active[(pos[i] + s_eff) % m] if i in pos else None
                      for i in range(n))
        return cls(stride, left, right, tuple(bool(b) for b in mask), m)


@dataclasses.dataclass(frozen=True)
class RingView:
    """A :class:`Wiring` seen from this process's rows: ``elems[r]`` is
    the ring element that local row r holds (every element stacked, where
    rows are elements; over ranks the rank's one element, its pod under
    hierarchy).  ``active`` / ``inactive`` index the local rows, ``cols``
    cuts host flags over the elements to them, and ``peers`` are the
    ranks a rank's transfers go to and come from: ``(left, right)``, the
    members of its element's neighbours that share its position in their
    pods, or None (stacked, or an inactive rank, which posts nothing)."""

    wiring: Wiring
    elems: tuple
    peers: tuple | None

    @property
    def stride(self) -> int:
        return self.wiring.stride

    @property
    def n(self) -> int:
        """Local rows (ring elements this process holds)."""
        return len(self.elems)

    @property
    def active(self) -> list[int]:
        return [r for r, e in enumerate(self.elems)
                if self.wiring.left[e] is not None]

    @property
    def inactive(self) -> list[int]:
        return [r for r, e in enumerate(self.elems)
                if self.wiring.left[e] is None]

    def cols(self, flags: np.ndarray | None) -> np.ndarray | None:
        """Host flags over the ring elements (the last axis) cut to the
        local rows' elements; None passes."""
        if flags is None or self.elems == tuple(range(flags.shape[-1])):
            return flags
        return flags[..., list(self.elems)]


def _pipeline_schedule(n_units: int, launch, retire, inspect=None) -> list:
    """The reference's double-buffered transfer schedule: at iteration c,
    ``launch(c+1)`` is issued before ``retire(c)``; ``inspect(c,
    inflight)`` sees each in-flight value before its retire.  Everything
    runs on the current stream.  Returns ``[retire(c, ...) for c]``."""
    outs = []
    inflight = launch(0)
    for c in range(n_units):
        if inspect is not None:
            inspect(c, inflight)
        nxt = launch(c + 1) if c + 1 < n_units else None
        outs.append(retire(c, inflight))
        inflight = nxt
    return outs


class ConsensusRuntime:
    """Stateless helper bound to (config, node count, context); the
    consensus state lives in the caller's train state.  Parameter trees
    have a leading node axis of size ``n_local`` on every leaf:
    ``n_nodes`` stacked, 1 under a process context."""

    def __init__(self, config: ConsensusConfig, n_nodes: int,
                 layout_spec: wireplan.PlanSpec | None = None,
                 ctx: ParallelContext | None = None):
        """``layout_spec``: the plan whose codec groups place the leaves
        in the packed buffer (default this runtime's own).  An adaptive
        run over a mixed plan keeps its first plan's placement through
        every tier, so its packed state keeps one row order.  ``ctx``: a
        process context puts this runtime's node on its rank of a ring of
        ``n_nodes`` ranks (default: every node stacked here)."""
        if n_nodes < 1:
            raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
        self.ctx = local_context() if ctx is None else ctx
        if self.ctx.process_ring:
            if n_nodes != self.ctx.total_consensus_nodes:
                raise ValueError(
                    f"n_nodes={n_nodes}, but the process ring has "
                    f"{self.ctx.total_consensus_nodes} ranks")
        if self.ctx.tp > 1:
            check_tp(config, self.ctx.tp)
        #: nodes this process holds (the leading axis of its tensors)
        self.n_local = 1 if self.ctx.process_ring else n_nodes
        hier = config.hierarchy
        #: nodes per ring element (a pod under hierarchy, else 1) and the
        #: ring's length: the loss model's receivers, the membership masks
        #: and the stride checks all index the ``ring_len`` elements
        self.pod_size = 1 if hier is None else hier.pod_size(n_nodes)
        self.ring_len = rl = n_nodes // self.pod_size
        if config.membership is not None:
            for e, m in enumerate(config.membership):
                if len(m) != rl:
                    raise ValueError(
                        f"membership mask {e} covers {len(m)} ring elements "
                        f"but the mesh has {rl} "
                        f"({'pods' if self.pod_size > 1 else 'nodes'})")
        if rl > 1 and config.algorithm in ("adc_dgd", "dgd",
                                           "compressed_dgd"):
            for s in config.ring_strides:
                if s % rl == 0:
                    raise ValueError(
                        f"ring stride {s} is a self-loop on {rl} ring "
                        "elements: the exchange would carry no "
                        "communication; drop it from ring_strides")
            # the union over one cycle is the circulant with connection set
            # {+-s}: connected iff gcd(s_1, ..., s_k, n) == 1
            g = math.gcd(rl, *config.ring_strides)
            if g != 1:
                raise ValueError(
                    f"ring_strides {config.ring_strides} on {rl} ring "
                    f"elements share the common factor {g}: the union of "
                    "all schedule epochs splits the ring into disjoint "
                    "components")
        self.cfg = config
        self.n_nodes = n_nodes
        self._wirings: dict = {}
        self._views: dict = {}
        #: the layout-independent plan recipe (a bare codec name is a
        #: uniform plan)
        self.plan_spec = wireplan.parse_spec(config.wire_codec)
        self.layout_spec = layout_spec or self.plan_spec
        self._plan_cache: dict = {}
        #: the loss model bound to the ring elements, and the async
        #: transport's straggler model (None: not configured)
        self.loss = config.loss_model_for(rl)
        self.straggler = config.straggler_model
        #: payloads read as the zero payload so far (one per dropped
        #: arrival per transfer unit): what the exchange really did (a
        #: rank counts its own arrivals)
        self.zero_payloads = 0
        #: the async transport's flight over ranks that has not landed:
        #: (flight, the state it completes, its two arrival tensors)
        self._flight = None

    @property
    def wire_name(self) -> str:
        """The wire's name: the codec's, or the mixed plan's spec."""
        return self.plan_spec.to_string()

    # -- state ---------------------------------------------------------
    def state_layout(self, params: Any) -> wire.WireLayout:
        """The packing plan of one node's parameter tree: leaf order, or
        for a mixed ``layout_spec`` its grouped placement (one run per
        codec)."""
        layout = wire.WireLayout.for_tree(T.tree_map(lambda a: a[0], params))
        if not self.layout_spec.is_uniform:
            placement = wireplan.grouped_placement(
                layout, tuple(self.layout_spec.codec_for_path(s.path)
                              for s in layout.slots))
            if placement is not None:
                layout = layout.with_placement(placement)
        return layout

    def wire_plan_for(self, layout: wire.WireLayout) -> wireplan.WirePlan:
        """The (cached) WirePlan of this runtime's spec on ``layout``: the
        one source of payload geometry and wire accounting."""
        plan = self._plan_cache.get(layout)
        if plan is None:
            plan = self._plan_cache[layout] = self.plan_spec.build(layout)
        return plan

    def noise_cols_for(self, layout: wire.WireLayout) -> int:
        """Columns of the noise buffer one exchange consumes (the most any
        codec of the plan reads)."""
        return self.wire_plan_for(layout).noise_cols(layout.block)

    def init_state(self, params: Any) -> dict:
        """Packed consensus shadows ``(N, n_rows, BLOCK)`` for ``adc_dgd``;
        with push-sum the weights ``ps_w`` ``(N, 1)`` and ``ps_nbr`` ``(N,
        2)`` (all 1); on the async transport the three ``(N, bytes)``
        uint8 in-flight payloads: zero bytes (the step-1 retire is a
        no-op), and with push-sum a trailer holding the weight 1.

        All nodes start from the same x0, so every neighbour estimate is x0
        and the incremental aggregate m_0 = sum_{j != i} W_ij x0 =
        (1 - W_ii) x0."""
        if self.cfg.algorithm != "adc_dgd":
            return {}
        n = self.n_local
        layout = self.state_layout(params)
        x_tilde = layout.pack(params)
        dev = x_tilde.device
        st = {"x_tilde": x_tilde,
              "m_agg": (1.0 - self.cfg.self_weight) * x_tilde}
        push = self.cfg.push_sum_enabled
        if push:
            st["ps_w"] = torch.ones((n, 1), dtype=torch.float32, device=dev)
            st["ps_nbr"] = torch.ones((n, 2), dtype=torch.float32,
                                      device=dev)
        if self.cfg.wire_packing == "async":
            nbytes = self.wire_plan_for(layout).payload_bytes
            trailer = st["ps_w"].view(torch.uint8) if push else None
            for key in wire.INFLIGHT_KEYS:
                st[key] = wire.inflight_init(n, nbytes, dev, trailer)
        return st

    # -- the async transport's flight over ranks -------------------------
    @property
    def in_flight(self) -> bool:
        """Has the last exchange posted an async payload that has not
        landed (:meth:`land`)?"""
        return self._flight is not None

    def land(self) -> None:
        """Complete the consensus state of the async transport over ranks.

        At staleness 1 an exchange on a process ring posts its payload to
        both neighbours and returns the new state WITHOUT ``fly_up`` and
        ``fly_dn``: their bytes are still on the wire.  This waits for that
        flight (if it has not landed yet) and puts its two arrivals into
        that same state dict.  Everything that reads the consensus state
        calls it first: the next exchange's retire does, and so do the
        trainer's end, the exchange probe and ``with_codec``; a state read
        before it has no ``fly_up`` (a ``KeyError``, never a half-landed
        buffer).  Each flight lands in tensors of its own step, which no
        later transfer writes, so a caller may keep any state (of any
        step) as long as it likes once it has landed.  A no-op stacked,
        on the other transports, and when nothing is in flight."""
        if self._flight is None:
            return
        flight, state, up, dn = self._flight
        self._flight = None
        flight.wait()
        state["fly_up"], state["fly_dn"] = up, dn

    @contextlib.contextmanager
    def aside(self):
        """A block of exchanges that are no step of the run (the trainer's
        exchange probe): the live flight lands first, so the live state is
        complete; the block's own flights land in tensors of their own
        states (never the live state's) and the last of them lands before
        the block ends, so the live state and the ring are left as they
        were and the run's next retire finds nothing in flight."""
        self.land()
        try:
            yield
        finally:
            self.land()

    # -- static accounting -------------------------------------------------
    def _payload_rows(self, layout: wire.WireLayout) -> tuple[int, int]:
        """(payload bytes of one direction without the trailer, rows of the
        resync's fp32 x_tilde) of the compressed wire."""
        if self.cfg.wire_packing == "per_leaf":
            rows = sum(kops.padded_block_rows(s.size) for s in layout.slots)
            return rows * kops.payload_width(), rows
        return self.wire_plan_for(layout).payload_bytes, layout.n_rows

    def wire_accounting(self, n_params_local: int,
                        layout: wire.WireLayout
                        ) -> telemetry.WireAccounting | None:
        """The byte accounting of this runtime's wire, the one source of
        ``wire_bytes_per_step``, the delivered bytes and the telemetry's
        shipped bytes: the plan's flat payload and the push-sum trailer
        per direction.  The per-leaf transport ships each leaf padded to
        its own TILE_N-aligned height, so more rows than the packed
        payload of the same tree.  A time-varying ring adds the epoch
        resync of ``adc_dgd``, one fp32 ``x_tilde`` per ring direction per
        re-wiring, amortized over ``schedule_period`` steps (an upper bound
        under membership, whose resyncs stop once the mask has clamped).
        Hierarchy adds the inner level's fp32 ring all-reduce
        (``HierarchySpec.inner_bytes_per_step``), all there is at one pod.
        ``dgd`` ships ``wire_dtype``; the others nothing (None)."""
        cfg = self.cfg
        alg = cfg.algorithm
        if alg in ("adc_dgd", "compressed_dgd"):
            hier = cfg.hierarchy if alg == "adc_dgd" else None
            inner = (0.0 if hier is None else hier.inner_bytes_per_step(
                n_params_local, self.n_nodes))
            if hier is not None and self.ring_len <= 1:
                return telemetry.WireAccounting(payload_bytes=0,
                                                inner_bytes=inner)
            payload, rows = self._payload_rows(layout)
            resync = 0.0
            if alg == "adc_dgd" and cfg.schedule_varying:
                resync = 2.0 * rows * kops.BLOCK * 4 / cfg.schedule_period
            push = alg == "adc_dgd" and cfg.push_sum_enabled
            return telemetry.WireAccounting(
                payload_bytes=int(payload),
                trailer_bytes=(wireplan.PUSH_SUM_TRAILER_BYTES if push
                               else 0),
                resync_bytes_amortized=resync, inner_bytes=inner)
        if alg == "dgd":
            return telemetry.WireAccounting.uncompressed(
                n_params_local,
                torch.empty((), dtype=cfg.wire_dtype).element_size())
        return None

    def wire_bytes_per_step(self, n_params_local: int,
                            layout: wire.WireLayout) -> float:
        """Bytes one node puts on the ring per step, both directions
        (:meth:`wire_accounting`)."""
        acct = self.wire_accounting(n_params_local, layout)
        return 0.0 if acct is None else acct.shipped_per_step

    def _chunks_for(self, layout: wire.WireLayout) -> wire.ChunkedLayout:
        """The compressed_dgd packed path's uniform int8 chunks: the
        configured count on the pipelined transport, else one."""
        return wire.ChunkedLayout.split(
            layout, self.cfg.pipeline_chunks
            if self.cfg.wire_packing == "pipelined" else 1)

    def pipeline_chunks_for(self, layout: wire.WireLayout) -> int:
        """Transfer units per step: the plan's snapped chunk count on the
        pipelined transport, else 1."""
        if self.cfg.wire_packing != "pipelined":
            return 1
        if self.cfg.algorithm == "compressed_dgd":
            return self._chunks_for(layout).n_chunks
        return self.wire_plan_for(layout).n_chunks(self.cfg.pipeline_chunks)

    def collectives_per_step(self, n_leaves: int = 1,
                             n_chunks: int | None = None,
                             layout: wire.WireLayout | None = None) -> float:
        """Ring transfers one node makes per step (static): one payload per
        ring direction and transfer unit on the packed, pipelined and async
        wires (2 x units), codes and scales per direction per leaf on the
        per-leaf transport; a time-varying ``adc_dgd`` ring adds its
        resync's transfers amortized over ``schedule_period`` steps, and
        hierarchy its inner average (the all-reduce's ``n - 1`` at one
        pod).  Without ``layout`` or ``n_chunks`` the pipelined count is the
        configured one."""
        cfg, n = self.cfg, self.n_nodes
        alg = cfg.algorithm
        if alg == "none" or (n <= 1 and alg != "allreduce"):
            return 0.0
        resync = 1.0 / cfg.schedule_period if cfg.schedule_varying else 0.0
        if cfg.wire_packing == "pipelined":
            if n_chunks is None and layout is not None:
                n_chunks = self.pipeline_chunks_for(layout)
            chunks = float(cfg.pipeline_chunks if n_chunks is None
                           else n_chunks)
        else:
            chunks = 1.0
        if alg == "adc_dgd":
            if cfg.hierarchy is not None and self.ring_len <= 1:
                return float(n - 1) * n_leaves     # the rotation all-reduce
            # the push-sum weight rides the payload's trailer, but is its
            # own scalar transfer per direction in the resync and on every
            # per-leaf step; the hierarchy's inner level is one more
            ps = 2.0 if cfg.push_sum_enabled else 0.0
            if cfg.wire_packing == "per_leaf":
                return 4.0 * n_leaves + ps + 2.0 * n_leaves * resync
            inner = 1.0 if self.pod_size > 1 else 0.0
            return inner + 2.0 * chunks + (2.0 * chunks + ps) * resync
        if alg == "compressed_dgd":
            return (4.0 * n_leaves if cfg.wire_packing == "per_leaf"
                    else 2.0 * chunks)
        if alg == "dgd":
            return 2.0 * n_leaves
        return float(n - 1) * n_leaves     # rotation all-reduce

    def stride_at(self, step: int) -> int:
        """The ring stride of ``step``'s schedule epoch (steps count from
        1): ``ring_strides`` cycled, each held ``schedule_period`` steps."""
        strides = self.cfg.ring_strides
        return strides[((step - 1) // self.cfg.schedule_period)
                       % len(strides)]

    def mask_at(self, step: int) -> tuple | None:
        """The membership mask of ``step``'s epoch (clamped to the last
        mask), or None without membership."""
        masks = self.cfg.membership
        if masks is None:
            return None
        return masks[min((step - 1) // self.cfg.schedule_period,
                         len(masks) - 1)]

    def _wiring(self, stride: int, mask=None) -> Wiring:
        key = (stride, mask)
        if key not in self._wirings:
            self._wirings[key] = Wiring.build(self.ring_len, stride, mask)
        return self._wirings[key]

    def wiring_at(self, step: int) -> Wiring:
        """The neighbour table of ``step``'s epoch: its stride over the
        ring compacted by its membership mask."""
        return self._wiring(self.stride_at(step), self.mask_at(step))

    def view(self, wiring: Wiring) -> RingView:
        """``wiring`` seen from this process's rows (:class:`RingView`):
        every element stacked; over ranks the rank's element ``rank // m``
        (m the pod size), whose transfers go to member ``rank % m`` of its
        left and right elements."""
        v = self._views.get(wiring)
        if v is None:
            if not self.ctx.process_ring:
                v = RingView(wiring, tuple(range(self.ring_len)), None)
            else:
                m = self.pod_size
                e, j = divmod(self.ctx.rank, m)
                left, right = wiring.left[e], wiring.right[e]
                v = RingView(wiring, (e,), None if left is None
                             else (left * m + j, right * m + j))
            self._views[wiring] = v
        return v

    def _post(self, x: torch.Tensor, slot, view: RingView,
              into: list | None = None):
        """Post this rank's ``x`` to its two peers of ``view`` and receive
        theirs (``ParallelContext.ring_start``).  An inactive rank has no
        peers and must post nothing."""
        if view.peers is None:
            raise RuntimeError(f"an inactive rank posted {slot!r}")
        return self.ctx.ring_start(x, slot, into=into, peers=view.peers)

    def resync_at(self, step: int) -> bool:
        """Does ``step`` open a re-wired epoch (every epoch but the first
        of a time-varying ring or membership), so that ``adc_dgd`` rebuilds
        ``m_agg``?  With membership and one stride the wiring stops
        changing once the mask has clamped, and so do the resyncs."""
        cfg = self.cfg
        if not (cfg.schedule_varying and step > 1
                and (step - 1) % cfg.schedule_period == 0):
            return False
        if cfg.membership is not None and len(cfg.ring_strides) == 1:
            return (step - 1) // cfg.schedule_period <= len(
                cfg.membership) - 1
        return True

    def rebuild_m_agg(self, xt: torch.Tensor, stride: int,
                      out: torch.Tensor | None = None,
                      mask=None) -> torch.Tensor:
        """The epoch resync: each active element's exact ``m_agg = side *
        (x_tilde[left] + x_tilde[right])`` from its new neighbours'
        (``Wiring`` of ``stride`` and ``mask``) fp32 shadows ``xt``
        ``(n, rows, BLOCK)`` (added, then scaled, as the reference does),
        into ``out`` when given; inactive rows are left as they are.  On
        the directed ring it is ``f32(w_fwd) x_tilde[left] + f32(w_bwd)
        x_tilde[right]``.  Under a process context the neighbours' shadows
        cross the wiring (the reference's ``_ring(xt, +-stride)``), a
        transfer posted here; an inactive rank posts nothing and leaves
        ``out`` as it is."""
        out = torch.empty_like(xt) if out is None else out
        view = self.view(self._wiring(stride, mask))
        if self.ctx.process_ring:
            if view.peers is None:
                return out
            flight = self._post(xt[0], ("resync", "x_tilde"), view)
            return self._rebuild_into(out, [(0, *flight.wait())])
        wiring = view.wiring
        return self._rebuild_into(out, [
            (i, xt[wiring.left[i]], xt[wiring.right[i]])
            for i in wiring.active])

    def _rebuild_into(self, out: torch.Tensor, pairs) -> torch.Tensor:
        """``rebuild_m_agg``'s arithmetic: ``out[i]`` from each ``(i,
        x_tilde left, x_tilde right)`` of ``pairs``.  The exchanges over
        ranks that post the shadows' transfer early pass its arrivals."""
        w_fwd, w_bwd = self.cfg.in_weights
        for i, left, right in pairs:
            if w_fwd != w_bwd:
                torch.mul(left, _f32(w_fwd), out=out[i])
                out[i].add_(right * _f32(w_bwd))
            else:
                torch.add(left, right, out=out[i])
                out[i].mul_(self.cfg.side_weight)
        return out

    def _keep_stale(self, built: torch.Tensor, stale: torch.Tensor,
                    ok: np.ndarray | None) -> None:
        """A resync whose handshake failed at node i keeps its stale
        aggregate: ``built[i] = stale[i]`` where ``ok[i]`` is False."""
        if ok is None:
            return
        for i in np.flatnonzero(~ok):
            built[i].copy_(stale[i])

    # -- faults ----------------------------------------------------------
    def keep_mask(self, step: int) -> np.ndarray | None:
        """``(2, n)`` host keep mask of the payloads launched at ``step``
        for the ``n`` ring elements (row 0 from upstream, row 1 from
        downstream), or None without a loss model."""
        if self.loss is None:
            return None
        return self.loss.keep_flags(step, self.ring_len)

    def deadline_mask(self, launch_step: int) -> np.ndarray | None:
        """``(2, N)`` straggler deadline flags of the async payloads
        launched at ``launch_step``, or None without a straggler model."""
        if self.straggler is None:
            return None
        return self.straggler.keep_flags(launch_step, self.ring_len)

    def resync_ok(self, step: int) -> np.ndarray | None:
        """``(N,)`` success of ``step``'s resync handshake (both directions
        landed within ``resync_retries``), or None when resyncs cannot fail
        (no loss model, or no resync at ``step``)."""
        if self.loss is None or not self.resync_at(step):
            return None
        ok = self.loss.resync_keep_flags(step, self.ring_len,
                                         self.cfg.resync_retries)
        return ok[0] & ok[1]

    def _arrivals(self, pays: list, view: RingView,
                  keep: np.ndarray | None) -> tuple[list, list]:
        """Each element's (left, right) arrivals of one transfer unit: its
        neighbours' payloads, or one shared all-zero payload of their size
        where ``keep`` drops them (the senders' buffers are never written);
        None for an inactive element.  Stacked only: over processes the
        arrivals are a transfer's (``_drop`` of what it received)."""
        wiring = view.wiring
        left = [None if j is None else pays[j] for j in wiring.left]
        right = [None if j is None else pays[j] for j in wiring.right]
        return self._drop(left, right, keep, view)

    def _drop(self, left: list, right: list, keep: np.ndarray | None,
              view: RingView) -> tuple[list, list]:
        """Replace the arrivals ``keep`` ``(2, n)`` (local rows) drops at
        active rows by one shared zero payload of their shape (a tensor,
        or a tuple of them); each is one zero payload read."""
        if keep is None:
            return left, right
        drop = ~keep
        drop[:, view.inactive] = False
        if not drop.any():
            return left, right
        first = next(t for t in left if t is not None)
        zero = (tuple(torch.zeros_like(t) for t in first)
                if isinstance(first, tuple) else torch.zeros_like(first))
        for side, row in ((left, drop[0]), (right, drop[1])):
            for i in np.flatnonzero(row):
                side[i] = zero
        self.zero_payloads += int(drop.sum())
        return left, right

    def _fault_metrics(self, metrics: dict, acct, flags, device,
                       view: RingView) -> torch.Tensor:
        """``wire_bytes_delivered`` (bytes per direction times surviving
        directions, ``acct``) and ``delivered_frac`` per local row, from
        the ``(2, n)`` arrival flags; 0 at an inactive row.  Returns the
        surviving directions per row."""
        delivered = flags.sum(axis=0)
        delivered[view.inactive] = 0
        delivered = _node_values(delivered, device)
        metrics["wire_bytes_delivered"] = acct.delivered_bytes(delivered)
        metrics["delivered_frac"] = delivered / 2.0
        return delivered

    def _telemetry_metrics(self, metrics: dict, acct, saturated, resync,
                           ok, view: RingView, retired=None) -> None:
        """The ``telemetry`` extras per element, shared by every ADC return
        path, 0 at an inactive element: ``wire_bytes_shipped`` (payload
        bytes put on the ring), ``saturated_count`` (the clipped-code
        census), under hierarchy ``wire_bytes_inner`` / ``_outer`` (the
        pod's fp32 level, the pod ring's payload), on a re-wired ring
        ``resync_fired`` and ``resync_ok`` (both handshakes landed), and on
        the async transport ``staleness_retired`` (in-flight payloads
        drained: the delivered directions, else 2)."""
        keys = self.cfg.telemetry_metric_keys()
        if not keys:
            return
        act = np.ones(view.n, np.float32)
        act[view.inactive] = 0.0
        act = _node_values(act, saturated.device)
        metrics["wire_bytes_shipped"] = act * _f32(acct.shipped_payload)
        metrics["saturated_count"] = act * saturated
        if "wire_bytes_inner" in keys:
            metrics["wire_bytes_inner"] = act * _f32(acct.inner_bytes)
            metrics["wire_bytes_outer"] = act * _f32(acct.shipped_payload)
        if "resync_fired" in keys:
            fired = 1.0 if resync else 0.0
            metrics["resync_fired"] = act * fired
            metrics["resync_ok"] = act * (
                fired if ok is None else _node_values(ok * fired,
                                                      act.device))
        if "staleness_retired" in keys:
            metrics["staleness_retired"] = act * (2.0 if retired is None
                                                  else retired)

    def _idle_telemetry(self, device) -> dict:
        """The ``telemetry`` extras of an exchange that sent nothing."""
        return {k: torch.zeros(self.n_local, dtype=torch.float32,
                               device=device)
                for k in self.cfg.telemetry_metric_keys()}

    def _neighbour_rows(self, t: torch.Tensor, view: RingView,
                        slot: Any = "weights"):
        """(rows left, rows right) of a small per-element tensor ``t``,
        stacked (no index tensor is copied to the device); under a process
        context the peers' ``t``, a transfer on ``slot`` (copies: the
        slot's buffers are reused)."""
        if self.ctx.process_ring:
            left, right = self._post(t, slot, view).wait()
            return left.clone(), right.clone()
        wiring = view.wiring
        return _rows(t, list(wiring.left)), _rows(t, list(wiring.right))

    def _push_sum_update(self, ps_w, w_l, w_r, state, keep, resync, ok,
                         view, fresh=None):
        """The push-sum weight step from the received weights ``w_l``,
        ``w_r`` ``(N, 1)``: dropped arrivals fall back to the last-seen
        ``ps_nbr``; a resync refreshes both from the new neighbours
        (``fresh``, the neighbours' weights already received, or a
        transfer of ``ps_w`` here) unless the node's handshake failed.
        Returns (ps_new, ps_nbr_new)."""
        nbr = state["ps_nbr"]
        if keep is not None:
            w_l = _pick(keep[0], w_l, nbr[:, 0:1])
            w_r = _pick(keep[1], w_r, nbr[:, 1:2])
        if resync:
            fresh_l, fresh_r = (fresh if fresh is not None else
                                self._neighbour_rows(ps_w, view,
                                                     ("resync", "w")))
            if ok is None:
                w_l, w_r = fresh_l, fresh_r
            else:
                w_l, w_r = _pick(ok, fresh_l, w_l), _pick(ok, fresh_r, w_r)
        w_fwd, w_bwd = self.cfg.in_weights
        # == self w + fwd w_l + bwd w_r, but exact when all weights agree:
        # on the homogeneous ring the weight stays 1 bit for bit
        ps_new = ps_w + ((w_l - ps_w) * _f32(w_fwd)
                         + (w_r - ps_w) * _f32(w_bwd))
        return ps_new, torch.cat([w_l, w_r], dim=1)

    def _directed_fix(self, codec_name: str, pay_l, pay_r, outs, i: int,
                      rows: slice) -> None:
        """The directed ring's correction of node i's fragment: ``t =
        f32(w_fwd - side) * (d_l - d_r)`` of the two decoded arrivals,
        added to its ``m_agg`` and combine rows ``outs[1][i, rows]``,
        ``outs[2][i, rows]``; in blocks of ``_DECODE_ROWS`` rows."""
        cd = wire_codec.by_name(codec_name)
        c = _f32(self.cfg.in_weights[0] - self.cfg.side_weight)
        n_rows = pay_l.shape[0]
        for r0 in range(0, n_rows, _DECODE_ROWS):
            r1 = min(r0 + _DECODE_ROWS, n_rows)
            t = cd.decode_payload(pay_l[r0:r1])
            t.sub_(cd.decode_payload(pay_r[r0:r1])).mul_(c)
            dst = slice(rows.start + r0, rows.start + r1)
            outs[1][i, dst].add_(t)
            outs[2][i, dst].add_(t)

    def _step_k(self, step: int) -> float | None:
        """Fixed mode: the grid step Delta_0 / k^gamma, in float32, as the
        reference's compiled step computes it (``f32.over_power``)."""
        if self.cfg.quant_mode != "fixed":
            return None
        k = max(np.float32(1.0), np.float32(step))
        return float(over_power(self.cfg.fixed_step0, k, self.cfg.gamma))

    def make_noise(self, layout: wire.WireLayout, step: int, seed: int,
                   device) -> torch.Tensor:
        """``(n, n_rows, noise_cols_for(layout))`` uniform noise for the
        ``n`` ring elements (``BLOCK`` columns; ``2 * BLOCK`` when the plan
        holds top-k), one ``torch.Generator`` on ``device`` per element
        seeded from (seed, step, element): under hierarchy a pod's members
        share their pod's draw.  Under a process context ``(1, ...)``: the
        rank's own element (its pod's, ``rank // m``), the stacked draw's
        row of that element (the reference's ``_device_key``)."""
        elems = ([self.ctx.rank // self.pod_size] if self.ctx.process_ring
                 else range(self.ring_len))
        noise = torch.empty((len(elems), layout.n_rows,
                             self.noise_cols_for(layout)),
                            dtype=torch.float32, device=device)
        for row, i in enumerate(elems):
            g = torch.Generator(device=device)
            g.manual_seed(noise_seed(seed, step, i))
            torch.rand(noise[row].shape, generator=g, out=noise[row])
        return noise

    # -- the exchange ----------------------------------------------------
    def exchange(self, x_prev: Any, x_half: Any, state: dict, step: int,
                 seed: int = 0, noise: torch.Tensor | None = None):
        """x_prev: params at step k; x_half: after the local optimizer step.

        ``noise``: optional ``(N, n_rows, >= noise_cols_for(layout))``
        uniform buffer consumed row for row by the encoders (tests inject
        the reference's; under hierarchy each pod reads its first
        member's rows); without it each ring element draws its own from
        ``(seed, step, element)``.  Returns (x_next, new_state,
        metrics)."""
        alg = self.cfg.algorithm
        layout = self.state_layout(x_half)
        wiring = self.wiring_at(step)
        view = self.view(wiring)
        metrics = {
            "collectives_per_step": self.collectives_per_step(
                layout.n_leaves, layout=layout),
            "wire_bytes_per_step": self.wire_bytes_per_step(
                layout.n_elements, layout)}
        device = T.tree_leaves(x_half)[0].device
        hier = alg == "adc_dgd" and self.cfg.hierarchy is not None
        if alg == "none" or (self.n_nodes <= 1 and alg != "allreduce"):
            x_next = x_half
            metrics.update(self._idle_telemetry(device))
        elif alg == "allreduce" or (hier and self.ring_len <= 1):
            # one pod of every node: its inner average is the whole
            # exchange, the allreduce's bit for bit; the shadows pass
            x_next = _allreduce_mean_delta(x_prev, x_half, self.ctx)
            if hier:
                metrics.update(self._idle_metrics(device))
        elif alg == "dgd":
            x_next = self._dgd_exchange(x_prev, x_half, view)
        elif alg == "compressed_dgd":
            if noise is None:
                noise = self.make_noise(layout, step, seed, device)
            fn = (self._cdgd_exchange_per_leaf
                  if self.cfg.wire_packing == "per_leaf"
                  else self._cdgd_exchange_packed)
            x_next = fn(x_prev, x_half, noise, layout, view)
        else:
            fn = {"packed": self._adc_exchange,
                  "pipelined": self._adc_exchange,
                  "async": self._adc_exchange_async,
                  "per_leaf": self._adc_exchange_per_leaf}[
                      self.cfg.wire_packing]
            if self.pod_size > 1:
                x_next, state, adc = self._pod_exchange(
                    fn, x_prev, x_half, state, step, seed, noise, layout,
                    view)
            else:
                x_next, state, adc = fn(x_prev, x_half, state, step, seed,
                                        noise, layout, view)
            metrics.update(adc)
            if self.cfg.membership is not None:
                metrics["active_nodes"] = torch.full(
                    (self.n_local,), float(wiring.n_active),
                    dtype=torch.float32, device=device)
        if self.cfg.track_consensus_error:
            metrics["consensus_err"] = _consensus_error(x_next, self.ctx)
        return x_next, state, metrics

    def _idle_metrics(self, device) -> dict:
        """The ADC metrics of an exchange that ran no compressed wire (one
        pod): nothing clipped or sent, every arrival delivered, every node
        of the ring active (the reference's ``total_consensus_nodes``)."""
        zero = torch.zeros(self.n_local, dtype=torch.float32, device=device)
        out = {"overflow_frac": zero, "residual_norm": zero}
        if self.cfg.faults_enabled:
            out["wire_bytes_delivered"] = zero
            out["delivered_frac"] = torch.ones_like(zero)
        if self.cfg.straggle_rate is not None:
            out["deadline_miss_frac"] = zero
        if self.cfg.membership is not None:
            out["active_nodes"] = torch.full_like(zero, float(self.n_nodes))
        out.update(self._idle_telemetry(device))
        return out

    def _pod_exchange(self, fn, x_prev, x_half, state, step, seed, noise,
                      layout, view):
        """The two-level exchange: each pod's inner fp32 mean of the
        optimizer delta, then ``fn``, the outer exchange, on the pods'
        representatives (their first members) over the pod ring; its
        parameters, state and per-element metrics are copied to every
        member, which the shared-x0 contract makes bitwise replicas.  Over
        processes every member runs ``fn`` on its own rows as its pod's
        replica (the copy to the members is implicit, as in the
        reference's pod ``ppermute``): ``view`` sends member j's payloads
        to member j of the neighbouring pods."""
        m = self.pod_size
        if self.ctx.process_ring:
            # an inactive pod is frozen whatever its mean: its members
            # send nothing, not even to one another
            if view.peers is not None:
                x_half = self._pod_mean_delta(x_prev, x_half)
            return fn(x_prev, x_half, state, step, seed, noise, layout, view)
        x_half = self._pod_mean_delta(x_prev, x_half)
        x_prev = T.tree_map(lambda a: a[::m], x_prev)
        state = {k: v[::m] for k, v in state.items()}
        x_next, state, adc = fn(x_prev, x_half, state, step, seed,
                                None if noise is None else noise[::m],
                                layout, view)

        def grow(a):
            return a.repeat_interleave(m, dim=0)
        return (T.tree_map(grow, x_next), {k: grow(v) for k, v in
                                           state.items()},
                {k: grow(v) if torch.is_tensor(v) else v
                 for k, v in adc.items()})

    def _pod_mean_delta(self, x_prev, x_half):
        """The inner level for the pods' representatives: ``x_prev + s /
        m`` with ``s`` the sum of the pod's members' fp32 deltas, added in
        member order (``ctx.pod_sums``; over processes each member's own
        pod, the representative's bits).  The reference's ``s / m``
        compiles to ``s * f32(1/m)`` contracted with the add into one fused
        multiply-add (``_fma``); at a pod size that is a power of two the
        product is exact and the plain multiply-add gives the same
        bits."""
        m = self.pod_size
        inv = float(recip(m))
        ring = self.ctx.process_ring
        prev, treedef = T.tree_flatten(x_prev)
        half = T.tree_leaves(x_half)
        sums = self.ctx.pod_sums(((h - p).to(torch.float32)
                                  for p, h in zip(prev, half)), m, "pod")
        out = []
        for s, p, h in zip(sums, prev, half):
            base = (p if ring else p[::m]).to(torch.float32)
            if inv * m == 1.0:
                out.append(s.mul_(inv).add_(base).to(h.dtype))
            else:
                out.append(_fma(s, inv, base).to(h.dtype))
        return T.tree_unflatten(treedef, out)

    def encode(self, y: torch.Tensor, noise: torch.Tensor, step: int,
               layout: wire.WireLayout) -> list[torch.Tensor]:
        """Each node's flat uint8 payload of the packed differentials ``y``
        ``(N, n_rows, BLOCK)`` on ``layout``: the bytes the packed exchange
        ships, one encode launch per node and codec run."""
        plan = self.wire_plan_for(layout)
        return self._encode_unit(plan, plan.transfer_units(None)[0], y,
                                 noise, self._step_k(step),
                                 nodes=range(y.shape[0]))

    def _encode_unit(self, plan, unit, y, noise, step_k, nodes, out=None,
                     trailer=None) -> list:
        """Each element's flat uint8 payload of transfer unit ``unit``
        (into ``out[i]`` when ``out`` is given): one encode launch per
        element of ``nodes`` and codec run; None for the others.
        ``trailer`` ``(n, 4)`` uint8 (the push-sum weight's bytes) is
        appended to each payload; ``out`` rows then hold it in their last
        4 bytes."""
        n = y.shape[0]
        nb = plan.unit_bytes(unit)
        if trailer is not None and out is None:
            out = torch.empty((n, nb + wireplan.PUSH_SUM_TRAILER_BYTES),
                              dtype=torch.uint8, device=y.device)
        pays = [None] * n
        if out is None:
            for i in nodes:
                pays[i] = plan.encode_unit(unit, y[i], noise[i], step_k)
            return pays
        if trailer is not None:
            out[:, nb:].copy_(trailer)
        for i in nodes:
            plan.encode_unit(unit, y[i], noise[i], step_k, out[i, :nb])
            pays[i] = out[i]
        return pays

    def _retire(self, plan, unit, own, left, right, xt, mb, outs,
                nodes) -> None:
        """Fused decode + shadow update + ring combine of one transfer unit
        for every element of ``nodes``, one launch per element and codec
        run, into the row slices of ``outs`` = (x_tilde', m_agg',
        combined).  ``own[i]``, ``left[i]`` and ``right[i]`` are element
        i's flat payload and its two arrivals, each starting at the unit's
        first byte.  On the directed ring each fragment then gets its
        correction (``_directed_fix``)."""
        cfg = self.cfg
        w_fwd, w_bwd = cfg.in_weights
        for i in nodes:
            for f in plan.unit_runs(unit):
                views = [plan.fragment_payload(p[i], f, unit.byte_start)
                         for p in (own, left, right)]
                wire_codec.by_name(f.codec).decode_combine(
                    *views, xt[i], mb[i], cfg.self_weight, cfg.side_weight,
                    1.0, row_offset=f.row_start, n_rows=f.n_rows,
                    out=[o[i, f.row_start:f.row_end] for o in outs])
                if w_fwd != w_bwd:
                    self._directed_fix(f.codec, views[1], views[2], outs, i,
                                       slice(f.row_start, f.row_end))

    def _census(self, plan, unit, y, step_k, pays, clipped, nodes) -> None:
        """Add each element's grid-saturation count of unit ``unit`` to
        ``clipped`` (overflow monitoring, paper §IV-D)."""
        for i in nodes:
            clipped[i] += plan.count_saturated(y[i], step_k, pays[i],
                                               unit.byte_start, unit)

    def _finish(self, x_prev, x_half, comb, y, clipped, plan, layout,
                view):
        """The gradient step applied per leaf while unpacking, and the
        overflow and residual metrics.  An inactive element keeps its
        ``x_prev`` bitwise and reads 0 in both metrics."""
        inv_codes, inv_elems = self._ratios(plan, layout)
        residual = torch.sqrt((y * y).sum(dim=(1, 2)) * inv_elems)
        x_next = T.tree_map(
            lambda c, h, p: (c + (h.to(torch.float32)
                                  - p.to(torch.float32))).to(h.dtype),
            layout.unpack(comb, cast=False), x_half, x_prev)
        for i in view.inactive:
            residual[i] = 0.0
            for nx, p in zip(T.tree_leaves(x_next), T.tree_leaves(x_prev)):
                nx[i].copy_(p[i])
        return x_next, {"overflow_frac": clipped * inv_codes,
                        "residual_norm": residual}

    @staticmethod
    def _freeze(new: tuple, old: tuple, view: RingView) -> None:
        """An inactive row keeps its shadows: ``new[k][i] =
        old[k][i]``."""
        for i in view.inactive:
            for a, b in zip(new, old):
                a[i].copy_(b[i])

    def _numerator(self, x_half, state, layout) -> torch.Tensor:
        """The packed ``x_half``, times ``ps_w`` with push-sum (the wire
        carries the numerator ``w x``; at ``w == 1`` an identity)."""
        y = layout.pack(x_half)
        if self.cfg.push_sum_enabled:
            y.mul_(state["ps_w"].view(-1, 1, 1))
        return y

    def _adc_exchange(self, x_prev, x_half, state, step, seed, noise,
                      layout, view):
        """Packed / pipelined exchange over the runtime's WirePlan: one
        transfer unit holding every codec run, or ``pipeline_chunks``
        single-run units taken in the reference's schedule.  Every codec is
        row-local, so every chunking gives the packed exchange's bits.  At
        a resync each unit's ``m_agg`` rows are rebuilt from its
        pre-update ``x_tilde`` rows just before its retire (stale where the
        element's handshake failed).  One keep mask covers every unit of
        the step; the push-sum trailer rides the last unit.

        Under a membership mask only the active elements encode and
        combine: nothing an inactive one would encode is delivered (the
        masked ring has no edge from it) and its combine's results are
        discarded by the freeze, so both are skipped, and its shadows and
        parameters are kept bitwise; an inactive rank posts nothing."""
        cfg, n = self.cfg, view.n
        plan = self.wire_plan_for(layout)
        units = plan.transfer_units(
            cfg.pipeline_chunks if cfg.wire_packing == "pipelined" else None)
        xt, mb = state["x_tilde"], state["m_agg"]
        push = cfg.push_sum_enabled
        keep = view.cols(self.keep_mask(step))
        resync = self.resync_at(step)
        ok = view.cols(self.resync_ok(step))
        ring = self.ctx.process_ring
        nodes = view.active
        y = self._numerator(x_half, state, layout)
        y.sub_(xt)                # the packed differential, built in place
        if noise is None:
            noise = self.make_noise(layout, step, seed, y.device)
        step_k = self._step_k(step)
        outs = tuple(torch.empty_like(xt) for _ in range(3))
        clipped = torch.zeros(n, dtype=torch.float32, device=y.device)
        m_in = torch.empty_like(mb) if resync else mb
        last = len(units) - 1
        trailer = state["ps_w"].view(torch.uint8) if push else None
        stride = view.stride
        # over processes: does this rank post (an inactive one does not)?
        post = ring and bool(nodes)
        recv, flights, shadows = {}, {}, {}

        def launch(c):
            # stacked, the ring transfer is an index and the launch phase
            # is empty; over processes it stages and posts the payload (and
            # at a resync the unit's x_tilde rows)
            telemetry.trace_mark("quantize", c, rows=units[c].n_rows)
            pays = self._encode_unit(plan, units[c], y, noise, step_k, nodes,
                                     trailer=trailer if c == last else None)
            telemetry.trace_mark("launch", c, rows=units[c].n_rows)
            if post:
                flights[c] = self._post(pays[0], ("adc", c), view)
                if resync:
                    shadows[c] = self._post(
                        xt[0, units[c].row_start:units[c].row_end],
                        ("resync", c), view)
            telemetry.trace_end()
            return pays

        def retire(c, pays):
            telemetry.trace_mark("retire", c)
            if resync:
                rows = slice(units[c].row_start, units[c].row_end)
                if post:        # the unit's shadows, posted at its launch
                    self._rebuild_into(m_in[:, rows],
                                       [(0, *shadows.pop(c).wait())])
                elif not ring:
                    self.rebuild_m_agg(xt[:, rows], stride,
                                       out=m_in[:, rows],
                                       mask=view.wiring.mask)
                self._keep_stale(m_in[:, rows], mb[:, rows], ok)
            if post:
                got = flights.pop(c).wait()
                if push and c == last:      # the trailers as they arrived
                    recv["w"] = [_trailer_weights([p]) for p in got]
                left, right = self._drop(got[:1], got[1:], keep, view)
            elif ring:                      # an inactive rank: no arrivals
                left, right = [None], [None]
            else:
                if push and c == last:
                    recv["w"] = self._neighbour_rows(_trailer_weights(pays),
                                                     view)
                left, right = self._arrivals(pays, view, keep)
            telemetry.trace_mark("dequant_combine", c,
                                 rows=units[c].n_rows)
            self._retire(plan, units[c], pays, left, right, xt, m_in, outs,
                         nodes)
            telemetry.trace_end()

        def census(c, pays):
            self._census(plan, units[c], y, step_k, pays, clipped, nodes)

        _pipeline_schedule(len(units), launch, retire,
                           census if cfg.quant_mode == "fixed" else None)
        del noise
        self._freeze(outs[:2], (xt, mb), view)
        new_state = {"x_tilde": outs[0], "m_agg": outs[1]}
        comb = outs[2]
        metrics = {}
        if push:
            ps_new, new_state["ps_nbr"] = self._push_sum_update(
                state["ps_w"], *recv["w"], state, keep, resync, ok, view)
            new_state["ps_w"] = ps_new
            comb.div_(ps_new.view(-1, 1, 1))
            metrics["push_sum_weight"] = ps_new[:, 0]
        x_next, m = self._finish(x_prev, x_half, comb, y, clipped, plan,
                                 layout, view)
        metrics.update(m)
        acct = self.wire_accounting(layout.n_elements, layout)
        if keep is not None:
            self._fault_metrics(metrics, acct, keep, y.device, view)
        self._telemetry_metrics(metrics, acct, clipped, resync, ok, view)
        return x_next, new_state, metrics

    def _adc_exchange_async(self, x_prev, x_half, state, step, seed, noise,
                            layout, view):
        """One-step-stale packed exchange.  ``staleness`` 1: RETIRE the
        payloads launched at step k-1 (zero bytes at step 1: a no-op
        gossip) into x_tilde / m_agg and the combine, then LAUNCH this
        step's differential, encoded against the drained shadow, and carry
        the three payloads (own, from the left, from the right) to step
        k+1; the overflow census reads the fresh payload.  ``staleness`` 0
        is the packed exchange, passing the idle buffers through.

        The retired payloads' loss draw and straggler deadlines are those
        of their launch step k-1; a missed deadline is a drop.  At a
        resync the retired payloads came from the previous epoch's
        neighbours, so they are drained with the old ``m_agg`` first; then
        ``m_agg`` is rebuilt from the new neighbours' post-retire
        ``x_tilde`` (kept where the handshake failed) and the combine
        moves by the difference.

        On the shift ring the payloads are encoded into rows s..s+n-1 of
        one ``(n + 2s, bytes)`` ring buffer (``s`` the stride mod n) whose
        first s rows repeat elements n-s..n-1 and last s rows elements
        0..s-1: ``fly_self``, ``fly_up`` and ``fly_dn`` are its
        overlapping views at rows s, 0 and 2s: the ring transfer copies 2s
        payloads.  Under a membership mask the compacted ring is no shift:
        ``fly_up`` and ``fly_dn`` are gathered from the neighbour table,
        and an inactive element launches and receives zero payloads (so a
        rejoining one retires zeros, then resyncs).

        Under a process context the rank's own payload is ``fly_self`` and
        the launch posts it to both neighbours at the step's stride and
        returns: the returned state has no ``fly_up`` / ``fly_dn`` until
        the flight has landed (:meth:`land`, the first thing the next
        retire does).  The arrivals land in tensors of their own step, so
        nothing rewrites a state once it is complete.  At a resync the
        drained ``x_tilde`` crosses the new wiring.  An inactive rank posts
        nothing: its state's three in-flight payloads are zeros of its own
        making (the stacked masked gather's), so the step it rejoins
        retires zeros, then resyncs."""
        if self.cfg.staleness == 0:
            x_next, ns, metrics = self._adc_exchange(
                x_prev, x_half, state, step, seed, noise, layout, view)
            for key in wire.INFLIGHT_KEYS:
                ns[key] = state[key]
            return x_next, ns, metrics
        ring = self.ctx.process_ring
        wiring = view.wiring
        n = view.n
        plan = self.wire_plan_for(layout)
        unit = plan.transfer_units(None)[0]
        xt, mb = state["x_tilde"], state["m_agg"]
        push = self.cfg.push_sum_enabled
        keep = view.cols(self.keep_mask(step - 1))
        meet = view.cols(self.deadline_mask(step - 1))
        arrive = (keep if meet is None else
                  meet if keep is None else keep & meet)
        resync = self.resync_at(step)
        ok = view.cols(self.resync_ok(step))
        nodes = view.active
        telemetry.trace_mark("retire", 0, mode="async")
        self.land()               # over ranks: the flight step k-1 posted
        fly = [state["fly_self"][i] for i in range(n)]
        # fly_up[i] / fly_dn[i] arrived at element i from its upstream /
        # downstream neighbour of step k-1
        up = [state["fly_up"][i] for i in range(n)]
        dn = [state["fly_dn"][i] for i in range(n)]
        left, right = self._drop(list(up), list(dn), arrive, view)
        outs = tuple(torch.empty_like(xt) for _ in range(3))
        telemetry.trace_mark("dequant_combine", 0, rows=unit.n_rows)
        self._retire(plan, unit, fly, left, right, xt, mb, outs, nodes)
        telemetry.trace_end()
        xt_new, m_new, comb = outs
        if resync:
            m_drained = self.rebuild_m_agg(xt_new, wiring.stride,
                                           mask=wiring.mask)
            self._keep_stale(m_drained, m_new, ok)
            comb.add_(m_drained - m_new)
            m_new = m_drained
        self._freeze((xt_new, m_new), (xt, mb), view)
        metrics = {}
        new_state = {}
        if push:
            ps_new, new_state["ps_nbr"] = self._push_sum_update(
                state["ps_w"], _trailer_weights(up), _trailer_weights(dn),
                state, arrive, resync, ok, view)
            new_state["ps_w"] = ps_new
            comb.div_(ps_new.view(-1, 1, 1))
            metrics["push_sum_weight"] = ps_new[:, 0]
        y = self._numerator(x_half, {"ps_w": ps_new} if push else state,
                            layout)
        y.sub_(xt_new)
        if noise is None:
            noise = self.make_noise(layout, step, seed, y.device)
        step_k = self._step_k(step)
        width = plan.payload_bytes + (wireplan.PUSH_SUM_TRAILER_BYTES
                                      if push else 0)
        trailer = ps_new.view(torch.uint8) if push else None
        r = 0 if ring or wiring.mask is not None else wiring.stride % n
        buf = torch.empty((n + 2 * r, width), dtype=torch.uint8,
                          device=y.device)
        own = buf[r:r + n]
        telemetry.trace_mark("quantize", 0, rows=unit.n_rows, mode="async")
        pays = self._encode_unit(plan, unit, y, noise, step_k, nodes, own,
                                 trailer=trailer)
        del noise
        telemetry.trace_mark("launch", 0, rows=unit.n_rows,
                             buffers=wire.INFLIGHT_KEYS)
        flight = None
        if ring:
            fly_up, fly_dn = torch.empty_like(own), torch.empty_like(own)
            if view.peers is None:
                # inactive: nothing posted, nothing to receive
                for t in (own, fly_up, fly_dn):
                    t.zero_()
            else:
                # posted, not waited: it lands at the next retire
                flight = self._post(own[0], "async", view,
                                    into=[fly_up[0], fly_dn[0]])
        elif wiring.mask is None:
            # ppermute(+s) hands element i element i-s's payload,
            # ppermute(-s) element i+s's
            buf[:r].copy_(buf[n:n + r])
            buf[n + r:].copy_(buf[r:2 * r])
            fly_up, fly_dn = buf[:n], buf[2 * r:]
        else:
            for i in view.inactive:
                own[i].zero_()
            fly_up, fly_dn = torch.empty_like(own), torch.empty_like(own)
            for dst, src in ((fly_up, wiring.left), (fly_dn, wiring.right)):
                for i, j in enumerate(src):
                    if j is None:
                        dst[i].zero_()
                    else:
                        dst[i].copy_(own[j])
        telemetry.trace_end()
        clipped = torch.zeros(n, dtype=torch.float32, device=y.device)
        if self.cfg.quant_mode == "fixed":
            self._census(plan, unit, y, step_k, pays, clipped, nodes)
        x_next, m = self._finish(x_prev, x_half, comb, y, clipped, plan,
                                 layout, view)
        metrics.update(m)
        acct = self.wire_accounting(layout.n_elements, layout)
        retired = None
        if arrive is not None:
            retired = self._fault_metrics(metrics, acct, arrive, y.device,
                                          view)
        if meet is not None:
            miss = (~meet).sum(axis=0)
            miss[view.inactive] = 0
            metrics["deadline_miss_frac"] = _node_values(miss,
                                                         y.device) / 2.0
        self._telemetry_metrics(metrics, acct, clipped, resync, ok, view,
                                retired)
        new_state.update({"x_tilde": xt_new, "m_agg": m_new,
                          "fly_self": own})
        if flight is None:
            new_state.update({"fly_up": fly_up, "fly_dn": fly_dn})
        else:
            self._flight = (flight, new_state, fly_up, fly_dn)
        return x_next, new_state, metrics

    def _ratios(self, plan, layout):
        """``(1/codes, 1/elements)`` of the packed buffer as float32
        reciprocals: the reference's averages, which XLA evaluates as
        products with the divisor's float32 reciprocal."""
        inv_codes = float(np.float32(1.0) / np.float32(plan.codes_total()))
        inv_elems = float(np.float32(1.0) / np.float32(
            layout.n_rows * layout.block))
        return inv_codes, inv_elems

    def _adc_exchange_per_leaf(self, x_prev, x_half, state, step, seed,
                               noise, layout, view):
        """The per-leaf reference transport of :meth:`_adc_exchange`: per
        leaf and node one ``quantize_blocks`` launch, the codes and scales
        handed to both ring neighbours (zero codes and zero scales where a
        packet drops), and one ``dequant_combine`` launch; at a resync each
        leaf's ``m_agg`` is rebuilt from its row-padded ``x_tilde`` (stale
        where the handshake failed).  The push-sum weight is its own
        scalar transfer, received before the leaves; the directed
        correction is the decoded arrivals' as on the packed path.  Each
        leaf is padded to its own TILE_N-aligned height; the noise is the
        packed path's buffer sliced per leaf, so the two transports give
        the same bits.

        Under a process context the rank's node is the one node: each
        leaf's codes and scales (and at a resync its padded ``x_tilde``)
        are posted to both neighbours in the leaf's launch, and leaf i+1
        is launched before leaf i is retired (the reference's pipeline
        schedule); the arrivals are the transfers'."""
        cfg, n = self.cfg, self.n_local
        ring = self.ctx.process_ring
        stride = view.stride
        resync = self.resync_at(step)
        ok = view.cols(self.resync_ok(step))
        keep = view.cols(self.keep_mask(step))
        push = cfg.push_sum_enabled
        w_fwd, w_bwd = cfg.in_weights
        c_dir = _f32(w_fwd - cfg.side_weight)
        step_k = self._step_k(step)
        xt, mb = state["x_tilde"], state["m_agg"]
        if noise is None:
            noise = self.make_noise(layout, step, seed, xt.device)
        metrics, new_state = {}, {}
        if push:
            ps_w = state["ps_w"]
            # the neighbours' weights: every step, so a resync reuses them
            fresh = self._neighbour_rows(ps_w, view)
            ps_new, new_state["ps_nbr"] = self._push_sum_update(
                ps_w, *fresh, state, keep, resync, ok, view, fresh=fresh)
            new_state["ps_w"] = ps_new
            metrics["push_sum_weight"] = ps_new[:, 0]
        clipped = torch.zeros(n, dtype=torch.float32, device=xt.device)
        residual_sq = torch.zeros(n, dtype=torch.float32, device=xt.device)
        new_x, xt_rows, m_rows = [], [], []
        leaves = list(zip(layout.slots, T.tree_leaves(x_half),
                          T.tree_leaves(x_prev)))

        def launch(i):
            nonlocal clipped, residual_sq
            slot, h, _ = leaves[i]
            full = kops.padded_block_rows(slot.size)
            y = _blockify_nodes(h, full)
            if push:
                y.mul_(ps_w.view(-1, 1, 1))
            xtb = _rowpad(layout.leaf_rows(xt, i), full)
            mbb = _rowpad(layout.leaf_rows(mb, i), full)
            shadow = (self._post(xtb[0], ("resync", "leaf", i), view)
                      if ring and resync else None)
            y.sub_(xtb)
            residual_sq += (y * y).sum(dim=(1, 2))
            u = _rowpad(layout.leaf_rows(noise, i), full)
            sent = [kops.quantize_blocks(y[j], u[j], fixed_step=step_k)
                    for j in range(n)]
            del y, u
            if cfg.quant_mode == "fixed":
                clipped += torch.stack([
                    (c.to(torch.int16).abs() >= 127).sum(dtype=torch.float32)
                    for c, _ in sent])
            flights = None
            if ring:
                flights = [self._post(t, ("leaf", i, part), view)
                           for part, t in zip(("codes", "scales"), sent[0])]
            return xtb, mbb, shadow, sent, flights

        def retire(i, launched):
            slot, h, p = leaves[i]
            xtb, mbb, shadow, sent, flights = launched
            if resync:
                built = (self.rebuild_m_agg(xtb, stride) if shadow is None
                         else self._rebuild_into(torch.empty_like(xtb),
                                                 [(0, *shadow.wait())]))
                self._keep_stale(built, mbb, ok)
                mbb = built
            if ring:
                (c_l, c_r), (s_l, s_r) = (f.wait() for f in flights)
                left, right = self._drop([(c_l, s_l)], [(c_r, s_r)], keep,
                                         view)
            else:
                left, right = self._arrivals(sent, view, keep)
            outs = [kops.dequant_combine(
                        *sent[j], *left[j], *right[j], xtb[j], mbb[j],
                        cfg.self_weight, cfg.side_weight, 1.0)
                    for j in range(n)]
            if w_fwd != w_bwd:
                for j, o in enumerate(outs):
                    t = left[j][0] * left[j][1]    # int8 x f32: exact widen
                    t.sub_(right[j][0] * right[j][1])
                    t.mul_(c_dir)
                    o[1].add_(t)
                    o[2].add_(t)
                    del t
            del sent, left, right
            comb = torch.stack([o[2] for o in outs])
            if push:
                comb.div_(ps_new.view(-1, 1, 1))
            xt_rows.append(torch.stack([o[0][:slot.n_rows] for o in outs]))
            m_rows.append(torch.stack([o[1][:slot.n_rows] for o in outs]))
            del outs
            combined = comb.reshape(n, -1)[:, :slot.size].reshape(h.shape)
            new_x.append((combined + (h.to(torch.float32)
                                      - p.to(torch.float32))).to(h.dtype))

        if ring:
            _pipeline_schedule(len(leaves), launch, retire)
        else:                  # one leaf at a time: the smallest peak
            for i in range(len(leaves)):
                retire(i, launch(i))
        inv_codes, inv_elems = self._ratios(self.wire_plan_for(layout),
                                            layout)
        new_state.update({"x_tilde": layout.from_leaf_rows(xt_rows),
                          "m_agg": layout.from_leaf_rows(m_rows)})
        metrics.update({"overflow_frac": clipped * inv_codes,
                        "residual_norm": torch.sqrt(residual_sq
                                                    * inv_elems)})
        acct = self.wire_accounting(layout.n_elements, layout)
        if keep is not None:
            self._fault_metrics(metrics, acct, keep, xt.device, view)
        self._telemetry_metrics(metrics, acct, clipped, resync, ok, view)
        return T.tree_unflatten(layout.treedef, new_x), new_state, metrics

    def _cdgd_mix(self, x_own, sent_l, sent_r):
        """One node's Eq. (5) mix: its own parameters uncompressed, its
        ring neighbours' ``(codes, scales)`` as they arrive on the int8
        wire (codes times scales)."""
        (c_l, s_l), (c_r, s_r) = sent_l, sent_r
        left = c_l.to(torch.float32) * s_l
        right = c_r.to(torch.float32) * s_r
        return (self.cfg.self_weight * x_own
                + self.cfg.side_weight * (left + right))

    def _cdgd_exchange_packed(self, x_prev, x_half, noise, layout, view):
        """Direct-compression DGD (paper Eq. (5), the negative control) on
        the packed int8 wire: per node one ``quantize_payload`` launch per
        chunk (one chunk unless pipelined) over the packed x_prev on the
        undecayed grid ``fixed_step0``; no combine kernel (there are no
        shadows).  Over processes the payload crosses the wire to both
        ring neighbours."""
        n = self.n_local
        xp = layout.pack(x_prev)
        step0 = float(np.float32(self.cfg.fixed_step0))
        bounds = self._chunks_for(layout).bounds
        pays = [_cat([kops.quantize_payload(xp[j], noise[j], step0,
                                            row_offset=r0, n_rows=rows)
                      for r0, rows in bounds])
                for j in range(n)]
        if self.ctx.process_ring:
            left, right = (kops.unpack_payload(p, layout.block) for p in
                           self._post(pays[0], "cdgd", view).wait())
            mixed = self._cdgd_mix(xp[0], left, right)[None]
        else:
            wiring = view.wiring
            sent = [kops.unpack_payload(p, layout.block) for p in pays]
            mixed = torch.stack([
                self._cdgd_mix(xp[j], sent[wiring.left[j]],
                               sent[wiring.right[j]]) for j in range(n)])
        return T.tree_map(
            lambda m, h, p: (m + (h.to(torch.float32)
                                  - p.to(torch.float32))).to(h.dtype),
            layout.unpack(mixed, cast=False), x_half, x_prev)

    def _cdgd_exchange_per_leaf(self, x_prev, x_half, noise, layout,
                                view):
        """Per-leaf reference of :meth:`_cdgd_exchange_packed`: per leaf
        and node one ``quantize_blocks`` launch; the same bits given the
        same noise buffer.  Over processes each leaf's codes and scales
        cross the wire to both ring neighbours (two transfers)."""
        n = self.n_local
        wiring = view.wiring
        step0 = float(np.float32(self.cfg.fixed_step0))
        out = []
        for i, (slot, h, p) in enumerate(zip(layout.slots,
                                              T.tree_leaves(x_half),
                                              T.tree_leaves(x_prev))):
            full = kops.padded_block_rows(slot.size)
            xb = _blockify_nodes(p, full)
            u = _rowpad(layout.leaf_rows(noise, i), full)
            sent = [kops.quantize_blocks(xb[j], u[j], fixed_step=step0)
                    for j in range(n)]
            if self.ctx.process_ring:
                flights = [self._post(t, ("cdgd", i, part), view)
                           for part, t in zip(("codes", "scales"), sent[0])]
                (c_l, c_r), (s_l, s_r) = (f.wait() for f in flights)
                mixed = self._cdgd_mix(xb[0], (c_l, s_l), (c_r, s_r))[None]
            else:
                mixed = torch.stack([
                    self._cdgd_mix(xb[j], sent[wiring.left[j]],
                                   sent[wiring.right[j]]) for j in range(n)])
            mixed = mixed.reshape(n, -1)[:, :slot.size].reshape(h.shape)
            out.append((mixed + (h.to(torch.float32)
                                 - p.to(torch.float32))).to(h.dtype))
        return T.tree_unflatten(layout.treedef, out)

    def _dgd_exchange(self, x_prev, x_half, view):
        """Uncompressed DGD: mix the parameters with both ring neighbours
        (``view``), whose copies arrive cast to ``wire_dtype``, then add
        the local optimizer delta.  Over processes every leaf's transfer
        is posted before the first is waited for."""
        w_self, w_side = self.cfg.self_weight, self.cfg.side_weight
        wire_dtype = self.cfg.wire_dtype
        wiring = view.wiring
        prev, treedef = T.tree_flatten(x_prev)
        flights = None
        if self.ctx.process_ring:
            flights = [self._post(p.to(wire_dtype), ("dgd", i), view)
                       for i, p in enumerate(prev)]

        def mix(i, h, p):
            p32 = p.to(torch.float32)
            if flights is None:
                send = p.to(wire_dtype)
                left = send.index_select(0, torch.tensor(
                    wiring.left, device=p.device))
                right = send.index_select(0, torch.tensor(
                    wiring.right, device=p.device))
            else:
                left, right = flights[i].wait()
            left, right = left.to(torch.float32), right.to(torch.float32)
            mixed = w_self * p32 + w_side * (left + right)
            return (mixed + (h.to(torch.float32) - p32)).to(h.dtype)

        return T.tree_unflatten(treedef, [
            mix(i, h, p) for i, (h, p) in enumerate(
                zip(T.tree_leaves(x_half), prev))])


def check_tp(config: ConsensusConfig, tp: int) -> None:
    """``NotImplementedError`` unless ``config`` lies in the ported slice
    of tensor parallelism (the runtime's docstring), naming what does
    not."""
    default = ConsensusConfig()
    off = [name for name, bad in (
        (f"algorithm {config.algorithm}",
         config.algorithm not in ("adc_dgd", "dgd", "allreduce", "none")),
        (f"the {config.wire_packing} transport",
         config.wire_packing != "packed"),
        (f"wire codec {config.wire_codec}", config.wire_codec != "int8"),
        (f"ring strides {config.ring_strides}",
         tuple(config.ring_strides) != (1,)),
        (f"topology {config.topology}", config.topology != "ring"),
        ("push-sum", config.push_sum_enabled),
        ("link faults", config.faults_enabled),
        ("stragglers", config.straggle_rate is not None),
        ("membership", config.membership is not None),
        ("hierarchy", config.hierarchy is not None),
        ("telemetry", config.telemetry),
        ("a byte budget", config.byte_budget != default.byte_budget)) if bad]
    if off:
        raise NotImplementedError(
            f"tp={tp}: {', '.join(off)} on a tensor-parallel grid is not "
            "yet ported (ROADMAP Queue 1 item 5d: TP with the ring "
            "runtime's other options)")


def _f32(v: float) -> float:
    """A Python float rounded to float32, as the reference's
    ``jnp.float32(v)`` constants are."""
    return float(np.float32(v))


def _node_values(values, device) -> torch.Tensor:
    """A host vector as float32 on ``device``, written by fills (no
    host-to-device copy, which would wait for the device)."""
    out = torch.empty(len(values), dtype=torch.float32, device=device)
    for i, v in enumerate(values):
        out[i].fill_(float(v))
    return out


def _rows(t: torch.Tensor, idx: list) -> torch.Tensor:
    """``t[idx]`` for a host list of row indices, without copying the
    index to the device."""
    return torch.stack([t[j] for j in idx])


def _pick(flags: np.ndarray, a: torch.Tensor, b: torch.Tensor
          ) -> torch.Tensor:
    """Row i of ``a`` where the host flag ``flags[i]`` is set, else of
    ``b`` (device tensors of one shape; no host-to-device copy)."""
    if flags.all():
        return a
    return torch.stack([a[i] if f else b[i] for i, f in enumerate(flags)])


def _trailer_weights(pays: list) -> torch.Tensor:
    """``(N, 1)`` float32 push-sum weights from the 4-byte trailers of
    ``pays`` (each a flat uint8 payload)."""
    tb = wireplan.PUSH_SUM_TRAILER_BYTES
    return torch.stack([p[-tb:] for p in pays]).view(torch.float32)


def _cat(parts: list) -> torch.Tensor:
    """Row concatenation that passes a single part through uncopied."""
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _blockify_nodes(leaf: torch.Tensor, rows: int) -> torch.Tensor:
    """A stacked leaf ``(N, *shape)`` as float32 ``(N, rows, BLOCK)``
    blocks, zero padded (a fresh tensor)."""
    n = leaf.shape[0]
    flat = leaf.reshape(n, -1).to(torch.float32)
    return F.pad(flat, (0, rows * kops.BLOCK - flat.shape[1])).reshape(
        n, rows, kops.BLOCK)


def _rowpad(a: torch.Tensor, rows: int) -> torch.Tensor:
    """``(N, r, BLOCK)`` rows zero padded to ``(N, rows, BLOCK)`` (a fresh
    contiguous tensor): per-leaf buffers take the TILE_N-aligned height,
    and zero rows quantize to code 0."""
    return F.pad(a, (0, 0, 0, rows - a.shape[-2]))


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA contracts it: the float64
    product of two float32 values is exact."""
    return (c.to(torch.float64) + a.to(torch.float64) * b).to(torch.float32)


def _ring_count(leaf: torch.Tensor, ctx: ParallelContext) -> int:
    """The ring's node count: the stacked leading axis, or the ranks."""
    return (ctx.total_consensus_nodes if ctx.process_ring
            else leaf.shape[0])


def _allreduce_mean_delta(x_prev, x_half,
                          ctx: ParallelContext | None = None):
    """Synchronous data parallelism: every node steps by the node-mean of
    the optimizer delta (the reference's rotation all-reduce, in its
    order: ``ctx.node_group_sum``).  The reference's ``x + s / n`` compiles
    to one fused multiply-add with float32(1/N).  ``ctx`` defaults to the
    stacked context."""
    ctx = local_context() if ctx is None else ctx
    prev, treedef = T.tree_flatten(x_prev)
    half = T.tree_leaves(x_half)
    inv_n = float(recip(_ring_count(half[0], ctx)))
    sums = ctx.node_group_sums(((h - p).to(torch.float32)
                                for p, h in zip(prev, half)), "allreduce")
    return T.tree_unflatten(treedef, [
        _fma(s, inv_n, p.to(torch.float32)).to(h.dtype)
        for s, p, h in zip(sums, prev, half)])


def _consensus_error(params,
                     ctx: ParallelContext | None = None) -> torch.Tensor:
    """(1/N) sum_i ||x_i - mean_nodes(x)||^2 over all leaves (a metric).

    In the reference's order: ``x - s / n`` is a fused multiply-add with
    float32(1/N); each node adds its leaves' sums of squares, the nodes'
    totals are added in node order, and the total is multiplied by
    float32(1/N).  Within a leaf the elements are added in PyTorch's order.
    Over processes the nodes' totals are gathered to every rank; over a
    tensor-parallel grid each rank's total covers its shards, and the
    model indices' sums over the nodes are added in model-index order (the
    reference's ``psum`` over ``model``; a replicated leaf counts once per
    rank, as there).  ``ctx`` defaults to the stacked context."""
    ctx = local_context() if ctx is None else ctx
    leaves = T.tree_leaves(params)
    n = _ring_count(leaves[0], ctx)
    inv_n = float(recip(n))
    per_node = None
    # float32 one leaf at a time (stacked): a generator, as in
    # ``_allreduce_mean_delta``
    sums = ctx.node_group_sums((x.to(torch.float32) for x in leaves),
                               "consensus_err")
    for x, s in zip(leaves, sums):
        x = x.to(torch.float32)
        d = _fma(s, -inv_n, x)
        e = (d * d).reshape(x.shape[0], -1).sum(dim=1)
        per_node = e if per_node is None else per_node + e
    per_node = ctx.gather_nodes(per_node, over_tp=True)
    total = None
    for m in range(ctx.tp):
        part = per_node[m]
        for i in range(1, n):
            part = part + per_node[i * ctx.tp + m]
        total = part if total is None else total + part
    return total * inv_n
