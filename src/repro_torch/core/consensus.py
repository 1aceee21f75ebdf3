"""Consensus algorithms: ADC-DGD (the paper's contribution) and baselines,
over a static or time-varying mixing, directed ones included; the
single-level part of ``repro.core.consensus``.

Single-process reference implementations on stacked node states ``x`` of
shape ``(N, P)``, float32 on the problem's device.  One node's row is one
node's iterate; the mixing ``W @ x`` is one ``torch.matmul`` (float32:
``run`` keeps TF32 off on the card).

  * ``ADCDGD``          — Algorithm 2: amplified-differential compression.
  * ``DGD``             — Algorithm 1 (Nedic & Ozdaglar), no compression.
  * ``DGDt``            — DGD^t (Berahas et al. [21]): t consensus steps per
                          gradient step.
  * ``CompressedDGD``   — Eq. (5): DGD with *directly* compressed exchanges;
                          provably non-convergent (the paper's Fig. 1).
  * ``CHOCOGossip``     — CHOCO-SGD (Koloskova et al.): error-feedback
                          compressed gossip.
  * ``CEDAS``           — one-step-stale ADC gossip; ``staleness=0`` is
                          ``ADCDGD``.
  * ``CentralizedGD``   — gradient descent on the global f.

Every algorithm is a frozen dataclass with ``init(problem)`` and
``step(state, problem, u=None, w=None) -> (state, metrics)``, where ``u``
holds the step's uniforms for the compressor (``uniform_shape``; the
reference draws them from per-node keys ``jax.random.split(key, N)``) and
``w`` the step's mixing matrix ``W^(k)`` (default: the static ``W``, or a
schedule's first matrix).  The step
counter ``state["k"]`` is a Python int, and every scalar of a step (the
amplification ``k**gamma``, the step size) is the float32 value the
reference's compiled step computes (``core.f32``).  A division by such a
scalar divides by a 0-dim tensor on the device, never by a Python float,
which PyTorch's CUDA kernels would turn into a product with a reciprocal.

``run`` drives the steps in a Python loop and keeps the paper's metrics on
the device until the end.  With a :class:`~repro_torch.core.topology.
TopologySchedule` of period > 1 as ``mixing``, ``run`` and ``run_many``
copy its float32 ``(period, N, N)`` stack to the device once and hand
step ``i`` the matrix ``stack[indices_for(n_steps)[i]]``; each step's
bytes are billed for the messages of the matrix it used.
``on_wire_plan`` routes an algorithm's gossip through a wire plan
(``core.wireplan.WirePlanCompressor``).

Directed (column-stochastic) mixing: ``ADCDGD``, ``CEDAS`` and
``CHOCOGossip`` then carry the push-sum weight ``ps_w`` ``(N, 1)`` in
their state, mixed by the same matrix as ``x``, and take gradients at the
de-biased ratio ``z = x / ps_w``; ``run`` reports metrics of ``z`` (the
network mean ``sum(x) / sum(ps_w)``), the de-biased ``x_final`` and
``ps_w_final``.  ``DGD``, ``DGDt`` and ``CompressedDGD`` mix a directed
matrix as they mix any other.  Each directed edge carries one message.

``run_elastic`` runs ADC-DGD under a :class:`~repro_torch.core.topology.
MembershipSchedule` (inactive nodes frozen, the survivors mixed by each
epoch's matrix, with push-sum's mass handoff and rejoin warm-restart), and
``run_hierarchical`` the two-level rule: exact pod means
(``pod_problem``), then ADC-DGD over the ring of pods.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch

from .compression import Compressor, IdentityCompressor
from .f32 import f32, over_power, power, recip
from .problems import ConsensusProblem
from .telemetry import WireAccounting
from .hierarchy import HierarchySpec
from .topology import (MembershipSchedule, MixingMatrix, TopologySchedule,
                       fully_connected, ring)
from .wireplan import WirePlanCompressor

__all__ = [
    "StepSize",
    "ADCDGD",
    "DGD",
    "DGDt",
    "CompressedDGD",
    "CHOCOGossip",
    "CEDAS",
    "CentralizedGD",
    "run",
    "run_many",
    "run_elastic",
    "pod_problem",
    "run_hierarchical",
    "by_name",
    "on_wire_plan",
]


@dataclasses.dataclass(frozen=True)
class StepSize:
    """alpha_k = alpha0 / k^eta  (eta = 0 -> constant step-size)."""

    alpha0: float
    eta: float = 0.0

    def __call__(self, k) -> float:
        """The float32 step size at step ``k``: ``alpha0 / max(1, k)**eta``
        as compiled (``alpha0 * pow(k, -eta)``)."""
        return float(over_power(self.alpha0, max(f32(1.0), f32(k)),
                                self.eta))


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-dim tensor on ``like``'s device (a fill, no copy)."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


class _Algorithm:
    """Interface: see module docstring."""

    name: str = "algorithm"

    def __post_init__(self):
        mixing = getattr(self, "mixing", None)
        if mixing is None:
            return
        if not isinstance(mixing, (MixingMatrix, TopologySchedule)):
            raise TypeError(f"mixing must be a MixingMatrix or a "
                            f"TopologySchedule, got {type(mixing).__name__}")

    def init(self, problem: ConsensusProblem, x0=None) -> dict[str, Any]:
        raise NotImplementedError

    def step(self, state, problem: ConsensusProblem, u=None, w=None):
        raise NotImplementedError

    @property
    def push_sum(self) -> bool:
        """True when ``mixing`` is directed: the algorithm then threads the
        push-sum weight ``ps_w`` through its state and takes gradients at
        ``z = x / ps_w``."""
        return bool(getattr(getattr(self, "mixing", None), "is_directed",
                            False))

    def _debias(self, state) -> torch.Tensor:
        """The de-biased iterate ``x / ps_w`` (``x`` without push-sum)."""
        ps = state.get("ps_w")
        return state["x"] if ps is None else state["x"] / ps

    def _ps_init(self, st: dict, x0: torch.Tensor) -> dict:
        """Add the push-sum weight ``w_0 = 1`` to a fresh state."""
        if self.push_sum:
            st["ps_w"] = torch.ones((self.mixing.n, 1), dtype=torch.float32,
                                    device=x0.device)
        return st

    def uniform_shape(self, problem: ConsensusProblem):
        """Shape of one step's uniforms (None: the step draws none)."""
        comp = getattr(self, "compressor", None)
        if comp is None:
            return None
        return comp.uniform_shape((problem.n_nodes, problem.dim))

    def bytes_per_iteration(self, problem: ConsensusProblem) -> float:
        """Mean wire bytes per iteration over the whole network: each node
        broadcasts one message per iteration; every undirected edge carries
        it in both directions -> 2*E messages of P elements."""
        raise NotImplementedError

    def _w(self, device, w: torch.Tensor | None = None) -> torch.Tensor:
        """This step's mixing matrix: the step-indexed ``w`` of a schedule
        when given, else the static ``W`` (a schedule passed as ``mixing``
        defaults to its first matrix) as float32 on ``device``."""
        if w is not None:
            return w
        m = self.mixing
        return self._on_device(device, m.matrix_at(0).w
                               if isinstance(m, TopologySchedule) else m.w)

    def _on_device(self, device, matrix: np.ndarray) -> torch.Tensor:
        """A host matrix as float32 on ``device``, copied there once."""
        key = ("w", str(device), id(matrix))
        cache = self.__dict__.setdefault("_dev_cache", {})
        if key not in cache:
            cache[key] = torch.as_tensor(np.asarray(matrix, np.float64),
                                         dtype=torch.float32, device=device)
        return cache[key]

    def _compressed_broadcast_bytes(self, problem) -> float:
        """One compressed broadcast per node per iteration, over every
        message of the mixing graph (``WireAccounting.shipped_payload``)."""
        return WireAccounting(
            payload_bytes=self.compressor.wire_bytes(problem.dim),
            directions=self.mixing.n_messages).shipped_payload


def _start(problem, n, x0):
    """The shared start x0 (zeros by default) as float32 on the problem's
    device."""
    if x0 is None:
        return torch.zeros((n, problem.dim), device=problem.device)
    return torch.as_tensor(x0, dtype=torch.float32, device=problem.device)


def _max_abs(t: torch.Tensor) -> torch.Tensor:
    return t.abs().amax()


@dataclasses.dataclass(frozen=True)
class ADCDGD(_Algorithm):
    """Amplified-Differential Compression DGD (paper Algorithm 2).

    Per iteration k (k = 1, 2, ...):
        y_i,k   = x_i,k - xt_i,k-1                (local differential)
        d_i,k   = C(k^gamma * y_i,k)              (amplified, compressed, sent)
        xt_j,k  = xt_j,k-1 + d_j,k / k^gamma      (receiver-side integration)
        x_i,k+1 = sum_j W_ij xt_j,k - alpha_k grad f_i(x_i,k)

    The amplification turns the per-step compression noise into
    eps/k^gamma — zero mean, variance sigma^2/k^(2gamma) -> 0 for
    gamma > 1/2 (paper Eq. (8)).  With the identity compressor the wire
    carries y exactly, so xt_k = x_k: the step then takes x itself (the
    float round trip k^g y / k^g would only add rounding) and is DGD bit
    for bit.
    """

    mixing: MixingMatrix | TopologySchedule
    compressor: Compressor
    stepsize: StepSize
    gamma: float = 1.0
    name: str = "adc_dgd"

    def init(self, problem, x0=None):
        n = self.mixing.n
        assert n == problem.n_nodes, (n, problem.n_nodes)
        x0 = _start(problem, n, x0)
        # paper init, generalized: all nodes start at the shared x0, take
        # the first gradient step; xt stays at x0
        x1 = x0 - self.stepsize(1.0) * problem.grad_fn(x0)
        return self._ps_init({"x": x1, "x_tilde": x0, "k": 1}, x0)

    def step(self, state, problem, u=None, w=None):
        x = state["x"]
        w = self._w(x.device, w)
        k = f32(state["k"])
        kg = power(k, self.gamma)
        y = x - state["x_tilde"]                              # (N, P)
        if isinstance(self.compressor, IdentityCompressor):
            x_tilde = x
            max_tx = float(kg) * _max_abs(y)   # = max |k^g y|, rounded alike
        else:
            d = self.compressor.apply(float(kg) * y, u)       # transmitted
            x_tilde = state["x_tilde"] + d / _scalar(kg, d)
            max_tx = _max_abs(d)                              # paper Fig. 8
        alpha = self.stepsize(k)
        x_next = w @ x_tilde - alpha * problem.grad_fn(self._debias(state))
        new_state = {"x": x_next, "x_tilde": x_tilde, "k": state["k"] + 1}
        if "ps_w" in state:
            # subgradient-push: the weight follows the numerator's mixing
            new_state["ps_w"] = w @ state["ps_w"]
        return new_state, {"max_transmitted": max_tx, "alpha": alpha}

    def bytes_per_iteration(self, problem):
        return self._compressed_broadcast_bytes(problem)


@dataclasses.dataclass(frozen=True)
class CEDAS(_Algorithm):
    """One-step-stale compressed diffusion (after CEDAS — Huang & Pu): the
    compressed increment ``d_k`` transmitted at step k is integrated at
    step k+1, and the gossip term is the diffusion difference of shadows
    at a common lag:

        h_k     = h_{k-1} + d_{k-1} / (k-1)^gamma          (retire)
        x_{k+1} = x_k - alpha_k grad f_i
                  + mix_step * (sum_j W_ij h_j,k - h_i,k)  (diffusion)
        d_k     = C(k^gamma (x_{k+1} - h_k))               (launch)

    ``staleness=0`` removes the in-flight delay and is exactly ``ADCDGD``.
    """

    mixing: MixingMatrix | TopologySchedule
    compressor: Compressor
    stepsize: StepSize
    gamma: float = 1.0
    staleness: int = 1
    mix_step: float = 0.5
    name: str = "cedas"

    def __post_init__(self):
        super().__post_init__()
        if self.staleness not in (0, 1):
            raise ValueError(
                f"staleness must be 0 or 1, got {self.staleness}")
        if not 0.0 < self.mix_step <= 1.0:
            raise ValueError(
                f"mix_step must be in (0, 1], got {self.mix_step}")

    @functools.cached_property
    def _eager(self) -> ADCDGD:
        return ADCDGD(self.mixing, self.compressor, self.stepsize,
                      gamma=self.gamma)

    def init(self, problem, x0=None):
        st = self._eager.init(problem, x0=x0)
        if self.staleness:
            # the in-flight increment (amplified domain); zero decodes to
            # a no-op retire at k = 1
            st["d_fly"] = torch.zeros_like(st["x_tilde"])
        return st

    def step(self, state, problem, u=None, w=None):
        if self.staleness == 0:
            return self._eager.step(state, problem, u, w)
        x = state["x"]
        w = self._w(x.device, w)
        k = f32(state["k"])
        # RETIRE the increment sent at step k-1 (max() guards k = 1, where
        # d_fly is exactly zero)
        kg_prev = power(max(f32(1.0), f32(k - f32(1.0))), self.gamma)
        h = state["x_tilde"] + state["d_fly"] / _scalar(kg_prev, x)
        alpha = self.stepsize(k)
        x_next = (x - alpha * problem.grad_fn(self._debias(state))
                  + self.mix_step * (w @ h - h))
        # LAUNCH the post-update differential against the drained shadow
        kg = power(k, self.gamma)
        d = self.compressor.apply(float(kg) * (x_next - h), u)
        new_state = {"x": x_next, "x_tilde": h, "d_fly": d,
                     "k": state["k"] + 1}
        if "ps_w" in state:
            # mass-conserving damped diffusion of the push-sum weight
            ps = state["ps_w"]
            new_state["ps_w"] = ps + self.mix_step * (w @ ps - ps)
        return new_state, {"max_transmitted": _max_abs(d), "alpha": alpha}

    def bytes_per_iteration(self, problem):
        return self._compressed_broadcast_bytes(problem)


@dataclasses.dataclass(frozen=True)
class DGD(_Algorithm):
    """Original DGD (paper Algorithm 1): x <- W x - alpha_k grad f(x)."""

    mixing: MixingMatrix | TopologySchedule
    stepsize: StepSize
    name: str = "dgd"
    #: bytes per transmitted element (paper stores uncompressed as double)
    elem_bytes: float = 8.0

    def init(self, problem, x0=None):
        x0 = _start(problem, self.mixing.n, x0)
        return {"x": x0 - self.stepsize(1.0) * problem.grad_fn(x0), "k": 1}

    def step(self, state, problem, u=None, w=None):
        """``w``: the mixing matrix to apply (DGD^t passes W^t)."""
        del u
        x = state["x"]
        w = self._w(x.device, w)
        alpha = self.stepsize(f32(state["k"]))
        x_next = w @ x - alpha * problem.grad_fn(x)
        return {"x": x_next, "k": state["k"] + 1}, {
            "max_transmitted": _max_abs(x), "alpha": alpha}

    def bytes_per_iteration(self, problem):
        return WireAccounting(payload_bytes=self.elem_bytes * problem.dim,
                              directions=self.mixing.n_messages
                              ).shipped_payload


@dataclasses.dataclass(frozen=True)
class DGDt(_Algorithm):
    """DGD^t (Berahas et al. [21]): t consensus rounds per gradient step.

    Effective mixing matrix W^t (beta^t mixing) at t-fold communication
    cost.  For a static ``MixingMatrix``, W^t is formed once at
    construction, in float64, and copied to the device once; under a
    schedule every step forms W^(k)^t from its float32 W^(k) as the
    reference does, a product chain ``((W @ W) @ W) ...``.
    """

    mixing: MixingMatrix | TopologySchedule
    stepsize: StepSize
    t: int = 3
    name: str = "dgd_t"
    elem_bytes: float = 8.0

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(
            self, "_w_eff",
            np.linalg.matrix_power(np.asarray(self.mixing.w), self.t)
            if isinstance(self.mixing, MixingMatrix) else None)

    def _dgd(self) -> DGD:
        return DGD(self.mixing, self.stepsize, elem_bytes=self.elem_bytes)

    def init(self, problem, x0=None):
        return self._dgd().init(problem, x0)

    def step(self, state, problem, u=None, w=None):
        dev = state["x"].device
        if w is None and self._w_eff is not None:
            wt = self._on_device(dev, self._w_eff)
        else:
            w = self._w(dev, w)
            wt = w
            for _ in range(self.t - 1):
                wt = wt @ w
        return self._dgd().step(state, problem, u, w=wt)

    def bytes_per_iteration(self, problem):
        return self.t * self._dgd().bytes_per_iteration(problem)


@dataclasses.dataclass(frozen=True)
class CompressedDGD(_Algorithm):
    """DGD with *direct* compression (paper Eq. (5)) — does NOT converge.

    x_i <- W_ii x_i + sum_{j != i} W_ij C(x_j) - alpha grad f_i(x_i).
    The compression noise enters undamped each iteration (paper Fig. 1).
    """

    mixing: MixingMatrix | TopologySchedule
    compressor: Compressor
    stepsize: StepSize
    name: str = "compressed_dgd"

    def init(self, problem, x0=None):
        return DGD(self.mixing, self.stepsize).init(problem, x0)

    def step(self, state, problem, u=None, w=None):
        x = state["x"]
        w = self._w(x.device, w)
        alpha = self.stepsize(f32(state["k"]))
        cx = self.compressor.apply(x, u)                   # broadcast C(x_j)
        w_diag = torch.diag(torch.diag(w))
        x_next = w_diag @ x + (w - w_diag) @ cx - alpha * problem.grad_fn(x)
        return {"x": x_next, "k": state["k"] + 1}, {
            "max_transmitted": _max_abs(cx), "alpha": alpha}

    def bytes_per_iteration(self, problem):
        return self._compressed_broadcast_bytes(problem)


@dataclasses.dataclass(frozen=True)
class CHOCOGossip(_Algorithm):
    """CHOCO-SGD (Koloskova et al., arXiv:1902.00340): error-feedback
    compressed gossip.

        x_i^{t+1/2} = x_i^t - alpha_t grad f_i(x_i^t)       (local step)
        q_i^t       = C(x_i^{t+1/2} - xh_i^t)               (compressed, sent)
        xh_j^{t+1}  = xh_j^t + q_j^t                        (all replicas of j)
        x_i^{t+1}   = x_i^{t+1/2}
                      + lam * sum_j W_ij (xh_j^{t+1} - xh_i^{t+1})
    """

    mixing: MixingMatrix | TopologySchedule
    compressor: Compressor
    stepsize: StepSize
    consensus_lr: float = 0.5
    name: str = "choco_gossip"

    def init(self, problem, x0=None):
        n = self.mixing.n
        assert n == problem.n_nodes, (n, problem.n_nodes)
        x0 = _start(problem, n, x0)
        x1 = x0 - self.stepsize(1.0) * problem.grad_fn(x0)
        # xh_0 = 0; the first q transmits C(x_1)
        return self._ps_init({"x": x1, "x_hat": torch.zeros_like(x0),
                              "k": 1}, x0)

    def step(self, state, problem, u=None, w=None):
        x = state["x"]
        w = self._w(x.device, w)
        alpha = self.stepsize(f32(state["k"]))
        x_half = x - alpha * problem.grad_fn(self._debias(state))
        q = self.compressor.apply(x_half - state["x_hat"], u)
        x_hat = state["x_hat"] + q
        # sum_j W_ij (xh_j - xh_i) = (W - I) xh  since rows of W sum to 1;
        # on a directed W the same damped gossip of the numerator and the
        # push-sum weight preserves both sums (columns sum to 1)
        x_next = x_half + self.consensus_lr * (w @ x_hat - x_hat)
        new_state = {"x": x_next, "x_hat": x_hat, "k": state["k"] + 1}
        if "ps_w" in state:
            ps = state["ps_w"]
            new_state["ps_w"] = ps + self.consensus_lr * (w @ ps - ps)
        return new_state, {"max_transmitted": _max_abs(q), "alpha": alpha}

    def bytes_per_iteration(self, problem):
        return self._compressed_broadcast_bytes(problem)


@dataclasses.dataclass(frozen=True)
class CentralizedGD(_Algorithm):
    """Classical gradient descent on the global objective (no network)."""

    stepsize: StepSize
    n_nodes: int = 1
    name: str = "centralized_gd"

    def init(self, problem, x0=None):
        return {"x": _start(problem, problem.n_nodes, x0), "k": 1}

    def step(self, state, problem, u=None, w=None):
        del u, w
        x = state["x"]
        alpha = self.stepsize(f32(state["k"]))
        x_bar = x.mean(dim=0)
        g = problem.global_grad(x_bar) * float(recip(problem.n_nodes))
        x_next = (x_bar - alpha * g).expand(x.shape).contiguous()
        return {"x": x_next, "k": state["k"] + 1}, {
            "max_transmitted": torch.zeros((), device=x.device),
            "alpha": alpha}

    def bytes_per_iteration(self, problem):
        return 0.0


# ---------------------------------------------------------------------------
# Running the steps
# ---------------------------------------------------------------------------

def _metrics(state, problem) -> dict[str, torch.Tensor]:
    """The paper's per-step metrics, as 0-dim tensors on the device.  With
    push-sum they are taken at the de-biased ``z = x / ps_w``, whose
    network mean is the mass ratio ``sum(x) / sum(ps_w)``."""
    x = state["x"]
    ps = state.get("ps_w")
    if ps is None:
        z, x_bar = x, x.mean(dim=0)
    else:
        z, x_bar = x / ps, x.sum(dim=0) / ps.sum()
    return {"obj": problem.global_obj(x_bar),
            "grad_norm": torch.linalg.vector_norm(problem.global_grad(x_bar))
            * float(recip(problem.n_nodes)),
            "consensus": problem.consensus_error(z)}


def _generator(problem, seed: int) -> torch.Generator:
    g = torch.Generator(device=problem.device)
    g.manual_seed(seed)
    return g


def _active_schedule(algorithm) -> TopologySchedule | None:
    """The algorithm's time-varying schedule, or None for static mixing
    (a period-1 schedule counts as static: ``_w`` already resolves it)."""
    mixing = getattr(algorithm, "mixing", None)
    if isinstance(mixing, TopologySchedule) and mixing.period > 1:
        return mixing
    return None


def _cumulative_bytes(algorithm, problem, n_steps: int) -> np.ndarray:
    """Cumulative wire bytes after each iteration, schedule-aware: each step
    is billed for the messages of the matrix it used."""
    per_iter = algorithm.bytes_per_iteration(problem)
    sched = _active_schedule(algorithm)
    if sched is None or per_iter == 0.0 or sched.n_messages == 0.0:
        return per_iter * (np.arange(n_steps, dtype=np.float64) + 1)
    per_msg = per_iter / sched.n_messages
    return np.cumsum(sched.messages_per_step(n_steps) * per_msg)


def _mixing_for(algorithm, problem, n_steps: int):
    """Step i's ``w`` argument: None for static mixing, else a row of the
    schedule's float32 stack, copied to the problem's device once."""
    sched = _active_schedule(algorithm)
    if sched is None:
        return lambda i: None
    stack = torch.as_tensor(sched.stack, dtype=torch.float32,
                            device=problem.device)
    idx = sched.indices_for(n_steps)
    return lambda i: stack[int(idx[i])]


def _trajectory(algorithm, problem, n_steps: int, uniforms, x0,
                step_events=None):
    """The steps of one run: ``(final state, {metric: (n_steps,) tensor})``.
    ``uniforms(i)`` gives step i's uniforms (0-based); ``step_events``, a
    list, receives a CUDA event recorded before each step and one after
    the last."""
    state = algorithm.init(problem, x0=x0)
    mixing = _mixing_for(algorithm, problem, n_steps)
    cols = {"obj": [], "grad_norm": [], "consensus": [], "max_tx": [],
            "alpha": []}
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i in range(n_steps):
            if step_events is not None:
                step_events.append(_event())
            state, m = algorithm.step(state, problem, uniforms(i),
                                      w=mixing(i))
            for name, v in _metrics(state, problem).items():
                cols[name].append(v)
            cols["max_tx"].append(torch.as_tensor(
                m["max_transmitted"], dtype=torch.float32,
                device=problem.device))
            cols["alpha"].append(m["alpha"])
        if step_events is not None:
            step_events.append(_event())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    traj = {name: torch.stack(v) for name, v in cols.items()
            if name != "alpha"}
    traj["alpha"] = np.asarray(cols["alpha"], np.float32)
    return state, traj


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _drawer(algorithm, problem, seed: int, uniforms):
    """Step i's uniforms: ``uniforms(i)`` when given, else a draw from one
    ``torch.Generator`` on the problem's device seeded with ``seed``."""
    if uniforms is not None:
        return uniforms
    shape = algorithm.uniform_shape(problem)
    if shape is None:
        return lambda i: None
    gen = _generator(problem, seed)
    return lambda i: torch.rand(shape, generator=gen,
                                device=problem.device)


def run(
    algorithm: _Algorithm,
    problem: ConsensusProblem,
    n_steps: int,
    key: int = 0,
    x0=None,
    log_every: int = 1,
    uniforms: Callable[[int], torch.Tensor] | None = None,
    step_events: list | None = None,
) -> dict[str, np.ndarray]:
    """Run ``n_steps`` iterations; return the paper's metrics.

    The compressor's uniforms come from a ``torch.Generator`` on the
    problem's device seeded with ``key``, or from ``uniforms(i)`` for step
    ``i`` (0-based).  The metrics stay on the device until the run ends,
    then are copied to the host at once.  On a CUDA problem,
    ``step_events`` (a list) receives a timing event recorded before each
    step and one after the last.

    Returned dict (numpy arrays of length n_steps//log_every):
      obj        — global objective at the mean iterate f(x_bar)
      grad_norm  — ||(1/N) sum_i grad f_i(x_bar)||   (paper's y-axis)
      consensus  — ||x - 1 (x) x_bar||               (Theorem 1 metric)
      max_tx     — max transmitted magnitude          (paper Fig. 8)
      alpha      — the step size of each step
      bytes      — cumulative wire bytes              (paper Fig. 6), each
                   step billed for the messages of its W^(k)
      x_final    — final stacked iterate (N, P), de-biased under push-sum
      ps_w_final — the final push-sum weights (N, 1), under push-sum only
    """
    state, traj = _trajectory(algorithm, problem, n_steps,
                              _drawer(algorithm, problem, key, uniforms), x0,
                              step_events)
    sl = slice(log_every - 1, None, log_every)
    result = {name: (v.cpu().numpy() if torch.is_tensor(v) else v)[sl]
              for name, v in traj.items()}
    result["bytes"] = _cumulative_bytes(algorithm, problem, n_steps)[sl]
    ps = state.get("ps_w")
    result["x_final"] = (state["x"] if ps is None
                         else state["x"] / ps).cpu().numpy()
    if ps is not None:
        result["ps_w_final"] = ps.cpu().numpy()
    return result


def run_many(
    algorithm: _Algorithm,
    problem: ConsensusProblem,
    n_steps: int,
    n_trials: int,
    seed: int = 0,
    x0=None,
) -> dict[str, np.ndarray]:
    """Several independent trials of :func:`run` (trial ``i`` draws its
    uniforms from a generator seeded ``seed + i``): metric arrays of shape
    (n_trials, n_steps) — the Monte-Carlo means of the paper's Figs. 7/8/10.
    """
    trials = []
    for i in range(n_trials):
        _, traj = _trajectory(algorithm, problem, n_steps,
                              _drawer(algorithm, problem, seed + i, None),
                              x0)
        trials.append({name: v for name, v in traj.items()
                       if name != "alpha"})
    return {name: torch.stack([t[name] for t in trials]).cpu().numpy()
            for name in trials[0]}


def run_elastic(
    algorithm: _Algorithm,
    problem: ConsensusProblem,
    n_steps: int,
    membership,
    *,
    schedule_period: int = 1,
    self_weight: float = 0.5,
    rule: str = "metropolis",
    push_sum: bool = False,
    key: int = 0,
    x0=None,
    log_every: int = 1,
    uniforms: Callable[[int], torch.Tensor] | None = None,
    step_events: list | None = None,
) -> dict[str, np.ndarray]:
    """ADC-DGD under elastic membership: the single-process rule of the
    runtime's ``ConsensusConfig.membership``.

    ``membership`` is a :class:`~repro_torch.core.topology.
    MembershipSchedule` (or its masks); epoch ``e = k // schedule_period``
    (0-based step ``k``, clamped to the last epoch) picks the active mask
    and the Metropolis-Hastings (or ``"ring"``) mixing over the survivors.
    Per step an inactive node sends a zero differential, takes no gradient
    step and keeps ``x`` and ``x_tilde`` (``a * x_next + (1 - a) * x``);
    metrics cover the active nodes, and ``bytes`` bills the full ring's
    bytes per iteration scaled by the active share.

    ``push_sum=True`` keeps the mass across membership changes: at each
    epoch boundary a departing node's ``(x, ps_w)`` moves to its nearest
    survivor (``handoff_at``) and a rejoining node warm-restarts from its
    nearest continuously active neighbour's de-biased iterate (``x = xt =
    z_src``, ``ps_w = 1``).  The reference applies the handoff ``T`` on
    every step, the identity off a boundary; here it is applied at
    boundaries only: the values are equal, the sign of a zero may differ.

    ``uniforms(i)``, ``key`` and ``step_events`` are as in :func:`run`.
    Returns :func:`run`'s dict plus ``active_nodes`` per step.  A single
    all-active mask gives :func:`run`'s dynamics.
    """
    if not isinstance(algorithm, ADCDGD):
        raise ValueError(
            f"run_elastic supports adc_dgd only, got {algorithm.name!r}")
    if not isinstance(membership, MembershipSchedule):
        membership = MembershipSchedule(tuple(membership))
    n = membership.n_nodes
    if n != problem.n_nodes:
        raise ValueError(f"membership has {n} nodes, problem has "
                         f"{problem.n_nodes}")
    if schedule_period < 1:
        raise ValueError(f"schedule_period must be >= 1, got "
                         f"{schedule_period}")
    n_ep = max(1, min(membership.n_epochs,
                      (n_steps + schedule_period - 1) // schedule_period))
    w_stack = np.stack([
        np.asarray(membership.mixing_at(e, self_weight=self_weight,
                                        rule=rule).w, np.float32)
        for e in range(n_ep)])
    act_stack = np.stack([
        np.asarray(membership.mask_at(e), np.float32) for e in range(n_ep)])
    ep_idx = np.minimum(np.arange(n_steps) // schedule_period,
                        n_ep - 1).astype(np.int32)
    dev = problem.device
    w_dev = torch.as_tensor(w_stack, device=dev)
    act_dev = torch.as_tensor(act_stack, device=dev)[:, :, None]
    draw = _drawer(algorithm, problem, key, uniforms)
    comp, stepsize, gamma = (algorithm.compressor, algorithm.stepsize,
                             algorithm.gamma)

    def debias(x, ps):
        # a departed node handed its mass off, leaving ps_j = 0: its
        # frozen row must not turn into 0/0
        return x / torch.where(ps == 0.0, torch.ones_like(ps), ps)

    x0 = _start(problem, n, x0)
    x = x0 - stepsize(1.0) * problem.grad_fn(x0)
    xt = x0
    ps = (torch.ones((n, 1), dtype=torch.float32, device=dev)
          if push_sum else None)
    cols = {"obj": [], "grad_norm": [], "consensus": [], "max_tx": [],
            "alpha": [], "active_nodes": []}
    inv_n = float(recip(n))
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i in range(n_steps):
            if step_events is not None:
                step_events.append(_event())
            e = int(ep_idx[i])
            w, a = w_dev[e], act_dev[e]
            if push_sum and i > 0 and e != int(ep_idx[i - 1]):
                t = torch.as_tensor(membership.handoff_at(e),
                                    dtype=torch.float32, device=dev)
                x, ps = t @ x, t @ ps                  # mass handoff
                sources = membership.rejoin_sources_at(e)
                if sources:
                    x, xt, ps = x.clone(), xt.clone(), ps.clone()
                    for j, src in sources.items():      # warm restart
                        z = debias(x[src], ps[src])
                        x[j], xt[j] = z, z
                        ps[j] = 1.0
            k = f32(i + 1)
            kg = power(k, gamma)
            y = (x - xt) * a                           # inactive: zero
            d = comp.apply(float(kg) * y, draw(i)) * a
            xt_new = xt + d / _scalar(kg, d)
            grads = problem.grad_fn(debias(x, ps) if push_sum else x) * a
            alpha = stepsize(k)
            x_next = w @ xt_new - alpha * grads
            x_next = a * x_next + (1.0 - a) * x        # freeze inactive
            if push_sum:
                ps = a * (w @ ps) + (1.0 - a) * ps
            x, xt = x_next, xt_new
            m = float(act_stack[e].sum())
            if push_sum:
                zz = debias(x, ps)
                x_bar = (a * x).sum(dim=0) / (a * ps).sum()
            else:
                zz = x
                x_bar = (a * x).sum(dim=0) / _scalar(m, x)
            cols["obj"].append(problem.global_obj(x_bar))
            cols["grad_norm"].append(torch.linalg.vector_norm(
                problem.global_grad(x_bar)) * inv_n)
            cols["consensus"].append(torch.linalg.vector_norm(
                (zz - x_bar) * a))
            cols["max_tx"].append(_max_abs(d))
            cols["alpha"].append(alpha)
            cols["active_nodes"].append(m)
        if step_events is not None:
            step_events.append(_event())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    sl = slice(log_every - 1, None, log_every)
    result = {name: torch.stack(cols[name]).cpu().numpy()[sl]
              for name in ("obj", "grad_norm", "consensus", "max_tx")}
    result["alpha"] = np.asarray(cols["alpha"], np.float32)[sl]
    result["active_nodes"] = np.asarray(cols["active_nodes"],
                                        np.float32)[sl]
    # the full ring's bytes per iteration times the active share: a
    # compacted ring of m survivors carries 2m of the full ring's 2n
    # messages
    per_iter = algorithm.bytes_per_iteration(problem)
    frac = act_stack.sum(axis=1)[ep_idx] / float(n)
    result["bytes"] = np.cumsum(per_iter * frac)[sl]
    result["x_final"] = (x if ps is None else x / ps).cpu().numpy()
    if ps is not None:
        result["ps_w_final"] = ps.cpu().numpy()
    return result


def pod_problem(problem: ConsensusProblem, pods: int) -> ConsensusProblem:
    """An ``n``-node problem as its ``pods``-node outer problem under the
    two-level hierarchy: pod ``g`` is one node with objective ``f_g =
    (1/m) sum_{i in pod g} f_i``, its gradient rows the pod means of the
    members' gradients at the pod iterate; ``global_obj`` and
    ``global_grad`` scale by ``1/m`` (so ``grad_norm`` reads as the flat
    run's).  The minimizer is unchanged."""
    spec = HierarchySpec.from_spec(pods)
    m = spec.pod_size(problem.n_nodes)

    def grad_fn(x_pods, key=None):
        g = problem.grad_fn(x_pods.repeat_interleave(m, dim=0))
        return g.reshape(spec.pods, m, -1).mean(dim=1)

    return dataclasses.replace(
        problem, n_nodes=spec.pods, grad_fn=grad_fn,
        global_obj=lambda x: problem.global_obj(x) / m,
        global_grad=lambda x: problem.global_grad(x) / m,
        name=f"{problem.name}/pods={spec.pods}")


def run_hierarchical(
    problem: ConsensusProblem,
    pods: int,
    n_steps: int,
    *,
    compressor: Compressor | None = None,
    stepsize: StepSize,
    gamma: float = 1.0,
    self_weight: float = 0.5,
    key: int = 0,
    x0=None,
    log_every: int = 1,
    uniforms: Callable[[int], torch.Tensor] | None = None,
    step_events: list | None = None,
) -> dict[str, np.ndarray]:
    """Two-level hierarchical ADC-DGD: each pod of ``m = n // pods``
    members averages exactly (:func:`pod_problem`), the pods run
    compressed ADC-DGD on the ``pods``-node ring; the effective mixing is
    ``W_outer (x) (1/m) 11^T`` (``topology.hierarchical_mixing``).

    ``pods == n`` is :func:`run` of ``ADCDGD(ring(n, self_weight), ...)``
    on the problem itself; ``pods == 1`` runs ADC-DGD on
    ``fully_connected(1)`` with the identity compressor (gradient descent
    on the mean objective; nothing on the wire).  ``x0`` may be ``(pods,
    P)``, ``(P,)`` or ``(n, P)`` with pod-identical rows (the
    representatives ``x0[::m]`` are taken).

    Returns :func:`run`'s dict over the outer problem with ``x_final``
    expanded to ``(n, P)``, plus ``bytes_outer`` (:func:`run`'s bytes),
    ``bytes_inner`` (the fp32 ring all-reduce model, 0 for singleton pods),
    ``bytes`` = inner + outer, ``pods`` and ``pod_size``."""
    spec = HierarchySpec.from_spec(pods)
    n = problem.n_nodes
    m = spec.pod_size(n)
    if compressor is None:
        compressor = IdentityCompressor()
    pp = problem if m == 1 else pod_problem(problem, spec.pods)
    if x0 is not None:
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=problem.device)
        if x0.ndim == 1:
            x0 = x0[None].expand(spec.pods, x0.shape[0])
        elif x0.shape[0] == n and m > 1:
            x0 = x0[::m]
    if spec.pods == 1:
        outer = ADCDGD(mixing=fully_connected(1),
                       compressor=IdentityCompressor(), stepsize=stepsize,
                       gamma=gamma)
    else:
        outer = ADCDGD(mixing=ring(spec.pods, self_weight),
                       compressor=compressor, stepsize=stepsize, gamma=gamma)
    out = run(outer, pp, n_steps, key=key, x0=x0, log_every=log_every,
              uniforms=uniforms, step_events=step_events)
    out["x_final"] = np.repeat(out["x_final"], m, axis=0)
    sl = slice(log_every - 1, None, log_every)
    inner_per_step = spec.inner_bytes_per_step(problem.dim, n) * n
    out["bytes_outer"] = out["bytes"]
    out["bytes_inner"] = (inner_per_step
                          * (np.arange(n_steps, dtype=np.float64) + 1))[sl]
    out["bytes"] = out["bytes_outer"] + out["bytes_inner"]
    out["pods"] = spec.pods
    out["pod_size"] = m
    return out


def on_wire_plan(name: str, mixing: MixingMatrix | TopologySchedule, plan,
                 stepsize: StepSize, **kw) -> _Algorithm:
    """An algorithm whose gossip wire goes through a
    :class:`~repro_torch.core.wireplan.WirePlan`: ADC-DGD's differential
    and CHOCO's error-feedback correction are encoded and decoded with the
    same plan, so the two ship equal bytes per step by construction.
    ``plan`` must cover the problem (``plan.layout.n_elements ==
    problem.dim``)."""
    return by_name(name, mixing, stepsize,
                   compressor=WirePlanCompressor(plan), **kw)


def by_name(name: str, mixing: MixingMatrix | TopologySchedule,
            stepsize: StepSize, compressor: Compressor | None = None,
            **kw) -> _Algorithm:
    if name == "adc_dgd":
        return ADCDGD(mixing, compressor or IdentityCompressor(), stepsize,
                      **kw)
    if name == "dgd":
        return DGD(mixing, stepsize)
    if name == "dgd_t":
        return DGDt(mixing, stepsize, **kw)
    if name == "compressed_dgd":
        return CompressedDGD(mixing, compressor or IdentityCompressor(),
                             stepsize)
    if name in ("choco_gossip", "choco"):
        return CHOCOGossip(mixing, compressor or IdentityCompressor(),
                           stepsize, **kw)
    if name == "cedas":
        return CEDAS(mixing, compressor or IdentityCompressor(), stepsize,
                     **kw)
    if name == "centralized_gd":
        return CentralizedGD(stepsize)
    raise KeyError(f"unknown algorithm {name!r}")
