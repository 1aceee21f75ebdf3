"""Deterministic fault injection for the consensus exchange: port of
``repro.core.faults``.

A dropped packet is zeroed at the receiver: every wire codec decodes the
all-zero payload to an exact zero differential, so the receiver keeps its
last estimate of the sender's ``x_tilde`` (stale reuse).  Every decision
is a pure function of integers through the reference's counter-based
PRNG (``core.prng``), so the masks here are the reference's bit for bit:

* :class:`LossModel` — per-directed-edge Bernoulli loss: the payload of
  ``step`` travelling in ring ``direction`` toward receiving ``node``
  arrives iff ``uniform(fold(seed, step, direction, node)) >= rate``.  One
  decision covers the whole flat payload of a step (every pipeline unit
  drops together, so packed and pipelined stay bit-identical under loss).
  ``rate=0.0`` runs the machinery and never drops.
* :class:`StragglerModel` — the same draw in its own PRNG domain: an async
  payload that misses its one-step deadline is treated as dropped.
* :class:`GilbertElliottLoss` — two-state Markov burst loss per directed
  edge, realized once on the host into a ``(horizon, 2, n_nodes)`` keep
  table; step ``k`` reads row ``(k - 1) % horizon``.
* ``resync_keep`` (all loss models) — the epoch resync's bounded-retry
  handshake: each direction succeeds if any of ``retries`` retransmits
  survives, drawn on channels ``RESYNC_CHANNEL_BASE + 2 a + d``.
* :class:`NodeFailureModel` — seeded per-epoch fail/recover masks (the
  membership schedule's source).

The port runs every node of the ring on one device, so steps and nodes
are host integers and a decision is a host boolean: ``keep`` and
``resync_keep`` answer for one node, ``keep_flags`` and
``resync_keep_flags`` for every node of a step at once (a ``(2, N)``
mask, row 0 the payload from upstream, row 1 from downstream).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core import prng

__all__ = [
    "LossModel",
    "GilbertElliottLoss",
    "StragglerModel",
    "NodeFailureModel",
    "parse_loss_spec",
    "FROM_UPSTREAM",
    "FROM_DOWNSTREAM",
    "RESYNC_CHANNEL_BASE",
]

#: direction ids folded into the drop key: 0 = payload arriving from the
#: upstream (+stride) neighbour, 1 = from the downstream one
FROM_UPSTREAM = 0
FROM_DOWNSTREAM = 1

#: channel ids >= 2 address resync retransmits: attempt ``a`` in direction
#: ``d`` uses channel ``2 + 2*a + d`` (never a payload channel)
RESYNC_CHANNEL_BASE = 2

#: PRNG domain folded first by :class:`StragglerModel`, so its deadline
#: draws are independent of link-loss draws at equal seeds
_STRAGGLER_DOMAIN = 0x5D1E


class _ResyncRetries:
    """Bounded-retry resync handshake draws, shared by all loss models.
    Burst models draw the retransmits independently at the channel's
    stationary loss rate."""

    _domain: tuple = ()

    def _resync_rate(self) -> float:
        raise NotImplementedError

    def _key(self, step, channel, node):
        """The key of (step, channel, node); array arguments broadcast to
        a batch of keys."""
        key = prng.fold_chain(self.seed, *self._domain, step)
        return prng.fold_in(prng.fold_in(key, channel), node)

    def _uniform(self, step, channel, node) -> np.ndarray:
        return prng.uniform(self._key(step, channel, node))

    def _resync_flags(self, step: int, nodes: np.ndarray,
                      retries: int) -> np.ndarray:
        """``(2, len(nodes))`` resync success flags: per direction and
        receiving node, the OR over ``retries`` retransmit draws."""
        if retries < 1:
            raise ValueError(f"resync retries must be >= 1, got {retries}")
        rate = np.float32(self._resync_rate())
        d = np.array([FROM_UPSTREAM, FROM_DOWNSTREAM])[:, None]
        ok = np.zeros((2, len(nodes)), dtype=bool)
        for a in range(retries):
            ok |= self._uniform(step, RESYNC_CHANNEL_BASE + 2 * a + d,
                                nodes[None, :]) >= rate
        return ok

    def resync_keep_flags(self, step: int, n_nodes: int,
                          retries: int) -> np.ndarray:
        """``(2, n_nodes)`` resync success flags of ``step``'s boundary
        exchange."""
        return self._resync_flags(step, np.arange(n_nodes), retries)

    def resync_keep(self, step: int, node: int,
                    retries: int) -> tuple[bool, bool]:
        """``(ok_up, ok_dn)`` of ``step``'s resync at receiving ``node``."""
        ok = self._resync_flags(step, np.array([node]), retries)[:, 0]
        return bool(ok[0]), bool(ok[1])

    def resync_keep_host(self, n_nodes: int, steps,
                         retries: int) -> np.ndarray:
        """``(len(steps), 2, n_nodes)`` bool resync flags."""
        steps = np.atleast_1d(np.asarray(steps, np.int32))
        return np.stack([self.resync_keep_flags(int(s), n_nodes, retries)
                         for s in steps])


@dataclasses.dataclass(frozen=True)
class LossModel(_ResyncRetries):
    """Per-directed-edge Bernoulli packet loss, rate in [0, 1)."""

    rate: float
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.rate < 1.0:
            raise ValueError(f"loss rate must be in [0, 1), got {self.rate}")

    def _resync_rate(self) -> float:
        return self.rate

    def keep(self, step: int, direction: int, node: int) -> bool:
        """Does the payload of ``step`` in ring ``direction`` reach
        ``node``?"""
        return bool(self._uniform(step, direction, node)
                    >= np.float32(self.rate))

    def keep_flags(self, step: int, n_nodes: int,
                   directions: int = 2) -> np.ndarray:
        """``(directions, n_nodes)`` keep mask of ``step``."""
        d = np.arange(directions)[:, None]
        return (self._uniform(step, d, np.arange(n_nodes)[None, :])
                >= np.float32(self.rate))

    def keep_mask_host(self, n_nodes: int, steps,
                       directions: int = 2) -> np.ndarray:
        """``(len(steps), directions, n_nodes)`` bool keep mask."""
        steps = np.atleast_1d(np.asarray(steps, np.int32))
        return np.stack([self.keep_flags(int(s), n_nodes, directions)
                         for s in steps])

    def expected_delivered_frac(self) -> float:
        return 1.0 - self.rate

    def describe(self) -> dict:
        return {"model": type(self).__name__, "rate": self.rate,
                "seed": self.seed,
                "expected_delivered_frac": self.expected_delivered_frac()}


@dataclasses.dataclass(frozen=True)
class StragglerModel(LossModel):
    """Straggler deadlines on the async transport as Bernoulli misses, in
    their own PRNG domain."""

    _domain = (_STRAGGLER_DOMAIN,)


@dataclasses.dataclass(frozen=True)
class GilbertElliottLoss(_ResyncRetries):
    """Two-state Markov (Gilbert-Elliott) burst loss per directed edge:
    state Good drops with probability ``g``, Bad with ``h``; transitions
    G->B with ``p``, B->G with ``r``.  Stationary loss ``pi_B h + pi_G g``
    with ``pi_B = p / (p + r)``."""

    p: float
    r: float
    h: float = 1.0
    g: float = 0.0
    seed: int = 0
    n_nodes: int = 0
    horizon: int = 4096

    def __post_init__(self):
        if not 0.0 < self.p <= 1.0:
            raise ValueError(f"gilbert p must be in (0, 1], got {self.p}")
        if not 0.0 < self.r <= 1.0:
            raise ValueError(f"gilbert r must be in (0, 1], got {self.r}")
        if not 0.0 <= self.g <= 1.0 or not 0.0 <= self.h <= 1.0:
            raise ValueError(
                f"gilbert state loss probs must be in [0, 1], "
                f"got h={self.h} g={self.g}")
        if self.n_nodes < 1:
            raise ValueError(
                f"GilbertElliottLoss needs n_nodes >= 1, got {self.n_nodes}")
        if self.horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {self.horizon}")

    def _resync_rate(self) -> float:
        return 1.0 - self.expected_delivered_frac()

    @functools.cached_property
    def _keep_table(self) -> np.ndarray:
        """``(horizon, 2, n_nodes)`` keep table: per channel one stream of
        ``(horizon, 2)`` uniforms keyed ``fold(seed, direction, node)``;
        column 0 decides the drop in the current state, column 1 the
        transition."""
        table = np.empty((self.horizon, 2, self.n_nodes), dtype=bool)
        base = prng.prng_key(self.seed)
        for d in range(2):
            for v in range(self.n_nodes):
                us = prng.uniform(prng.fold_in(prng.fold_in(base, d), v),
                                  (self.horizon, 2))
                bad = False
                for t in range(self.horizon):
                    loss_p = self.h if bad else self.g
                    table[t, d, v] = us[t, 0] >= loss_p
                    if bad:
                        bad = not us[t, 1] < self.r
                    else:
                        bad = us[t, 1] < self.p
        return table

    def keep(self, step: int, direction: int, node: int) -> bool:
        return bool(self._keep_table[(step - 1) % self.horizon, direction,
                                     node])

    def keep_flags(self, step: int, n_nodes: int,
                   directions: int = 2) -> np.ndarray:
        return self.keep_mask_host(n_nodes, [step], directions)[0]

    def keep_mask_host(self, n_nodes: int, steps,
                       directions: int = 2) -> np.ndarray:
        if n_nodes != self.n_nodes:
            raise ValueError(
                f"keep_mask_host n_nodes={n_nodes} does not match the "
                f"model's n_nodes={self.n_nodes}")
        steps = np.atleast_1d(np.asarray(steps, np.int64))
        idx = np.mod(steps - 1, self.horizon)
        return self._keep_table[idx][:, :directions, :]

    def expected_delivered_frac(self) -> float:
        pi_bad = self.p / (self.p + self.r)
        return 1.0 - (pi_bad * self.h + (1.0 - pi_bad) * self.g)

    def describe(self) -> dict:
        return {"model": type(self).__name__, "p": self.p, "r": self.r,
                "h": self.h, "g": self.g, "seed": self.seed,
                "mean_burst_steps": 1.0 / self.r,
                "expected_delivered_frac": self.expected_delivered_frac()}


@dataclasses.dataclass(frozen=True)
class NodeFailureModel:
    """Seeded per-epoch node fail/recover process.  Epoch 0 is all
    active; at each later epoch node ``v`` draws ``uniform(fold(seed,
    epoch, v))``: an active node fails if ``u < fail_rate`` (refused, in
    node order, below ``min_active``), an inactive one recovers if
    ``u < recover_rate``."""

    fail_rate: float
    recover_rate: float = 0.5
    seed: int = 0
    min_active: int = 2

    def __post_init__(self):
        if not 0.0 <= self.fail_rate < 1.0:
            raise ValueError(
                f"fail rate must be in [0, 1), got {self.fail_rate}")
        if not 0.0 <= self.recover_rate <= 1.0:
            raise ValueError(
                f"recover rate must be in [0, 1], got {self.recover_rate}")
        if self.min_active < 2:
            raise ValueError(
                f"min_active must be >= 2, got {self.min_active}")

    def active_mask_host(self, n_nodes: int, n_epochs: int) -> np.ndarray:
        """``(n_epochs, n_nodes)`` bool activity mask."""
        if n_nodes < self.min_active:
            raise ValueError(
                f"n_nodes={n_nodes} below min_active={self.min_active}")
        masks = np.empty((n_epochs, n_nodes), dtype=bool)
        masks[0] = True
        for e in range(1, n_epochs):
            prev = masks[e - 1]
            cur = prev.copy()
            n_active = int(prev.sum())
            us = prng.uniform(prng.fold_in(prng.fold_chain(self.seed, e),
                                           np.arange(n_nodes)))
            for v in range(n_nodes):
                u = float(us[v])
                if prev[v]:
                    if u < self.fail_rate and n_active - 1 >= self.min_active:
                        cur[v] = False
                        n_active -= 1
                elif u < self.recover_rate:
                    cur[v] = True
                    n_active += 1
            masks[e] = cur
        return masks


def parse_loss_spec(spec: str) -> dict:
    """Parse a ``--link-loss-model`` spec: ``"bernoulli"`` (the i.i.d.
    model, rate from ``--link-loss``) or
    ``"gilbert:p=0.1,r=0.5[,h=1.0][,g=0.0]"`` (burst loss).  Returns a dict
    with a ``kind`` key and the parameters; raises ``ValueError`` on a
    malformed spec."""
    spec = spec.strip()
    if spec == "bernoulli":
        return {"kind": "bernoulli"}
    head, sep, tail = spec.partition(":")
    if head != "gilbert":
        raise ValueError(
            f"unknown loss model {spec!r} (expected 'bernoulli' or "
            f"'gilbert:p=..,r=..[,h=..][,g=..]')")
    params = {"h": 1.0, "g": 0.0}
    if not sep or not tail:
        raise ValueError("gilbert spec needs at least p=..,r=..")
    for item in tail.split(","):
        k, eq, val = item.partition("=")
        k = k.strip()
        if not eq or k not in ("p", "r", "h", "g"):
            raise ValueError(f"bad gilbert parameter {item!r}")
        try:
            params[k] = float(val)
        except ValueError as exc:
            raise ValueError(f"bad gilbert parameter {item!r}") from exc
    if "p" not in params or "r" not in params:
        raise ValueError("gilbert spec needs both p=.. and r=..")
    params["kind"] = "gilbert"
    return params
