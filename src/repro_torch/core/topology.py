"""Network topologies, consensus (mixing) matrices and time-varying
schedules of them: the undirected part of ``repro.core.topology``.

The consensus matrix ``W`` must satisfy the paper's three properties
(Section III-A):

  1. doubly stochastic:  rows and columns sum to 1,
  2. sparsity pattern follows the network graph (W_ij > 0 iff edge or i==j),
  3. symmetric (real eigenvalues, 1 = lam_1 >= ... >= lam_N > -1).

``beta = max(|lam_2|, |lam_N|) < 1`` is the mixing rate that appears in every
convergence bound of the paper (error ball ``alpha*D/(1-beta)`` etc.).

A :class:`TopologySchedule` is a step-indexed stack of such matrices
``W^(k)``: periodic (``PeriodicSchedule``) or pre-sampled i.i.d. random
graphs (``ErdosRenyiSchedule``, ``RandomGeometricSchedule``) drawn with
numpy from a seed, so the stacks equal the reference's.

Matrices are float64 numpy arrays, built on the host exactly as the
reference builds them; the algorithms copy ``W`` to their device as
float32.  Directed (column-stochastic) matrices and schedules, and
membership schedules, are not ported yet: their ``by_name`` and
``schedule_by_name`` rows raise.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "MixingMatrix",
    "ring",
    "fully_connected",
    "star",
    "torus",
    "chain",
    "expander",
    "paper_fig3",
    "paper_circle",
    "metropolis_weights",
    "lazy_metropolis_weights",
    "spectral_beta",
    "validate_mixing_matrix",
    "by_name",
    "is_connected",
    "erdos_renyi_graph",
    "random_geometric_graph",
    "TopologySchedule",
    "StaticSchedule",
    "PeriodicSchedule",
    "ErdosRenyiSchedule",
    "RandomGeometricSchedule",
    "as_schedule",
    "schedule_by_name",
]

#: ``by_name`` rows of the reference that belong to later slices
NOT_PORTED = ("directed-ring", "directed_ring", "directed-cycle",
              "directed_cycle", "directed_er")


@dataclasses.dataclass(frozen=True)
class MixingMatrix:
    """A consensus matrix together with its derived spectral quantities."""

    w: np.ndarray                 # (N, N) doubly stochastic symmetric
    name: str

    @property
    def n(self) -> int:
        return self.w.shape[0]

    @property
    def beta(self) -> float:
        return spectral_beta(self.w)

    @property
    def n_edges(self) -> int:
        """Number of undirected communication edges (excluding self loops)."""
        off = self.w.copy()
        np.fill_diagonal(off, 0.0)
        return int((np.abs(off) > 1e-12).sum() // 2)

    @property
    def is_directed(self) -> bool:
        return False

    @property
    def n_messages(self) -> int:
        """Point-to-point messages one gossip round puts on the wire: every
        undirected edge carries the broadcast in both directions."""
        return 2 * self.n_edges

    def neighbors(self, i: int) -> list[int]:
        return [j for j in range(self.n)
                if j != i and abs(self.w[i, j]) > 1e-12]

    def validate(self) -> None:
        validate_mixing_matrix(self.w)


def validate_mixing_matrix(w: np.ndarray, atol: float = 1e-8) -> None:
    if w.ndim != 2 or w.shape[0] != w.shape[1]:
        raise ValueError(f"W must be square, got {w.shape}")
    if not np.allclose(w, w.T, atol=atol):
        raise ValueError("W must be symmetric")
    if not np.allclose(w.sum(axis=0), 1.0, atol=atol):
        raise ValueError("W must be doubly stochastic (column sums)")
    if not np.allclose(w.sum(axis=1), 1.0, atol=atol):
        raise ValueError("W must be doubly stochastic (row sums)")
    lam = np.sort(np.linalg.eigvalsh(w))
    if lam[0] <= -1.0 + 1e-12:
        raise ValueError(f"lambda_N(W) = {lam[0]} must be > -1")
    if abs(lam[-1] - 1.0) > 1e-8:
        raise ValueError(f"lambda_1(W) = {lam[-1]} must equal 1")


def spectral_beta(w: np.ndarray) -> float:
    """beta = max(|lambda_2|, |lambda_N|) — the mixing rate of W.

    Symmetric matrices use the (exact, ordered) Hermitian eigensolver; an
    asymmetric W has a complex spectrum, so beta is the second-largest
    eigenvalue *modulus*.
    """
    w = np.asarray(w, dtype=np.float64)
    if np.allclose(w, w.T, atol=1e-12):
        lam = np.sort(np.linalg.eigvalsh(w))
        return float(max(abs(lam[0]), abs(lam[-2]))) if len(lam) > 1 else 0.0
    mods = np.sort(np.abs(np.linalg.eigvals(w)))
    return float(mods[-2]) if len(mods) > 1 else 0.0


# ---------------------------------------------------------------------------
# Weight rules for an adjacency structure
# ---------------------------------------------------------------------------

def metropolis_weights(adj: np.ndarray) -> np.ndarray:
    """Metropolis-Hastings weights: W_ij = 1/(1+max(d_i,d_j)) on edges.

    Always yields a symmetric doubly-stochastic matrix for any undirected
    connected graph.
    """
    adj = np.asarray(adj, dtype=bool)
    n = adj.shape[0]
    deg = adj.sum(axis=1)
    w = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for j in range(n):
            if i != j and adj[i, j]:
                w[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w


def lazy_metropolis_weights(adj: np.ndarray,
                            laziness: float = 0.5) -> np.ndarray:
    """(1-laziness)*I + laziness*Metropolis — guarantees lam_N > 0."""
    w = metropolis_weights(adj)
    n = w.shape[0]
    return (1.0 - laziness) * np.eye(n) + laziness * w


# ---------------------------------------------------------------------------
# Concrete topologies
# ---------------------------------------------------------------------------

def _mm(w: np.ndarray, name: str) -> MixingMatrix:
    m = MixingMatrix(w=np.asarray(w, dtype=np.float64), name=name)
    m.validate()
    return m


def ring(n: int, self_weight: float = 0.5) -> MixingMatrix:
    """Circle topology (paper Fig. 9): node i <-> i±1 (mod n).

    ``self_weight`` in (0, 1); the two neighbors split the rest equally.
    """
    if n < 2:
        return _mm(np.ones((1, 1)), f"ring{n}")
    if n == 2:
        # degenerate: the two "neighbors" are the same node
        w = np.array([[self_weight, 1 - self_weight],
                      [1 - self_weight, self_weight]])
        return _mm(w, "ring2")
    w = np.zeros((n, n))
    side = (1.0 - self_weight) / 2.0
    for i in range(n):
        w[i, i] = self_weight
        w[i, (i - 1) % n] += side
        w[i, (i + 1) % n] += side
    return _mm(w, f"ring{n}")


def chain(n: int) -> MixingMatrix:
    """Path graph with Metropolis weights."""
    adj = np.zeros((n, n), dtype=bool)
    for i in range(n - 1):
        adj[i, i + 1] = adj[i + 1, i] = True
    return _mm(lazy_metropolis_weights(adj), f"chain{n}")


def fully_connected(n: int) -> MixingMatrix:
    """Complete graph with uniform averaging; beta = 0 (one-shot consensus).

    With W = (1/n) 11^T, DGD reduces to synchronous data-parallel SGD.
    """
    return _mm(np.full((n, n), 1.0 / n), f"full{n}")


def star(n: int) -> MixingMatrix:
    """Hub-and-spoke (parameter-server-like) with Metropolis weights."""
    adj = np.zeros((n, n), dtype=bool)
    adj[0, 1:] = True
    adj[1:, 0] = True
    return _mm(lazy_metropolis_weights(adj), f"star{n}")


def torus(rows: int, cols: int) -> MixingMatrix:
    """2-D torus with lazy Metropolis weights."""
    n = rows * cols
    adj = np.zeros((n, n), dtype=bool)

    def idx(r: int, c: int) -> int:
        return (r % rows) * cols + (c % cols)

    for r in range(rows):
        for c in range(cols):
            i = idx(r, c)
            for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                adj[i, idx(r + dr, c + dc)] = True
    np.fill_diagonal(adj, False)
    return _mm(lazy_metropolis_weights(adj), f"torus{rows}x{cols}")


def expander(n: int, degree: int = 4, seed: int = 0) -> MixingMatrix:
    """Random (near-)regular expander via unions of random perfect matchings.

    Expanders give beta bounded away from 1 independent of n — the
    communication-efficient topology of Chow et al. [20] in the paper's
    related work.
    """
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n), dtype=bool)
    attempts = 0
    while adj.sum(axis=1).min() < degree and attempts < 100 * degree:
        perm = rng.permutation(n)
        # pair up (perm[0], perm[1]), (perm[2], perm[3]), ...
        for a, b in zip(perm[0::2], perm[1::2]):
            if a != b:
                adj[a, b] = adj[b, a] = True
        attempts += 1
    # ensure connectivity with a ring backbone
    for i in range(n):
        adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = True
    np.fill_diagonal(adj, False)
    return _mm(lazy_metropolis_weights(adj), f"expander{n}d{degree}")


def paper_fig3() -> MixingMatrix:
    """The exact 4-node consensus matrix of the paper's Fig. 3/4."""
    w = np.array(
        [
            [1 / 4, 1 / 4, 1 / 4, 1 / 4],
            [1 / 4, 3 / 4, 0, 0],
            [1 / 4, 0, 3 / 4, 0],
            [1 / 4, 0, 0, 3 / 4],
        ]
    )
    return _mm(w, "paper_fig3")


def paper_circle(n: int) -> MixingMatrix:
    """The 'circle' system of the paper's Section V-3 (Fig. 9)."""
    return ring(n, self_weight=0.5)


def by_name(name: str, n: int | None = None, **kw) -> MixingMatrix:
    """Topology registry (``--topology ring --nodes 8``)."""
    builders = {
        "ring": lambda: ring(n, **kw),
        "full": lambda: fully_connected(n),
        "star": lambda: star(n),
        "chain": lambda: chain(n),
        "expander": lambda: expander(n, **kw),
        "paper_fig3": paper_fig3,
        "paper_circle": lambda: paper_circle(n),
    }
    if name.startswith("torus"):
        r, c = name[5:].split("x")
        return torus(int(r), int(c))
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"topology {name!r} (a directed, column-stochastic matrix) is "
            "not yet ported")
    if name not in builders:
        raise KeyError(f"unknown topology {name!r}; have "
                       f"{sorted(builders) + list(NOT_PORTED)}")
    return builders[name]()


# ---------------------------------------------------------------------------
# Random-graph samplers (building blocks for time-varying schedules)
# ---------------------------------------------------------------------------

def is_connected(adj: np.ndarray) -> bool:
    """BFS connectivity check on a boolean adjacency matrix."""
    adj = np.asarray(adj, dtype=bool)
    n = adj.shape[0]
    if n == 0:
        return True
    seen = np.zeros(n, dtype=bool)
    frontier = np.zeros(n, dtype=bool)
    seen[0] = frontier[0] = True
    while frontier.any():
        nxt = adj[frontier].any(axis=0) & ~seen
        seen |= nxt
        frontier = nxt
    return bool(seen.all())


def erdos_renyi_graph(n: int, p: float,
                      rng: np.random.Generator) -> np.ndarray:
    """One G(n, p) sample: each undirected edge present i.i.d. w.p. ``p``."""
    upper = rng.random((n, n)) < p
    adj = np.triu(upper, k=1)
    return adj | adj.T


def random_geometric_graph(n: int, radius: float,
                           rng: np.random.Generator) -> np.ndarray:
    """RGG sample: nodes uniform in the unit square, edge iff dist <= radius."""
    pts = rng.random((n, 2))
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    adj = d2 <= radius**2
    np.fill_diagonal(adj, False)
    return adj


# ---------------------------------------------------------------------------
# Time-varying topology schedules
# ---------------------------------------------------------------------------

class TopologySchedule:
    """A step-indexed sequence of mixing matrices ``W^(k)``: iteration ``i``
    (0-based) uses ``stack[i % period]``.  For i.i.d. random schedules the
    period is a long pre-sampled horizon.  Every matrix of the stack
    satisfies the paper's Section III-A requirements; connected samples
    also have beta < 1."""

    name: str = "schedule"

    def __init__(self, matrices: Sequence[MixingMatrix], name: str):
        if not matrices:
            raise ValueError("schedule needs at least one mixing matrix")
        n = matrices[0].n
        if any(m.n != n for m in matrices):
            raise ValueError("all matrices in a schedule must share N")
        self.matrices: tuple[MixingMatrix, ...] = tuple(matrices)
        self.name = name

    @property
    def n(self) -> int:
        return self.matrices[0].n

    @property
    def period(self) -> int:
        return len(self.matrices)

    @property
    def stack(self) -> np.ndarray:
        """(period, N, N) float64 stack of the mixing matrices."""
        return np.stack([m.w for m in self.matrices])

    @property
    def n_edges(self) -> float:
        """Mean undirected edge count over the schedule."""
        return float(np.mean([m.n_edges for m in self.matrices]))

    @property
    def is_directed(self) -> bool:
        return any(m.is_directed for m in self.matrices)

    @property
    def n_messages(self) -> float:
        """Mean point-to-point message count per round (2E undirected)."""
        return float(np.mean([m.n_messages for m in self.matrices]))

    @property
    def beta(self) -> float:
        """Spectral gap of the mean matrix E[W]."""
        return spectral_beta(self.stack.mean(axis=0))

    def matrix_at(self, i: int) -> MixingMatrix:
        """Mixing matrix used by 0-based iteration ``i``."""
        return self.matrices[i % self.period]

    def indices_for(self, n_steps: int) -> np.ndarray:
        """Stack indices for iterations 0..n_steps-1."""
        return np.arange(n_steps) % self.period

    def edges_per_step(self, n_steps: int) -> np.ndarray:
        """Undirected edge count of the matrix used at each iteration."""
        counts = np.array([m.n_edges for m in self.matrices], dtype=np.float64)
        return counts[self.indices_for(n_steps)]

    def messages_per_step(self, n_steps: int) -> np.ndarray:
        """Wire message count of the matrix used at each iteration."""
        counts = np.array([m.n_messages for m in self.matrices],
                          dtype=np.float64)
        return counts[self.indices_for(n_steps)]

    def validate(self) -> None:
        for m in self.matrices:
            m.validate()


class StaticSchedule(TopologySchedule):
    """Degenerate schedule: the same W every step (the paper's setting)."""

    def __init__(self, mixing: MixingMatrix):
        super().__init__([mixing], f"static({mixing.name})")


class PeriodicSchedule(TopologySchedule):
    """Deterministic cycle through a list of matrices, each held ``dwell``
    steps."""

    def __init__(self, matrices: Sequence[MixingMatrix], dwell: int = 1,
                 name: str | None = None):
        if dwell < 1:
            raise ValueError(f"dwell must be >= 1, got {dwell}")
        expanded = [m for m in matrices for _ in range(dwell)]
        label = name or ("periodic(" + "|".join(m.name for m in matrices)
                         + (f" dwell={dwell}" if dwell > 1 else "") + ")")
        super().__init__(expanded, label)


def _sampled_schedule(sampler, horizon: int, seed: int,
                      ensure_connected: bool, laziness: float,
                      name: str) -> list[MixingMatrix]:
    """Draw ``horizon`` i.i.d. graphs, lazy-Metropolis-weight each into a
    valid W.  With ``ensure_connected`` a disconnected draw is rejected and
    redrawn (at most 1,000 times); without it disconnected samples stay
    (only joint connectivity over time matters)."""
    rng = np.random.default_rng(seed)
    mats: list[MixingMatrix] = []
    for t in range(horizon):
        adj = sampler(rng)
        attempts = 0
        while ensure_connected and not is_connected(adj):
            adj = sampler(rng)
            attempts += 1
            if attempts > 1000:
                raise RuntimeError(
                    f"{name}: could not draw a connected graph in 1000 tries "
                    "— increase p/radius or set ensure_connected=False")
        mats.append(_mm(lazy_metropolis_weights(adj, laziness),
                        f"{name}[{t}]"))
    return mats


class ErdosRenyiSchedule(TopologySchedule):
    """i.i.d. G(n, p) samples with lazy Metropolis-Hastings weights."""

    def __init__(self, n: int, p: float, horizon: int = 64, seed: int = 0,
                 ensure_connected: bool = True, laziness: float = 0.5):
        name = f"erdos_renyi(n={n},p={p})"
        mats = _sampled_schedule(
            lambda rng: erdos_renyi_graph(n, p, rng), horizon, seed,
            ensure_connected, laziness, name)
        super().__init__(mats, name)


class RandomGeometricSchedule(TopologySchedule):
    """i.i.d. random-geometric-graph samples (unit square, radius r) with
    lazy Metropolis-Hastings weights."""

    def __init__(self, n: int, radius: float, horizon: int = 64, seed: int = 0,
                 ensure_connected: bool = True, laziness: float = 0.5):
        name = f"rgg(n={n},r={radius})"
        mats = _sampled_schedule(
            lambda rng: random_geometric_graph(n, radius, rng), horizon,
            seed, ensure_connected, laziness, name)
        super().__init__(mats, name)


def as_schedule(mixing: "MixingMatrix | TopologySchedule") -> TopologySchedule:
    """Normalize a static W or an existing schedule to a TopologySchedule."""
    if isinstance(mixing, TopologySchedule):
        return mixing
    if isinstance(mixing, MixingMatrix):
        return StaticSchedule(mixing)
    raise TypeError(f"expected MixingMatrix or TopologySchedule, got "
                    f"{type(mixing)}")


def schedule_by_name(name: str, n: int | None = None,
                     **kw) -> TopologySchedule:
    """Schedule registry:

      static:<topology>     — StaticSchedule over ``by_name(topology)``
      ring_torus            — ring(n) / torus alternation (n even)
      erdos_renyi           — i.i.d. G(n, p) samples (kw: p, horizon, seed)
      rgg                   — i.i.d. random geometric graphs (kw: radius, ...)
      directed_erdos_renyi  — not yet ported (raises)
    """
    if name.startswith("static:"):
        return StaticSchedule(by_name(name.split(":", 1)[1], n=n, **kw))
    if name == "ring_torus":
        if n is None or n % 2:
            raise ValueError("ring_torus needs an even n")
        return PeriodicSchedule([ring(n), torus(2, n // 2)],
                                dwell=kw.get("dwell", 1))
    if name == "erdos_renyi":
        return ErdosRenyiSchedule(n, **kw)
    if name == "rgg":
        return RandomGeometricSchedule(n, **kw)
    if name == "directed_erdos_renyi":
        raise NotImplementedError(
            "schedule 'directed_erdos_renyi' (directed, column-stochastic "
            "matrices) is not yet ported")
    raise KeyError(f"unknown schedule {name!r}")
