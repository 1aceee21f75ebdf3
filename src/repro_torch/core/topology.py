"""Network topologies, consensus (mixing) matrices and time-varying
schedules of them: port of ``repro.core.topology``.

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

Directed networks: a :class:`DirectedMixingMatrix` is only **column**
stochastic — each sender splits unit mass over its out-edges
(``out_degree_weights``) — so plain DGD converges to a reweighted average.
Push-sum repairs this with a weight scalar mixed by the same matrix
(``push_sum_weights``); the de-biased iterate is ``x / w``.  Each directed
edge carries one message per round.

Matrices are float64 numpy arrays, built on the host exactly as the
reference builds them; the algorithms copy ``W`` to their device as
float32.

Elastic membership: a :class:`MembershipSchedule` holds per-epoch masks of
active nodes, the mixing over each epoch's surviving ring, and the
push-sum handoff and rejoin sources at each change; ``hierarchical_mixing``
is the two-level matrix ``W_outer (x) (1/m) 11^T``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "MixingMatrix",
    "DirectedMixingMatrix",
    "ring",
    "fully_connected",
    "hierarchical_mixing",
    "star",
    "torus",
    "chain",
    "expander",
    "paper_fig3",
    "paper_circle",
    "directed_ring",
    "directed_cycle",
    "directed_erdos_renyi",
    "metropolis_weights",
    "lazy_metropolis_weights",
    "out_degree_weights",
    "spectral_beta",
    "validate_mixing_matrix",
    "validate_column_stochastic",
    "by_name",
    "is_connected",
    "is_strongly_connected",
    "erdos_renyi_graph",
    "random_geometric_graph",
    "directed_erdos_renyi_graph",
    "push_sum_weights",
    "TopologySchedule",
    "StaticSchedule",
    "PeriodicSchedule",
    "ErdosRenyiSchedule",
    "RandomGeometricSchedule",
    "DirectedErdosRenyiSchedule",
    "as_schedule",
    "schedule_by_name",
    "MembershipSchedule",
]


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


@dataclasses.dataclass(frozen=True)
class DirectedMixingMatrix(MixingMatrix):
    """A column-stochastic consensus matrix over a directed graph:
    ``w[i, j] > 0`` iff the edge ``j -> i`` exists (or ``i == j``).  Rows
    need not sum to 1; ``beta`` is the second-largest eigenvalue
    modulus."""

    @property
    def is_directed(self) -> bool:
        return True

    @property
    def n_edges(self) -> int:
        """Number of directed communication edges (excluding self loops)."""
        off = self.w.copy()
        np.fill_diagonal(off, 0.0)
        return int((np.abs(off) > 1e-12).sum())

    @property
    def n_messages(self) -> int:
        """Each directed edge carries exactly one message per round."""
        return self.n_edges

    def in_neighbors(self, i: int) -> list[int]:
        """Senders node ``i`` hears from (support of row i)."""
        return [j for j in range(self.n)
                if j != i and abs(self.w[i, j]) > 1e-12]

    def out_neighbors(self, j: int) -> list[int]:
        """Receivers node ``j`` pushes to (support of column j)."""
        return [i for i in range(self.n)
                if i != j and abs(self.w[i, j]) > 1e-12]

    def neighbors(self, i: int) -> list[int]:
        return self.in_neighbors(i)

    def validate(self) -> None:
        validate_column_stochastic(self.w)


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


def validate_column_stochastic(w: np.ndarray, atol: float = 1e-8) -> None:
    """The push-sum requirements: non-negative, columns sum to 1, and a
    strictly positive diagonal (which keeps push-sum weights positive)."""
    if w.ndim != 2 or w.shape[0] != w.shape[1]:
        raise ValueError(f"W must be square, got {w.shape}")
    if (w < -atol).any():
        raise ValueError("column-stochastic W must be non-negative")
    if not np.allclose(w.sum(axis=0), 1.0, atol=atol):
        raise ValueError("W must be column stochastic (column sums == 1)")
    if (np.diag(w) <= atol).any():
        raise ValueError(
            "column-stochastic W needs a strictly positive diagonal "
            "(push-sum weight positivity; add a self loop / self_weight > 0)")


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


def out_degree_weights(adj: np.ndarray,
                       self_weight: float = 0.5) -> np.ndarray:
    """Column-stochastic push weights for a directed adjacency
    (``adj[i, j]`` is the edge ``j -> i``): sender ``j`` keeps
    ``self_weight`` and splits the rest equally over its out-neighbours;
    a sink keeps all its mass."""
    if not 0.0 < self_weight < 1.0:
        raise ValueError(f"self_weight must be in (0, 1), got {self_weight}")
    adj = np.asarray(adj, dtype=bool).copy()
    np.fill_diagonal(adj, False)
    n = adj.shape[0]
    outdeg = adj.sum(axis=0)                      # column sums = out-degrees
    w = np.zeros((n, n), dtype=np.float64)
    for j in range(n):
        if outdeg[j] == 0:
            w[j, j] = 1.0
            continue
        w[:, j] = adj[:, j] * ((1.0 - self_weight) / outdeg[j])
        w[j, j] = self_weight
    return w


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


def hierarchical_mixing(outer: MixingMatrix, pod_size: int) -> MixingMatrix:
    """Two-level mixing ``W_outer (x) (1/m) 11^T`` over ``outer.n *
    pod_size`` nodes: every pod of ``m`` consecutive nodes averages
    internally while the pods mix by ``outer``.  Its spectrum is
    ``eig(W_outer)`` plus ``n - pods`` zeros, so its ``beta`` is the pod
    ring's."""
    if pod_size < 1:
        raise ValueError(f"pod_size must be >= 1, got {pod_size}")
    m = pod_size
    w = np.kron(outer.w, np.full((m, m), 1.0 / m))
    return _mm(w, f"hier[{outer.name}x{m}]")


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


def _dmm(w: np.ndarray, name: str) -> DirectedMixingMatrix:
    m = DirectedMixingMatrix(w=np.asarray(w, dtype=np.float64), name=name)
    m.validate()
    return m


def directed_ring(n: int, self_weight: float = 0.5,
                  forward_weight: float | None = None
                  ) -> DirectedMixingMatrix:
    """Asymmetric circulant ring: node i pushes ``forward_weight`` to i+1
    and ``1 - self_weight - forward_weight`` to i-1 (mod n); the default
    sends 2/3 of the leaving mass forward.  The matrix the runtime's
    ``topology="directed-ring"`` realizes on the node ring."""
    if not 0.0 < self_weight < 1.0:
        raise ValueError(f"self_weight must be in (0, 1), got {self_weight}")
    if forward_weight is None:
        forward_weight = 2.0 * (1.0 - self_weight) / 3.0
    backward = 1.0 - self_weight - forward_weight
    if forward_weight <= 0.0 or backward < 0.0:
        raise ValueError(
            f"forward_weight must be in (0, 1 - self_weight]; got "
            f"{forward_weight} with self_weight={self_weight}")
    if n < 2:
        return _dmm(np.ones((1, 1)), f"directed_ring{n}")
    w = np.zeros((n, n))
    for j in range(n):
        w[j, j] = self_weight
        w[(j + 1) % n, j] += forward_weight
        w[(j - 1) % n, j] += backward
    return _dmm(w, f"directed_ring{n}")


def directed_cycle(n: int, self_weight: float = 0.5) -> DirectedMixingMatrix:
    """Pure one-directional push ring: i sends only to i+1 (mod n)."""
    return directed_ring(n, self_weight=self_weight,
                         forward_weight=1.0 - self_weight)


def directed_erdos_renyi(n: int, p: float, seed: int = 0,
                         self_weight: float = 0.5,
                         ensure_connected: bool = True
                         ) -> DirectedMixingMatrix:
    """One directed G(n, p) sample with out-degree push weights, redrawn
    (at most 1,000 times) until strongly connected when
    ``ensure_connected``."""
    rng = np.random.default_rng(seed)
    adj = directed_erdos_renyi_graph(n, p, rng)
    attempts = 0
    while ensure_connected and not is_strongly_connected(adj):
        adj = directed_erdos_renyi_graph(n, p, rng)
        attempts += 1
        if attempts > 1000:
            raise RuntimeError(
                f"directed_erdos_renyi(n={n}, p={p}): no strongly connected "
                "draw in 1000 tries — increase p or set "
                "ensure_connected=False")
    return _dmm(out_degree_weights(adj, self_weight),
                f"directed_er(n={n},p={p})")


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
        "directed-ring": lambda: directed_ring(n, **kw),
        "directed_ring": lambda: directed_ring(n, **kw),
        "directed-cycle": lambda: directed_cycle(n, **kw),
        "directed_cycle": lambda: directed_cycle(n, **kw),
        "directed_er": lambda: directed_erdos_renyi(n, **kw),
    }
    if name.startswith("torus"):
        r, c = name[5:].split("x")
        return torus(int(r), int(c))
    if name not in builders:
        raise KeyError(f"unknown topology {name!r}; have {sorted(builders)}")
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


def directed_erdos_renyi_graph(n: int, p: float,
                               rng: np.random.Generator) -> np.ndarray:
    """One directed G(n, p) sample: each ordered pair (j, i), i != j, is an
    edge j -> i (``adj[i, j]``) i.i.d. w.p. ``p``."""
    adj = rng.random((n, n)) < p
    np.fill_diagonal(adj, False)
    return adj


def is_strongly_connected(adj: np.ndarray) -> bool:
    """Strong connectivity of a directed adjacency (``adj[i, j]`` = edge
    j -> i): node 0 reaches every node forward and backward."""
    adj = np.asarray(adj, dtype=bool)

    def _reaches_all(a: np.ndarray) -> bool:
        n = a.shape[0]
        if n == 0:
            return True
        seen = np.zeros(n, dtype=bool)
        frontier = np.zeros(n, dtype=bool)
        seen[0] = frontier[0] = True
        while frontier.any():
            nxt = a[:, frontier].any(axis=1) & ~seen
            seen |= nxt
            frontier = nxt
        return bool(seen.all())

    return _reaches_all(adj) and _reaches_all(adj.T)


def push_sum_weights(matrices: "Sequence[MixingMatrix] | TopologySchedule",
                     horizon: int | None = None) -> np.ndarray:
    """Push-sum weight trajectory ``w_k = W^(k-1) ... W^(0) 1``:
    ``(horizon + 1, N)`` float64 with ``w_0 = 1``.  Column stochasticity
    keeps ``sum(w_k) == N``, a positive diagonal every entry positive."""
    if isinstance(matrices, TopologySchedule):
        sched = matrices
        steps = sched.period if horizon is None else horizon
        mats = [sched.matrix_at(i).w for i in range(steps)]
    else:
        mats = [m.w for m in matrices]
        if horizon is not None:
            mats = [mats[i % len(mats)] for i in range(horizon)]
    n = mats[0].shape[0]
    w = np.ones(n, dtype=np.float64)
    out = [w.copy()]
    for a in mats:
        w = np.asarray(a, dtype=np.float64) @ w
        out.append(w.copy())
    return np.stack(out)


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


class DirectedErdosRenyiSchedule(TopologySchedule):
    """i.i.d. directed G(n, p) samples with out-degree (column-stochastic)
    push weights; a draw that is not strongly connected is redrawn (at
    most 1,000 times) when ``ensure_connected``."""

    def __init__(self, n: int, p: float, horizon: int = 64, seed: int = 0,
                 ensure_connected: bool = True, self_weight: float = 0.5):
        name = f"directed_er(n={n},p={p})"
        rng = np.random.default_rng(seed)
        mats: list[MixingMatrix] = []
        for t in range(horizon):
            adj = directed_erdos_renyi_graph(n, p, rng)
            attempts = 0
            while ensure_connected and not is_strongly_connected(adj):
                adj = directed_erdos_renyi_graph(n, p, rng)
                attempts += 1
                if attempts > 1000:
                    raise RuntimeError(
                        f"{name}: no strongly connected draw in 1000 tries "
                        "— increase p or set ensure_connected=False")
            mats.append(_dmm(out_degree_weights(adj, self_weight),
                             f"{name}[{t}]"))
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
      directed_erdos_renyi  — i.i.d. directed G(n, p) samples (kw: p, ...)
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
        return DirectedErdosRenyiSchedule(n, **kw)
    raise KeyError(f"unknown schedule {name!r}")


# ---------------------------------------------------------------------------
# Elastic membership
# ---------------------------------------------------------------------------

def _nearest_active(j: int, mask: "Sequence[bool]",
                    exclude: "set[int] | None" = None) -> int:
    """Nearest node to ``j`` (ring distance, preferring +1 over -1) that is
    active in ``mask`` and not in ``exclude``."""
    n = len(mask)
    exclude = exclude or set()
    for d in range(1, n):
        for cand in ((j + d) % n, (j - d) % n):
            if mask[cand] and cand not in exclude and cand != j:
                return cand
    raise ValueError(f"no active neighbor for node {j} in mask {mask}")


@dataclasses.dataclass(frozen=True)
class MembershipSchedule:
    """Per-epoch active-node masks for elastic consensus.

    ``masks[e][v]`` says whether node ``v`` takes part in epoch ``e``;
    epochs past the end clamp to the last mask.  Three pieces of algebra
    hang off the masks:

      * :meth:`mixing_at`: the consensus matrix over the surviving ring:
        identity rows and columns for inactive nodes, the survivors a
        compacted stride-1 ring weighted by Metropolis-Hastings (default)
        or the runtime's ``(self_weight, side, side)`` rule;
      * :meth:`handoff_at`: the column-stochastic push-sum handoff: a node
        departing at epoch ``e`` pushes its whole (value, weight) mass to
        its nearest survivor;
      * :meth:`rejoin_sources_at`: for each node rejoining at ``e``, the
        nearest node active through ``e - 1``, whose de-biased iterate it
        warm-restarts from.
    """

    masks: tuple

    def __post_init__(self):
        if not self.masks:
            raise ValueError("MembershipSchedule needs at least one mask")
        masks = tuple(tuple(bool(b) for b in m) for m in self.masks)
        n = len(masks[0])
        for e, m in enumerate(masks):
            if len(m) != n:
                raise ValueError(
                    f"mask {e} has {len(m)} nodes, expected {n}")
            if sum(m) < 2:
                raise ValueError(
                    f"epoch {e} must keep >= 2 active nodes, got {sum(m)}")
        object.__setattr__(self, "masks", masks)

    @property
    def n_nodes(self) -> int:
        return len(self.masks[0])

    @property
    def n_epochs(self) -> int:
        return len(self.masks)

    @property
    def is_static(self) -> bool:
        return all(m == self.masks[0] for m in self.masks)

    def mask_at(self, epoch: int) -> tuple:
        """The active mask for ``epoch`` (clamped to the last one)."""
        return self.masks[min(epoch, self.n_epochs - 1)]

    def active_indices(self, epoch: int) -> list:
        m = self.mask_at(epoch)
        return [v for v in range(self.n_nodes) if m[v]]

    def epoch_events(self) -> list:
        """One row per epoch boundary where the mask changes: who joined,
        who departed, how many remain active."""
        events = []
        for e in range(1, self.n_epochs):
            prev, cur = self.masks[e - 1], self.masks[e]
            if prev == cur:
                continue
            events.append({
                "epoch": e,
                "joined": [v for v in range(self.n_nodes)
                           if cur[v] and not prev[v]],
                "departed": [v for v in range(self.n_nodes)
                             if prev[v] and not cur[v]],
                "active": sum(cur),
            })
        return events

    def mixing_at(self, epoch: int, self_weight: float = 0.5,
                  rule: str = "metropolis") -> MixingMatrix:
        """The mixing over the surviving ring at ``epoch`` (float64)."""
        active = self.active_indices(epoch)
        n, m = self.n_nodes, len(active)
        w = np.eye(n, dtype=np.float64)
        if rule == "metropolis":
            adj = np.zeros((m, m), dtype=bool)
            for p in range(m):
                q = (p + 1) % m
                if q != p:
                    adj[p, q] = adj[q, p] = True
            sub = metropolis_weights(adj)
        elif rule == "ring":
            sub = ring(m, self_weight=self_weight).w
        else:
            raise ValueError(f"unknown reweighting rule {rule!r}")
        for p, i in enumerate(active):
            for q, j in enumerate(active):
                w[i, j] = sub[p, q]
        mm = MixingMatrix(w=w, name=f"elastic{m}of{n}@{epoch}")
        mm.validate()
        return mm

    def handoff_at(self, epoch: int) -> np.ndarray:
        """Column-stochastic ``(n, n)`` handoff ``H`` at the boundary
        entering ``epoch``: column ``j`` of a node departing there is
        ``e_target`` (its nearest node active through the change, or of
        the new active set when none is); other columns are identity."""
        if epoch < 1:
            raise ValueError("handoff is defined for epoch >= 1")
        prev, cur = self.mask_at(epoch - 1), self.mask_at(epoch)
        cont = [prev[v] and cur[v] for v in range(self.n_nodes)]
        pool = cont if any(cont) else list(cur)
        h = np.eye(self.n_nodes, dtype=np.float64)
        for j in range(self.n_nodes):
            if prev[j] and not cur[j]:
                target = _nearest_active(j, pool)
                h[j, j] = 0.0
                h[target, j] = 1.0
        return h

    def rejoiners_at(self, epoch: int) -> list:
        if epoch < 1:
            return []
        prev, cur = self.mask_at(epoch - 1), self.mask_at(epoch)
        return [v for v in range(self.n_nodes) if cur[v] and not prev[v]]

    def rejoin_sources_at(self, epoch: int) -> dict:
        """``{rejoiner: source}``, the source active through ``epoch - 1``
        and at ``epoch``; empty when no node is active through the change
        (a full membership swap)."""
        prev, cur = self.mask_at(epoch - 1), self.mask_at(epoch)
        survivors = [prev[v] and cur[v] for v in range(self.n_nodes)]
        if not any(survivors):
            return {}
        return {v: _nearest_active(v, survivors)
                for v in self.rejoiners_at(epoch)}

    @classmethod
    def static(cls, n_nodes: int) -> "MembershipSchedule":
        return cls(masks=(tuple(True for _ in range(n_nodes)),))

    @classmethod
    def from_spec(cls, spec: str, n_nodes: int,
                  n_epochs: int | None = None) -> "MembershipSchedule":
        """Parse ``"2@1:3;0@4:6"``: node 2 inactive for epochs [1, 3), node
        0 for [4, 6).  ``n_epochs`` defaults to ``max(end) + 1``, so the
        schedule ends with a recovery epoch."""
        outages = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            node_s, sep, span = part.partition("@")
            start_s, sep2, end_s = span.partition(":")
            if not sep or not sep2:
                raise ValueError(
                    f"bad outage {part!r} (expected 'node@start:end')")
            node, start, end = int(node_s), int(start_s), int(end_s)
            if not 0 <= node < n_nodes:
                raise ValueError(f"node {node} out of range [0, {n_nodes})")
            if not 0 <= start < end:
                raise ValueError(f"bad epoch span {start}:{end}")
            outages.append((node, start, end))
        if not outages:
            raise ValueError(f"empty membership spec {spec!r}")
        total = n_epochs if n_epochs is not None else max(
            e for _, _, e in outages) + 1
        masks = []
        for e in range(total):
            m = [True] * n_nodes
            for node, start, end in outages:
                if start <= e < end:
                    m[node] = False
            masks.append(tuple(m))
        return cls(masks=tuple(masks))

    @classmethod
    def from_failure_model(cls, model, n_nodes: int,
                           n_epochs: int) -> "MembershipSchedule":
        """Masks drawn from a :class:`repro_torch.core.faults.
        NodeFailureModel`."""
        am = model.active_mask_host(n_nodes, n_epochs)
        return cls(masks=tuple(tuple(bool(b) for b in row) for row in am))
