"""Network topologies and consensus (mixing) matrices: the static,
undirected part of ``repro.core.topology``.

The consensus matrix ``W`` must satisfy the paper's three properties
(Section III-A):

  1. doubly stochastic:  rows and columns sum to 1,
  2. sparsity pattern follows the network graph (W_ij > 0 iff edge or i==j),
  3. symmetric (real eigenvalues, 1 = lam_1 >= ... >= lam_N > -1).

``beta = max(|lam_2|, |lam_N|) < 1`` is the mixing rate that appears in every
convergence bound of the paper (error ball ``alpha*D/(1-beta)`` etc.).

Matrices are float64 numpy arrays, built on the host exactly as the
reference builds them; the algorithms copy ``W`` to their device as
float32.  Directed (column-stochastic) matrices, time-varying schedules and
membership schedules are not ported yet: their ``by_name`` rows raise.
"""
from __future__ import annotations

import dataclasses

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
