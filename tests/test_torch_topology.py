"""The port's static topologies held to the JAX package's.

Every ported constructor builds the same float64 ``W`` on the host as
``repro.core.topology`` does, so ``W``, ``beta``, the edge and message
counts and the neighbour lists are compared exactly (no tolerance).
``validate_mixing_matrix`` refuses what the reference refuses, with the
same message.  The directed rows of ``by_name`` build the reference's
column-stochastic matrices (``tests/test_torch_directed.py`` holds the
directed half in full).
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest

from repro.core import topology as JT
from repro_torch.core import topology as T

CASES = [
    ("ring", (2,), {}), ("ring", (3,), {}), ("ring", (8,), {}),
    ("ring", (5,), {"self_weight": 0.3}), ("ring", (1,), {}),
    ("chain", (6,), {}), ("fully_connected", (5,), {}), ("star", (7,), {}),
    ("torus", (3, 4), {}), ("expander", (12,), {"degree": 4, "seed": 3}),
    ("paper_fig3", (), {}), ("paper_circle", (20,), {}),
]


@pytest.mark.parametrize("fn,args,kw", CASES,
                         ids=[f"{c[0]}{c[1]}{c[2] or ''}" for c in CASES])
def test_constructors_equal_reference(fn, args, kw):
    got = getattr(T, fn)(*args, **kw)
    want = getattr(JT, fn)(*args, **kw)
    assert got.name == want.name
    assert got.w.dtype == want.w.dtype == np.float64
    np.testing.assert_array_equal(got.w, want.w)
    assert got.beta == want.beta == T.spectral_beta(want.w)
    assert (got.n, got.n_edges, got.n_messages) == (want.n, want.n_edges,
                                                    want.n_messages)
    assert [got.neighbors(i) for i in range(got.n)] == \
        [want.neighbors(i) for i in range(want.n)]
    assert not got.is_directed


@pytest.mark.parametrize("rule", ["metropolis", "lazy"])
def test_weight_rules_equal_reference(rule):
    rng = np.random.default_rng(0)
    adj = rng.random((9, 9)) < 0.4
    adj = np.triu(adj, 1)
    adj = adj | adj.T
    if rule == "metropolis":
        got, want = T.metropolis_weights(adj), JT.metropolis_weights(adj)
    else:
        got = T.lazy_metropolis_weights(adj, 0.3)
        want = JT.lazy_metropolis_weights(adj, 0.3)
    np.testing.assert_array_equal(got, want)


def _bad_matrices():
    ok = np.full((3, 3), 1 / 3)
    asym = np.array([[0.5, 0.5, 0.0], [0.25, 0.5, 0.25], [0.25, 0.0, 0.75]])
    rows = np.array([[0.6, 0.2, 0.2], [0.2, 0.6, 0.2], [0.2, 0.2, 0.5]])
    flip = np.array([[0.0, 1.0], [1.0, 0.0]])          # lambda_N = -1
    return {"square": np.ones((2, 3)) / 3, "symmetric": asym,
            "doubly stochastic": rows, "lambda_N": flip,
            "ok": ok}


@pytest.mark.parametrize("case", list(_bad_matrices()))
def test_validate_refuses_what_the_reference_refuses(case):
    w = _bad_matrices()[case]
    try:
        JT.validate_mixing_matrix(w)
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        T.validate_mixing_matrix(w)
        assert case == "ok"
        return
    with pytest.raises(ValueError) as got:
        T.validate_mixing_matrix(w)
    assert str(got.value) == want


@pytest.mark.parametrize("name,n,kw", [
    ("ring", 6, {}), ("full", 4, {}), ("star", 5, {}), ("chain", 5, {}),
    ("expander", 10, {"seed": 1}), ("paper_fig3", None, {}),
    ("paper_circle", 10, {}), ("torus2x3", None, {})])
def test_by_name_equals_reference(name, n, kw):
    got, want = T.by_name(name, n, **kw), JT.by_name(name, n, **kw)
    np.testing.assert_array_equal(got.w, want.w)
    assert got.name == want.name


@pytest.mark.parametrize("name", ["directed-ring", "directed_ring",
                                  "directed-cycle", "directed_cycle",
                                  "directed_er"])
def test_directed_rows_equal_reference(name):
    kw = {"p": 0.5, "seed": 2} if name == "directed_er" else {}
    got, want = T.by_name(name, 4, **kw), JT.by_name(name, 4, **kw)
    np.testing.assert_array_equal(got.w, want.w)
    assert got.name == want.name and got.is_directed and want.is_directed
    assert (got.n_edges, got.n_messages) == (want.n_edges, want.n_messages)
    with pytest.raises(KeyError):
        T.by_name("no-such-topology", 4)


def test_spectral_beta_of_an_asymmetric_matrix():
    """The second-largest eigenvalue modulus, as the reference computes it
    for a column-stochastic matrix."""
    w = np.array([[0.5, 0.0, 0.5], [0.5, 0.5, 0.0], [0.0, 0.5, 0.5]])
    assert T.spectral_beta(w) == JT.spectral_beta(w)
