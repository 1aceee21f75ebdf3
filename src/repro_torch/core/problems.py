"""Consensus optimization problems (paper Section III/V test functions);
counterpart of ``repro.core.problems``.

A problem bundles per-node local objectives f_i and their gradients over
stacked states ``x`` of shape ``(N, P)`` (one row per node), as float32
tensors on the problem's device (``cuda`` unless the caller asks for the
CPU).  The data come from the same numpy ``default_rng(seed)`` draws as the
reference's and are rounded to float32 once, as the reference's
``jnp.asarray`` rounds them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from .f32 import recip

__all__ = [
    "ConsensusProblem",
    "quadratic_problem",
    "paper_2node",
    "paper_4node",
    "paper_circle_problem",
    "decentralized_linear_regression",
    "decentralized_logistic_regression",
]


@dataclasses.dataclass(frozen=True)
class ConsensusProblem:
    """min_x sum_i f_i(x) in consensus form over N nodes, x in R^P."""

    n_nodes: int
    dim: int
    #: (N, P) -> (N, P): per-node gradient of f_i evaluated at row i
    grad_fn: Callable
    #: (P,)    -> scalar: global objective f(x) = sum_i f_i(x)
    global_obj: Callable
    #: (P,)    -> (P,): gradient of the *global* objective at a single point
    global_grad: Callable
    #: known optimum (or None)
    x_star: np.ndarray | None = None
    name: str = "problem"
    device: torch.device = torch.device("cpu")

    def mean_grad_norm(self, x_stack: torch.Tensor) -> torch.Tensor:
        """|| (1/N) sum_i grad f_i(x_bar) ||, the paper's convergence
        metric."""
        x_bar = x_stack.mean(dim=0)
        return torch.linalg.vector_norm(
            self.global_grad(x_bar) * float(recip(self.n_nodes)))

    def consensus_error(self, x_stack: torch.Tensor) -> torch.Tensor:
        """|| x - 1 (x) bar x ||  (Theorem 1 metric)."""
        x_bar = x_stack.mean(dim=0, keepdim=True)
        return torch.linalg.vector_norm(x_stack - x_bar)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32,
                           device=device)


# ---------------------------------------------------------------------------
# Quadratics (the paper's experiments are all of this family)
# ---------------------------------------------------------------------------

def quadratic_problem(a: np.ndarray, b: np.ndarray, name: str = "quadratic",
                      device: str | torch.device | None = None
                      ) -> ConsensusProblem:
    """f_i(x) = sum_p a[i,p] * (x[p] - b[i,p])^2.

    ``a`` may contain negative rows (non-convex local objectives, as in the
    paper's four-node example where f_1(x) = -4x^2) as long as the *global*
    sum stays strongly convex (sum_i a[i] > 0 per coordinate).
    """
    dev = resolve_device(device)
    a = np.atleast_2d(np.asarray(a, dtype=np.float64))
    b = np.atleast_2d(np.asarray(b, dtype=np.float64))
    assert a.shape == b.shape
    n, p = a.shape
    a_sum = a.sum(axis=0)
    if np.any(a_sum <= 0):
        raise ValueError("global objective must be coercive: sum_i a_i > 0")
    # global optimum of sum_i a_i (x-b_i)^2: x* = sum(a b)/sum(a)
    x_star = (a * b).sum(axis=0) / a_sum

    aj, bj = _f32(a, dev), _f32(b, dev)
    two_a = 2.0 * aj                     # exact: the reference folds it

    def grad_fn(x_stack, key=None):
        del key
        return two_a * (x_stack - bj)

    def global_obj(x):
        d = x[None, :] - bj
        return (aj * (d * d)).sum()

    def global_grad(x):
        return (two_a * (x[None, :] - bj)).sum(dim=0)

    return ConsensusProblem(
        n_nodes=n, dim=p, grad_fn=grad_fn, global_obj=global_obj,
        global_grad=global_grad, x_star=x_star, name=name, device=dev,
    )


def paper_2node(device: str | torch.device | None = None) -> ConsensusProblem:
    """Fig. 1 motivating example: f1 = 4(x-2)^2, f2 = 2(x+3)^2.

    x* = (4*2 + 2*(-3)) / 6 = 1/3.
    """
    return quadratic_problem(a=[[4.0], [2.0]], b=[[2.0], [-3.0]],
                             name="paper_2node", device=device)


def paper_4node(device: str | torch.device | None = None) -> ConsensusProblem:
    """Section V-1 example: f1 = -4x^2, f2 = 2(x-0.2)^2, f3 = 2(x+0.3)^2,
    f4 = 5(x-0.1)^2.

    f1 is non-convex; the sum 5x^2 + ... is strongly convex.
    x* = (0 + 2*0.2 - 2*0.3 + 5*0.1)/(-4+2+2+5) = 0.3/5 = 0.06.
    """
    return quadratic_problem(
        a=[[-4.0], [2.0], [2.0], [5.0]],
        b=[[0.0], [0.2], [-0.3], [0.1]],
        name="paper_4node", device=device,
    )


def paper_circle_problem(n: int, seed: int = 0, dim: int = 1,
                         device: str | torch.device | None = None
                         ) -> ConsensusProblem:
    """Section V-3: f_i = a_i (x-b_i)^2, a~U[0,10], b~U[0,1], circle graph."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 10.0, size=(n, dim))
    b = rng.uniform(0.0, 1.0, size=(n, dim))
    return quadratic_problem(a, b, name=f"paper_circle{n}", device=device)


# ---------------------------------------------------------------------------
# Decentralized ML problems (high-dimensional; the paper's motivation)
# ---------------------------------------------------------------------------

def decentralized_linear_regression(
    n_nodes: int, dim: int, samples_per_node: int = 64, seed: int = 0,
    noise: float = 0.01, device: str | torch.device | None = None,
) -> ConsensusProblem:
    """f_i(x) = (1/2m) ||A_i x - y_i||^2 with a shared ground-truth x_true."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x_true = rng.normal(size=(dim,)) / np.sqrt(dim)
    A = rng.normal(size=(n_nodes, samples_per_node, dim)) / np.sqrt(dim)
    y = A @ x_true + noise * rng.normal(size=(n_nodes, samples_per_node))
    Aj, yj = _f32(A, dev), _f32(y, dev)
    inv_m = float(recip(samples_per_node))

    def grad_fn(x_stack, key=None):
        del key
        resid = torch.einsum("nmd,nd->nm", Aj, x_stack) - yj
        return torch.einsum("nmd,nm->nd", Aj, resid) * inv_m

    def global_obj(x):
        r = torch.einsum("nmd,d->nm", Aj, x) - yj
        return 0.5 * (r * r).sum() * inv_m

    def global_grad(x):
        r = torch.einsum("nmd,d->nm", Aj, x) - yj
        return torch.einsum("nmd,nm->d", Aj, r) * inv_m

    # closed-form optimum of the global least squares
    A2 = A.reshape(-1, dim)
    y2 = y.reshape(-1)
    x_star, *_ = np.linalg.lstsq(A2, y2, rcond=None)
    return ConsensusProblem(
        n_nodes=n_nodes, dim=dim, grad_fn=grad_fn, global_obj=global_obj,
        global_grad=global_grad, x_star=x_star,
        name=f"linreg{n_nodes}x{dim}", device=dev,
    )


def decentralized_logistic_regression(
    n_nodes: int, dim: int, samples_per_node: int = 64, seed: int = 0,
    l2: float = 1e-3, device: str | torch.device | None = None,
) -> ConsensusProblem:
    """Binary logistic regression with l2; smooth, strongly convex global f.

    The gradients are written in closed form: d/dz log(1 + e^z) is the
    sigmoid, so grad f_i(x) = A_i^T (sigmoid(A_i x) - y_i) / m + l2 x.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(dim,))
    A = rng.normal(size=(n_nodes, samples_per_node, dim))
    logits = A @ w_true
    labels = (rng.uniform(size=logits.shape)
              < 1.0 / (1.0 + np.exp(-logits))).astype(np.float64)
    Aj, yj = _f32(A, dev), _f32(labels, dev)
    inv_m = float(recip(samples_per_node))

    def grad_fn(x_stack, key=None):
        del key
        z = torch.einsum("nmd,nd->nm", Aj, x_stack)
        return (torch.einsum("nmd,nm->nd", Aj, torch.sigmoid(z) - yj)
                * inv_m + l2 * x_stack)

    def global_obj(x):
        z = torch.einsum("nmd,d->nm", Aj, x)
        per = torch.logaddexp(torch.zeros_like(z), z) - yj * z
        return per.mean(dim=1).sum() + 0.5 * l2 * n_nodes * (x * x).sum()

    def global_grad(x):
        z = torch.einsum("nmd,d->nm", Aj, x)
        return (torch.einsum("nmd,nm->d", Aj, torch.sigmoid(z) - yj) * inv_m
                + l2 * n_nodes * x)

    return ConsensusProblem(
        n_nodes=n_nodes, dim=dim, grad_fn=grad_fn, global_obj=global_obj,
        global_grad=global_grad, x_star=None,
        name=f"logreg{n_nodes}x{dim}", device=dev,
    )
