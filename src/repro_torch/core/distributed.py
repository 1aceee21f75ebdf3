"""ADC-DGD consensus runtime over consensus nodes stacked on one device.

Port of ``repro.core.distributed`` for the packed exchange with a uniform
wire codec (``int8``, ``int4``, ``int2`` or ``topk[:k=<int>]``).  The
reference runs one consensus node per device inside ``shard_map`` and moves
the wire payload with ``ppermute``; here the ``N`` nodes are a leading axis
of every tensor, and a ring transfer is an index: ``ppermute(+1)`` hands
node ``i`` the payload of node ``i-1`` ("left"), ``ppermute(-1)`` that of
node ``i+1`` ("right").  Payloads stay a list of per-node tensors and the
neighbours' entries are passed as they are — nothing is copied for the
"transfer".

Per step k of ``adc_dgd`` (paper Algorithm 2, amplification folded into
the quantizer grid), for every node i:

    y_i    = pack(x_half_i) - x_tilde_i
    pay_i  = codec.encode_payload(y_i, noise_i, step_k)     (encode kernel)
    x_tilde_i, m_agg_i, comb_i = codec.decode_combine(
                 pay_i, pay_{i-1}, pay_{i+1}, x_tilde_i, m_agg_i)  (combine)
    x_next_i = comb_i + (x_half_i - x_prev_i)           (per leaf)

``step_k = fixed_step0 / k**gamma`` in fixed mode, the per-row absmax grid
in adaptive mode.  ``dgd`` (uncompressed mixing), ``allreduce`` (exact mean
of the optimizer delta) and ``none`` (isolated nodes) are the baselines.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import codec as wire_codec
from repro_torch.core import tree as T
from repro_torch.core import wire
from repro_torch.kernels import ops as kops

__all__ = ["ConsensusConfig", "ConsensusRuntime", "noise_seed"]

ALGORITHMS = ("adc_dgd", "dgd", "allreduce", "none")


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    algorithm: str = "adc_dgd"     # adc_dgd | dgd | allreduce | none
    gamma: float = 1.0             # amplification exponent (paper gamma)
    self_weight: float = 0.5       # ring W_ii; each side gets (1 - W_ii)/2
    quant_mode: str = "fixed"      # fixed (paper-faithful) | adaptive
    fixed_step0: float = 1e-3      # Delta_0; effective step = Delta_0 / k^gamma
    track_consensus_error: bool = False
    wire_codec: str = "int8"       # a core.codec name (no mixed plans yet)
    byte_budget: float | None = None   # bytes/step target (the controller)

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm must be one of {ALGORITHMS} (the "
                             f"ported subset), got {self.algorithm!r}")
        if self.quant_mode not in ("fixed", "adaptive"):
            raise ValueError(f"quant_mode must be 'fixed' or 'adaptive', "
                             f"got {self.quant_mode!r}")
        if not 0.0 < self.self_weight <= 1.0:
            raise ValueError(f"self_weight must be in (0, 1], got "
                             f"{self.self_weight}")
        if self.wire_codec.startswith("mixed:"):
            raise NotImplementedError(
                f"wire_codec={self.wire_codec!r}: mixed wire plans are not "
                "yet ported")
        try:
            wire_codec.by_name(self.wire_codec)
        except (KeyError, ValueError) as e:
            raise ValueError(f"wire_codec={self.wire_codec!r}: "
                             f"{e.args[0]}") from None
        if self.byte_budget is not None and self.byte_budget <= 0:
            raise ValueError(f"byte_budget must be positive, got "
                             f"{self.byte_budget}")

    @property
    def side_weight(self) -> float:
        return (1.0 - self.self_weight) / 2.0


def noise_seed(seed: int, step: int, node: int) -> int:
    """Generator seed of node ``node``'s quantization noise at ``step`` of
    run ``seed``: distinct for every (run, step, node)."""
    state = np.random.SeedSequence([seed, step, node]).generate_state(
        1, np.uint64)
    return int(state[0] & np.uint64(0x7FFF_FFFF_FFFF_FFFF))


def _left(i: int, n: int) -> int:
    """Ring neighbour whose payload ``ppermute(+1)`` delivers to node i."""
    return (i - 1) % n


def _right(i: int, n: int) -> int:
    return (i + 1) % n


def _ring_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the node axis in the reference's rotation order: node i
    accumulates x_i + x_{i-1} + x_{i-2} + ... (one ppermute(+1) per term)."""
    n = x.shape[0]
    acc = x
    for r in range(1, n):
        idx = torch.tensor([(i - r) % n for i in range(n)], device=x.device)
        acc = acc + x.index_select(0, idx)
    return acc


class ConsensusRuntime:
    """Stateless helper bound to (config, node count); the consensus state
    lives in the caller's train state.  Parameter trees have a leading
    node axis of size ``n_nodes`` on every leaf."""

    def __init__(self, config: ConsensusConfig, n_nodes: int):
        if n_nodes < 1:
            raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
        self.cfg = config
        self.n_nodes = n_nodes
        self.codec = wire_codec.by_name(config.wire_codec)

    # -- state ---------------------------------------------------------
    def state_layout(self, params: Any) -> wire.WireLayout:
        """The packing plan of one node's parameter tree."""
        return wire.WireLayout.for_tree(T.tree_map(lambda a: a[0], params))

    def init_state(self, params: Any) -> dict:
        """Packed consensus shadows ``(N, n_rows, BLOCK)`` for ``adc_dgd``.

        All nodes start from the same x0, so every neighbour estimate is x0
        and the incremental aggregate m_0 = sum_{j != i} W_ij x0 =
        (1 - W_ii) x0."""
        if self.cfg.algorithm != "adc_dgd":
            return {}
        x_tilde = self.state_layout(params).pack(params)
        return {"x_tilde": x_tilde,
                "m_agg": (1.0 - self.cfg.self_weight) * x_tilde}

    # -- static accounting -------------------------------------------------
    def wire_bytes_per_step(self, n_params_local: int,
                            layout: wire.WireLayout | None = None) -> float:
        """Bytes one node puts on the ring per step (both directions)."""
        alg = self.cfg.algorithm
        if alg == "adc_dgd":
            rows = (layout.n_rows if layout is not None
                    else kops.padded_block_rows(n_params_local))
            return 2.0 * self.codec.payload_bytes(rows)
        if alg == "dgd":
            return 2.0 * n_params_local * 4
        return 0.0

    def collectives_per_step(self, n_leaves: int = 1) -> float:
        """Ring transfers one node issues per step (static)."""
        alg, n = self.cfg.algorithm, self.n_nodes
        if alg == "none" or (n <= 1 and alg != "allreduce"):
            return 0.0
        if alg == "adc_dgd":
            return 2.0            # one payload per ring direction
        if alg == "dgd":
            return 2.0 * n_leaves
        return float(n - 1) * n_leaves     # rotation all-reduce

    def _step_k(self, step: int) -> float | None:
        """Fixed mode: the grid step Delta_0 / k^gamma, in float32."""
        if self.cfg.quant_mode != "fixed":
            return None
        k = np.maximum(np.float32(1.0), np.float32(step))
        return float(np.float32(self.cfg.fixed_step0)
                     / k ** np.float32(self.cfg.gamma))

    def make_noise(self, layout: wire.WireLayout, step: int, seed: int,
                   device) -> torch.Tensor:
        """``(N, n_rows, codec.noise_cols())`` uniform noise (``BLOCK``
        columns; ``2 * BLOCK`` for top-k), one ``torch.Generator`` on
        ``device`` per node seeded from (seed, step, node)."""
        noise = torch.empty((self.n_nodes, layout.n_rows,
                             self.codec.noise_cols(layout.block)),
                            dtype=torch.float32, device=device)
        for i in range(self.n_nodes):
            g = torch.Generator(device=device)
            g.manual_seed(noise_seed(seed, step, i))
            torch.rand(noise[i].shape, generator=g, out=noise[i])
        return noise

    # -- the exchange ----------------------------------------------------
    def exchange(self, x_prev: Any, x_half: Any, state: dict, step: int,
                 seed: int = 0, noise: torch.Tensor | None = None):
        """x_prev: params at step k; x_half: after the local optimizer step.

        ``noise``: optional ``(N, n_rows, >= codec.noise_cols())`` uniform
        buffer consumed row for row by the encoder (tests inject the
        reference's; int8 takes exactly ``BLOCK`` columns); without it
        each node draws its own from ``(seed, step, node)``.
        Returns (x_next, new_state, metrics)."""
        alg = self.cfg.algorithm
        layout = self.state_layout(x_half)
        metrics = {
            "collectives_per_step": self.collectives_per_step(layout.n_leaves),
            "wire_bytes_per_step": self.wire_bytes_per_step(
                layout.n_elements, layout)}
        if alg == "none" or (self.n_nodes <= 1 and alg != "allreduce"):
            x_next = x_half
        elif alg == "allreduce":
            x_next = _allreduce_mean_delta(x_prev, x_half)
        elif alg == "dgd":
            x_next = self._dgd_exchange(x_prev, x_half)
        else:
            x_next, state, adc = self._adc_exchange(
                x_prev, x_half, state, step, seed, noise, layout)
            metrics.update(adc)
        if self.cfg.track_consensus_error:
            metrics["consensus_err"] = _consensus_error(x_next)
        return x_next, state, metrics

    def encode(self, y: torch.Tensor, noise: torch.Tensor,
               step: int) -> list[torch.Tensor]:
        """Each node's wire payload ``(n_rows, payload_width)`` uint8 for
        the packed differentials ``y`` ``(N, n_rows, BLOCK)``: one encode
        launch per node."""
        step_k = self._step_k(step)
        return [self.codec.encode_payload(y[i], noise[i], fixed_step=step_k)
                for i in range(self.n_nodes)]

    def _adc_exchange(self, x_prev, x_half, state, step, seed, noise,
                      layout):
        cfg, n = self.cfg, self.n_nodes
        xt, mb = state["x_tilde"], state["m_agg"]
        y = layout.pack(x_half)
        y.sub_(xt)                # the packed differential, built in place
        if noise is None:
            noise = self.make_noise(layout, step, seed, y.device)
        pays = self.encode(y, noise, step)
        del noise
        outs = [self.codec.decode_combine(
                    pays[i], pays[_left(i, n)], pays[_right(i, n)], xt[i],
                    mb[i], cfg.self_weight, cfg.side_weight, 1.0)
                for i in range(n)]
        xt_new, m_new, comb = (torch.stack([o[j] for o in outs])
                               for j in range(3))
        del outs
        # averages as the reference evaluates them: XLA turns the division
        # by a constant into a product with its float32 reciprocal
        inv_codes = float(np.float32(1.0) / np.float32(
            layout.n_rows * self.codec.codes_per_row(layout.block)))
        inv_elems = float(np.float32(1.0) / np.float32(
            layout.n_rows * layout.block))
        step_k = self._step_k(step)
        if cfg.quant_mode == "fixed":
            # overflow monitoring (paper §IV-D): values beyond the grid
            overflow = torch.stack([
                self.codec.count_saturated(y[i], step_k, pays[i],
                                           layout.block)
                for i in range(n)]) * inv_codes
        else:
            overflow = torch.zeros(n, dtype=torch.float32, device=y.device)
        residual = torch.sqrt((y * y).sum(dim=(1, 2)) * inv_elems)
        del y, pays
        # gradient step applied per leaf while unpacking
        x_next = T.tree_map(
            lambda c, h, p: (c + (h.to(torch.float32)
                                  - p.to(torch.float32))).to(h.dtype),
            layout.unpack(comb, cast=False), x_half, x_prev)
        return (x_next, {"x_tilde": xt_new, "m_agg": m_new},
                {"overflow_frac": overflow, "residual_norm": residual})

    def _dgd_exchange(self, x_prev, x_half):
        """Uncompressed DGD: mix the raw fp32 parameters with both ring
        neighbours each step, then add the local optimizer delta."""
        n = self.n_nodes
        w_self, w_side = self.cfg.self_weight, self.cfg.side_weight

        def mix(h, p):
            p32 = p.to(torch.float32)
            left = p32.index_select(0, torch.tensor(
                [_left(i, n) for i in range(n)], device=p.device))
            right = p32.index_select(0, torch.tensor(
                [_right(i, n) for i in range(n)], device=p.device))
            mixed = w_self * p32 + w_side * (left + right)
            return (mixed + (h.to(torch.float32) - p32)).to(h.dtype)

        return T.tree_map(mix, x_half, x_prev)


def _allreduce_mean_delta(x_prev, x_half):
    """Synchronous data parallelism: every node steps by the node-mean of
    the optimizer delta (the reference's rotation all-reduce)."""
    n = T.tree_leaves(x_half)[0].shape[0]

    def avg(p, h):
        delta = (h - p).to(torch.float32)
        return (p.to(torch.float32) + _ring_sum(delta) / n).to(h.dtype)

    return T.tree_map(avg, x_prev, x_half)


def _consensus_error(params) -> torch.Tensor:
    """(1/N) sum_i ||x_i - mean_nodes(x)||^2 over all leaves (a metric)."""
    n = T.tree_leaves(params)[0].shape[0]
    total = None
    for x in T.tree_leaves(params):
        x = x.to(torch.float32)
        d = x - _ring_sum(x) / n
        e = (d * d).sum()
        total = e if total is None else total + e
    return total / n
