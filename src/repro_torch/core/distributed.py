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
of the optimizer delta) and ``none`` (isolated nodes) are the baselines;
``compressed_dgd`` (paper Eq. (5), the negative control) mixes the
neighbours' int8-compressed parameters themselves, on the undecayed grid
``fixed_step0``, with the node's own parameters uncompressed.

``wire_packing="packed"`` ships the whole tree as one payload per node;
``"per_leaf"`` is the reference transport of the same exchange, int8 only:
per leaf one quantize launch (codes and scales as two tensors) and one
combine launch per node, four ring transfers per leaf.  Drawn from the same
noise buffer, the two give the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import codec as wire_codec
from repro_torch.core import tree as T
from repro_torch.core import wire
from repro_torch.core.f32 import over_power, recip
from repro_torch.kernels import ops as kops

__all__ = ["ConsensusConfig", "ConsensusRuntime", "noise_seed"]

ALGORITHMS = ("adc_dgd", "dgd", "compressed_dgd", "allreduce", "none")
#: wire transports of the reference; the ported ones are packed and per_leaf
WIRE_PACKINGS = ("packed", "pipelined", "per_leaf", "async")


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    algorithm: str = "adc_dgd"     # adc_dgd | dgd | compressed_dgd |
                                   # allreduce | none
    gamma: float = 1.0             # amplification exponent (paper gamma)
    self_weight: float = 0.5       # ring W_ii; each side gets (1 - W_ii)/2
    quant_mode: str = "fixed"      # fixed (paper-faithful) | adaptive
    fixed_step0: float = 1e-3      # Delta_0; effective step = Delta_0 / k^gamma
    track_consensus_error: bool = False
    wire_codec: str = "int8"       # a core.codec name (no mixed plans yet)
    byte_budget: float | None = None   # bytes/step target (the controller)
    wire_packing: str = "packed"   # packed | per_leaf (the reference path)

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
        if self.wire_packing not in WIRE_PACKINGS:
            raise ValueError(f"wire_packing must be one of {WIRE_PACKINGS}, "
                             f"got {self.wire_packing!r}")
        if self.wire_packing in ("pipelined", "async"):
            raise NotImplementedError(
                f"wire_packing={self.wire_packing!r} is not yet ported")
        if self.wire_packing == "per_leaf" and self.wire_codec != "int8":
            raise ValueError(
                f"wire_codec={self.wire_codec!r} requires the packed "
                "transport; the per-leaf reference path speaks int8 only")
        if self.algorithm == "compressed_dgd" and self.wire_codec != "int8":
            raise ValueError(
                "compressed_dgd (the Eq. (5) negative control) is pinned "
                f"to the int8 wire; got wire_codec={self.wire_codec!r}")

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
        """Bytes one node puts on the ring per step (both directions).  The
        per-leaf transport ships each leaf padded to its own TILE_N-aligned
        height, so more rows than the packed payload of the same tree."""
        alg = self.cfg.algorithm
        if alg in ("adc_dgd", "compressed_dgd"):
            if layout is not None and self.cfg.wire_packing == "per_leaf":
                rows = sum(kops.padded_block_rows(s.size)
                           for s in layout.slots)
            elif layout is not None:
                rows = layout.n_rows
            else:
                rows = kops.padded_block_rows(n_params_local)
            return 2.0 * self.codec.payload_bytes(rows)
        if alg == "dgd":
            return 2.0 * n_params_local * 4
        return 0.0

    def collectives_per_step(self, n_leaves: int = 1) -> float:
        """Ring transfers one node makes per step (static): one payload
        per ring direction on the packed wire, codes and scales per
        direction per leaf on the per-leaf transport."""
        alg, n = self.cfg.algorithm, self.n_nodes
        if alg == "none" or (n <= 1 and alg != "allreduce"):
            return 0.0
        if alg in ("adc_dgd", "compressed_dgd"):
            return (2.0 if self.cfg.wire_packing == "packed"
                    else 4.0 * n_leaves)
        if alg == "dgd":
            return 2.0 * n_leaves
        return float(n - 1) * n_leaves     # rotation all-reduce

    def _step_k(self, step: int) -> float | None:
        """Fixed mode: the grid step Delta_0 / k^gamma, in float32, as the
        reference's compiled step computes it (``f32.over_power``)."""
        if self.cfg.quant_mode != "fixed":
            return None
        k = max(np.float32(1.0), np.float32(step))
        return float(over_power(self.cfg.fixed_step0, k, self.cfg.gamma))

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
        elif alg == "compressed_dgd":
            if noise is None:
                noise = self.make_noise(layout, step, seed,
                                        T.tree_leaves(x_half)[0].device)
            fn = (self._cdgd_exchange_packed
                  if self.cfg.wire_packing == "packed"
                  else self._cdgd_exchange_per_leaf)
            x_next = fn(x_prev, x_half, noise, layout)
        else:
            fn = (self._adc_exchange if self.cfg.wire_packing == "packed"
                  else self._adc_exchange_per_leaf)
            x_next, state, adc = fn(x_prev, x_half, state, step, seed, noise,
                                    layout)
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
        inv_codes, inv_elems = self._ratios(layout)
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

    def _ratios(self, layout):
        """``(1/codes, 1/elements)`` of the packed buffer as float32
        reciprocals: the reference's averages, which XLA evaluates as
        products with the divisor's float32 reciprocal."""
        inv_codes = float(np.float32(1.0) / np.float32(
            layout.n_rows * self.codec.codes_per_row(layout.block)))
        inv_elems = float(np.float32(1.0) / np.float32(
            layout.n_rows * layout.block))
        return inv_codes, inv_elems

    def _adc_exchange_per_leaf(self, x_prev, x_half, state, step, seed,
                               noise, layout):
        """The per-leaf reference transport of :meth:`_adc_exchange` (no
        push-sum, faults or resync, as on the packed path): per leaf and
        node one ``quantize_blocks`` launch, the codes and scales handed to
        both ring neighbours, and one ``dequant_combine`` launch.  Each
        leaf is padded to its own TILE_N-aligned height; the noise is the
        packed path's buffer sliced per leaf, so the two transports give
        the same bits."""
        cfg, n = self.cfg, self.n_nodes
        step_k = self._step_k(step)
        xt, mb = state["x_tilde"], state["m_agg"]
        if noise is None:
            noise = self.make_noise(layout, step, seed, xt.device)
        clipped = torch.zeros(n, dtype=torch.float32, device=xt.device)
        residual_sq = torch.zeros(n, dtype=torch.float32, device=xt.device)
        new_x, xt_rows, m_rows = [], [], []
        for i, (slot, h, p) in enumerate(zip(layout.slots,
                                              T.tree_leaves(x_half),
                                              T.tree_leaves(x_prev))):
            full = kops.padded_block_rows(slot.size)
            y = _blockify_nodes(h, full)
            xtb = _rowpad(layout.leaf_rows(xt, i), full)
            mbb = _rowpad(layout.leaf_rows(mb, i), full)
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
            outs = [kops.dequant_combine(
                        *sent[j], *sent[_left(j, n)], *sent[_right(j, n)],
                        xtb[j], mbb[j], cfg.self_weight, cfg.side_weight, 1.0)
                    for j in range(n)]
            del sent
            comb = torch.stack([o[2] for o in outs])
            xt_rows.append(torch.stack([o[0][:slot.n_rows] for o in outs]))
            m_rows.append(torch.stack([o[1][:slot.n_rows] for o in outs]))
            del outs
            combined = comb.reshape(n, -1)[:, :slot.size].reshape(h.shape)
            new_x.append((combined + (h.to(torch.float32)
                                      - p.to(torch.float32))).to(h.dtype))
        inv_codes, inv_elems = self._ratios(layout)
        new_state = {"x_tilde": layout.from_leaf_rows(xt_rows),
                     "m_agg": layout.from_leaf_rows(m_rows)}
        return (T.tree_unflatten(layout.treedef, new_x), new_state,
                {"overflow_frac": clipped * inv_codes,
                 "residual_norm": torch.sqrt(residual_sq * inv_elems)})

    def _cdgd_mix(self, x_own, sent, j):
        """Node j's Eq. (5) mix: its own parameters uncompressed, its ring
        neighbours' as they arrive on the int8 wire (codes times scales)."""
        n = self.n_nodes
        (c_l, s_l), (c_r, s_r) = sent[_left(j, n)], sent[_right(j, n)]
        left = c_l.to(torch.float32) * s_l
        right = c_r.to(torch.float32) * s_r
        return (self.cfg.self_weight * x_own
                + self.cfg.side_weight * (left + right))

    def _cdgd_exchange_packed(self, x_prev, x_half, noise, layout):
        """Direct-compression DGD (paper Eq. (5), the negative control) on
        the packed int8 wire: one ``quantize_payload`` launch per node over
        the packed x_prev on the undecayed grid ``fixed_step0``; no
        combine kernel (there are no shadows)."""
        n = self.n_nodes
        xp = layout.pack(x_prev)
        step0 = float(np.float32(self.cfg.fixed_step0))
        pays = [kops.quantize_payload(xp[j], noise[j], fixed_step=step0)
                for j in range(n)]
        sent = [kops.unpack_payload(p, layout.block) for p in pays]
        mixed = torch.stack([self._cdgd_mix(xp[j], sent, j)
                             for j in range(n)])
        return T.tree_map(
            lambda m, h, p: (m + (h.to(torch.float32)
                                  - p.to(torch.float32))).to(h.dtype),
            layout.unpack(mixed, cast=False), x_half, x_prev)

    def _cdgd_exchange_per_leaf(self, x_prev, x_half, noise, layout):
        """Per-leaf reference of :meth:`_cdgd_exchange_packed`: per leaf
        and node one ``quantize_blocks`` launch; the same bits given the
        same noise buffer."""
        n = self.n_nodes
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
            mixed = torch.stack([self._cdgd_mix(xb[j], sent, j)
                                 for j in range(n)])
            mixed = mixed.reshape(n, -1)[:, :slot.size].reshape(h.shape)
            out.append((mixed + (h.to(torch.float32)
                                 - p.to(torch.float32))).to(h.dtype))
        return T.tree_unflatten(layout.treedef, out)

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


def _allreduce_mean_delta(x_prev, x_half):
    """Synchronous data parallelism: every node steps by the node-mean of
    the optimizer delta (the reference's rotation all-reduce).  The
    reference's ``x + s / n`` compiles to one fused multiply-add with
    float32(1/N)."""
    inv_n = float(recip(T.tree_leaves(x_half)[0].shape[0]))

    def avg(p, h):
        delta = (h - p).to(torch.float32)
        return _fma(_ring_sum(delta), inv_n, p.to(torch.float32)).to(h.dtype)

    return T.tree_map(avg, x_prev, x_half)


def _consensus_error(params) -> torch.Tensor:
    """(1/N) sum_i ||x_i - mean_nodes(x)||^2 over all leaves (a metric).

    In the reference's order: ``x - s / n`` is a fused multiply-add with
    float32(1/N); each node adds its leaves' sums of squares, the nodes'
    totals are added in node order, and the total is multiplied by
    float32(1/N).  Within a leaf the elements are added in PyTorch's order.
    """
    n = T.tree_leaves(params)[0].shape[0]
    inv_n = float(recip(n))
    per_node = None
    for x in T.tree_leaves(params):
        x = x.to(torch.float32)
        d = _fma(_ring_sum(x), -inv_n, x)
        e = (d * d).reshape(n, -1).sum(dim=1)
        per_node = e if per_node is None else per_node + e
    total = per_node[0]
    for i in range(1, n):
        total = total + per_node[i]
    return total * inv_n
