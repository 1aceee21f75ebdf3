"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) block, on one device
or head-parallel over a node's ranks.

Counterpart of ``repro.models.mamba2``.  Separate projections give the gate ``z``, the inner ``x``,
one group of ``B`` and ``C`` (state width ``N``) and the per-head step
``dt``; ``x``, ``B`` and ``C`` each pass a depthwise causal conv of width
``ssm_conv`` and SiLU; then the selective scan, the skip ``D * x``, the
gate ``y * silu(z)``, an RMS norm over the whole of ``d_inner`` with ``(1
+ norm_w)``, and the output projection.

Train and prefill run the reference's chunked SSD scan: chunks of ``q =
min(ssm_chunk, s)`` positions (``s`` must be a multiple of ``q``, as the
reference asserts), each with its within-chunk decay matrix ``L`` from
:func:`_segsum`, the factorised contractions ``w = L * scores``, ``wd``,
``y_diag``, the incoming state's ``y_off`` and the state carried to the
next chunk; the chunks run in a Python loop, as the reference's
``lax.scan``.  Decode runs the exact one-token recurrence.  Everything is
plain PyTorch: the reference has no Pallas kernel here.

Precision is the reference's at any compute dtype: the projections and
the convs run in the compute dtype, ``dt`` and the gate ``z`` are float32
products (``layers.dot_f32``: the reference casts them to float32 right
away), the scan, the skip and the gated norm run in float32, and the norm's
output is rounded to the compute dtype before the output projection.
``a_log``, ``d_skip`` and ``dt_bias`` are float32 parameters at every
compute dtype.

The decode cache of one block is ``{"ssm": (b, h, hd, N), "conv": {"x":
(b, k-1, d_inner), "b": (b, k-1, N), "c": (b, k-1, N)}}``: the recurrent
state and the last ``k - 1`` raw (pre-conv) inputs of each conv.  Prefill
returns it, the state rounded to the compute dtype (the reference's);
a decode step reads the state in float32 and writes it in place in the
cache's dtype.

Head parallelism (``ctx.tp`` > 1, the reference's): a rank runs ``h /
tp`` heads and their ``d_inner / tp`` channels (``w_z``, ``w_x``, ``w_dt``
and ``conv_x`` split on their channel axis, ``w_out`` on its rows), while
``B`` and ``C`` (``w_b``, ``w_c``, ``conv_b``, ``conv_c``) are replicated
compute; ``a_log``, ``d_skip`` and ``dt_bias`` are replicated and sliced
to the rank's heads, ``norm_w`` to its channels.  The gated norm's
variance is the sum of ``y * y`` over the ranks' channels over ``d_inner``
(``psum_tp``, as the reference's), and the output projection is summed
over the ranks.  Every replicated leaf feeds the rank's heads only, so
each enters through ``ctx.copy_tp`` (its backward sums the ranks'
cotangents), as do the stream and the summed variance.  ``h % tp != 0``
raises ValueError, where the reference asserts.  The decode cache holds
the rank's heads' state ``(b, h / tp, hd, N)`` and conv window ``(b, k-1,
d_inner / tp)``; the ``b`` and ``c`` windows are whole on every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ONE_DEVICE, dot_f32, widen
from repro_torch.models.params import ParamDef

__all__ = ["mamba_defs", "mamba_forward", "chunk_len"]


def _dims(cfg: ModelConfig, tp: int = 1) -> tuple[int, int, int, int]:
    """(d_inner, head dim, heads, state width N), the widths a rank of
    ``tp`` holds: ``d_inner / tp`` and ``heads / tp`` (ValueError unless
    ``tp`` divides the heads)."""
    d_in, hd = cfg.d_inner, cfg.ssm_head_dim
    h = cfg.ssm_heads or d_in // hd
    if h % tp:
        raise ValueError(f"{cfg.arch_id}: {h} SSM heads do not split over "
                         f"tp={tp}")
    return d_in // tp, hd, h // tp, cfg.ssm_state


def mamba_defs(cfg: ModelConfig, dtype=torch.float32, ctx=ONE_DEVICE
               ) -> dict[str, ParamDef]:
    """The block's parameters in ``dtype`` with the reference's ``tp_dim``
    at ``ctx.tp``; ``a_log``, ``d_skip`` and ``dt_bias`` are float32 at
    every dtype, as in the reference."""
    d = cfg.d_model
    _dims(cfg, ctx.tp)          # ValueError unless tp splits the heads
    d_in, _, h, n = _dims(cfg)
    k = cfg.ssm_conv
    f32 = torch.float32
    return {"w_z": ParamDef((d, d_in), dtype=dtype, tp_dim=1),
            "w_x": ParamDef((d, d_in), dtype=dtype, tp_dim=1),
            "w_b": ParamDef((d, n), dtype=dtype),
            "w_c": ParamDef((d, n), dtype=dtype),
            "w_dt": ParamDef((d, h), dtype=dtype, tp_dim=1),
            "conv_x": ParamDef((k, d_in), scale=0.5, dtype=dtype, tp_dim=1),
            "conv_b": ParamDef((k, n), scale=0.5, dtype=dtype),
            "conv_c": ParamDef((k, n), scale=0.5, dtype=dtype),
            "a_log": ParamDef((h,), init="zeros", dtype=f32),
            "d_skip": ParamDef((h,), init="ones", dtype=f32),
            "dt_bias": ParamDef((h,), init="zeros", dtype=f32),
            "norm_w": ParamDef((d_in,), init="zeros", dtype=dtype),
            "w_out": ParamDef((d_in, d), dtype=dtype, tp_dim=0, fsdp_dim=1)}


def chunk_len(cfg: ModelConfig, s: int) -> int:
    """The scan's chunk ``q = min(ssm_chunk, s)``; raises ValueError
    unless ``s`` is a multiple of it."""
    q = min(cfg.ssm_chunk, s)
    if s % q:
        raise ValueError(f"{cfg.arch_id}: a sequence of {s} tokens is not a "
                         f"multiple of min(ssm_chunk, length) = {q}: the "
                         "Mamba2 blocks' chunked scan needs one")
    return q


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 cache: torch.Tensor | None):
    """Depthwise causal conv1d, then SiLU.  x: (b, s, c), w: (k, c).

    Returns (y, the last k - 1 inputs): ``cache`` (b, k-1, c) goes in
    front of ``x`` when given, zeros otherwise."""
    k, s = w.shape[0], x.shape[1]
    if cache is not None:
        xc = torch.cat([cache.to(x.dtype), x], dim=1)
    else:
        xc = F.pad(x, (0, 0, k - 1, 0))
    # y[t] = sum_j w[j] * xc[t + j]
    y = torch.zeros_like(x)
    for j in range(k):
        y = y + xc[:, j:j + s] * w[j]
    return F.silu(y), (xc[:, -(k - 1):] if k > 1 else None)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise sums, ``out[..., i, j] = sum_{j<k<=i}
    a[..., k]``, as the difference of a cumsum; -inf above the diagonal.
    a: (..., q) -> (..., q, q)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(q, device=a.device)
    return torch.where(ii[:, None] >= ii[None, :], diff, -torch.inf)


def _local(ctx, w: torch.Tensor, n: int) -> torch.Tensor:
    """The rank's ``n`` entries of the replicated vector ``w`` (its heads
    or channels), through ``copy_tp``."""
    return ctx.copy_tp(w)[ctx.tp_rank * n:(ctx.tp_rank + 1) * n]


def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig, mode: str = "train",
                  cache: dict | None = None, ctx=ONE_DEVICE):
    """x: (b, s, d), the same on every rank.  Returns (out (b, s, d),
    cache), at ``ctx.tp`` > 1 on the rank's heads (module docstring):

    * ``train``: the chunked scan from a zero state; no cache;
    * ``prefill``: the same, and the block's decode cache (the final state
      and the conv windows);
    * ``decode``: one token through the recurrence against ``cache``,
      whose state and conv windows are overwritten in place.
    """
    b, s, _ = x.shape
    d_in, hd, h, n = _dims(cfg, ctx.tp)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got "
                         f"{mode!r}")
    if mode == "decode" and (cache is None or s != 1):
        raise ValueError(f"decode takes one token and a cache, got {s} "
                         f"tokens and {'a' if cache else 'no'} cache")
    # every replicated leaf feeds the rank's heads only (module docstring)
    x = ctx.copy_tp(x)
    rep = {key: ctx.copy_tp(p[key])
           for key in ("w_b", "w_c", "conv_b", "conv_c")}
    z = dot_f32(x, p["w_z"])                                    # float32
    xi = x @ p["w_x"]
    bb = x @ rep["w_b"]
    cc = x @ rep["w_c"]
    dt = F.softplus(dot_f32(x, p["w_dt"])
                    + _local(ctx, p["dt_bias"], h))              # (b, s, h)
    a = -torch.exp(_local(ctx, p["a_log"], h))                  # (h,)
    d_skip = _local(ctx, p["d_skip"], h)

    conv = cache["conv"] if mode == "decode" else None
    xi, ncx = _causal_conv(xi, p["conv_x"], conv["x"] if conv else None)
    bb, ncb = _causal_conv(bb, rep["conv_b"], conv["b"] if conv else None)
    cc, ncc = _causal_conv(cc, rep["conv_c"], conv["c"] if conv else None)
    # the scan's operands in float32 (exact from the compute dtype)
    xh = widen(xi.reshape(b, s, h, hd))
    bb, cc = widen(bb), widen(cc)

    if mode == "decode":
        dt1 = dt[:, 0]                                          # (b, h)
        da = torch.exp(dt1 * a)
        dbx = ((dt1[:, :, None] * xh[:, 0])[..., None]
               * bb[:, 0][:, None, None, :])                    # (b,h,hd,n)
        ssm = widen(cache["ssm"]) * da[..., None, None] + dbx
        y = torch.einsum("bn,bhpn->bhp", cc[:, 0], ssm)
        y = y + d_skip[None, :, None] * xh[:, 0]
        out = _finish(p, y.reshape(b, 1, d_in), z, x.dtype, cfg, ctx)
        cache["ssm"].copy_(ssm)
        for key, new in (("x", ncx), ("b", ncb), ("c", ncc)):
            cache["conv"][key].copy_(new)
        return out, cache

    # ----- the chunked SSD scan (train / prefill) ------------------------
    q = chunk_len(cfg, s)
    nc = s // q
    xc = xh.reshape(b, nc, q, h, hd)
    bc = bb.reshape(b, nc, q, n)
    ccq = cc.reshape(b, nc, q, n)
    dtc = dt.reshape(b, nc, q, h)
    dac = dtc * a                                               # (b,nc,q,h)
    ssm = xh.new_zeros((b, h, hd, n))
    ys = []
    for c in range(nc):
        xq, bq, cq, dtq, daq = xc[:, c], bc[:, c], ccq[:, c], dtc[:, c], \
            dac[:, c]
        # within-chunk decay matrix L (b, h, q, q)
        L = torch.exp(_segsum(daq.transpose(1, 2)))
        scores = torch.einsum("bqn,bkn->bqk", cq, bq)           # (b, q, q)
        # the reference's factorised contractions: elementwise weights,
        # then one contraction over the key position each
        w = L * scores[:, None]                                 # (b,h,q,k)
        wd = w * dtq.transpose(1, 2)[:, :, None, :]             # dt at k
        y_diag = torch.einsum("bhqk,bkhp->bqhp", wd, xq)
        # the incoming state's contribution
        decay_in = torch.exp(torch.cumsum(daq, dim=1))          # (b, q, h)
        y_off = torch.einsum("bqn,bhpn->bqhp", cq, ssm) * decay_in[..., None]
        # the state at the chunk's end: the old one decayed, plus the
        # chunk's outer products decayed from each position to the end
        total = torch.exp(torch.sum(daq, dim=1))                # (b, h)
        decay_out = torch.exp(torch.sum(daq, dim=1)[:, None, :]
                              - torch.cumsum(daq, dim=1))
        xw = xq * (decay_out * dtq)[..., None]                  # (b,k,h,hd)
        state_new = torch.einsum("bkn,bkhp->bhpn", bq, xw)
        ssm = ssm * total[..., None, None] + state_new
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(b, s, h, hd)
    y = y + d_skip[None, None, :, None] * xh
    out = _finish(p, y.reshape(b, s, d_in), z, x.dtype, cfg, ctx)
    if mode == "prefill":
        return out, {"ssm": ssm.to(x.dtype),
                     "conv": {"x": ncx, "b": ncb, "c": ncc}}
    return out, None


def _finish(p, y: torch.Tensor, z: torch.Tensor, dtype: torch.dtype,
            cfg: ModelConfig, ctx=ONE_DEVICE) -> torch.Tensor:
    """Gate, RMS norm over the whole of d_inner with ``(1 + norm_w)``, all
    in float32, then rounded to ``dtype`` for the output projection.  At
    ``ctx.tp`` > 1 ``y`` holds the rank's channels: the variance is the
    ranks' summed squares over all of d_inner (reference ``_finish``) and
    the projection is summed over the ranks."""
    y = y * F.silu(z)
    d_loc = y.shape[-1]
    # the summed squares feed the rank's channels again: copy_tp
    var = ctx.copy_tp(ctx.psum_tp(y.square().sum(dim=-1, keepdim=True))
                      ) / (d_loc * ctx.tp)
    y = y * torch.rsqrt(var + cfg.norm_eps) * (
        1.0 + widen(_local(ctx, p["norm_w"], d_loc)))
    return ctx.psum_tp(y.to(dtype) @ p["w_out"])
