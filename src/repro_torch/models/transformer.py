"""Model assembly: parameter declarations, forward pass, training loss and
the decode cache.

Counterpart of ``repro.models.transformer`` on one device, in train,
prefill and decode mode: an optional prelude of unstacked layers, then a
period of blocks repeated ``n_periods`` times.
Each block is 'A' (global attention) or 'L' (sliding-window attention)
with a gated MLP, 'E' (global attention with the routed experts of
``models.moe``), 'D' (global attention with a dense MLP of width
``dense_d_ff``, deepseek's layer 0), 'M' (the Mamba2 block of
``models.mamba2``, with a gated MLP only when ``d_ff > 0``) or 'X' (Mamba2
with the routed experts, jamba's), with the reference's optional
post-norms (``norm1_post``/``norm2_post``).  The parameter tree has the
reference's structure and names — ``embed/{table, unembed}``,
``final_norm``, ``layers[j]/{attn|mamba,mlp|moe,norm1,norm2,...}``, one
tree per code ``j`` of the period whose leaves stack its ``n_periods``
layers on a leading axis, and ``prelude[i]``, one unstacked tree per
prelude layer — so the wire layout and the weight carry line up leaf for
leaf.  The reference scans the stacked periods with ``lax.scan``; here a
Python loop indexes them.  The MoE blocks' auxiliary losses are summed
over each period, then over the model (the reference's order), and
weighted into ``train_loss`` by ``cfg.router_aux_weight``.

The reference's precision and recompute options: ``build_defs(cfg,
dtype=)`` declares the parameters in the compute dtype (float32 or
bfloat16), ``model_apply``/``train_loss``/``greedy_decode_step`` take
``compute_dtype`` (the embeddings, an encoder-decoder's frames and
learned positions are cast to it; a prefill without a cache builds one of
that dtype), and in train ``remat`` recomputes in the backward what the
forward did not keep, as the reference's ``jax.checkpoint`` of its period
body: ``True`` (the default) keeps only each period's input, ``"dots"``
also the outputs of the matrix products without batch dimensions (the
reference's ``dots_with_no_batch_dims_saveable``: ``aten.mm`` and
``aten.addmm`` here), ``False`` keeps everything.  The prelude stays
outside, as outside the reference's ``scan``.  Recompute repeats the same
operations, so on the CPU every choice gives the same bits.

An encoder-decoder config (whisper-small) adds, as the reference does,
an encoder (``encoder/{layers[0], final_norm}``: 'A' blocks stacked over
``n_encoder_layers``, bidirectional, without RoPE, over the frames
``batch["enc_frames"]`` ``(b, T, d)`` plus sinusoidal positions) and
learned decoder positions ``pos_emb`` ``(32768, d)`` in place of RoPE;
every decoder block gains ``norm_cross`` and a ``cross`` attention from
the decoder stream to the encoder's output.  A batch without frames
skips the cross attention (train and prefill), as the reference's does.

``model_apply``/``train_loss``/``greedy_decode_step`` are functions of a
parameter tree; :class:`Transformer` is the ``nn.Module`` that owns such a
tree as parameters.  The decode cache has the reference's structure,
``{"layers": (entry, ...), "len"}``, one entry per code of the period
stacked over its layers, and with a prelude ``"prelude": (entry, ...)``,
one unstacked entry per prelude layer.  An attention block's entry is
``{"attn": {"k", "v"}}``, K and V ``(n_periods, b, S, kvh, hd)``, plus
``"cross": {"k", "v"}`` ``(n_periods, b, T, kvh, hd)`` for an
encoder-decoder (the encoder output's K and V, written whole by the
prefill and only read by decode steps); a Mamba2
block's is ``{"mamba": {"ssm", "conv": {"x", "b", "c"}}}``, its recurrent
state ``(n_periods, b, h, hd, N)`` and conv windows ``(n_periods, b, k-1,
width)``.  ``len`` (the number of cached positions) is a Python int, and a
decode step writes K and V, or the state and the shifted windows, into
the cache in place.  With ``long_serve`` the 'A' blocks attend within
``cfg.long_context_window`` positions (the reference's long-context
serving).

Tensor parallelism: ``build_defs(cfg, ctx=)`` with a process grid's
context at ``ctx.tp`` > 1 declares the reference's ``tp_dim`` of every
leaf (and the padded vocabulary and expert axis) and keeps the context in
the :class:`ModelDefs`; the forward, the loss, the decode step and the
cache then run on the rank's shards with the tp collectives of
``models.layers``, the prelude and the encoder as the periods.  It covers
every block ('A', 'L', 'E', 'D', 'M', 'X', whisper's encoder and cross
attention: ``models.moe`` runs the rank's experts, ``models.mamba2`` its
SSM heads) in float32; bfloat16 raises ``NotImplementedError`` (ROADMAP
Queue 1 item 5d-2).  ``init_cache`` holds the rank's kv heads
(head-sharded) or all of them (sequence-sharded), in the cross entries
too, whose sequence-sharded form keeps every frame on each rank (sharding
it over the frames is item 5d-4), and a Mamba2 block's state and ``x``
window at the rank's heads and channels.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core import tree as T
from repro_torch.models import mamba2, moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ONE_DEVICE, attention_defs,
                                       attention_forward, chunked_attention,
                                       combine_decode_partials,
                                       decode_attention_local, embed_defs,
                                       embed_lookup, logits_local, mlp_defs,
                                       mlp_forward, norm_def, rms_norm,
                                       sharded_greedy_sample,
                                       sharded_softmax_xent,
                                       sinusoidal_positions, head_sharded,
                                       kv_weights)
from repro_torch.models.params import ParamDef

__all__ = ["ModelDefs", "build_defs", "init_cache", "model_apply",
           "train_loss", "greedy_decode_step", "Transformer", "POS_EMB_ROWS",
           "check_remat"]


#: configuration features the reference supports and the port does not yet:
#: each is ``(description, predicate on the config)``
_UNPORTED = (
    ("MLP activations other than silu and gelu",
     lambda c: c.mlp_act not in ("silu", "gelu")),
)

#: rows of an encoder-decoder's learned decoder positions: the most
#: positions a decoder (and its cache) can hold
POS_EMB_ROWS = 32_768

#: the compute dtypes of the reference the port runs, and float64: not a
#: reference dtype, a measuring aid (a forward of the same weights in
#: float64 measures how far each side's rounding takes it)
COMPUTE_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def _dots_saveable(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of matrix products without batch
    dimensions, recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _block_defs(code: str, cfg: ModelConfig, cross: bool = False,
                dtype=torch.float32, ctx=ONE_DEVICE) -> dict:
    """One block: attention ('A', 'L', 'E', 'D') or Mamba2 ('M', 'X'),
    with ``cross`` a cross attention and its norm, then a dense MLP ('A',
    'L', and 'M' when ``d_ff > 0``), the routed experts ('E', 'X') or a
    dense MLP of width ``dense_d_ff`` ('D')."""
    d = {"norm1": norm_def(cfg, dtype)}
    if code in "ALED":
        d["attn"] = attention_defs(cfg, dtype, ctx)
    elif code in "MX":
        d["mamba"] = mamba2.mamba_defs(cfg, dtype, ctx)
    else:
        raise ValueError(f"unknown block code {code!r}")
    if cross:
        d["norm_cross"] = norm_def(cfg, dtype)
        d["cross"] = attention_defs(cfg, dtype, ctx)
    if code in "EX":
        d["norm2"] = norm_def(cfg, dtype)
        d["moe"] = moe.moe_defs(cfg, dtype, ctx)
    elif code == "D":
        d["norm2"] = norm_def(cfg, dtype)
        d["mlp"] = mlp_defs(cfg, d_ff=cfg.dense_d_ff, dtype=dtype, ctx=ctx)
    elif code in "AL" or (code == "M" and cfg.d_ff > 0):
        d["norm2"] = norm_def(cfg, dtype)
        d["mlp"] = mlp_defs(cfg, dtype=dtype, ctx=ctx)
    if cfg.post_norms:
        d["norm1_post"] = norm_def(cfg, dtype)
        if "norm2" in d:
            d["norm2_post"] = norm_def(cfg, dtype)
    return d


def _stack_defs(defs: Any, n: int) -> Any:
    """Add a leading stacking dim of size n to every ParamDef in the tree."""
    return T.tree_map(lambda d: dataclasses.replace(
        d, shape=(n,) + d.shape,
        tp_dim=None if d.tp_dim is None else d.tp_dim + 1,
        fsdp_dim=d.fsdp_dim + 1), defs)


@dataclasses.dataclass(frozen=True)
class ModelDefs:
    cfg: ModelConfig
    storage: Any            # full tree of (layer-stacked) ParamDefs
    #: the context the layers run in (a process grid's at tp > 1)
    ctx: Any = dataclasses.field(default=ONE_DEVICE, compare=False,
                                 repr=False)

    @property
    def tp(self) -> int:
        return self.ctx.tp


def _check_dtype(dtype) -> None:
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {dtype}")


def check_remat(remat) -> None:
    """ValueError unless ``remat`` is one of the reference's values: True
    (full recompute of each period), "dots" (keep the products without
    batch dimensions) or False (keep everything)."""
    if not (remat is True or remat is False or remat == "dots"):
        raise ValueError(f"remat must be True, 'dots' or False, got "
                         f"{remat!r}")


def build_defs(cfg: ModelConfig, dtype=torch.float32,
               ctx=None) -> ModelDefs:
    """The parameter tree of ``cfg`` with its leaves declared in ``dtype``
    (the compute dtype), as the reference's ``build_defs(cfg, ctx,
    dtype)``; ``ctx`` a process grid's context at tp > 1 (module
    docstring), else None: one device."""
    _check_dtype(dtype)
    missing = [what for what, used in _UNPORTED if used(cfg)]
    if missing:
        raise NotImplementedError(
            f"{cfg.arch_id}: {', '.join(missing)} not yet ported")
    ctx = ONE_DEVICE if ctx is None or ctx.tp == 1 else ctx
    if ctx.tp > 1:
        check_tp(cfg, ctx.tp, dtype)
    cross = cfg.is_encoder_decoder
    storage = {"embed": embed_defs(cfg, dtype, ctx),
               "layers": tuple(_stack_defs(_block_defs(c, cfg, cross, dtype,
                                                       ctx),
                                           cfg.n_periods)
                               for c in cfg.period),
               "final_norm": norm_def(cfg, dtype)}
    if cfg.prelude:
        storage["prelude"] = tuple(_block_defs(c, cfg, cross, dtype, ctx)
                                   for c in cfg.prelude)
    if cross:
        storage["pos_emb"] = ParamDef((POS_EMB_ROWS, cfg.d_model),
                                      scale=0.02, dtype=dtype)
        storage["encoder"] = {
            "layers": (_stack_defs(_block_defs("A", cfg, dtype=dtype,
                                               ctx=ctx),
                                   cfg.n_encoder_layers),),
            "final_norm": norm_def(cfg, dtype)}
    return ModelDefs(cfg=cfg, storage=storage, ctx=ctx)


def check_tp(cfg: ModelConfig, tp: int, dtype=torch.float32) -> None:
    """``NotImplementedError`` unless ``cfg`` at ``tp`` > 1 lies in the
    ported slice of tensor parallelism: every block family in float32
    (other compute dtypes are ROADMAP Queue 1 item 5d-2).  The widths that
    must split over ``tp`` raise ``ValueError`` where their leaves are
    declared: a dense MLP's ``d_ff`` (``layers.mlp_defs``), the shared
    experts' width (``moe.moe_defs``) and the SSM heads
    (``mamba2.mamba_defs``)."""
    if dtype != torch.float32:
        raise NotImplementedError(
            f"{cfg.arch_id} at tp={tp} in {dtype}: tensor parallelism runs "
            "float32; other compute dtypes are not yet ported (ROADMAP "
            "Queue 1 item 5d-2)")


def init_cache(cfg: ModelConfig, b: int, capacity: int,
               dtype=torch.float32, device=None,
               enc_len: int | None = None, tp: int = 1) -> dict:
    """Zeroed decode cache for ``b`` sequences of up to ``capacity``
    positions (before prefill); a Mamba2 block's entry does not grow with
    the positions.  An encoder-decoder's blocks also hold the cross K/V
    over ``enc_len`` frames (``cfg.encoder_frames`` when None), and its
    capacity is at most POS_EMB_ROWS (ValueError: the reference would read
    fill values past its learned positions).  At ``tp`` > 1 a rank's
    attention and cross caches hold its kv heads (head-sharded: ``kvh /
    tp``, or the one kv head its q heads use when ``kvh < tp``) or every
    kv head (sequence-sharded), and a Mamba2 block's state and ``x``
    window its heads and channels."""
    if cfg.is_encoder_decoder and capacity > POS_EMB_ROWS:
        raise ValueError(f"a cache of {capacity} positions exceeds the "
                         f"{POS_EMB_ROWS} learned decoder positions")

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def entry(code, *lead):
        if code in "MX":
            d_in, hd, h, n = mamba2._dims(cfg, tp)
            k = cfg.ssm_conv
            return {"mamba": {"ssm": zeros(*lead, b, h, hd, n),
                              "conv": {"x": zeros(*lead, b, k - 1, d_in),
                                       "b": zeros(*lead, b, k - 1, n),
                                       "c": zeros(*lead, b, k - 1, n)}}}
        kvh = cfg.n_kv_heads
        if tp > 1 and head_sharded(cfg, tp):
            kvh = max(kvh // tp, 1)
        kv = (kvh, cfg.resolved_head_dim)
        out = {"attn": {"k": zeros(*lead, b, capacity, *kv),
                        "v": zeros(*lead, b, capacity, *kv)}}
        if cfg.is_encoder_decoder:
            t = enc_len or cfg.encoder_frames
            out["cross"] = {"k": zeros(*lead, b, t, *kv),
                            "v": zeros(*lead, b, t, *kv)}
        return out

    cache = {"layers": tuple(entry(c, cfg.n_periods) for c in cfg.period),
             "len": 0}
    if cfg.prelude:
        cache["prelude"] = tuple(entry(c) for c in cfg.prelude)
    return cache


def _block_forward(code: str, p, x: torch.Tensor, cfg: ModelConfig, *,
                   mode: str, cache: dict | None, pos: int,
                   long_serve: bool, enc_out: torch.Tensor | None = None,
                   use_rope: bool = True, ctx=ONE_DEVICE):
    """One block: pre-norm attention or Mamba2, then the cross attention
    when the block has one and there are frames (``enc_out``) or their
    cached K/V, then the MLP or experts when the block has them, each with
    its post-norm when the config has them.  ``cache`` is the block's
    cache entry in decode, None otherwise.  Returns (x, the block's cache
    parts ``{"attn" | "mamba": ..., "cross": ...}``, its auxiliary loss:
    None but for 'E' and 'X')."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    part = "attn" if "attn" in p else "mamba"
    c_in = cache[part] if cache is not None else None
    if part == "attn":
        window = (cfg.long_context_window
                  if long_serve and code == "A" and cfg.long_context_window
                  else None)
        a, c = attention_forward(p["attn"], h, cfg, mode=mode, cache=c_in,
                                 pos=pos, kind=code, window_override=window,
                                 use_rope=use_rope, ctx=ctx)
    else:
        a, c = mamba2.mamba_forward(p["mamba"], h, cfg, mode=mode,
                                    cache=c_in, ctx=ctx)
    if cfg.post_norms:
        a = rms_norm(a, p["norm1_post"], cfg.norm_eps)
    x = x + a
    parts = {part: c}
    if "cross" in p and (enc_out is not None or
                         (cache is not None and "cross" in cache)):
        h = rms_norm(x, p["norm_cross"], cfg.norm_eps)
        a, parts["cross"] = _cross_attention(
            p["cross"], h, cfg, enc_out=enc_out,
            cache=cache["cross"] if mode == "decode" else None, ctx=ctx)
        x = x + a
    aux = None
    if "norm2" not in p:
        return x, parts, aux
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if "moe" in p:
        f, aux = moe.moe_forward(p["moe"], h, cfg, ctx)
    else:
        f = mlp_forward(p["mlp"], h, cfg, ctx)
    if cfg.post_norms:
        f = rms_norm(f, p["norm2_post"], cfg.norm_eps)
    return x + f, parts, aux


def _cross_attention(p, x: torch.Tensor, cfg: ModelConfig, *,
                     enc_out: torch.Tensor | None, cache: dict | None,
                     ctx=ONE_DEVICE):
    """Attention of the decoder stream ``x`` (b, s, d) over the encoder's
    frames: no RoPE, no q/k norm, no softcap, every frame visible.  With
    ``cache`` (decode) q attends over its K and V through the flash-decode
    kernel, and the same cache comes back; otherwise K and V are projected
    from ``enc_out`` (b, T, d), attended in the reference's blocks
    (``min(512, s)`` x ``min(1024, T)``) and returned as the cache
    ``{"k", "v"}``, each (b, T, kvh, hd).  Returns (out (b, s, d),
    cache).

    Head-sharded at ``ctx.tp`` > 1 (reference ``_cross_attention``): q on
    the rank's heads, K and V projected from the encoder's output on its
    kv heads (so the cache it writes is their own projection, contiguous
    for the flash-decode kernel), the output summed over the ranks.
    Sequence-sharded (``n_heads % tp != 0``): every weight is replicated
    and every rank computes every head over every frame, without a sum
    (the reference's replicated compute; its cache keeps every frame on
    each rank, where the reference's shards them, item 5d-4)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    if not head_sharded(cfg, ctx.tp):
        ctx = ONE_DEVICE
    tp = ctx.tp
    h = cfg.n_heads // tp
    x = ctx.copy_tp(x)
    wk, wv, kvh = kv_weights(p, cfg, ctx)
    q = (x @ p["wq"]).reshape(b, s, kvh, h // kvh, hd)
    if cache is not None:
        k, v = cache["k"], cache["v"]
        valid = torch.ones(k.shape[1], dtype=torch.bool, device=x.device)
        out = combine_decode_partials(
            *decode_attention_local(q, k, v, valid)).reshape(b, s, -1)
        return ctx.psum_tp(out.to(x.dtype) @ p["wo"]), cache
    t = enc_out.shape[1]
    enc_out = ctx.copy_tp(enc_out)
    k = (enc_out @ wk).reshape(b, t, kvh, hd)
    v = (enc_out @ wv).reshape(b, t, kvh, hd)
    out = chunked_attention(q, k, v, causal=False, chunk_q=min(512, s),
                            chunk_k=min(1024, t)).reshape(b, s, -1)
    return ctx.psum_tp(out @ p["wo"]), {"k": k, "v": v}


def _encoder_apply(params: Any, cfg: ModelConfig, frames: torch.Tensor,
                   ctx=ONE_DEVICE) -> torch.Tensor:
    """The encoder over frames (b, T, d): sinusoidal positions added, then
    ``n_encoder_layers`` pre-norm blocks of bidirectional attention
    without RoPE and the MLP, then the encoder's final norm; at ``ctx.tp``
    > 1 on the rank's heads (or frames, sequence-sharded) and ``d_ff``
    columns, as the decoder's blocks."""
    enc = params["encoder"]
    x = frames + sinusoidal_positions(frames.shape[1], frames.shape[2],
                                      device=frames.device
                                      )[None].to(frames.dtype)
    for layer in range(cfg.n_encoder_layers):
        p = T.tree_map(lambda a: a[layer], enc["layers"][0])
        a, _ = attention_forward(p["attn"], rms_norm(x, p["norm1"],
                                                     cfg.norm_eps),
                                 cfg, use_rope=False, causal=False, ctx=ctx)
        x = x + a
        x = x + mlp_forward(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps),
                            cfg, ctx)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def model_apply(params: Any, defs: ModelDefs, batch: dict, *,
                mode: str = "train", cache: dict | None = None,
                compute_dtype=torch.float32, remat=True,
                long_serve: bool = False, logits_from: int = 0):
    """Forward of tokens ``(b, s)``.  Returns (float32 logits ``(b, s -
    logits_from, V)`` of the positions from ``logits_from`` on, cache):

    * ``train``: the causal forward; the cache is None;
    * ``prefill``: the same, and the prompt's K and V written at positions
      ``[0, s)`` of ``cache`` (a new one of ``s`` positions when None),
      the Mamba2 blocks' final states and conv windows into theirs, an
      encoder-decoder's cross K/V over all the frames into theirs; the
      cache comes back with ``len = s``;
    * ``decode``: ``s`` = 1 token at position ``cache["len"]``, written
      into ``cache`` in place; the cache comes back with ``len + 1``.

    An encoder-decoder takes ``batch["enc_frames"]`` (b, T, d) in train
    and prefill; without them the cross attention is skipped, and a
    prefill's cache then comes back without its ``cross`` entries, so
    that decode skips it too.  Decode takes tokens only (ValueError).

    With Mamba2 blocks, train and prefill need ``s`` to be a multiple of
    ``min(ssm_chunk, s)`` (ValueError otherwise, where the reference
    asserts).

    ``long_serve`` caps the 'A' blocks' attention at
    ``cfg.long_context_window`` positions.  ``compute_dtype`` and
    ``remat`` (train only) are the reference's (module docstring).
    """
    logits, cache, _ = _apply(params, defs, batch, mode=mode,
                              cache=cache, compute_dtype=compute_dtype,
                              remat=remat, long_serve=long_serve,
                              logits_from=logits_from)
    return logits, cache


def _apply(params: Any, defs: ModelDefs, batch: dict, *,
           mode: str = "train", cache: dict | None = None,
           compute_dtype=torch.float32, remat=True,
           long_serve: bool = False, logits_from: int = 0):
    """:func:`model_apply`, returning (logits, cache, aux): the MoE blocks'
    auxiliary losses summed over each period and then over the periods,
    0 without MoE blocks."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got "
                         f"{mode!r}")
    _check_dtype(compute_dtype)
    check_remat(remat)
    cfg, ctx = defs.cfg, defs.ctx
    tokens = batch["tokens"]
    b, s = tokens.shape
    frames = batch.get("enc_frames") if cfg.is_encoder_decoder else None
    pos = 0
    if mode == "decode":
        if cache is None:
            raise ValueError("decode requires a cache")
        if frames is not None:
            raise ValueError("decode takes no enc_frames: the cross K/V "
                             "come from the prefill's cache")
        pos = cache["len"]
    if mode == "prefill" and cache is None:
        cache = init_cache(cfg, b, s, dtype=compute_dtype,
                           device=tokens.device,
                           enc_len=None if frames is None
                           else frames.shape[1], tp=defs.tp)
    if mode == "prefill":
        cap = min((e["attn"]["k"].shape[-3] for e in
                   cache["layers"] + cache.get("prelude", ()) if "attn" in e),
                  default=s)
        if s > cap:
            raise ValueError(f"prompt of {s} tokens exceeds the cache of "
                             f"{cap} positions")
        if frames is not None and any(
                e["cross"]["k"].shape[-3] != frames.shape[1]
                for e in cache["layers"] + cache.get("prelude", ())):
            raise ValueError(f"{frames.shape[1]} frames do not fill the "
                             "cache's cross K/V")
    x = embed_lookup(params["embed"], tokens, cfg, dtype=compute_dtype,
                     ctx=ctx)
    enc_out = None
    if cfg.is_encoder_decoder:
        if frames is not None:
            enc_out = _encoder_apply(params, cfg, frames.to(compute_dtype),
                                     ctx)
        x = x + params["pos_emb"][pos:pos + s][None].to(x.dtype)
    use_rope = not cfg.is_encoder_decoder

    def run(code, p, entry, x):
        """One block; in prefill its cache parts are written into
        ``entry``: K and V fill the prompt's positions (the cross K/V all
        the frames), a Mamba2 block's state and conv windows the whole of
        theirs, each cast to the cache's dtype."""
        x, parts, a = _block_forward(
            code, p, x, cfg, mode=mode,
            cache=entry if mode == "decode" else None, pos=pos,
            long_serve=long_serve, enc_out=enc_out, use_rope=use_rope,
            ctx=ctx)
        if mode == "prefill":
            for part, c in parts.items():
                for dst, src in zip(T.tree_leaves(entry[part]),
                                    T.tree_leaves(c)):
                    dst[:, :src.shape[1]] = src
        return x, a

    def period(x, layer):
        """The codes of period ``layer``: (x, their auxiliary losses
        summed)."""
        aux_p = torch.zeros((), device=tokens.device)
        for j, code in enumerate(cfg.period):
            p = T.tree_map(lambda a: a[layer], params["layers"][j])
            entry = (T.tree_map(lambda a: a[layer], cache["layers"][j])
                     if cache is not None else None)
            x, a = run(code, p, entry, x)
            if a is not None:
                aux_p = aux_p + a
        return x, aux_p

    aux = torch.zeros((), device=tokens.device)
    for i, code in enumerate(cfg.prelude):
        x, a = run(code, params["prelude"][i],
                   cache["prelude"][i] if cache is not None else None, x)
        if a is not None:
            aux = aux + a
    recompute = mode == "train" and remat is not False \
        and torch.is_grad_enabled()
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    _dots_saveable)
                  if remat == "dots" else None)
    for layer in range(cfg.n_periods):
        if recompute:
            x, aux_p = checkpoint(
                period, x, layer, use_reentrant=False,
                **({"context_fn": context_fn} if context_fn else {}))
        else:
            x, aux_p = period(x, layer)
        aux = aux + aux_p
    x = rms_norm(x[:, logits_from:], params["final_norm"], cfg.norm_eps)
    logits = logits_local(params["embed"], x, cfg, ctx)
    if mode == "train":
        return logits, None, aux
    cache = {**cache, "len": pos + s}
    if mode == "prefill" and cfg.is_encoder_decoder and frames is None:
        for key in ("layers", "prelude"):
            if key in cache:
                cache[key] = tuple({k: v for k, v in e.items()
                                    if k != "cross"} for e in cache[key])
    return logits, cache, aux


def train_loss(params: Any, defs: ModelDefs, batch: dict,
               compute_dtype=torch.float32, remat=True):
    """(loss, {"ce": ..., "aux": ...}): the cross-entropy plus
    ``cfg.router_aux_weight`` times the MoE blocks' auxiliary loss (0
    without MoE blocks, so loss == ce for dense models)."""
    logits, _, aux = _apply(params, defs, batch,
                            compute_dtype=compute_dtype, remat=remat)
    ce = sharded_softmax_xent(logits, batch["labels"], defs.ctx)
    return ce + defs.cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}


def greedy_decode_step(params: Any, defs: ModelDefs, tokens: torch.Tensor,
                       cache: dict, compute_dtype=torch.float32,
                       long_serve: bool = False):
    """One serving step: tokens ``(b, 1)`` -> (greedy next ids ``(b, 1)``
    int32, the cache advanced by one position, the step's logits ``(b,
    V)``; at tp > 1 the rank's vocabulary columns).  The reference
    returns the first two."""
    logits, cache = model_apply(params, defs, {"tokens": tokens},
                                mode="decode", cache=cache,
                                compute_dtype=compute_dtype,
                                long_serve=long_serve)
    return (sharded_greedy_sample(logits[:, -1:, :], defs.ctx), cache,
            logits[:, -1])


class _Tree(nn.Module):
    """A dict level of a parameter tree as a module: tensor entries are
    registered as Parameters sharing the tensors' storage, nested dicts
    as child modules, tuples as ModuleLists."""

    def __init__(self, tree: dict):
        super().__init__()
        self.keys_ = tuple(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            elif isinstance(v, (tuple, list)):
                self.add_module(k, nn.ModuleList([_Tree(c) for c in v]))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self) -> dict:
        out = {}
        for k in self.keys_:
            v = getattr(self, k)
            if isinstance(v, _Tree):
                out[k] = v.tree()
            elif isinstance(v, nn.ModuleList):
                out[k] = tuple(c.tree() for c in v)
            else:
                out[k] = v
        return out


class Transformer(nn.Module):
    """One node's model: owns a parameter tree (``embed``, ``final_norm``
    and the layer-stacked ``layers``, one tree per code of the period) as ``nn.Parameter``s named by their
    tree paths (``layers.0.attn.wq``).

    Built from an existing tree, each parameter shares that tensor's
    storage, so a stacked multi-node tree can hand node ``i``'s slice to a
    module without a copy.  ``forward(batch)`` returns ``train_loss`` at
    the module's ``compute_dtype`` and ``remat``."""

    def __init__(self, defs: ModelDefs, params: Any,
                 compute_dtype=torch.float32, remat=True):
        super().__init__()
        self.defs = defs
        self.compute_dtype, self.remat = compute_dtype, remat
        self.params = _Tree(params)

    def tree(self) -> Any:
        """The parameters in the reference's tree structure."""
        return self.params.tree()

    def forward(self, batch: dict):
        return train_loss(self.tree(), self.defs, batch,
                          compute_dtype=self.compute_dtype, remat=self.remat)
