"""Model assembly: parameter declarations, forward pass, training loss and
the decode cache.

Counterpart of ``repro.models.transformer`` for dense attention models on
one device, in train, prefill and decode mode: a period of blocks, each
'A' (global attention) or 'L' (sliding-window attention) with a gated MLP,
repeated ``n_periods`` times, with the reference's optional post-norms
(``norm1_post``/``norm2_post``).  The parameter tree has the reference's
structure and names — ``embed/{table, unembed}``, ``final_norm`` and
``layers[j]/{attn,mlp,norm1,norm2,...}``, one tree per code ``j`` of the
period whose leaves stack its ``n_periods`` layers on a leading axis — so
the wire layout and the weight carry line up leaf for leaf.  The reference
scans the stacked periods with ``lax.scan`` under remat; here a Python
loop indexes them, and autograd keeps the activations (one node's fit on
the card).

``model_apply``/``train_loss``/``greedy_decode_step`` are functions of a
parameter tree; :class:`Transformer` is the ``nn.Module`` that owns such a
tree as parameters.  The decode cache has the reference's structure,
``{"layers": ({"attn": {"k", "v"}}, ...), "len"}``, one entry per code of
the period with K and V stacked over its layers, ``(n_periods, b, S, kvh,
hd)``; ``len`` (the number of cached positions) is a Python int, and a
decode step writes its K and V into the cache in place.  With
``long_serve`` the 'A' blocks attend within ``cfg.long_context_window``
positions (the reference's long-context serving).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.core import tree as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attention_defs, attention_forward,
                                       embed_defs, embed_lookup,
                                       logits_local, mlp_defs, mlp_forward,
                                       norm_def, rms_norm,
                                       sharded_greedy_sample,
                                       sharded_softmax_xent)

__all__ = ["ModelDefs", "build_defs", "init_cache", "model_apply",
           "train_loss", "greedy_decode_step", "Transformer"]


#: configuration features the reference supports and the port does not yet:
#: each is ``(description, predicate on the config)``
_UNPORTED = (
    ("layer codes other than 'A' and 'L' (attention + dense MLP)",
     lambda c: bool(set(c.period) - set("AL"))),
    ("prelude layers", lambda c: bool(c.prelude)),
    ("encoder-decoder stacks", lambda c: c.is_encoder_decoder),
    ("MLP activations other than silu and gelu",
     lambda c: c.mlp_act not in ("silu", "gelu")),
)


def _block_defs(cfg: ModelConfig) -> dict:
    """One 'A' or 'L' block (both hold the same parameters)."""
    d = {"norm1": norm_def(cfg), "attn": attention_defs(cfg),
         "norm2": norm_def(cfg), "mlp": mlp_defs(cfg)}
    if cfg.post_norms:
        d["norm1_post"] = norm_def(cfg)
        d["norm2_post"] = norm_def(cfg)
    return d


def _stack_defs(defs: Any, n: int) -> Any:
    """Add a leading stacking dim of size n to every ParamDef in the tree."""
    return T.tree_map(lambda d: dataclasses.replace(d, shape=(n,) + d.shape),
                      defs)


@dataclasses.dataclass(frozen=True)
class ModelDefs:
    cfg: ModelConfig
    storage: Any            # full tree of (layer-stacked) ParamDefs


def build_defs(cfg: ModelConfig) -> ModelDefs:
    missing = [what for what, used in _UNPORTED if used(cfg)]
    if missing:
        raise NotImplementedError(
            f"{cfg.arch_id}: {', '.join(missing)} not yet ported")
    storage = {"embed": embed_defs(cfg),
               "layers": tuple(_stack_defs(_block_defs(cfg), cfg.n_periods)
                               for _ in cfg.period),
               "final_norm": norm_def(cfg)}
    return ModelDefs(cfg=cfg, storage=storage)


def init_cache(cfg: ModelConfig, b: int, capacity: int,
               dtype=torch.float32, device=None) -> dict:
    """Zeroed decode cache for ``b`` sequences of up to ``capacity``
    positions (before prefill)."""
    shape = (cfg.n_periods, b, capacity, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"layers": tuple(
                {"attn": {"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype,
                                           device=device)}}
                for _ in cfg.period),
            "len": 0}


def _block_forward(code: str, p, x: torch.Tensor, cfg: ModelConfig, *,
                   mode: str, cache: dict | None, pos: int,
                   long_serve: bool):
    """One block: pre-norm attention and MLP, each with its post-norm when
    the config has them.  Returns (x, the attention's cache)."""
    window = (cfg.long_context_window
              if long_serve and code == "A" and cfg.long_context_window
              else None)
    a, c = attention_forward(p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps),
                             cfg, mode=mode, cache=cache, pos=pos, kind=code,
                             window_override=window)
    if cfg.post_norms:
        a = rms_norm(a, p["norm1_post"], cfg.norm_eps)
    x = x + a
    f = mlp_forward(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps), cfg)
    if cfg.post_norms:
        f = rms_norm(f, p["norm2_post"], cfg.norm_eps)
    return x + f, c


def model_apply(params: Any, defs: ModelDefs, batch: dict, *,
                mode: str = "train", cache: dict | None = None,
                long_serve: bool = False, logits_from: int = 0):
    """Forward of tokens ``(b, s)``.  Returns (float32 logits ``(b, s -
    logits_from, V)`` of the positions from ``logits_from`` on, cache):

    * ``train``: the causal forward; the cache is None;
    * ``prefill``: the same, and the prompt's K and V written at positions
      ``[0, s)`` of ``cache`` (a new one of ``s`` positions when None);
      the cache comes back with ``len = s``;
    * ``decode``: ``s`` = 1 token at position ``cache["len"]``, written
      into ``cache`` in place; the cache comes back with ``len + 1``.

    ``long_serve`` caps the 'A' blocks' attention at
    ``cfg.long_context_window`` positions.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got "
                         f"{mode!r}")
    cfg = defs.cfg
    tokens = batch["tokens"]
    b, s = tokens.shape
    pos = 0
    if mode == "decode":
        if cache is None:
            raise ValueError("decode requires a cache")
        pos = cache["len"]
    if mode == "prefill" and cache is None:
        cache = init_cache(cfg, b, s, device=tokens.device)
    if mode == "prefill" and s > cache["layers"][0]["attn"]["k"].shape[2]:
        raise ValueError(f"prompt of {s} tokens exceeds the cache of "
                         f"{cache['layers'][0]['attn']['k'].shape[2]} "
                         "positions")
    x = embed_lookup(params["embed"], tokens, cfg)
    for layer in range(cfg.n_periods):
        for j, code in enumerate(cfg.period):
            p = T.tree_map(lambda a: a[layer], params["layers"][j])
            kv = cache["layers"][j]["attn"] if cache is not None else None
            c = ({"k": kv["k"][layer], "v": kv["v"][layer]}
                 if mode == "decode" else None)
            x, c = _block_forward(code, p, x, cfg, mode=mode, cache=c,
                                  pos=pos, long_serve=long_serve)
            if mode == "prefill":
                kv["k"][layer, :, :s] = c["k"]
                kv["v"][layer, :, :s] = c["v"]
    x = rms_norm(x[:, logits_from:], params["final_norm"], cfg.norm_eps)
    logits = logits_local(params["embed"], x, cfg)
    if mode == "train":
        return logits, None
    return logits, {"layers": cache["layers"], "len": pos + s}


def train_loss(params: Any, defs: ModelDefs, batch: dict):
    """(loss, {"ce": ..., "aux": ...}); dense blocks have no auxiliary
    loss, so loss == ce."""
    logits, _ = model_apply(params, defs, batch)
    loss = sharded_softmax_xent(logits, batch["labels"])
    return loss, {"ce": loss, "aux": torch.zeros((), device=loss.device)}


def greedy_decode_step(params: Any, defs: ModelDefs, tokens: torch.Tensor,
                       cache: dict, long_serve: bool = False):
    """One serving step: tokens ``(b, 1)`` -> (greedy next ids ``(b, 1)``
    int32, the cache advanced by one position, the step's logits ``(b,
    V)``).  The reference returns the first two."""
    logits, cache = model_apply(params, defs, {"tokens": tokens},
                                mode="decode", cache=cache,
                                long_serve=long_serve)
    return sharded_greedy_sample(logits[:, -1:, :]), cache, logits[:, -1]


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
    module without a copy.  ``forward(batch)`` returns ``train_loss``."""

    def __init__(self, defs: ModelDefs, params: Any):
        super().__init__()
        self.defs = defs
        self.params = _Tree(params)

    def tree(self) -> Any:
        """The parameters in the reference's tree structure."""
        return self.params.tree()

    def forward(self, batch: dict):
        return train_loss(self.tree(), self.defs, batch)
