"""Model assembly: parameter declarations, forward pass and training loss.

Counterpart of ``repro.models.transformer`` for dense attention models
(period of 'A' blocks) in train mode on one device.  The parameter tree
has the reference's structure and names — ``embed/table``, ``final_norm``
and ``layers[0]/{attn,mlp,norm1,norm2}`` whose leaves stack all
``n_periods`` layers on a leading axis — so the wire layout and the weight
carry line up leaf for leaf.  The reference scans the stacked layers with
``lax.scan`` under remat; here a Python loop indexes them, and autograd
keeps the activations (one node's fit on the card).

``model_apply``/``train_loss`` are functions of a parameter tree;
:class:`Transformer` is the ``nn.Module`` that owns such a tree as
parameters.
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
                                       sharded_softmax_xent)

__all__ = ["ModelDefs", "build_defs", "model_apply", "train_loss",
           "Transformer"]


#: configuration features the reference supports and the port does not yet:
#: each is ``(description, predicate on the config)``
_UNPORTED = (
    ("layer periods other than 'A' (attention + dense MLP)",
     lambda c: c.period != "A"),
    ("prelude layers", lambda c: bool(c.prelude)),
    ("encoder-decoder stacks", lambda c: c.is_encoder_decoder),
    ("post-norms", lambda c: c.post_norms),
    ("q/k norms", lambda c: c.qk_norm),
    ("untied embeddings", lambda c: not c.tie_embeddings),
    ("softcaps", lambda c: c.attn_softcap is not None
     or c.final_softcap is not None),
    ("embedding scale", lambda c: c.embed_scale),
    ("MLP activations other than silu", lambda c: c.mlp_act != "silu"),
)


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
    block = {"norm1": norm_def(cfg), "attn": attention_defs(cfg),
             "norm2": norm_def(cfg), "mlp": mlp_defs(cfg)}
    storage = {"embed": embed_defs(cfg),
               "layers": (_stack_defs(block, cfg.n_periods),),
               "final_norm": norm_def(cfg)}
    return ModelDefs(cfg=cfg, storage=storage)


def model_apply(params: Any, defs: ModelDefs, batch: dict) -> torch.Tensor:
    """Train-mode forward: tokens ``(b, s)`` -> float32 logits
    ``(b, s, V)``."""
    cfg = defs.cfg
    x = embed_lookup(params["embed"], batch["tokens"])
    for layer in range(cfg.n_periods):
        p = T.tree_map(lambda a: a[layer], params["layers"][0])
        x = x + attention_forward(p["attn"],
                                  rms_norm(x, p["norm1"], cfg.norm_eps), cfg)
        x = x + mlp_forward(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_local(params["embed"], x)


def train_loss(params: Any, defs: ModelDefs, batch: dict):
    """(loss, {"ce": ..., "aux": ...}); dense blocks have no auxiliary
    loss, so loss == ce."""
    loss = sharded_softmax_xent(model_apply(params, defs, batch),
                                batch["labels"])
    return loss, {"ce": loss, "aux": torch.zeros((), device=loss.device)}


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
    and the layer-stacked ``layers``) as ``nn.Parameter``s named by their
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
