"""The ranks' work of ``test_torch_tp.py`` and of the family files beside
it (``test_torch_tp_moe.py``, ``test_torch_tp_ssm.py``,
``test_torch_tp_whisper.py``): a tensor-parallel grid.

A module of its own, free of JAX: ``launch.mesh.run_ranks`` spawns each
rank, which imports the module of the function it runs, so the ranks
import this one and never the reference.  The test process uses the same
helpers for the port's stacked (tp = 1) runs.

Every rank of ``N_NODES x tp`` runs, for each case, on the weights the
test drew with numpy (the full logical leaves of the config at the padded
vocabulary and expert axis, carried to the rank's slice by
``params_from_jax``), on its batch (an encoder-decoder's with its frames,
the serve prompts with theirs): the
train-mode logits and loss of its node's rows, its gradient, one
``algorithm="none"`` step, a prefill and ``DECODE`` greedy decode steps
over its node's tp group, and for the ADC cases ``ADC_STEPS`` trainer
steps of int8 packed ADC-DGD with every exchange's inputs kept, so that
the stacked runtime can replay them.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import tree as T
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import make_process_context
from repro_torch.models import transformer as TF
from repro_torch.models.layers import padded_vocab
from repro_torch.models.params import params_from_jax

N_NODES = 2
B, S, LR = 4, 48, 1e-2
SSM_S = 64
#: serving: prompts of PROMPT tokens (a multiple of every tp here), then
#: DECODE greedy steps
SERVE_B, PROMPT, DECODE = 2, 24, 6
ADC_STEPS, ADC_SEED = 3, 5


def config(case: dict, tp: int):
    """The case's reduced config at ``tp``: ``d_ff`` replaced when the case
    says so, and the vocabulary padded (``padded_vocab``) so that the same
    function runs at tp = 1 (ROADMAP hazard: the padded columns enter the
    softmax)."""
    cfg = reduced(get_config(case["arch"]))
    cfg = dataclasses.replace(cfg, **case.get("overrides", {}))
    return dataclasses.replace(cfg, vocab_size=padded_vocab(cfg, tp))


def seq_len(cfg) -> int:
    """The training sequence of ``cfg``: ``S``, or with Mamba2 blocks
    ``SSM_S``, a multiple of the reduced configs' scan chunk (32)."""
    return SSM_S if set(cfg.prelude + cfg.period) & set("MX") else S


def digest(t: torch.Tensor) -> str:
    a = t.detach().contiguous().cpu()
    return hashlib.sha1(a.reshape(-1).view(torch.uint8).numpy()
                        .tobytes()).hexdigest()


def setup_for(cfg, ctx=None, algorithm="none", n=N_NODES):
    return train.build_train_setup(
        cfg, consensus_nodes=None if ctx is not None else n,
        algorithm=algorithm, lr=LR, device="cpu", ctx=ctx,
        track_consensus_error=algorithm != "none", seed=ADC_SEED)


def _carry(weights, setup, ctx):
    return params_from_jax(weights, setup.defs.storage, "cpu", n_nodes=1,
                           tp=setup.defs.tp, tp_rank=ctx.tp_rank)


def _serve(cfg, weights, prompts, frames, ctx) -> dict:
    pre = serve.build_prefill_setup(cfg, device="cpu", ctx=ctx)
    srv = serve.build_serve_setup(cfg, device="cpu", ctx=ctx, keep_logits=1)
    params = params_from_jax(weights, pre.defs.storage, "cpu",
                             tp=pre.defs.tp, tp_rank=ctx.tp_rank)
    batch = {"tokens": torch.as_tensor(prompts)}
    if frames is not None:
        batch["enc_frames"] = torch.as_tensor(frames)
    ids, cache = pre.prefill_step(params, batch, PROMPT + DECODE)
    state = {"params": params, "cache": cache, "tokens": ids}
    out = [ids]
    for _ in range(DECODE):
        state = srv.serve_step(state)
        out.append(state["tokens"])
    return {"tokens": torch.cat(out, dim=1).numpy(),
            "cache_shapes": T.tree_map(lambda a: tuple(a.shape),
                                       {k: v for k, v in cache.items()
                                        if k != "len"})}


def _adc(cfg, weights, batches, ctx) -> dict:
    """``ADC_STEPS`` steps of int8 packed ADC-DGD; per step the optimizer's
    x_half (the exchange's input), and digests of what the exchange made:
    the payload bytes, x_next, x_tilde and m_agg."""
    setup = setup_for(cfg, ctx, "adc_dgd")
    rt = setup.consensus
    state = train.init_train_state(setup, params=_carry(weights, setup, ctx))
    pays = []
    encode = rt._encode_unit

    def spy(*args, **kw):
        out = encode(*args, **kw)
        pays.append([digest(p) for p in out])
        return out
    rt._encode_unit = spy
    exchange = rt.exchange
    halves = []

    def keep(x_prev, x_half, *args, **kw):
        halves.append([a.clone() for a in T.tree_leaves(x_half)])
        return exchange(x_prev, x_half, *args, **kw)
    rt.exchange = keep
    x0 = [a.clone() for a in T.tree_leaves(state["params"])]
    steps = []
    for k in range(ADC_STEPS):
        del pays[:]
        state, m = train.train_step(setup, state, batches[k])
        steps.append({
            "pays": list(pays),
            "x": [digest(a) for a in T.tree_leaves(state["params"])],
            "x_tilde": digest(state["consensus"]["x_tilde"]),
            "m_agg": digest(state["consensus"]["m_agg"]),
            "loss": m["loss"], "consensus_err": m["consensus_err"],
            "residual_norm": m["residual_norm"]})
    return {"x0": x0, "halves": halves, "steps": steps,
            "x_final": [a.clone() for a in T.tree_leaves(state["params"])]}


def grid(tp: int, cases: list) -> dict:
    """One rank of the ``N_NODES x tp`` grid: every case's results."""
    ctx = make_process_context("cpu", tp=tp)
    out = {"node": ctx.rank, "m": ctx.tp_rank}
    for case in cases:
        cfg = config(case, tp)
        setup = setup_for(cfg, ctx)
        params = _carry(case["weights"], setup, ctx)
        batch = case["batch"]
        rows = slice(ctx.rank * (B // N_NODES),
                     (ctx.rank + 1) * (B // N_NODES))
        node_batch = {k: torch.as_tensor(v[rows]) for k, v in batch.items()}
        p0 = T.tree_map(lambda a: a[0], params)
        with torch.no_grad():
            logits, _ = TF.model_apply(p0, setup.defs, node_batch)
        ctx.reset_tp_stats()
        losses, grads = train._node_grads(setup, params, batch)
        tp_stats = ctx.tp_stats()
        state = train.init_train_state(setup, params=params)
        state, metrics = train.train_step(setup, state, batch)
        res = {"logits": logits, "node_loss": float(losses[0]),
               "loss": metrics["loss"],
               "grads": [g[0] for g in T.tree_leaves(grads)],
               "params1": [a[0] for a in T.tree_leaves(state["params"])],
               "tp_stats": tp_stats,
               "serve": _serve(cfg, case["weights"], case["prompts"],
                               case.get("serve_frames"), ctx)}
        if case.get("adc"):
            res["adc"] = _adc(cfg, case["weights"], case["adc_batches"], ctx)
        out[case["name"]] = res
    return out
