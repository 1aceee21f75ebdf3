"""The reference's precision and recompute options on the port:
``compute_dtype``, ``cache_dtype`` and ``remat``, held to the JAX package
compiled at the same dtypes.

**bfloat16 against the reference.**  Both packages build the same
bfloat16 weights (the reference's ``init_params`` at ``dtype=bfloat16``,
norm leaves perturbed, carried by ``params_from_jax``) and run the same
tokens, one architecture per block kind at reduced size: smollm-135m
('A'), gemma2-9b ('L', softcaps, post-norms, the embedding scale),
granite-moe-3b-a800m ('E'), mamba2-1.3b ('M') and whisper-small (the
encoder-decoder, with frames).  The two sides round in other places (XLA
fuses and reorders; a bfloat16 product sums in another order), so their
bfloat16 outputs are not compared with each other.  Each is measured
against a float64 forward of the same bfloat16 weights and inputs (the
port's model at ``compute_dtype=float64``), as ``dist = max |x - x64| /
max |x64|`` over a tensor, and held so:

* the port to at most ``2 * dist_ref + FLOOR``.  ``FLOOR`` = 2^-9 is
  half a bfloat16 ulp at the tensor's largest value: one more rounding to
  bfloat16 than the reference makes;
* the reference to at most ``REF_BOUND`` = 2^-4 (it measured 0.012-0.052
  on these models: loss, gradients, prefill logits and caches, decode
  logits), so that the float64 forward is a meaningful yardstick.

An MoE router's top-k choice flips where rounding moves a near tie
(hazard 29), and a flipped choice moves its token by far more than
rounding; so the model runs granite's reduced config with every expert
routed (``top_k = n_experts``: its routing weights, combine order and
bfloat16 arithmetic are all there, but no choice can flip), and one MoE
layer with the real top-k is held to the reference on identical inputs,
where both route the same.

**Faults this slice repairs**, each failing on the tree before it:
``chunked_attention`` in bfloat16 (float32 scores and products, not
bfloat16 ones) within ``ATTN_ULPS`` of the jitted reference; ``Sgd`` and
``Momentum`` on bfloat16 leaves bitwise equal to the jitted reference's;
``sqrt(d_model)`` rounded to the table's dtype; the per-query-chunk
recompute of ``chunked_attention``'s backward (no score block is kept for
autograd).

**remat**: loss and every gradient bitwise equal between ``full``,
``dots`` and ``none`` at float32 and bfloat16, within the existing bounds
of the reference's ``jax.grad`` at ``remat=True``, and what each keeps for
the backward ordered ``full < dots < none``.

**The trainer at bfloat16** (a 4-host-device subprocess, as
``test_torch_train.py``: hazard 1), **checkpoints** of bfloat16 leaves in
the reference's ``'<V2'`` format, and **the CLIs'** new flags.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import functools
import json
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import wire as jwire
from repro.data import SyntheticLMDataset
from repro.models import layers as JL
from repro.models import moe as JMoE
from repro.models import transformer as JT
from repro.models.sharding import local_context
from repro_torch import optim
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.core import tree as T
from repro_torch.core import wire
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.launch import serve, train
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as TF
from repro_torch.models.params import init_params, meta_params
from repro_torch.models.params import params_from_jax

from test_torch_zoo import GRAD_RTOL, LOSS_RTOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CTX = local_context()
JBF, BF = jnp.bfloat16, torch.bfloat16
ARCHS = ("smollm-135m", "gemma2-9b", "granite-moe-3b-a800m", "mamba2-1.3b",
         "whisper-small")
#: sequences, prompt tokens (a multiple of reduced mamba2's chunk of 32,
#: longer than reduced gemma2's window of 64) and decode steps
B, P, DECODE = 4, 96, 4
#: the greedy test's prompts, and the positions it must compare: random
#: weights give flat logits, whose top-2 margins are mostly within
#: bfloat16 rounding, so it takes many sequences to find sure calls
B_GREEDY, MIN_GREEDY = 16, 8
FLOOR = 2.0 ** -9
REF_BOUND = 2.0 ** -4
#: chunked_attention in bfloat16 against the jitted reference: outputs
#: are bfloat16 roundings of float32 values that differ only in the order
#: of their float32 sums, so an output is at most one bfloat16 ulp off,
#: and rarely (ATTN_OFF_FRAC); scores rounded to bfloat16 move far more
ATTN_ULPS, ATTN_OFF_FRAC = 1, 0.01
CACHE_DTYPES = {"cache-bf16": BF, "cache-f32": torch.float32}
#: the bfloat16 trainer's own loss and gradients against the reference's
#: at the same weights: both are bfloat16 forwards, each ~1e-4 of the loss
#: and 0.01-0.05 of a leaf's largest gradient from a float64 one (the
#: model tests above), so they are held to their sum and a margin
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-3, 0.125


def _f64(a) -> np.ndarray:
    return (a.detach().double().numpy() if torch.is_tensor(a)
            else np.asarray(a, np.float64))


def dist(x, x64) -> float:
    """max |x - x64| / max |x64|, in float64."""
    x, x64 = _f64(x), _f64(x64)
    scale = np.max(np.abs(x64))
    return float(np.max(np.abs(x - x64)) / (scale if scale else 1.0))


def held(what, port, ref, x64):
    """The port within 2 * the reference's distance + FLOOR of the float64
    values, and the reference within REF_BOUND."""
    d_ref, d_port = dist(ref, x64), dist(port, x64)
    assert d_ref <= REF_BOUND, (what, d_ref)
    assert d_port <= 2 * d_ref + FLOOR, (what, d_port, d_ref)
    return d_ref, d_port


def _np(a):
    """A JAX array (bfloat16 too) as float32 numpy."""
    return np.asarray(jnp.asarray(a, jnp.float32))


def _configs(arch):
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    if cfg.n_experts:
        # every expert routed: no top-k choice can flip (module doc)
        jcfg = dataclasses.replace(jcfg, top_k=jcfg.n_experts)
        cfg = dataclasses.replace(cfg, top_k=cfg.n_experts)
    return jcfg, cfg


def _perturb_norms(jparams):
    """Non-zero norm weights, each leaf its own draw, in the leaf's
    dtype."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(jparams)
    return jax.tree_util.tree_unflatten(treedef, [
        (a + 0.1 * jax.random.normal(jax.random.PRNGKey(1 + i), a.shape)
         ).astype(a.dtype) if "norm" in jax.tree_util.keystr(p) else a
        for i, (p, a) in enumerate(leaves)])


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg, cfg = _configs(arch)
    jdefs = JT.build_defs(jcfg, CTX, dtype=JBF)
    jparams = _perturb_norms(JT.init_params(jdefs, jax.random.PRNGKey(0),
                                            CTX))
    defs = TF.build_defs(cfg, dtype=BF)
    params = params_from_jax(jax.device_get(jparams), defs.storage,
                             device="cpu")
    p64 = T.tree_map(lambda a: a.double(), params)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, P + DECODE), dtype=np.int32)
    frames = (rng.standard_normal((B, cfg.encoder_frames, cfg.d_model),
                                  dtype=np.float32)
              if cfg.is_encoder_decoder else None)
    return dict(jcfg=jcfg, cfg=cfg, jdefs=jdefs, jparams=jparams, defs=defs,
                params=params, p64=p64, tokens=tokens, frames=frames)


def _batches(m, tokens):
    """(the reference's batch, the port's) of ``tokens`` with the model's
    frames."""
    jb, tb = {"tokens": jnp.asarray(tokens)}, {
        "tokens": torch.from_numpy(tokens)}
    if m["frames"] is not None:
        jb["enc_frames"] = jnp.asarray(m["frames"])
        tb["enc_frames"] = torch.from_numpy(m["frames"])
    return jb, tb


def test_params_carry_bfloat16_and_float32_leaves(model):
    """Every leaf in bfloat16 bit for bit, but Mamba2's ``a_log``,
    ``d_skip`` and ``dt_bias``, float32 at every compute dtype; the
    port's own ``init_params`` declares the same dtypes."""
    jl = jax.tree_util.tree_leaves_with_path(model["jparams"])
    tl, _ = T.tree_flatten_with_path(model["params"])
    own = T.tree_leaves(init_params(model["defs"].storage, 0, "cpu"))
    for (jp, a), (p, b), c in zip(jl, tl, own):
        f32 = p.split("'")[-2] in ("a_log", "d_skip", "dt_bias")
        assert b.dtype == c.dtype == (torch.float32 if f32 else BF), p
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(_np(a), b.float().numpy())


def test_bf16_train_loss_and_grads(model):
    """Loss and every gradient at bfloat16 (the reference's ``jax.grad``
    of ``train_loss`` at ``remat=True``, the port's at its default
    ``remat=True``) against a float64 forward/backward of the same
    weights."""
    cfg = model["cfg"]
    kw = ({"enc_frames": cfg.encoder_frames, "d_model": cfg.d_model}
          if cfg.is_encoder_decoder else {})
    batch = SyntheticLMDataset(cfg.vocab_size, P, B, seed=3, **kw).batch(0)
    jdefs = model["jdefs"]
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.train_loss(p, jdefs, b, CTX, compute_dtype=JBF),
        has_aux=True))(model["jparams"],
                       {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = {}
    for name, params, dtype in (("port", model["params"], BF),
                                ("f64", model["p64"], torch.float64)):
        module = TF.Transformer(model["defs"], params, compute_dtype=dtype)
        loss, _ = module(tb)
        got[name] = (loss, torch.autograd.grad(loss,
                                               T.tree_leaves(module.tree())))
    held("loss", got["port"][0], float(jloss), got["f64"][0])
    paths = [p for p, _ in T.tree_flatten_with_path(model["params"])[0]]
    for path, g, jg, g64, leaf in zip(
            paths, got["port"][1], jax.tree_util.tree_leaves(jgrads),
            got["f64"][1], T.tree_leaves(model["params"])):
        assert g.dtype == leaf.dtype and g.shape == jg.shape
        held(path, g, _np(jg), g64)


def _jax_cache(jc, capacity, dtype):
    """The reference's prefill cache (compute dtype, the prompt's length)
    as its caller serves it: padded to ``capacity`` positions and cast to
    ``dtype``."""
    def pad(path, a):
        key = jax.tree_util.keystr(path)
        if "['attn']" in key and a.ndim == 5:
            a = jnp.pad(a, [(0, 0), (0, 0), (0, capacity - a.shape[2]),
                            (0, 0), (0, 0)])
        return a.astype(dtype) if a.dtype != jnp.int32 else a
    return jax.tree_util.tree_map_with_path(pad, jc)


def _cache_leaves(cache):
    return {k: T.tree_leaves(cache[k]) for k in ("layers", "prelude")
            if k in cache}


def test_bf16_prefill_logits_and_caches(model):
    """Prefill at bfloat16: the last position's logits and every cache
    leaf (K and V, an encoder-decoder's cross K/V, a Mamba2 block's state
    and conv windows), each in the compute dtype, against the float64
    prefill."""
    jb, tb = _batches(model, model["tokens"][:, :P])
    jl, jc, _ = jax.jit(lambda p, b: JT.model_apply(
        p, model["jdefs"], b, CTX, mode="prefill", compute_dtype=JBF))(
        model["jparams"], jb)
    with torch.inference_mode():
        tl, tc = TF.model_apply(model["params"], model["defs"], tb,
                                mode="prefill", compute_dtype=BF)
        l64, c64 = TF.model_apply(model["p64"], model["defs"], tb,
                                  mode="prefill", compute_dtype=torch.float64)
    assert tl.dtype == torch.float32 and jl.dtype == jnp.float32
    held("prefill logits", tl, _np(jl), l64)
    want = jax.tree_util.tree_leaves(jc["layers"])
    got, got64 = T.tree_leaves(tc["layers"]), T.tree_leaves(c64["layers"])
    assert len(want) == len(got) == len(got64)
    for w, g, g64 in zip(want, got, got64):
        assert g.dtype == BF and w.dtype == JBF and g.shape == w.shape
        held("prefill cache", g, _np(w), g64)


def _decode_runs(m, cache_dtype):
    """Prefill of P tokens, then DECODE teacher-forced decode steps into a
    cache of ``cache_dtype`` at bfloat16 compute: the logits of each step
    from the reference and the port, the port's cache, and the float64
    train-mode forward's logits at the same positions."""
    seq, cap = m["tokens"], P + DECODE
    jb, tb = _batches(m, seq[:, :P])
    jdefs = m["jdefs"]
    _, jc, _ = JT.model_apply(m["jparams"], jdefs, jb, CTX, mode="prefill",
                              compute_dtype=JBF)
    jc = _jax_cache(jc, cap, {BF: JBF, torch.float32: jnp.float32}[
        cache_dtype])
    jstep = jax.jit(lambda p, tok, c: JT.model_apply(
        p, jdefs, {"tokens": tok}, CTX, mode="decode", cache=c,
        compute_dtype=JBF, remat=False)[:2])
    pre = serve.build_prefill_setup(m["cfg"], device="cpu",
                                    compute_dtype=BF)
    _, cache = pre.prefill_step(m["params"], tb, cap, cache_dtype)
    want, got = [], []
    with torch.inference_mode():
        for t in range(P, cap):
            tok = seq[:, t:t + 1]
            jl, jc = jstep(m["jparams"], jnp.asarray(tok), jc)
            tl, cache = TF.model_apply(m["params"], m["defs"],
                                       {"tokens": torch.from_numpy(tok)},
                                       mode="decode", cache=cache,
                                       compute_dtype=BF)
            want.append(_np(jl[:, 0]))
            got.append(tl[:, 0].numpy())
        _, tb_all = _batches(m, _padded(m["cfg"], seq))
        l64, _ = TF.model_apply(m["p64"], m["defs"], tb_all,
                                compute_dtype=torch.float64,
                                logits_from=P)
    return np.stack(want, 1), np.stack(got, 1), cache, l64[:, :DECODE]


@pytest.mark.parametrize("cache_dtype", list(CACHE_DTYPES.values()),
                         ids=list(CACHE_DTYPES))
def test_bf16_decode_steps(model, cache_dtype):
    """DECODE decode steps at bfloat16 compute, the cache in bfloat16 and
    in float32: logits against the float64 forward, and every cache leaf
    in the cache's dtype (K and V written so, a Mamba2 state rounded
    there)."""
    want, got, cache, l64 = _decode_runs(model, cache_dtype)
    held("decode logits", got, want, l64)
    for leaves in _cache_leaves(cache).values():
        assert all(a.dtype == cache_dtype for a in leaves)
    assert cache["len"] == P + DECODE


def _padded(cfg, seq):
    """``seq`` padded with token 0 after its positions to a length a Mamba2
    model's chunked scan takes (a multiple of its chunk); as it is
    otherwise.  A causal forward's logits at the first positions do not
    see the padding."""
    if set(cfg.prelude + cfg.period) & set("MX"):
        seq = np.pad(seq, ((0, 0), (0, -seq.shape[1] % cfg.ssm_chunk)))
    return seq


def test_bf16_greedy_tokens(model):
    """Prefill and DECODE greedy steps of B_GREEDY prompts through the
    serve setups at bfloat16 compute and cache, against the reference's
    greedy tokens.  A float64 forward along the reference's tokens gives
    each step's logits; each side's logits lie within its measured
    distance of them, so wherever the float64 top-2 margin exceeds twice
    the larger distance (times the largest logit) both pick the float64
    token.  Each sequence is compared up to its first closer call, after
    which the two may go apart."""
    m = model
    cap = P + DECODE + 1
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, m["cfg"].vocab_size, (B_GREEDY, P),
                           dtype=np.int32)
    gm = dict(m, frames=None if m["frames"] is None else rng.standard_normal(
        (B_GREEDY,) + m["frames"].shape[1:], dtype=np.float32))
    jb, tb = _batches(gm, prompts)
    jdefs = m["jdefs"]
    jl, jc, _ = JT.model_apply(m["jparams"], jdefs, jb, CTX, mode="prefill",
                               compute_dtype=JBF)
    jc = _jax_cache(jc, cap, JBF)
    jstep = jax.jit(lambda p, tok, c: JT.model_apply(
        p, jdefs, {"tokens": tok}, CTX, mode="decode", cache=c,
        compute_dtype=JBF, remat=False)[:2])
    ref = [_np(jl[:, -1])]
    for _ in range(DECODE):
        tok = jnp.asarray(ref[-1].argmax(-1).astype(np.int32)[:, None])
        jl, jc = jstep(m["jparams"], tok, jc)
        ref.append(_np(jl[:, 0]))
    ref = np.stack(ref, 1)                              # (B, 1 + DECODE, V)
    want = ref.argmax(-1)
    pre = serve.build_prefill_setup(m["cfg"], device="cpu",
                                    compute_dtype=BF)
    srv = serve.build_serve_setup(m["cfg"], device="cpu", compute_dtype=BF,
                                  cache_dtype=BF, keep_logits=B_GREEDY)
    first, cache = pre.prefill_step(m["params"], tb, cap, srv.cache_dtype)
    with torch.inference_mode():
        l0, _ = TF.model_apply(m["params"], m["defs"], tb, mode="prefill",
                               compute_dtype=BF, logits_from=P - 1)
    state = {"params": m["params"], "cache": cache, "tokens": first}
    got, port = [first.numpy()], [l0[:, 0].numpy()]
    for _ in range(DECODE):
        state = srv.serve_step(state)
        got.append(state["tokens"].numpy())
        port.append(state["logits"].numpy())
    got, port = np.concatenate(got, 1), np.stack(port, 1)
    # the float64 logits along the reference's tokens
    seq = np.concatenate([prompts, want[:, :-1]], 1)
    _, tseq = _batches(gm, _padded(m["cfg"], seq))
    with torch.inference_mode():
        l64, _ = TF.model_apply(m["p64"], m["defs"], tseq,
                                compute_dtype=torch.float64,
                                logits_from=P - 1)
    l64 = l64[:, :1 + DECODE].numpy()
    # the port's logits count where its context is the reference's
    same = np.concatenate([np.ones((B_GREEDY, 1), bool), np.cumprod(
        got[:, :-1] == want[:, :-1], axis=1).astype(bool)], 1)
    d_ref = dist(ref, l64)
    d_port = dist(port[same], l64[same])
    assert d_port <= 2 * d_ref + FLOOR, (d_port, d_ref)
    top2 = np.sort(l64, -1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]
            > 2 * max(d_ref, d_port) * np.abs(l64).max())
    compared = 0
    for b in range(B_GREEDY):
        for t in range(1 + DECODE):
            if not sure[b, t]:
                break
            assert got[b, t] == want[b, t] == l64[b, t].argmax(), (b, t)
            compared += 1
    assert compared >= MIN_GREEDY, (compared, d_ref, d_port)


def test_moe_layer_top_k_matches_reference_bf16():
    """One MoE layer of reduced granite with its real top-2 of 4 experts
    on identical bfloat16 inputs: the same routing as the reference's and
    as a float64 forward's (the router's product is float32 on both
    sides), the auxiliary loss to float32 rounding, and the output held
    as the models' are (the reference's combine adds the kept experts'
    rows in ascending expert id, rounded to bfloat16 at each add; the
    port's gathers add in that order)."""
    jcfg = jreduced(jget_config("granite-moe-3b-a800m"))
    cfg = reduced(get_config("granite-moe-3b-a800m"))
    jdefs = JMoE.moe_defs(jcfg, CTX, JBF)
    leaves, treedef = jax.tree_util.tree_flatten(
        jdefs, is_leaf=lambda d: hasattr(d, "tp_dim"))
    keys = jax.random.split(jax.random.PRNGKey(4), len(leaves))
    jp = jax.tree_util.tree_unflatten(treedef, [
        (jax.random.normal(k, d.shape) / np.sqrt(d.shape[-2])).astype(JBF)
        for k, d in zip(keys, leaves)])
    x = jax.random.normal(jax.random.PRNGKey(5), (2, 48, cfg.d_model)
                          ).astype(JBF)
    jout, jaux = jax.jit(lambda p, x: JMoE.moe_forward(p, x, jcfg, CTX))(
        jp, x)
    p = params_from_jax(jax.device_get(jp), M.moe_defs(cfg, BF), "cpu")
    xt = torch.tensor(_np(x)).to(BF)
    out, aux = M.moe_forward(p, xt, cfg)
    p64 = T.tree_map(lambda a: a.double(), p)
    out64, _ = M.moe_forward(p64, xt.double(), cfg)
    jprobs = jax.nn.softmax((x.reshape(-1, cfg.d_model) @ jp["router"]
                             ).astype(jnp.float32), axis=-1)
    jtop = np.asarray(jax.lax.top_k(jprobs, cfg.top_k)[1])
    for params, xx in ((p, xt), (p64, xt.double())):
        r = M.route(params["router"], xx.reshape(-1, cfg.d_model), cfg)
        np.testing.assert_array_equal(r.top_e.numpy(), jtop)
    assert out.dtype == BF
    held("moe layer", out, _np(jout), out64)
    assert float(aux) == pytest.approx(float(jaux), rel=LOSS_RTOL)


# ----- the faults this slice repairs ---------------------------------------

def _bf16_ulps(a, b):
    """Elementwise distance in bfloat16 ulps (of two bfloat16 arrays)."""
    def ordered(x):
        i = torch.as_tensor(np.asarray(x, np.float32)).to(BF).view(
            torch.int16).numpy().astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("softcap,window", [(None, None), (30.0, 24)],
                         ids=["plain", "softcap-window"])
def test_chunked_attention_bf16_matches_jitted_reference(softcap, window):
    """bfloat16 q, K and V over 4 x 2 blocks: the reference's products
    take bfloat16 operands with float32 results, its softmax is float32,
    and the output is rounded to bfloat16 once; the port's outputs are
    within ATTN_ULPS of the jitted reference's, and off in at most
    ATTN_OFF_FRAC of them (float32 sums in another order).  Scores rounded
    to bfloat16 (the tree before this slice) put most outputs further
    off."""
    rng = np.random.default_rng(11)
    b, s, kvh, g, hd = 2, 64, 2, 2, 32
    q = jnp.asarray(rng.standard_normal((b, s, kvh, g, hd)), JBF)
    k = jnp.asarray(rng.standard_normal((b, s, kvh, hd)), JBF)
    v = jnp.asarray(rng.standard_normal((b, s, kvh, hd)), JBF)
    kw = dict(softcap=softcap, window=window, chunk_q=16, chunk_k=32)
    want = _np(jax.jit(lambda q, k, v: JL.chunked_attention(q, k, v, **kw))(
        q, k, v))
    got = L.chunked_attention(*(torch.tensor(_np(a)).to(BF)
                                for a in (q, k, v)), **kw)
    assert got.dtype == BF
    ulps = _bf16_ulps(got.float().numpy(), want)
    assert ulps.max() <= ATTN_ULPS, ulps.max()
    assert (ulps > 0).mean() <= ATTN_OFF_FRAC, (ulps > 0).mean()


OPTIMIZERS = {"sgd": (joptim.Sgd(), optim.Sgd()),
              "sgd-wd": (joptim.Sgd(weight_decay=0.01),
                         optim.Sgd(weight_decay=0.01)),
              "momentum": (joptim.Momentum(), optim.Momentum()),
              "nesterov": (joptim.Momentum(nesterov=True),
                           optim.Momentum(nesterov=True)),
              "momentum-wd": (joptim.Momentum(weight_decay=0.01),
                              optim.Momentum(weight_decay=0.01))}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizers_on_bf16_leaves_bitwise(name):
    """Three steps of each optimizer on bfloat16 leaves, bitwise equal to
    the jitted reference's (float32 leaves keep their float32 arithmetic,
    which XLA contracts into fused multiply-adds: hazard 8): its learning
    rate is a
    float32 array, so ``p - lr * d`` is float32 arithmetic rounded once,
    and its ``beta`` and ``weight_decay`` are weak Python constants,
    rounded to bfloat16 (``Momentum``'s ``m`` stays bfloat16)."""
    jopt, opt = OPTIMIZERS[name]
    rng = np.random.default_rng(2)
    shapes = {"w": (256, 384), "b": (384,)}
    jp = {k: jnp.asarray(rng.standard_normal(s), JBF)
          for k, s in shapes.items()}
    p = {k: torch.tensor(_np(a)).to(BF) for k, a in jp.items()}
    jsched = joptim.constant_schedule(3e-2)
    sched = optim.schedules.constant_schedule(3e-2)
    jstep = jax.jit(lambda st, p, g, lr: jopt.step(st, p, g, lr))
    jst, st = jopt.init(jp), opt.init(p)
    for k in range(1, 4):
        jg = {kk: jnp.asarray(rng.standard_normal(a.shape) * 0.5, a.dtype)
              for kk, a in jp.items()}
        g = {kk: torch.tensor(_np(a)).to(p[kk].dtype) for kk, a in jg.items()}
        jp, jst = jstep(jst, jp, jg, jsched(jnp.asarray(k, jnp.int32)))
        p, st = opt.step(st, p, g, sched(k))
        for kk in jp:
            assert p[kk].dtype == BF
            np.testing.assert_array_equal(p[kk].float().numpy(),
                                          _np(jp[kk]))
        if "m" in st:
            for kk in jp:
                assert st["m"][kk].dtype == p[kk].dtype
                np.testing.assert_array_equal(st["m"][kk].float().numpy(),
                                              _np(jst["m"][kk]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_scale_rounds_in_table_dtype(dtype):
    """gemma2-9b's ``sqrt(3584)`` = 59.866 is rounded to the table's dtype
    before it scales the rows (59.75 in bfloat16), bitwise as the jitted
    reference's ``embed_lookup``."""
    jcfg, cfg = jget_config("gemma2-9b"), get_config("gemma2-9b")
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (JBF, BF)}[dtype]
    rng = np.random.default_rng(3)
    table = jnp.asarray(rng.standard_normal((64, cfg.d_model)), jdt)
    ids = jnp.asarray(rng.integers(0, 64, (2, 8)), jnp.int32)
    want = jax.jit(lambda t, i: JL.embed_lookup({"table": t}, i, jcfg, CTX,
                                                dtype=jdt))(table, ids)
    got = L.embed_lookup({"table": torch.tensor(_np(table)).to(tdt)},
                         torch.from_numpy(np.asarray(ids)), cfg, dtype=tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), _np(want))
    scale = float(torch.tensor(np.sqrt(cfg.d_model), dtype=tdt))
    assert scale == {"float32": np.float32(np.sqrt(3584)),
                     "bfloat16": 59.75}[dtype]


def _saved_shapes(fn):
    """Shapes of the tensors autograd keeps for the backward of ``fn()``
    outside any checkpointed region (a checkpoint keeps its inputs)."""
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, shapes


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
def test_chunked_attention_recompute_is_bitwise_and_keeps_no_scores(
        dtype, monkeypatch):
    """With several query chunks and autograd recording, each query chunk
    runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` of its ``q_step``): no ``(cq, ck)`` block of scores
    or probabilities is kept for the backward, and the output and the
    gradients of q, K and V are the same bits as without recompute."""
    rng = np.random.default_rng(5)
    b, s, kvh, g, hd, cq, ck = 2, 64, 2, 2, 16, 16, 32
    base = [torch.tensor(rng.standard_normal(sh), dtype=torch.float32
                         ).to(dtype)
            for sh in ((b, s, kvh, g, hd), (b, s, kvh, hd), (b, s, kvh, hd))]
    cot = torch.tensor(rng.standard_normal((b, s, kvh, g, hd)),
                       dtype=torch.float32).to(dtype)
    res = {}
    for recompute in (True, False):
        if not recompute:       # each query chunk called directly
            monkeypatch.setattr(L, "checkpoint",
                                lambda fn, *a, use_reentrant: fn(*a))
        ins = [a.clone().requires_grad_() for a in base]
        out, shapes = _saved_shapes(lambda: L.chunked_attention(
            *ins, chunk_q=cq, chunk_k=ck))
        grads = torch.autograd.grad(out, ins, cot)
        res[recompute] = (out, grads, shapes)
    blocks = [sh for sh in res[False][2] if sh[-2:] == (cq, ck)]
    assert blocks, "without recompute the score blocks are kept"
    assert not [sh for sh in res[True][2] if sh[-2:] == (cq, ck)]
    assert torch.equal(res[True][0], res[False][0])
    for a, c in zip(res[True][1], res[False][1]):
        assert torch.equal(a, c)


# ----- remat ----------------------------------------------------------------

REMATS = {"full": True, "dots": "dots", "none": False}


@functools.lru_cache(maxsize=None)
def _remat_inputs(arch, dtype):
    """The reference's defs, weights and a train batch of reduced ``arch``
    at ``dtype`` (made once per arch and dtype), and the port's config."""
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jdt = {torch.float32: jnp.float32, BF: JBF}[dtype]
    jdefs = JT.build_defs(jcfg, CTX, dtype=jdt)
    jparams = JT.init_params(jdefs, jax.random.PRNGKey(0), CTX)
    kw = ({"enc_frames": cfg.encoder_frames, "d_model": cfg.d_model}
          if cfg.is_encoder_decoder else {})
    batch = SyntheticLMDataset(cfg.vocab_size, 64, 2, seed=3, **kw).batch(0)
    return (jdefs, jparams, batch), cfg


def _remat_run(arch, dtype, remat, count_ops=False):
    """Loss and gradients of reduced ``arch`` at ``dtype`` and ``remat``
    from the reference's weights, with the matrix products its backward
    runs (``aten.mm`` and ``aten.bmm`` calls) when ``count_ops``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in self.n:
                self.n[name] += 1
            return func(*args, **(kwargs or {}))

    (jdefs, jparams, batch), cfg = _remat_inputs(arch, dtype)
    defs = TF.build_defs(cfg, dtype=dtype)
    params = params_from_jax(jax.device_get(jparams), defs.storage, "cpu")
    module = TF.Transformer(defs, params, compute_dtype=dtype, remat=remat)
    loss, _ = module({k: torch.from_numpy(v) for k, v in batch.items()})
    counter = Count()
    if count_ops:
        with counter:
            grads = torch.autograd.grad(loss, T.tree_leaves(module.tree()))
    else:
        grads = torch.autograd.grad(loss, T.tree_leaves(module.tree()))
    return (jdefs, jparams, batch), loss, grads, counter.n


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_choices_are_bitwise_equal(arch, dtype):
    """``remat`` full, dots and none give the same loss and gradients bit
    for bit on the CPU (recompute repeats the same operations); at float32
    they are within the zoo's bounds (LOSS_RTOL, GRAD_RTOL) of the
    reference's ``jax.grad`` of ``train_loss`` at ``remat=True`` (at
    bfloat16 ``test_bf16_train_loss_and_grads`` holds them)."""
    runs = {name: _remat_run(arch, dtype, r) for name, r in REMATS.items()}
    _, loss, grads, _ = runs["full"]
    for name in ("dots", "none"):
        assert torch.equal(runs[name][1], loss), name
        for a, c in zip(runs[name][2], grads):
            assert a.dtype == c.dtype and torch.equal(a, c), name
    if dtype == torch.float32:
        jdefs, jparams, batch = runs["full"][0]
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: JT.train_loss(p, jdefs, b, CTX, remat=True),
            has_aux=True))(jparams, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
        for g, jg in zip(grads, jax.tree_util.tree_leaves(jgrads)):
            jg = np.asarray(jg)
            err = np.max(np.abs(g.numpy() - jg)) / np.max(np.abs(jg))
            assert err < GRAD_RTOL, err


def test_remat_recomputes_what_it_does_not_keep():
    """What each choice's backward recomputes, by the products it runs
    (reduced smollm-135m at float32): ``full`` repeats every forward
    product; ``dots`` keeps the products without batch dimensions
    (``aten.mm``) and repeats the batched ones (attention's ``aten.bmm``);
    ``none`` repeats nothing.  And ``full`` keeps less for autograd
    outside its checkpoints than ``none`` keeps."""
    n = {name: _remat_run("smollm-135m", torch.float32, r, count_ops=True)[3]
         for name, r in REMATS.items()}
    assert n["full"]["mm"] > n["dots"]["mm"] == n["none"]["mm"]
    assert n["full"]["bmm"] == n["dots"]["bmm"] > n["none"]["bmm"]
    cfg = reduced(get_config("smollm-135m"))
    defs = TF.build_defs(cfg)
    params = T.tree_map(lambda a: a.requires_grad_(),
                        init_params(defs.storage, 0, "cpu"))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64), dtype=np.int32))
    kept = {}
    for name, r in REMATS.items():
        _, shapes = _saved_shapes(lambda: TF.train_loss(
            params, defs, {"tokens": tokens, "labels": tokens}, remat=r))
        kept[name] = sum(int(np.prod(sh)) for sh in shapes)
    assert kept["full"] == kept["dots"] < kept["none"] / 2, kept


def test_remat_and_dtype_values_are_refused():
    cfg = reduced(get_config("smollm-135m"))
    with pytest.raises(ValueError):
        TF.build_defs(cfg, dtype=torch.float16)
    defs = TF.build_defs(cfg)
    params = init_params(defs.storage, 0, "cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        TF.train_loss(params, defs, {"tokens": tokens, "labels": tokens},
                      remat="partial")
    with pytest.raises(ValueError):
        train.build_train_setup(cfg, remat="dot", device="cpu")


# ----- the trainer, the wire, checkpoints and the CLIs at bfloat16 ----------

def test_wire_rows_and_bytes_at_bf16_equal_float32_and_reference():
    """The packed layout of a bfloat16 tree (every leaf packs as float32
    rows) is the float32 tree's and the reference's bfloat16 tree's, at
    reduced and at full width, and so are the int8 wire bytes per step."""
    for jcfg, cfg in ((jreduced(jget_config("smollm-135m")),
                       reduced(get_config("smollm-135m"))),
                      (jget_config("smollm-135m"),
                       get_config("smollm-135m"))):
        jshapes = jax.eval_shape(lambda: JT.init_params(
            JT.build_defs(jcfg, CTX, dtype=JBF), jax.random.PRNGKey(0), CTX))
        assert {a.dtype for a in jax.tree_util.tree_leaves(jshapes)} == {
            jnp.dtype(JBF)}
        want = jwire.WireLayout.for_tree(jshapes)
        layouts = [wire.WireLayout.for_tree(meta_params(
            TF.build_defs(cfg, dtype=dt).storage))
            for dt in (torch.float32, BF)]
        for got in layouts:
            assert (got.n_rows, got.n_data_rows, got.n_elements) == \
                (want.n_rows, want.n_data_rows, want.n_elements)
        rt = ConsensusRuntime(ConsensusConfig(), 4)
        assert rt.wire_bytes_per_step(layouts[1].n_elements, layouts[1]) \
            == rt.wire_bytes_per_step(layouts[0].n_elements, layouts[0]) \
            == 2 * want.n_rows * 516


TRAIN_BODY = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np, torch
from jax.sharding import Mesh, PartitionSpec as P
from repro import optim as joptim
from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import wire as jwire
from repro.core.distributed import ConsensusConfig as JCfg
from repro.core.distributed import ConsensusRuntime as JRt
from repro.data import SyntheticLMDataset
from repro.kernels import ops as jops
from repro.models import transformer as JT
from repro.models.sharding import ParallelContext, local_context
from repro.models.sharding import shard_map_compat
from repro_torch.configs import get_config, reduced
from repro_torch.core import tree as T
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models.params import params_from_jax

N, STEPS, LR, B, S = 4, 2, 1e-2, 8, 64
BF = jnp.bfloat16
mesh = Mesh(np.array(jax.devices()[:N]), ("data",))
ctx = ParallelContext(tp=1, data_size=N, n_nodes=N, in_shard_map=True)
cfg = jreduced(jget_config("smollm-135m"))
ldefs = JT.build_defs(cfg, local_context(), dtype=BF)
p0 = jax.device_get(JT.init_params(ldefs, jax.random.PRNGKey(0)))
ds = SyntheticLMDataset(cfg.vocab_size, S, B, n_shards=N)
layout = jwire.WireLayout.for_tree(p0)

def noise(k):
    return np.random.default_rng([5, k]).random(
        (N, layout.n_rows, 512), dtype=np.float32)

def f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))

# ---- the reference, composed from its parts at bfloat16 --------------------
jrt = JRt(JCfg(quant_mode="fixed", track_consensus_error=True), ctx)
grad_fn = jax.jit(jax.value_and_grad(
    lambda p, b: JT.train_loss(p, ldefs, b, local_context(),
                               compute_dtype=BF), has_aux=True))
sgd, sched = joptim.Sgd(), joptim.constant_schedule(LR)
sgd_step = jax.jit(lambda x, g, lr: sgd.step((), x, g, lr)[0])
x = jax.tree.map(lambda a: np.broadcast_to(a, (N,) + a.shape).copy(), p0)
pspec = jax.tree.map(lambda a: P("data"), x)
cspec = {"x_tilde": P("data", None, None), "m_agg": P("data", None, None)}
js = jax.jit(shard_map_compat(
    lambda p: jax.tree.map(lambda a: a[None], jrt.init_state(p)), mesh,
    in_specs=(pspec,), out_specs=cspec, check=False))(x)
def jstep(xp, xh, s, k, nz):
    xn, s2, m = jrt.exchange(xp, xh, jax.tree.map(lambda a: a[0], s), k,
                             jax.random.PRNGKey(7), noise=nz[0])
    return xn, jax.tree.map(lambda a: a[None], s2), m["consensus_err"]
step_f = jax.jit(shard_map_compat(
    jstep, mesh, in_specs=(pspec, pspec, cspec, P(), P("data")),
    out_specs=(pspec, cspec, P()), check=False))
ref = []
for k in range(1, STEPS + 1):
    batch = ds.global_batch_arrays(k - 1)
    bn = B // N
    outs = [grad_fn(jax.tree.map(lambda a: a[i], x),
                    {kk: jnp.asarray(v[i * bn:(i + 1) * bn])
                     for kk, v in batch.items()}) for i in range(N)]
    grads = jax.tree.map(lambda *g: jnp.stack(g), *[o[1] for o in outs])
    x_half = sgd_step(jax.tree.map(jnp.asarray, x), grads,
                      sched(jnp.asarray(k, jnp.int32)))
    y = np.stack([f32(layout.pack(jax.tree.map(lambda a: a[i], x_half)))
                  for i in range(N)]) - np.asarray(js["x_tilde"])
    x, js, cerr = step_f(x, x_half, js, jnp.asarray(k, jnp.int32), noise(k))
    ref.append(dict(loss=[float(o[0][0]) for o in outs],
                    grads=[f32(g) for g in jax.tree_util.tree_leaves(grads)],
                    x_half=[f32(a) for a in jax.tree_util.tree_leaves(x_half)],
                    y=y, x=[f32(a) for a in jax.tree_util.tree_leaves(x)],
                    xt=np.asarray(js["x_tilde"]), cerr=float(cerr)))
    x = jax.device_get(x)

# ---- the port, driven by the reference's gradients -------------------------
setup = train.build_train_setup(reduced(get_config("smollm-135m")),
                                consensus_nodes=N, lr=LR, device="cpu",
                                compute_dtype=torch.bfloat16,
                                track_consensus_error=True)
state = train.init_train_state(setup, params=params_from_jax(
    p0, setup.defs.storage, device="cpu", n_nodes=N))
seen = {"grads": [], "x_half": [], "encode": []}
real_grads, real_q = train._node_grads, ops.quantize_payload

def driven(setup, params, batch, auxes=None):
    losses, grads = real_grads(setup, params, batch, auxes)
    seen["grads"].append([g.float().numpy() for g in T.tree_leaves(grads)])
    seen["losses"] = losses
    k = len(seen["grads"])
    return losses, T.tree_unflatten(T.tree_flatten(grads)[1], [
        torch.from_numpy(g).to(torch.bfloat16) for g in ref[k - 1]["grads"]])

class Recorder:
    def __init__(self, opt):
        self.opt = opt
    def init(self, p):
        return self.opt.init(p)
    def step(self, *a):
        out = self.opt.step(*a)
        seen["x_half"].append([l.float().numpy()
                               for l in T.tree_leaves(out[0])])
        return out

def spy_q(y, noise, fixed_step=None, row_offset=0, n_rows=None, out=None):
    got = real_q(y, noise, fixed_step, row_offset, n_rows, out=out)
    seen["encode"].append((y.clone().numpy(), noise.clone().numpy(),
                           fixed_step, got.clone().numpy()))
    return got

train._node_grads, ops.quantize_payload = driven, spy_q
setup = dataclasses.replace(setup, optimizer=Recorder(setup.optimizer))
res = {"steps": []}
for k in range(1, STEPS + 1):
    seen["encode"] = []
    state, m = train.train_step(setup, state, ds.global_batch_arrays(k - 1),
                                noise=torch.from_numpy(noise(k)))
    r = ref[k - 1]
    grad_err = max(float(np.max(np.abs(g - w)) / np.max(np.abs(w)))
                   for g, w in zip(seen["grads"][-1], r["grads"]))
    x_half_equal = all(np.array_equal(a, b) for a, b in zip(
        seen["x_half"][-1], r["x_half"]))
    ys = np.stack([e[0] for e in seen["encode"]])
    pay = np.stack([e[3] for e in seen["encode"]])
    jpay = np.stack([np.asarray(jops.quantize_payload(
        jnp.asarray(r["y"][i]), jnp.asarray(e[1]),
        fixed_step=jnp.float32(e[2]))) for i, e in enumerate(seen["encode"])])
    def ulps(a, b):
        i = lambda v: np.where(v.view(np.int32) < 0,
                               -(v.view(np.int32) & 0x7FFFFFFF),
                               v.view(np.int32)).astype(np.int64)
        return int(np.max(np.abs(i(np.asarray(a, np.float32))
                                 - i(np.asarray(b, np.float32)))))
    params = T.tree_leaves(state["params"])
    res["steps"].append(dict(
        loss=m["node_loss"].tolist(), jloss=r["loss"], grad_err=grad_err,
        x_half_equal=x_half_equal, calls=len(seen["encode"]),
        y_equal=bool(np.array_equal(ys, r["y"])),
        payload_equal=bool(np.array_equal(pay, jpay)),
        param_dtypes=sorted({str(p.dtype) for p in params}),
        param_bf16_ulps=max(ulps(torch.tensor(p.float().numpy()).bfloat16()
                                 .float().numpy(), w) // 65536
                            for p, w in zip(params, r["x"])),
        param_max=max(float(np.max(np.abs(p.float().numpy() - w)))
                      for p, w in zip(params, r["x"])),
        xt_dtype=str(state["consensus"]["x_tilde"].dtype),
        m_agg_dtype=str(state["consensus"]["m_agg"].dtype),
        xt_ulps=ulps(state["consensus"]["x_tilde"].numpy(), r["xt"]),
        cerr=m["consensus_err"], jcerr=r["cerr"],
        wire_bytes=m["wire_bytes_per_step"],
        jwire_bytes=jrt.wire_bytes_per_step(layout.n_elements,
                                            layout=layout)))
print("RESULT " + json.dumps(res))
"""


@pytest.fixture(scope="module")
def trained():
    """Two bfloat16 trainer steps of 4 nodes against the reference
    composed from its parts (``test_torch_train.py``'s harness), the port
    driven by the reference's gradients (its own are compared)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", TRAIN_BODY],
                          capture_output=True, text=True, timeout=600,
                          env=env, cwd=REPO)
    if proc.returncode != 0:
        raise AssertionError(f"subprocess failed:\n{proc.stderr[-4000:]}")
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])["steps"]
    raise AssertionError(f"no RESULT line:\n{proc.stdout[-2000:]}")


def test_bf16_trainer_own_loss_and_grads(trained):
    """The port's own loss and gradients at the reference's weights:
    bfloat16 rounding apart (TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL: the model
    tests above hold them to a float64 forward)."""
    for s in trained:
        assert s["loss"] == pytest.approx(s["jloss"], rel=TRAIN_LOSS_RTOL)
        assert s["grad_err"] <= TRAIN_GRAD_RTOL, s["grad_err"]


def test_bf16_trainer_update_and_payloads_exact(trained):
    """Driven by the reference's gradients, every node's ``x_half`` (the
    float32 update rounded once to bfloat16) is the reference's bit for
    bit, the float32 differential ``y`` of the packed bfloat16 leaves too,
    and so the int8 payload bytes (one encode per node and step)."""
    for s in trained:
        assert s["x_half_equal"]
        assert s["calls"] == 4 and s["y_equal"] and s["payload_equal"]


def test_bf16_trainer_state_dtypes_and_values(trained):
    """``x_next`` comes back in bfloat16 within one bfloat16 ulp of the
    reference's, ``x_tilde`` and ``m_agg`` stay float32 (``x_tilde``
    within hazard 4's 2 ulps per step), ``consensus_err`` is float32
    arithmetic within float32 rounding of the reference's, and the wire
    bytes are the reference's."""
    for k, s in enumerate(trained, 1):
        assert s["param_dtypes"] == ["torch.bfloat16"]
        assert s["param_bf16_ulps"] <= 1, s["param_bf16_ulps"]
        assert s["xt_dtype"] == s["m_agg_dtype"] == "torch.float32"
        assert s["xt_ulps"] <= 2 * k, s["xt_ulps"]
        assert s["cerr"] == pytest.approx(s["jcerr"], rel=1e-5)
        assert s["wire_bytes"] == s["jwire_bytes"]


def test_bf16_checkpoint_loads_across_packages(tmp_path):
    """A bfloat16 train state written by the reference's
    ``save_checkpoint`` (its bfloat16 leaves ``'<V2'`` words through
    ``ml_dtypes``) loads in the port with equal bits; the port's writes
    the same members (descr, shape, bytes) and manifest dtypes, which the
    reference's loader reads as it reads its own (it refuses the port's
    treedef string, as for every port checkpoint)."""
    cfg = reduced(get_config("smollm-135m"))
    jcfg = jreduced(jget_config("smollm-135m"))
    jp = JT.init_params(JT.build_defs(jcfg, CTX, dtype=JBF),
                        jax.random.PRNGKey(0), CTX)
    jstate = {"params": jp, "opt": {"m": jax.tree.map(
        lambda a: (a * 0.5).astype(a.dtype), jp)}, "step": jnp.int32(3)}
    jpath = jsave(str(tmp_path / "jax"), 3, jstate)
    defs = TF.build_defs(cfg, dtype=BF)
    params = params_from_jax(jax.device_get(jp), defs.storage, "cpu")
    template = {"params": T.tree_map(torch.zeros_like, params),
                "opt": {"m": T.tree_map(torch.zeros_like, params)},
                "step": 0}
    state, step = load_checkpoint(str(tmp_path / "jax"), template)
    assert step == 3 and state["step"] == 3
    for a, w in zip(T.tree_leaves(state), jax.tree_util.tree_leaves(jstate)):
        if torch.is_tensor(a):
            assert a.dtype == BF
            np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                          np.asarray(w).view(np.int16))
    ppath = save_checkpoint(str(tmp_path / "port"), 3, state)
    with zipfile.ZipFile(jpath) as zj, zipfile.ZipFile(ppath) as zp:
        names = [n for n in zj.namelist() if n != "manifest.npy"]
        assert sorted(names) == sorted(n for n in zp.namelist()
                                       if n != "manifest.npy")
        for n in names:
            assert zp.read(n) == zj.read(n), n
    with np.load(jpath) as zj, np.load(ppath) as zp:
        mj, mp = (json.loads(str(z["manifest"])) for z in (zj, zp))
        assert mp["dtypes"] == mj["dtypes"] and "bfloat16" in mp["dtypes"]
        assert mp["shapes"] == mj["shapes"]
    again, _ = load_checkpoint(str(tmp_path / "port"), template)
    for a, b in zip(T.tree_leaves(again), T.tree_leaves(state)):
        assert (a == b) if not torch.is_tensor(a) else torch.equal(a, b)


def test_cli_flags_on_the_cpu():
    """The trainer's ``--compute-dtype`` and ``--remat`` and the server's
    ``--compute-dtype`` and ``--cache-dtype``, run on the CPU, and bad
    values refused."""
    hist, state = train.main(
        ["--reduced", "--device", "cpu", "--nodes", "2", "--batch", "4",
         "--seq", "32", "--steps", "2", "--compute-dtype", "bfloat16",
         "--remat", "dots"], return_state=True)
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert {a.dtype for a in T.tree_leaves(state["params"])} == {BF}
    assert state["consensus"]["x_tilde"].dtype == torch.float32
    r = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "16", "--new-tokens", "3",
                    "--compute-dtype", "bfloat16", "--cache-dtype",
                    "float32", "--keep-logits", "1"])
    assert r["tokens"].shape == (2, 3) and np.isfinite(r["logits"]).all()
    for argv in (["--compute-dtype", "float16"], ["--remat", "partial"]):
        with pytest.raises(SystemExit):
            train.main(["--reduced", "--device", "cpu", *argv])
    for argv in (["--compute-dtype", "int8"], ["--cache-dtype", "half"]):
        with pytest.raises(SystemExit):
            serve.main(["--reduced", "--device", "cpu", *argv])
