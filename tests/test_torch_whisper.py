"""The encoder-decoder (whisper-small) on the port, held to the JAX package.

What the architecture adds: an encoder of bidirectional 'A' blocks without
RoPE over the frames plus sinusoidal positions, with its own final norm;
learned decoder positions (``pos_emb``) in place of RoPE; and in every
decoder block a cross attention from the decoder stream to the encoder's
output, whose K and V a prefill writes into the decode cache beside the
self-attention's and every decode step reads.  A batch without frames
skips the cross attention, as the reference's does.

Configurations, parameter trees and full-width wire layouts are compared
exactly.  The sinusoidal table is held to the compiled reference's within
one ulp (``SIN_ULPS``: XLA's ``sin``/``cos`` lie within an ulp of the
correctly rounded values the port takes).  The model runs at ``reduced``
size (2 encoder layers over 32 frames, 2 decoder layers, 4 heads of 64 on
2 KV heads: g 2) and as a reduced MHA copy with 4 KV heads (g 1, as the
full model), on the reference's ``init_params`` carried over by
``params_from_jax``, norm weights perturbed so that ``(1 + w)`` is
exercised.  Both sides run float32 on the CPU but sum in other orders, so
values agree to float32 rounding, not bit for bit: the tolerances of
``test_torch_moe.py`` (``LOSS_RTOL`` 1e-5 on the loss, ``GRAD_RTOL`` 1e-4
of each leaf's largest gradient, ``LOGIT_TOL`` 1e-5 on outputs, logits and
caches).  Greedy tokens are equal.  Every reference function runs under
``jax.jit``, one compile per model and function, shared by the module's
fixtures.  The consensus exchange is model-agnostic and held to the
reference's runtime in ``test_torch_train.py``; here the trainer runs its
CLI on the CPU and its wire bytes are held to the reference's layout.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import wire as jwire
from repro.core.distributed import ConsensusConfig as JCfg
from repro.core.distributed import ConsensusRuntime as JRt
from repro.data import SyntheticLMDataset
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.params import ParamDef as JParamDef
from repro.models.sharding import ParallelContext, local_context
from repro_torch.configs import get_config, reduced
from repro_torch.core import tree as T
from repro_torch.core import wire
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.launch import serve, train
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.models.params import meta_params, params_from_jax

from test_torch_moe import GRAD_RTOL, LOGIT_TOL, LOSS_RTOL
from test_torch_zoo import _perturb_norms

ARCH = "whisper-small"
CTX = local_context()
#: sequences, prompt tokens, teacher-forced decode steps after the prompt,
#: and the train batch's tokens (at least encoder_frames - 1 = 31: the
#: data stub draws the frames from the first seq + 1 tokens)
B, P, DECODE, SEQ = 2, 16, 8, 32
#: the sinusoidal table against the compiled reference's, in ulps
SIN_ULPS = 1
#: the reduced variants: reduced's 2 KV heads for 4 heads (g 2), and an
#: MHA copy with 4 (g 1, as whisper-small's 12 of 12)
KV_HEADS = {"g2": None, "g1": 4}
#: full-width payload rows per node in the reference's layout, and the
#: int8 wire bytes per node and step, 2 x rows x 516
FULL_ROWS, FULL_WIRE_BYTES = 702_528, 725_008_896


def _close(a, b, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def _configs(full, kv_heads=None):
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    if full:
        return jcfg, cfg
    jcfg, cfg = jreduced(jcfg), reduced(cfg)
    if kv_heads:
        jcfg = dataclasses.replace(jcfg, n_kv_heads=kv_heads)
        cfg = dataclasses.replace(cfg, n_kv_heads=kv_heads)
    return jcfg, cfg


def _grads_close(got, want):
    for g, jg in zip(got, want):
        jg = np.asarray(jg)
        g = g.detach().numpy()
        assert g.shape == jg.shape
        scale = np.max(np.abs(jg))
        err = np.max(np.abs(g - jg)) / scale if scale else np.max(np.abs(g))
        assert err < GRAD_RTOL, err


def _ulps(a, b):
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
def test_config_matches_reference(full):
    jcfg, cfg = _configs(full)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.citation == jcfg.citation == "arXiv:2212.04356"
    assert cfg.param_count() == jcfg.param_count()
    if full:
        assert (cfg.n_heads, cfg.n_kv_heads, cfg.encoder_frames,
                cfg.n_encoder_layers, cfg.mlp_act) == (12, 12, 1504, 12,
                                                       "gelu")
    else:
        assert (cfg.n_heads, cfg.n_kv_heads, cfg.encoder_frames,
                cfg.n_encoder_layers) == (4, 2, 32, 2)


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
def test_defs_match_reference_storage(full):
    """``(path, shape)`` of every leaf in the reference's flatten order:
    the decoder blocks' ``cross`` and ``norm_cross``, ``pos_emb``, and the
    encoder's one-element tuple of stacked 'A' blocks and final norm."""
    jcfg, cfg = _configs(full)
    want = [(jax.tree_util.keystr(p), tuple(d.shape))
            for p, d in jax.tree_util.tree_leaves_with_path(
                JT.build_defs(jcfg, CTX).storage,
                is_leaf=lambda x: isinstance(x, JParamDef))]
    got = [(p, tuple(d.shape)) for p, d in
           T.tree_flatten_with_path(TF.build_defs(cfg).storage)[0]]
    assert got == want
    paths = dict(got)
    assert paths["['pos_emb']"] == (32_768, cfg.d_model)
    assert paths["['encoder']['layers'][0]['attn']['wq']"][0] == \
        cfg.n_encoder_layers
    assert "['layers'][0]['cross']['wk']" in paths
    assert not any(p.startswith("['encoder']") and "cross" in p
                   for p in paths)
    if full:
        assert sum(int(np.prod(s)) for s in paths.values()) == 359_682_048


def test_full_width_wire_rows_and_bytes():
    """The packed layout of the full-width tree (shapes only, nothing
    allocated) and the int8 wire bytes per node and step equal the
    reference's."""
    jcfg, cfg = _configs(True)
    jdefs = JT.build_defs(jcfg, CTX)
    want = jwire.WireLayout.for_tree(jax.eval_shape(
        lambda: JT.init_params(jdefs, jax.random.PRNGKey(0), CTX)))
    got = wire.WireLayout.for_tree(meta_params(TF.build_defs(cfg).storage))
    assert [(s.path, s.shape, s.row_start, s.n_rows, s.size)
            for s in got.slots] == \
        [(s.path, s.shape, s.row_start, s.n_rows, s.size)
         for s in want.slots]
    assert (got.n_rows, got.n_data_rows, got.n_elements) == \
        (want.n_rows, want.n_data_rows, want.n_elements)
    assert got.n_rows == FULL_ROWS
    rt = ConsensusRuntime(ConsensusConfig(wire_codec="int8"), 4)
    jrt = JRt(JCfg(wire_codec="int8"),
              ParallelContext(tp=1, data_size=4, n_nodes=4))
    got_b = rt.wire_bytes_per_step(got.n_elements, got)
    assert got_b == jrt.wire_bytes_per_step(want.n_elements, layout=want)
    assert got_b == 2 * FULL_ROWS * 516 == FULL_WIRE_BYTES


@pytest.mark.parametrize("n,d", [(1504, 768), (32, 256)])
def test_sinusoidal_positions_within_an_ulp(n, d):
    """The encoder's table at whisper-small's full and reduced sizes,
    against the reference's under ``jit``: angles up to 1,503 rad."""
    want = np.asarray(jax.jit(lambda: JL.sinusoidal_positions(n, d))())
    got = L.sinusoidal_positions(n, d).numpy()
    assert got.shape == want.shape == (n, d)
    assert _ulps(got, want).max() <= SIN_ULPS


# ---------------------------------------------------------------------------
# The model at reduced size, g 2 and g 1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(KV_HEADS))
def model(request):
    jcfg, cfg = _configs(False, KV_HEADS[request.param])
    jdefs = JT.build_defs(jcfg, CTX)
    jparams = _perturb_norms(JT.init_params(jdefs, jax.random.PRNGKey(0),
                                            CTX))
    defs = TF.build_defs(cfg)
    params = params_from_jax(jax.device_get(jparams), defs.storage,
                             device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (B, P + DECODE),
                          dtype=np.int32)
    frames = rng.standard_normal((B, jcfg.encoder_frames, jcfg.d_model),
                                 dtype=np.float32)
    return jcfg, jdefs, jparams, defs, params, tokens, frames


def _cross_params(jparams, layer=1):
    """One decoder block's cross attention (the second layer's)."""
    return jax.tree.map(lambda a: a[layer], jparams["layers"][0]["cross"])


def test_weight_carry_keeps_structure(model):
    _, _, jparams, _, params, _, _ = model
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    tl, _ = T.tree_flatten_with_path(params)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_encoder_matches_jax(model):
    """The encoder alone over the frames: sinusoidal positions,
    bidirectional attention without RoPE in 32 x 32 blocks, the MLPs and
    its final norm."""
    jcfg, jdefs, jparams, defs, params, _, frames = model
    want = jax.jit(lambda p, f: JT._encoder_apply(p, jdefs, f, jcfg, CTX))(
        jparams, jnp.asarray(frames))
    got = TF._encoder_apply(params, defs.cfg, torch.from_numpy(frames))
    _close(got.numpy(), want)


def _cross(model):
    """The second decoder layer's cross attention, on both sides."""
    jparams, cfg = model[2], model[3].cfg
    jp = jax.tree.map(lambda a: a[1], jparams["layers"][0]["cross"])
    return jp, params_from_jax(jax.device_get(jp), L.attention_defs(cfg),
                               device="cpu")


@pytest.mark.parametrize("s", [5, 16])
def test_cross_attention_train_matches_jax(model, s):
    """One block's cross attention in train mode from ``s`` decoder
    positions to the 32 frames: output within LOGIT_TOL, the gradients
    of its four weights and of both inputs within GRAD_RTOL."""
    jcfg, _, _, defs, _, _, frames = model
    jp, p = _cross(model)
    x = np.random.default_rng(s).standard_normal(
        (B, s, jcfg.d_model)).astype(np.float32)

    def jloss(jp, x, enc):
        out, _ = JT._cross_attention(jp, x, jcfg, CTX, mode="train",
                                     enc_out=enc, cache=None)
        return jnp.sum(jnp.sin(out)), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                               has_aux=True))(
        jp, jnp.asarray(x), jnp.asarray(frames))
    leaves, treedef = T.tree_flatten(p)
    leaves = [a.requires_grad_(True) for a in leaves]
    xs = [torch.from_numpy(x).requires_grad_(True),
          torch.from_numpy(frames).requires_grad_(True)]
    out, _ = TF._cross_attention(T.tree_unflatten(treedef, leaves), xs[0],
                                 defs.cfg, enc_out=xs[1], cache=None)
    _close(out.detach().numpy(), jout)
    grads = torch.autograd.grad(torch.sin(out).sum(), leaves + xs)
    _grads_close(grads, jax.tree_util.tree_leaves(jg[0]) + list(jg[1:]))


def test_cross_attention_prefill_and_decode_match_jax(model):
    """The prefill's output and cross K/V over all 32 frames, then 4
    one-token decode steps against that cache through the flash-decode
    path (the plain #9 on the CPU), each against the reference's."""
    jcfg, _, _, defs, _, _, frames = model
    jp, p = _cross(model)
    x = np.random.default_rng(9).standard_normal(
        (B, P + 4, jcfg.d_model)).astype(np.float32)
    jout, jc = jax.jit(lambda jp, x, e: JT._cross_attention(
        jp, x, jcfg, CTX, mode="prefill", enc_out=e, cache=None))(
        jp, jnp.asarray(x[:, :P]), jnp.asarray(frames))
    out, c = TF._cross_attention(p, torch.from_numpy(x[:, :P]), defs.cfg,
                                 enc_out=torch.from_numpy(frames),
                                 cache=None)
    _close(out.numpy(), jout)
    for key in ("k", "v"):
        assert tuple(c[key].shape) == (B, jcfg.encoder_frames,
                                       jcfg.n_kv_heads, 64)
        _close(c[key].numpy(), jc[key])
    jstep = jax.jit(lambda jp, xt, c: JT._cross_attention(
        jp, xt, jcfg, CTX, mode="decode", enc_out=None, cache=c))
    for t in range(P, P + 4):
        jout, jc = jstep(jp, jnp.asarray(x[:, t:t + 1]), jc)
        out, c2 = TF._cross_attention(p, torch.from_numpy(x[:, t:t + 1]),
                                      defs.cfg, enc_out=None, cache=c)
        assert c2 is c
        _close(out.numpy(), jout)


@pytest.fixture(scope="module")
def jtrain(model):
    """The reference's jitted loss and gradients of the model."""
    jdefs = model[1]
    return jax.jit(jax.value_and_grad(
        lambda p, b: JT.train_loss(p, jdefs, b, CTX), has_aux=True))


@pytest.mark.parametrize("with_frames", [True, False],
                         ids=["frames", "no-frames"])
def test_train_loss_and_grads_match_jax(model, jtrain, with_frames):
    """The loss, its cross-entropy and every gradient on the data stub's
    batch of 32 tokens with its frames (the encoder in the graph), and
    without them (no cross attention: its and the encoder's gradients
    are zero on both sides)."""
    jcfg, _, jparams, defs, params, _, _ = model
    batch = SyntheticLMDataset(jcfg.vocab_size, SEQ, B, seed=3,
                               enc_frames=jcfg.encoder_frames,
                               d_model=jcfg.d_model).batch(0)
    if not with_frames:
        del batch["enc_frames"]
    (jloss, jparts), jgrads = jtrain(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    module = TF.Transformer(defs, params)
    loss, parts = module({k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, T.tree_leaves(module.tree()),
                                allow_unused=True)
    paths = [p for p, _ in T.tree_flatten_with_path(params)[0]]
    grads = [torch.zeros_like(a) if g is None else g
             for g, a in zip(grads, T.tree_leaves(params))]
    for got, want in ((loss, jloss), (parts["ce"], jparts["ce"])):
        assert float(got.detach()) == pytest.approx(float(want),
                                                     rel=LOSS_RTOL)
    _grads_close(grads, jax.tree_util.tree_leaves(jgrads))
    skipped = [float(g.abs().max()) for path, g in zip(paths, grads)
               if "cross" in path or "encoder" in path]
    assert skipped and (max(skipped) > 0) == with_frames


def _close_caches(got, want, tol=LOGIT_TOL):
    """Every cache entry (self K/V, cross K/V) by path and value."""
    g, _ = T.tree_flatten_with_path(
        {k: v for k, v in got.items() if k != "len"})
    w = jax.tree_util.tree_leaves_with_path(
        {k: v for k, v in want.items() if k != "len"})
    assert [p for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in w]
    for (_, a), (_, b) in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        _close(np.asarray(a), b, tol)


@pytest.fixture(scope="module")
def jprefill(model):
    """The reference's jitted prefill of the P-token prompts with their
    frames: (logits, cache), the self K/V padded to P + DECODE positions
    (the cross K/V hold all the frames already)."""
    _, jdefs, jparams, _, _, tokens, frames = model
    jl, jc, _ = jax.jit(lambda p, b: JT.model_apply(
        p, jdefs, b, CTX, mode="prefill", remat=False))(
        jparams, {"tokens": jnp.asarray(tokens[:, :P]),
                  "enc_frames": jnp.asarray(frames)})

    def grow(path, a):
        if "'attn'" not in jax.tree_util.keystr(path):
            return a
        widths = [(0, 0)] * a.ndim
        widths[a.ndim - 3] = (0, DECODE)
        return jnp.pad(a, widths)
    return jl, jax.tree_util.tree_map_with_path(grow, jc)


@pytest.fixture(scope="module")
def jdecode(model):
    """The reference's jitted decode step of the model: (logits, cache)."""
    jdefs = model[1]
    return jax.jit(lambda p, tok, c: JT.model_apply(
        p, jdefs, {"tokens": tok}, CTX, mode="decode", cache=c,
        remat=False)[:2])


def _prefill(model):
    _, _, _, defs, params, tokens, frames = model
    cache = TF.init_cache(defs.cfg, B, P + DECODE)
    return TF.model_apply(params, defs,
                          {"tokens": torch.from_numpy(tokens[:, :P]),
                           "enc_frames": torch.from_numpy(frames)},
                          mode="prefill", cache=cache)


def test_prefill_matches_jax(model, jprefill):
    """Logits, and both caches of every block: the prompt's K/V padded to
    the capacity, the cross K/V over all 32 frames."""
    jcfg = model[0]
    jl, jc = jprefill
    tl, tc = _prefill(model)
    _close(tl.numpy(), jl)
    assert tc["len"] == int(jc["len"]) == P
    assert [sorted(e) for e in tc["layers"]] == [["attn", "cross"]]
    assert tuple(tc["layers"][0]["cross"]["k"].shape) == (
        jcfg.n_periods, B, jcfg.encoder_frames, jcfg.n_kv_heads, 64)
    _close_caches(tc, jc)


def test_decode_matches_jax_token_by_token(model, jprefill, jdecode):
    """Teacher-forced decode of 8 tokens after the prompt (learned
    positions P..P+7): logits against the reference's decode and the
    port's own train-mode forward with the same frames, and every cache
    entry."""
    _, _, jparams, defs, params, tokens, frames = model
    _, jcache = jprefill
    _, cache = _prefill(model)
    want, got = [], []
    for t in range(P, P + DECODE):
        tok = tokens[:, t:t + 1]
        jl, jcache = jdecode(jparams, jnp.asarray(tok), jcache)
        tl, cache = TF.model_apply(params, defs,
                                   {"tokens": torch.from_numpy(tok)},
                                   mode="decode", cache=cache)
        assert cache["len"] == int(jcache["len"]) == t + 1
        want.append(np.asarray(jl[:, 0]))
        got.append(tl[:, 0].numpy())
    forward, _ = TF.model_apply(params, defs,
                                {"tokens": torch.from_numpy(tokens),
                                 "enc_frames": torch.from_numpy(frames)},
                                logits_from=P)
    _close(np.stack(got, 1), np.stack(want, 1))
    _close(np.stack(got, 1), forward.numpy())
    _close_caches(cache, jcache)


def test_greedy_tokens_match_jax(model, jprefill, jdecode):
    """Prefill plus 8 greedy decode steps through the serve setups: the
    same 9 tokens per sequence as the reference's decode and greedy
    sample."""
    _, _, jparams, defs, params, tokens, frames = model
    jl, jc = jprefill
    jtok = jnp.argmax(jl[:, -1:, :], axis=-1).astype(jnp.int32)
    want = [np.asarray(jtok)]
    for _ in range(DECODE):
        jl, jc = jdecode(jparams, jtok, jc)
        jtok = JL.sharded_greedy_sample(jl[:, -1:, :], CTX)
        want.append(np.asarray(jtok))
    pre = serve.build_prefill_setup(defs.cfg, device="cpu")
    srv = serve.build_serve_setup(defs.cfg, device="cpu")
    first, cache = pre.prefill_step(
        params, {"tokens": torch.from_numpy(tokens[:, :P]),
                 "enc_frames": torch.from_numpy(frames)}, P + DECODE)
    state = {"params": params, "cache": cache, "tokens": first}
    got = [first.numpy()]
    for _ in range(DECODE):
        state = srv.serve_step(state)
        got.append(state["tokens"].numpy())
    assert state["cache"]["len"] == P + DECODE
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))


def test_prefill_without_frames_matches_jax(model, jdecode):
    """A prefill without frames skips the cross attention, and its cache
    holds no cross K/V, so a decode step skips it too, as the
    reference's."""
    _, jdefs, jparams, defs, params, tokens, _ = model
    jl, jc, _ = jax.jit(lambda p, tok: JT.model_apply(
        p, jdefs, {"tokens": tok}, CTX, mode="prefill", remat=False))(
        jparams, jnp.asarray(tokens[:, :P]))
    tl, tc = TF.model_apply(params, defs,
                            {"tokens": torch.from_numpy(tokens[:, :P])},
                            mode="prefill")
    _close(tl.numpy(), jl)
    assert [sorted(e) for e in tc["layers"]] == [["attn"]]
    _close_caches(tc, jc)
    tok = tokens[:, P - 1:P]
    tc["layers"][0]["attn"] = {k: torch.cat(
        [v, torch.zeros_like(v[:, :, :1])], 2)
        for k, v in tc["layers"][0]["attn"].items()}
    jc = jax.tree_util.tree_map_with_path(
        lambda path, a: a if "'attn'" not in jax.tree_util.keystr(path)
        else jnp.pad(a, [(0, 0)] * (a.ndim - 3) + [(0, 1), (0, 0), (0, 0)]),
        jc)
    jl, _ = jdecode(jparams, jnp.asarray(tok), jc)
    tl, _ = TF.model_apply(params, defs, {"tokens": torch.from_numpy(tok)},
                           mode="decode", cache=tc)
    _close(tl.numpy(), jl)


# ---------------------------------------------------------------------------
# Errors and the command lines
# ---------------------------------------------------------------------------

def test_capacity_past_learned_positions_raises():
    """``pos_emb`` has 32,768 rows: a larger cache is refused, where the
    reference's ``jnp.take`` would read fill values."""
    cfg = reduced(get_config(ARCH))
    TF.init_cache(cfg, 1, TF.POS_EMB_ROWS, device="meta")
    with pytest.raises(ValueError, match="32768 learned decoder positions"):
        TF.init_cache(cfg, 1, TF.POS_EMB_ROWS + 1, device="meta")
    with pytest.raises(ValueError, match="32768 learned decoder positions"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--batch", "1", "--prompt-len", "32760",
                    "--new-tokens", "10"])


def test_decode_refuses_frames(model):
    _, _, _, defs, params, tokens, frames = model
    _, cache = _prefill(model)
    with pytest.raises(ValueError, match="decode takes no enc_frames"):
        TF.model_apply(params, defs, {"tokens": torch.from_numpy(
            tokens[:, P:P + 1]), "enc_frames": torch.from_numpy(frames)},
            mode="decode", cache=cache)


def test_train_refuses_short_seq():
    """The data stub adds ``seqs[:, :frames]`` to a ``(frames, d)``
    projection, which broadcasts only when ``seq + 1 >= frames``: the
    reference fails inside numpy, the port refuses the flag first."""
    jcfg = jreduced(jget_config(ARCH))
    with pytest.raises(ValueError, match="broadcast"):
        SyntheticLMDataset(jcfg.vocab_size, 16, 2,
                           enc_frames=jcfg.encoder_frames,
                           d_model=jcfg.d_model).batch(0)
    with pytest.raises(ValueError, match="--seq must be at least 31"):
        train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--nodes", "2", "--batch", "2", "--seq", "16",
                    "--steps", "1"])


def test_train_cli_on_cpu():
    """``train --arch whisper-small --reduced --device cpu``: 2 int8 steps
    on 2 nodes with the encoder in the graph, finite losses near ln(V),
    and the wire bytes of the reference's layout of the reduced tree."""
    hist = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--nodes", "2", "--batch", "2", "--seq", "31",
                       "--steps", "2", "--lr", "1e-2"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert abs(hist[0]["loss"] - np.log(1024)) < 0.5
    jcfg = jreduced(jget_config(ARCH))
    jdefs = JT.build_defs(jcfg, CTX)
    layout = jwire.WireLayout.for_tree(jax.eval_shape(
        lambda: JT.init_params(jdefs, jax.random.PRNGKey(0), CTX)))
    assert hist[-1]["wire_bytes_per_step"] == 2 * layout.n_rows * 516


def test_serve_cli_on_cpu():
    """``serve --arch whisper-small --reduced --device cpu``: the frames
    drawn after the prompts from the seed, 5 greedy tokens, and the kept
    logits' argmax equal to the next tokens."""
    r = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "16", "--new-tokens",
                    "5", "--keep-logits", "1", "--seed", "4"])
    cfg = reduced(get_config(ARCH))
    rng = np.random.default_rng(4)
    np.testing.assert_array_equal(r["prompts"], rng.integers(
        0, cfg.vocab_size, (2, 16), dtype=np.int32))
    np.testing.assert_array_equal(r["frames"], rng.standard_normal(
        (2, 32, cfg.d_model), dtype=np.float32))
    assert r["tokens"].shape == (2, 5)
    assert r["cache_len"] == 16 + 4
    np.testing.assert_array_equal(r["logits"][0].argmax(-1),
                                  r["tokens"][0, 1:])
