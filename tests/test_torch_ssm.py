"""The state-space family (mamba2-1.3b, jamba-v0.1-52b) on the port, held to
the JAX package.

What the family adds: the Mamba2 block of ``models.mamba2`` (separate
projections, three depthwise causal convs, the chunked SSD scan in train
and prefill, the one-token recurrence in decode, the gated RMS norm over
``d_inner``), the 'M' block (Mamba2, with a dense MLP only when ``d_ff >
0``: jamba's has one, mamba2-1.3b's none) and 'X' (Mamba2 with the routed
experts), and a decode cache that holds each Mamba2 block's state and conv
windows beside the attention blocks' K and V (jamba's period
'MXMXAXMX').

Configurations, parameter trees and full-width wire layouts are compared
exactly.  The model runs at ``reduced`` size (chunk 32, state 16, 8 heads
of 64) with the reference's ``init_params`` carried over by
``params_from_jax``, norm weights perturbed so that ``(1 + w)`` is
exercised; every length is a multiple of the chunk, as the scan needs.
Both sides run float32 on the CPU but sum in other orders (XLA's
``cumsum`` and contractions against PyTorch's; ``_segsum`` is the
reference's difference of cumsums, so both exponentiate the same rounded
differences only up to an ulp), so values agree to float32 rounding, not
bit for bit: the tolerances of ``test_torch_moe.py`` (``LOSS_RTOL``,
``GRAD_RTOL``, ``LOGIT_TOL``) on loss, gradients, logits, states and conv
windows.  Greedy tokens are equal.  The trainer is held to the
reference's exchange-level runtime by the harness of
``test_torch_train.py``, within its grid-step bounds.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import json
import os
import subprocess
import sys

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
from repro.models import mamba2 as JMB
from repro.models import transformer as JT
from repro.models.params import ParamDef as JParamDef
from repro.models.params import materialize_logical
from repro.models.sharding import ParallelContext, local_context
from repro_torch.configs import get_config, reduced
from repro_torch.core import tree as T
from repro_torch.core import wire
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.launch import serve, train
from repro_torch.models import mamba2 as MB
from repro_torch.models import transformer as TF
from repro_torch.models.params import (ParamDef, init_params, meta_params,
                                       params_from_jax)

import test_torch_train
from test_torch_moe import GRAD_RTOL, LOGIT_TOL, LOSS_RTOL
from test_torch_zoo import _perturb_norms

ARCHS = ("mamba2-1.3b", "jamba-v0.1-52b")
CTX = local_context()
#: prompt of the model tests: two chunks of the reduced scan; DECODE
#: teacher-forced steps after it, held to a forward over FORWARD tokens
#: (a chunk multiple past P + DECODE)
B, P, DECODE, FORWARD = 2, 64, 8, 96
#: logits, states and caches of reduced jamba-v0.1-52b (16 layers: 2
#: periods of 'MXMXAXMX') against the reference's: its float32 prefill
#: logits lie up to 2.0e-5 (the port's) and 2.2e-5 (the reference's) from
#: a float64 forward of the same weights (measured on the CPU, reduced
#: mamba2-1.3b's 2 layers: 2.3e-6 and 2.4e-6), so the two may differ by
#: about their sum, above LOGIT_TOL
JAMBA_TOL = 5e-5


def _close(a, b, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def _tol(cfg):
    return JAMBA_TOL if cfg.arch_id.startswith("jamba") else LOGIT_TOL


def _configs(arch, full):
    jcfg, cfg = jget_config(arch), get_config(arch)
    return (jcfg, cfg) if full else (jreduced(jcfg), reduced(cfg))


def _grads_close(got, want):
    for g, jg in zip(got, want):
        jg = np.asarray(jg)
        g = g.detach().numpy()
        assert g.shape == jg.shape
        scale = np.max(np.abs(jg))
        err = np.max(np.abs(g - jg)) / scale if scale else np.max(np.abs(g))
        assert err < GRAD_RTOL, err


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, full):
    jcfg, cfg = _configs(arch, full)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.citation and cfg.citation == jcfg.citation
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    if not full:
        assert (cfg.d_model, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim,
                cfg.ssm_chunk) == (256, 16, 8, 64, 32)
        assert cfg.d_inner == cfg.ssm_heads * cfg.ssm_head_dim


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_defs_match_reference_storage(arch, full):
    """``(path, shape)`` of every leaf in the reference's flatten order:
    'M' with an MLP (jamba) and without (mamba2-1.3b), 'X' with the
    routed experts, 'A' with its MLP."""
    jcfg, cfg = _configs(arch, full)
    want = [(jax.tree_util.keystr(p), tuple(d.shape))
            for p, d in jax.tree_util.tree_leaves_with_path(
                JT.build_defs(jcfg, CTX).storage,
                is_leaf=lambda x: isinstance(x, JParamDef))]
    got = [(p, tuple(d.shape)) for p, d in
           T.tree_flatten_with_path(TF.build_defs(cfg).storage)[0]]
    assert got == want
    paths = [p for p, _ in got]
    assert "['layers'][0]['mamba']['conv_x']" in paths
    if arch == "mamba2-1.3b":
        assert not any("mlp" in p or "norm2" in p for p in paths)
    else:
        assert "['layers'][0]['mlp']['w_gate']" in paths
        assert "['layers'][1]['moe']['router']" in paths
        assert "['layers'][1]['mlp']['w_gate']" not in paths
        assert "['layers'][4]['attn']['wq']" in paths


def test_init_params_scale_and_ones():
    """The draws: normal leaves take ``scale / sqrt(fan_in)`` of one
    generator in flatten order, zeros and ones draw nothing, so the
    leaves of a tree without either (every arch before this family) are
    the same as before ``scale`` and ``ones`` existed."""
    defs = {"a": ParamDef((3, 5)), "b": ParamDef((4,), init="ones"),
            "c": ParamDef((2, 6, 7), scale=0.5),
            "d": ParamDef((6,), init="zeros"), "e": ParamDef((5, 2))}
    got = init_params(defs, 3, "cpu")
    gen = torch.Generator().manual_seed(3)
    a = torch.randn((3, 5), generator=gen) * (1.0 / np.sqrt(3))
    c = torch.randn((2, 6, 7), generator=gen) * (0.5 / np.sqrt(6))
    e = torch.randn((5, 2), generator=gen) * (1.0 / np.sqrt(5))
    for key, want in (("a", a), ("b", torch.ones(4)), ("c", c),
                      ("d", torch.zeros(6)), ("e", e)):
        assert torch.equal(got[key], want), key
    stacked = init_params(defs, 3, "cpu", n_nodes=2)
    assert all(torch.equal(stacked[k][i], got[k]) for k in defs
               for i in range(2))


def _jax_layout(cfg):
    """The reference's layout of its own tree, from shapes only."""
    defs = JT.build_defs(cfg, CTX)
    shapes = jax.eval_shape(lambda: JT.init_params(
        defs, jax.random.PRNGKey(0), CTX))
    return jwire.WireLayout.for_tree(shapes)


#: full-width payload rows per node in the reference's layout, and the
#: int8 wire bytes per node and step, 2 x rows x 516: mamba2-1.3b uncut
#: and at the trainer's 8 of 48 periods, jamba-v0.1-52b at the 1 of 4
#: periods that one card serves
FULL = {"mamba2-1.3b": ("mamba2-1.3b", None, 2_624_096, 2_708_067_072),
        "mamba2-1.3b-8-periods": ("mamba2-1.3b", 8, 604_960, 624_318_720),
        "jamba-1-period": ("jamba-v0.1-52b", 1, 25_913_312,
                           26_742_537_984)}


@pytest.mark.parametrize("which", list(FULL))
def test_full_width_wire_rows_and_bytes(which):
    """The packed layout of the full-width tree (shapes only, nothing
    allocated) and the wire bytes per step equal the reference's."""
    arch, periods, rows, wire_bytes = FULL[which]
    jcfg, cfg = _configs(arch, True)
    if periods:
        jcfg = dataclasses.replace(jcfg, n_periods=periods)
        cfg = dataclasses.replace(cfg, n_periods=periods)
    want = _jax_layout(jcfg)
    got = wire.WireLayout.for_tree(meta_params(TF.build_defs(cfg).storage))
    assert [(s.path, s.shape, s.row_start, s.n_rows, s.size)
            for s in got.slots] == \
        [(s.path, s.shape, s.row_start, s.n_rows, s.size)
         for s in want.slots]
    assert (got.n_rows, got.n_data_rows, got.n_elements) == \
        (want.n_rows, want.n_data_rows, want.n_elements)
    assert got.n_rows == rows
    ctx = ParallelContext(tp=1, data_size=4, n_nodes=4)
    rt = ConsensusRuntime(ConsensusConfig(wire_codec="int8"), 4)
    jrt = JRt(JCfg(wire_codec="int8"), ctx)
    got_b = rt.wire_bytes_per_step(got.n_elements, got)
    assert got_b == jrt.wire_bytes_per_step(want.n_elements, layout=want)
    assert got_b == 2 * rows * 516 == wire_bytes


# ---------------------------------------------------------------------------
# The Mamba2 block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_cache", [False, True], ids=["pad", "cache"])
def test_causal_conv_matches_jax(with_cache):
    """The conv and SiLU, and the new window: the last k - 1 raw inputs
    of the cache (or zero padding) followed by ``x``."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32) * 0.5
    c = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_cache \
        else None
    jy, jc = JMB._causal_conv(jnp.asarray(x), jnp.asarray(w),
                              None if c is None else jnp.asarray(c))
    y, nc = MB._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                            None if c is None else torch.from_numpy(c))
    _close(y.numpy(), jy, 1e-6)
    np.testing.assert_array_equal(nc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(nc.numpy(), x[:, -3:])


def test_segsum_matches_jax():
    a = -np.abs(np.random.default_rng(6).standard_normal(
        (3, 2, 32))).astype(np.float32)
    got = MB._segsum(torch.from_numpy(a)).numpy()
    want = np.asarray(JMB._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    assert np.all(np.isneginf(got[..., np.triu_indices(32, 1)[0],
                                  np.triu_indices(32, 1)[1]]))
    fin = np.isfinite(want)
    _close(got[fin], want[fin], 1e-5)


def _block(arch="mamba2-1.3b"):
    jcfg, cfg = _configs(arch, False)
    jp = materialize_logical(JMB.mamba_defs(jcfg, CTX, jnp.float32),
                             jax.random.PRNGKey(1))
    # non-trivial a_log, dt_bias, d_skip and norm weights
    jp = {k: (v + 0.3 * jax.random.normal(jax.random.PRNGKey(2 + i),
                                          v.shape)
              if v.ndim == 1 else v)
          for i, (k, v) in enumerate(sorted(jp.items()))}
    p = params_from_jax(jax.device_get(jp), MB.mamba_defs(cfg),
                        device="cpu")
    return jcfg, cfg, jp, p


@pytest.mark.parametrize("s", [16, 32, 64])
def test_mamba_forward_train_matches_jax(s):
    """One block in train mode below, at and at twice the chunk of 32:
    output within LOGIT_TOL, every gradient within GRAD_RTOL of its
    leaf's largest."""
    jcfg, cfg, jp, p = _block()
    x = np.random.default_rng(7).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)

    def jloss(jp):
        out, _ = JMB.mamba_forward(jp, jnp.asarray(x), jcfg, CTX)
        return jnp.sum(jnp.sin(out)), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    leaves, treedef = T.tree_flatten(p)
    leaves = [a.requires_grad_(True) for a in leaves]
    out, cache = MB.mamba_forward(T.tree_unflatten(treedef, leaves),
                                  torch.from_numpy(x), cfg)
    assert cache is None
    _close(out.detach().numpy(), jout)
    grads = torch.autograd.grad(torch.sin(out).sum(), leaves)
    _grads_close(grads, jax.tree_util.tree_leaves(jg))


def test_mamba_forward_refuses_ragged_length():
    """48 tokens at chunk 32: the reference asserts, the port raises."""
    jcfg, cfg, jp, p = _block()
    x = np.zeros((1, 48, cfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        JMB.mamba_forward(jp, jnp.asarray(x), jcfg, CTX)
    with pytest.raises(ValueError, match="multiple of min"):
        MB.mamba_forward(p, torch.from_numpy(x), cfg)
    assert MB.chunk_len(cfg, 31) == 31      # one chunk of 31


def test_mamba_prefill_and_decode_match_jax():
    """One block: the prefill's state and conv windows, then 8 decode
    steps of state, windows and outputs, each against the reference's
    from the same cache."""
    jcfg, cfg, jp, p = _block()
    x = np.random.default_rng(8).standard_normal(
        (2, 32 + 8, cfg.d_model)).astype(np.float32)
    jcache = jax.tree.map(lambda a: a[0], JT.init_cache(
        jcfg, CTX, 2, 1, ())["layers"][0]["mamba"])
    jout, jcache = JMB.mamba_forward(jp, jnp.asarray(x[:, :32]), jcfg, CTX,
                                     mode="prefill", cache=jcache)
    out, cache = MB.mamba_forward(p, torch.from_numpy(x[:, :32]), cfg,
                                  mode="prefill")
    _close(out.numpy(), jout)

    def close_cache(got, want):
        g, _ = T.tree_flatten_with_path(got)
        w = jax.tree_util.tree_leaves_with_path(want)
        assert [k for k, _ in g] == [jax.tree_util.keystr(k) for k, _ in w]
        for (_, a), (_, b) in zip(g, w):
            _close(a.numpy(), b)

    close_cache(cache, jcache)
    jstep = jax.jit(lambda jp, xt, c: JMB.mamba_forward(
        jp, xt, jcfg, CTX, mode="decode", cache=c))
    for t in range(32, 40):
        jout, jcache = jstep(jp, jnp.asarray(x[:, t:t + 1]), jcache)
        before = cache["ssm"]
        out, cache = MB.mamba_forward(p, torch.from_numpy(x[:, t:t + 1]),
                                      cfg, mode="decode", cache=cache)
        assert cache["ssm"] is before          # written in place
        _close(out.numpy(), jout)
        close_cache(cache, jcache)


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg, cfg = _configs(arch, False)
    jdefs = JT.build_defs(jcfg, CTX)
    jparams = _perturb_norms(JT.init_params(jdefs, jax.random.PRNGKey(0),
                                            CTX))
    defs = TF.build_defs(cfg)
    params = params_from_jax(jax.device_get(jparams), defs.storage,
                             device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, FORWARD), dtype=np.int32)
    return jcfg, jdefs, jparams, defs, params, tokens


@pytest.fixture(scope="module")
def jdecode(model):
    """The reference's jitted decode step of the model: (logits, cache)."""
    jdefs = model[1]
    return jax.jit(lambda p, tok, c: JT.model_apply(
        p, jdefs, {"tokens": tok}, CTX, mode="decode", cache=c,
        remat=False)[:2])


def test_weight_carry_keeps_structure(model):
    _, _, jparams, _, params, _ = model
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    tl, _ = T.tree_flatten_with_path(params)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_train_loss_and_grads_match_jax(model):
    """``ce + router_aux_weight * aux`` (aux 0 for mamba2-1.3b), its parts
    and every gradient, on 64-token sequences (two chunks)."""
    jcfg, jdefs, jparams, defs, params, _ = model
    batch = SyntheticLMDataset(jcfg.vocab_size, 64, 2, seed=3).batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.train_loss(p, jdefs, b, CTX), has_aux=True))(
        jparams, jbatch)
    module = TF.Transformer(defs, params)
    loss, parts = module({k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, T.tree_leaves(module.tree()))
    for got, want in ((loss, jloss), (parts["ce"], jparts["ce"]),
                      (parts["aux"], jparts["aux"])):
        assert float(got.detach()) == pytest.approx(float(want),
                                                     rel=LOSS_RTOL)
    if jcfg.n_experts:
        assert float(parts["aux"].detach()) > 0
    else:
        assert float(parts["aux"].detach()) == 0.0
    _grads_close(grads, jax.tree_util.tree_leaves(jgrads))


def _close_caches(got, want, tol):
    """Every cache entry (K, V, states, conv windows) by path and value."""
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
    """The reference's prefill of the P-token prompts: (logits, cache),
    its K and V padded to P + DECODE positions (axis 2 of the stacked
    entries); the Mamba2 blocks' states and windows do not grow."""
    _, jdefs, jparams, _, _, tokens = model
    jl, jc, _ = JT.model_apply(jparams, jdefs,
                               {"tokens": jnp.asarray(tokens[:, :P])}, CTX,
                               mode="prefill")

    def grow(path, a):
        if "'attn'" not in jax.tree_util.keystr(path):
            return a
        widths = [(0, 0)] * a.ndim
        widths[a.ndim - 3] = (0, DECODE)
        return jnp.pad(a, widths)
    return jl, jax.tree_util.tree_map_with_path(grow, jc)


def test_prefill_matches_jax(model, jprefill):
    """Logits, and every cache entry: K/V padded to the capacity, each
    Mamba2 block's final state and conv windows."""
    jcfg, jdefs, jparams, defs, params, tokens = model
    prompt, cap = tokens[:, :P], P + DECODE
    jl, jc = jprefill
    cache = TF.init_cache(defs.cfg, B, cap)
    tl, tc = TF.model_apply(params, defs,
                            {"tokens": torch.from_numpy(prompt)},
                            mode="prefill", cache=cache)
    _close(tl.numpy(), jl, _tol(jcfg))
    assert tc["len"] == int(jc["len"]) == P
    assert [next(iter(e)) for e in tc["layers"]] == [
        "attn" if c == "A" else "mamba" for c in jcfg.period]
    _close_caches(tc, jc, _tol(jcfg))


def test_decode_matches_jax_token_by_token(model, jprefill, jdecode):
    """Teacher-forced decode of 8 tokens after the prompt: logits against
    the reference's decode and the port's own train-mode forward over 96
    tokens (the scan's chunk multiple), and every cache entry."""
    jcfg, jdefs, jparams, defs, params, tokens = model
    cap = P + DECODE
    _, jcache = jprefill
    cache = TF.init_cache(defs.cfg, B, cap)
    _, cache = TF.model_apply(params, defs,
                              {"tokens": torch.from_numpy(tokens[:, :P])},
                              mode="prefill", cache=cache)
    want, got = [], []
    for t in range(P, cap):
        tok = tokens[:, t:t + 1]
        jl, jcache = jdecode(jparams, jnp.asarray(tok), jcache)
        tl, cache = TF.model_apply(params, defs,
                                   {"tokens": torch.from_numpy(tok)},
                                   mode="decode", cache=cache)
        assert cache["len"] == int(jcache["len"]) == t + 1
        want.append(np.asarray(jl[:, 0]))
        got.append(tl[:, 0].numpy())
    forward, _ = TF.model_apply(params, defs,
                                {"tokens": torch.from_numpy(tokens)},
                                logits_from=P)
    _close(np.stack(got, 1), np.stack(want, 1), _tol(jcfg))
    _close(np.stack(got, 1), forward[:, :DECODE].numpy(), _tol(jcfg))
    _close_caches(cache, jcache, _tol(jcfg))


def test_greedy_tokens_match_jax(model, jprefill, jdecode):
    """Prefill plus 8 greedy decode steps through the serve setups: the
    same 9 tokens per sequence as the reference's decode and greedy
    sample (its ``greedy_decode_step``, with the decode jitted once per
    model)."""
    jcfg, jdefs, jparams, defs, params, tokens = model
    prompt, cap = tokens[:, :P], P + DECODE
    jl, jc = jprefill
    jtok = jnp.argmax(jl[:, -1:, :], axis=-1).astype(jnp.int32)
    want = [np.asarray(jtok)]
    for _ in range(DECODE):
        jl, jc = jdecode(jparams, jtok, jc)
        jtok = JL.sharded_greedy_sample(jl[:, -1:, :], CTX)
        want.append(np.asarray(jtok))
    pre = serve.build_prefill_setup(defs.cfg, device="cpu")
    srv = serve.build_serve_setup(defs.cfg, device="cpu")
    first, cache = pre.prefill_step(params, {"tokens":
                                             torch.from_numpy(prompt)}, cap)
    state = {"params": params, "cache": cache, "tokens": first}
    got = [first.numpy()]
    for _ in range(DECODE):
        state = srv.serve_step(state)
        got.append(state["tokens"].numpy())
    assert state["cache"]["len"] == cap
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))


# ---------------------------------------------------------------------------
# The trainer and the command lines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def trainer_run():
    """The harness of ``test_torch_train.py`` (4 nodes, int8 packed ADC-DGD
    against the reference's exchange-level runtime) on reduced
    mamba2-1.3b, 2 steps of 64-token sequences (two chunks), started
    before the module's first test so that it runs beside them."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        test_torch_train.REPO, "src"))
    env.pop("XLA_FLAGS", None)
    body = (test_torch_train.BODY.replace("__STEPS__", "2")
            .replace('"smollm-135m"', repr("mamba2-1.3b")))
    assert body.count(repr("mamba2-1.3b")) == 2 and "8, 64\n" in body
    proc = subprocess.Popen([sys.executable, "-c", body],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=test_torch_train.REPO)
    yield proc
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def train_result(trainer_run):
    out, err = trainer_run.communicate(timeout=600)
    if trainer_run.returncode != 0:
        raise AssertionError(f"subprocess failed:\n{err[-4000:]}")
    for line in reversed(out.splitlines()):
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise AssertionError(f"no RESULT line:\n{out[-2000:]}")


def test_train_losses_match_reference_exchange(train_result):
    assert len(train_result["tlosses"]) == 2
    for got, want in zip(train_result["tlosses"], train_result["jlosses"]):
        assert got == pytest.approx(want, rel=test_torch_train.LOSS_RTOL)


@pytest.mark.parametrize("what", ["param", "xt"])
def test_train_state_within_grid_steps(train_result, what):
    assert train_result[f"{what}_max"] <= (test_torch_train.MAX_GRID_STEPS
                                           * test_torch_train.FIXED_STEP0)
    assert train_result[f"{what}_frac_off"] <= test_torch_train.MAX_FRAC_OFF


def test_train_cli_on_cpu():
    """``train --arch mamba2-1.3b --reduced --periods 1 --device cpu``: 2
    int8 steps on 2 nodes with the wire bytes of the cut tree."""
    hist = train.main(["--arch", "mamba2-1.3b", "--reduced", "--device",
                       "cpu", "--nodes", "2", "--batch", "4", "--seq", "64",
                       "--steps", "2", "--lr", "1e-2", "--periods", "1"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    cfg = dataclasses.replace(reduced(get_config("mamba2-1.3b")),
                              n_periods=1)
    layout = wire.WireLayout.for_tree(meta_params(
        TF.build_defs(cfg).storage))
    assert hist[-1]["wire_bytes_per_step"] == 2 * layout.n_rows * 516


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--new-tokens", "5", "--keep-logits", "1", "--periods", "1"]
    r = serve.main(argv + ["--prompt-len", "64"])
    assert r["tokens"].shape == (2, 5)
    assert r["cache_len"] == 64 + 4
    np.testing.assert_array_equal(r["logits"][0].argmax(-1),
                                  r["tokens"][0, 1:])
    with pytest.raises(ValueError, match="multiple of min"):
        serve.main(argv + ["--prompt-len", "48"])
