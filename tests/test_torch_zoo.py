"""The dense model zoo (qwen3-0.6b, yi-9b, chameleon-34b, gemma2-9b) on the
port, held to the JAX package.

What each architecture adds to smollm-135m's blocks: q/k norms (qwen3,
chameleon), an untied ``unembed`` matrix (yi, chameleon), and for gemma2
the period ``LA`` of sliding-window and global blocks, post-norms,
attention and final softcaps, the ``sqrt(d_model)`` embedding scale and
GeGLU; gemma2 also serves with ``long_serve``, which caps its 'A' blocks
at ``long_context_window``.

Configurations and parameter trees are compared exactly, at full size and
at ``reduced`` size.  The model runs at ``reduced`` size (sliding window
64, long-context window 128) with the reference's ``init_params`` carried
over by ``params_from_jax``, norm weights perturbed so that ``(1 + w)`` is
exercised; prompts are longer than the window (and, for ``long_serve``,
than the cap).  Both sides run float32 on the CPU but sum in other orders,
and PyTorch's ``tanh`` (softcaps, GeGLU) is another approximation than
XLA's, so values agree to float32 rounding, not bit for bit: ``LOSS_RTOL``
relative on the loss, ``GRAD_RTOL`` of each leaf's largest gradient on the
gradients, ``LOGIT_TOL`` absolute and relative on logits, caches and
attention outputs.  Greedy tokens and wire rows and bytes are equal
exactly.  The trainer is held to the reference's exchange-level runtime
by the harness of ``test_torch_train.py``, within its grid-step bounds.
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
from repro.configs import shape_applicable as jshape_applicable
from repro.core import wire as jwire
from repro.core.distributed import ConsensusConfig as JCfg
from repro.core.distributed import ConsensusRuntime as JRt
from repro.data import SyntheticLMDataset
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.config import INPUT_SHAPES as JINPUT_SHAPES
from repro.models.params import ParamDef as JParamDef
from repro.models.sharding import ParallelContext, local_context
from repro_torch.configs import get_config, reduced, shape_applicable
from repro_torch.core import tree as T
from repro_torch.core import wire
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.launch import serve, train
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.models.params import meta_params, params_from_jax

import test_torch_train

ARCHS = ("qwen3-0.6b", "yi-9b", "chameleon-34b", "gemma2-9b")
CTX = local_context()
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
LOGIT_TOL = 1e-5
#: prompt length of the model tests: a prime above reduced gemma2's
#: sliding window of 64, so 'L' blocks mask in prefill and in decode
B, P, DECODE = 2, 67, 16
#: the long_serve prompt: a prime above reduced gemma2's cap of 128
LONG_P = 131


def _close(a, b, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def _configs(arch, full):
    jcfg, cfg = jget_config(arch), get_config(arch)
    return (jcfg, cfg) if full else (jreduced(jcfg), reduced(cfg))


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, full):
    jcfg, cfg = _configs(arch, full)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.citation and cfg.citation == jcfg.citation
    assert cfg.param_count() == jcfg.param_count()
    for name, shape in JINPUT_SHAPES.items():
        assert dataclasses.asdict(INPUT_SHAPES[name]) == \
            dataclasses.asdict(shape)
        assert shape_applicable(cfg, INPUT_SHAPES[name]) == \
            jshape_applicable(jcfg, shape)


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_defs_match_reference_storage(arch, full):
    """``(path, shape)`` of every leaf, in the reference's flatten order
    (sorted keys: ``k_norm < q_norm < wk``, ``norm1 < norm1_post <
    norm2``, ``table < unembed``, one stacked tree per code of the
    period)."""
    jcfg, cfg = _configs(arch, full)
    want = [(jax.tree_util.keystr(p), tuple(d.shape))
            for p, d in jax.tree_util.tree_leaves_with_path(
                JT.build_defs(jcfg, CTX).storage,
                is_leaf=lambda x: isinstance(x, JParamDef))]
    got = [(p, tuple(d.shape)) for p, d in
           T.tree_flatten_with_path(TF.build_defs(cfg).storage)[0]]
    assert got == want
    paths = [p for p, _ in got]
    if cfg.qk_norm:
        assert "['layers'][0]['attn']['q_norm']" in paths
    if not cfg.tie_embeddings:
        assert paths[1] == "['embed']['unembed']"
    if cfg.post_norms:
        assert "['layers'][1]['norm2_post']" in paths


def _jax_layout(cfg):
    """The reference's layout of its own parameter tree, from shapes only
    (``jax.eval_shape`` of ``init_params``: nothing is allocated)."""
    defs = JT.build_defs(cfg, CTX)
    shapes = jax.eval_shape(lambda: JT.init_params(
        defs, jax.random.PRNGKey(0), CTX))
    return jwire.WireLayout.for_tree(shapes)


#: full-width payload rows of the two trainer archs (the reference's
#: layout of its tree, padded to TILE_N rows), and so int8 wire bytes per
#: node and step, 2 x rows x 516
FULL_ROWS = {"qwen3-0.6b": 1_164_160, "gemma2-9b": 18_050_208}
FULL_WIRE_BYTES = {"qwen3-0.6b": 1_201_413_120, "gemma2-9b": 18_627_814_656}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-9b"])
def test_full_width_wire_rows_and_bytes(arch):
    """The packed layout of the full tree (shapes only) and the wire bytes
    per step of the int8 exchange equal the reference's."""
    jcfg, cfg = _configs(arch, True)
    want = _jax_layout(jcfg)
    got = wire.WireLayout.for_tree(meta_params(TF.build_defs(cfg).storage))
    assert [(s.path, s.shape, s.row_start, s.n_rows, s.size)
            for s in got.slots] == \
        [(s.path, s.shape, s.row_start, s.n_rows, s.size)
         for s in want.slots]
    assert (got.n_rows, got.n_data_rows, got.n_elements) == \
        (want.n_rows, want.n_data_rows, want.n_elements)
    assert got.n_rows == FULL_ROWS[arch]
    ctx = ParallelContext(tp=1, data_size=3, n_nodes=3)
    for codec in ("int8", "int4", "mixed:norm=int4,embed=int4,*=int8"):
        rt = ConsensusRuntime(ConsensusConfig(wire_codec=codec), 3)
        jrt = JRt(JCfg(wire_codec=codec), ctx)
        got_b = rt.wire_bytes_per_step(got.n_elements, got)
        assert got_b == jrt.wire_bytes_per_step(want.n_elements,
                                                layout=want)
        if codec == "int8":
            assert got_b == 2 * got.n_rows * 516 == FULL_WIRE_BYTES[arch]


def _perturb_norms(jparams):
    """Non-zero norm weights (q/k and post-norms too), each leaf its own
    draw, so the ``(1 + w)`` scaling is exercised and a norm read in place
    of another shows."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(jparams)
    return jax.tree_util.tree_unflatten(treedef, [
        a + 0.1 * jax.random.normal(jax.random.PRNGKey(1 + i), a.shape)
        if "norm" in jax.tree_util.keystr(p) else a
        for i, (p, a) in enumerate(leaves)])


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg, cfg = _configs(arch, False)
    jdefs = JT.build_defs(jcfg, CTX)
    jparams = JT.init_params(jdefs, jax.random.PRNGKey(0), CTX)
    jparams = _perturb_norms(jparams)
    defs = TF.build_defs(cfg)
    params = params_from_jax(jax.device_get(jparams), defs.storage,
                             device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, P + DECODE), dtype=np.int32)
    return jcfg, jdefs, jparams, defs, params, tokens


def test_weight_carry_keeps_structure(model):
    _, _, jparams, _, params, _ = model
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    tl, _ = T.tree_flatten_with_path(params)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_train_loss_and_grads_match_jax(model):
    jcfg, jdefs, jparams, defs, params, _ = model
    batch = SyntheticLMDataset(jcfg.vocab_size, 96, 2, seed=3).batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(JT.train_loss, has_aux=True)(
        jparams, jdefs, jbatch, CTX)
    module = TF.Transformer(defs, params)
    loss, _ = module({k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, T.tree_leaves(module.tree()))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    for g, jg in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        jg = np.asarray(jg)
        assert g.shape == jg.shape
        err = np.max(np.abs(g.numpy() - jg)) / np.max(np.abs(jg))
        assert err < GRAD_RTOL, err


def test_prefill_matches_jax(model):
    jcfg, jdefs, jparams, defs, params, tokens = model
    prompt = tokens[:, :P]
    jl, jc, _ = JT.model_apply(jparams, jdefs, {"tokens": jnp.asarray(prompt)},
                               CTX, mode="prefill")
    tl, tc = TF.model_apply(params, defs, {"tokens": torch.from_numpy(prompt)},
                            mode="prefill")
    _close(tl.numpy(), jl)
    assert tc["len"] == int(jc["len"]) == P
    assert len(tc["layers"]) == len(jc["layers"]) == len(jcfg.period)
    for j in range(len(jcfg.period)):
        for key in ("k", "v"):
            want = jc["layers"][j]["attn"][key]
            got = tc["layers"][j]["attn"][key]
            assert tuple(got.shape) == tuple(want.shape)
            _close(got.numpy(), want)
    # the logits of a suffix only: the same values, no other positions
    last, _ = TF.model_apply(params, defs,
                             {"tokens": torch.from_numpy(prompt)},
                             logits_from=P - 1)
    assert last.shape == (B, 1, jcfg.vocab_size)
    _close(last[:, 0].numpy(), jl[:, -1])


def _jax_prefill_cache(jparams, jdefs, prompt, capacity, long_serve=False):
    jl, jc, _ = JT.model_apply(jparams, jdefs, {"tokens": jnp.asarray(prompt)},
                               CTX, mode="prefill", long_serve=long_serve)
    pad = capacity - prompt.shape[1]
    jc = jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, pad), (0, 0), (0, 0)])
        if a.ndim == 5 else a, jc)
    return jl, jc


def _decode_both(model, prompt_len, steps, long_serve=False):
    """Teacher-forced decode of ``steps`` tokens after a prefill of
    ``prompt_len``: per-step logits of the reference, of the port, and the
    port's train-mode logits at the same positions."""
    jcfg, jdefs, jparams, defs, params, tokens = model
    seq = tokens if tokens.shape[1] >= prompt_len + steps else \
        np.random.default_rng(1).integers(
            0, jcfg.vocab_size, (B, prompt_len + steps), dtype=np.int32)
    cap = prompt_len + steps
    _, jcache = _jax_prefill_cache(jparams, jdefs, seq[:, :prompt_len], cap,
                                   long_serve)
    jdecode = jax.jit(lambda p, tok, c: JT.model_apply(
        p, jdefs, {"tokens": tok}, CTX, mode="decode", cache=c,
        remat=False, long_serve=long_serve)[:2])
    cache = TF.init_cache(defs.cfg, B, cap)
    _, cache = TF.model_apply(
        params, defs, {"tokens": torch.from_numpy(seq[:, :prompt_len])},
        mode="prefill", cache=cache, long_serve=long_serve)
    want, got = [], []
    for t in range(prompt_len, cap):
        tok = seq[:, t:t + 1]
        jl, jcache = jdecode(jparams, jnp.asarray(tok), jcache)
        tl, cache = TF.model_apply(params, defs,
                                   {"tokens": torch.from_numpy(tok)},
                                   mode="decode", cache=cache,
                                   long_serve=long_serve)
        assert cache["len"] == int(jcache["len"]) == t + 1
        want.append(np.asarray(jl[:, 0]))
        got.append(tl[:, 0].numpy())
    train, _ = TF.model_apply(
        params, defs, {"tokens": torch.from_numpy(seq[:, :cap])},
        long_serve=long_serve, logits_from=prompt_len)
    return np.stack(want, 1), np.stack(got, 1), train.numpy(), cache, jcache


def test_decode_matches_jax_token_by_token(model):
    """16 decode steps past a prompt longer than reduced gemma2's window:
    logits against the reference's decode and the port's own train-mode
    forward, and the caches."""
    want, got, train, cache, jcache = _decode_both(model, P, DECODE)
    _close(got, want)
    _close(got, train)
    for j, layer in enumerate(cache["layers"]):
        for key in ("k", "v"):
            _close(layer["attn"][key].numpy(),
                   jcache["layers"][j]["attn"][key])


def test_greedy_tokens_match_jax(model):
    """Prefill plus 16 greedy decode steps through the serve setups: the
    same 17 tokens per sequence as the reference's ``greedy_decode_step``.
    """
    jcfg, jdefs, jparams, defs, params, tokens = model
    prompt, cap = tokens[:, :P], P + DECODE
    jl, jc = _jax_prefill_cache(jparams, jdefs, prompt, cap)
    jtok = jnp.argmax(jl[:, -1:, :], axis=-1).astype(jnp.int32)
    want = [np.asarray(jtok)]
    jstep = jax.jit(lambda p, tok, c: JT.greedy_decode_step(p, jdefs, tok, c,
                                                            CTX))
    for _ in range(DECODE):
        jtok, jc = jstep(jparams, jtok, jc)
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


def test_gemma2_long_serve_matches_jax():
    """``long_serve`` on reduced gemma2 (cap 128, window 64): a prompt of
    131 then 16 decode steps, prefill and decode against the reference's
    ``long_serve=True``; without the cap the logits differ, so it bites."""
    jcfg, cfg = _configs("gemma2-9b", False)
    assert cfg.long_context_window == 128 and cfg.sliding_window == 64
    jdefs = JT.build_defs(jcfg, CTX)
    jparams = _perturb_norms(JT.init_params(jdefs, jax.random.PRNGKey(2),
                                            CTX))
    defs = TF.build_defs(cfg)
    params = params_from_jax(jax.device_get(jparams), defs.storage,
                             device="cpu")
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, LONG_P + DECODE), dtype=np.int32)
    m = (jcfg, jdefs, jparams, defs, params, tokens)
    want, got, train, cache, jcache = _decode_both(m, LONG_P, DECODE,
                                                   long_serve=True)
    _close(got, want)
    _close(got, train)
    jl, _ = _jax_prefill_cache(jparams, jdefs, tokens[:, :LONG_P], LONG_P,
                               long_serve=True)
    tl, _ = TF.model_apply(params, defs,
                           {"tokens": torch.from_numpy(tokens[:, :LONG_P])},
                           mode="prefill", long_serve=True)
    _close(tl.numpy(), jl)
    uncapped, _, _, _, _ = _decode_both(m, LONG_P, DECODE)
    assert np.abs(uncapped - want).max() > 100 * LOGIT_TOL


#: chunked_attention cases: (sq, sk, causal, window, softcap, q_offset,
#: k_offset, chunk_q, chunk_k); several blocks each way, and a prime length
#: whose chunks fall to one position
ATTN_CASES = {
    "causal": (96, 96, True, None, None, 0, 0, 40, 64),
    "window": (96, 96, True, 20, None, 0, 0, 32, 48),
    "softcap": (64, 64, True, None, 30.0, 0, 0, 16, 32),
    "window+softcap": (64, 64, True, 16, 50.0, 0, 0, 16, 16),
    "q_offset": (24, 64, True, None, None, 40, 0, 8, 16),
    "offsets+window": (24, 64, True, 12, 50.0, 48, 8, 12, 16),
    "not causal": (32, 48, False, None, None, 0, 0, 16, 16),
    "prime": (67, 67, True, 9, 50.0, 0, 0, 16, 32),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_matches_jax(case):
    sq, sk, causal, window, cap, qo, ko, cq, ck = ATTN_CASES[case]
    rng = np.random.default_rng(sq + sk)
    q = rng.standard_normal((2, sq, 2, 3, 32)).astype(np.float32) * 2
    k = rng.standard_normal((2, sk, 2, 32)).astype(np.float32) * 2
    v = rng.standard_normal((2, sk, 2, 32)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=qo,
              k_offset=ko, chunk_q=cq, chunk_k=ck)
    got = L.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    want = JL.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    assert got.shape == want.shape
    _close(got.numpy(), want)
    # the block split does not change the values beyond rounding
    one = L.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                              **dict(kw, chunk_q=sq, chunk_k=sk))
    _close(got.numpy(), one.numpy())


@pytest.fixture(scope="module", params=["qwen3-0.6b", "gemma2-9b"])
def train_result(request):
    """The harness of ``test_torch_train.py`` (4 nodes, int8 packed ADC-DGD
    against the reference's exchange-level runtime) on a reduced arch, 2
    steps."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        test_torch_train.REPO, "src"))
    env.pop("XLA_FLAGS", None)
    body = (test_torch_train.BODY.replace("__STEPS__", "2")
            .replace('"smollm-135m"', repr(request.param)))
    proc = subprocess.run([sys.executable, "-c", body], capture_output=True,
                          text=True, timeout=600, env=env,
                          cwd=test_torch_train.REPO)
    if proc.returncode != 0:
        raise AssertionError(f"subprocess failed:\n{proc.stderr[-4000:]}")
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise AssertionError(f"no RESULT line:\n{proc.stdout[-2000:]}")


def test_train_losses_match_reference_exchange(train_result):
    assert len(train_result["tlosses"]) == 2
    for got, want in zip(train_result["tlosses"], train_result["jlosses"]):
        assert got == pytest.approx(want, rel=test_torch_train.LOSS_RTOL)


@pytest.mark.parametrize("what", ["param", "xt"])
def test_train_state_within_grid_steps(train_result, what):
    assert train_result[f"{what}_max"] <= (test_torch_train.MAX_GRID_STEPS
                                           * test_torch_train.FIXED_STEP0)
    assert train_result[f"{what}_frac_off"] <= test_torch_train.MAX_FRAC_OFF


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_on_cpu(arch):
    """``train --arch <arch> --reduced --device cpu``: 2 int8 steps on 3
    nodes, with the wire bytes of the reduced tree."""
    hist = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--nodes", "3", "--batch", "6", "--seq", "32",
                       "--steps", "2", "--lr", "1e-2"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    layout = wire.WireLayout.for_tree(meta_params(
        TF.build_defs(reduced(get_config(arch))).storage))
    assert hist[-1]["wire_bytes_per_step"] == 2 * layout.n_rows * 516


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen3-0.6b"], ["--arch", "yi-9b"],
    ["--arch", "chameleon-34b", "--periods", "1"],
    ["--arch", "gemma2-9b", "--prompt-len", "70"],
    ["--arch", "gemma2-9b", "--long-serve", "--prompt-len", "131"]],
    ids=["qwen3", "yi", "chameleon-1-period", "gemma2", "gemma2-long"])
def test_serve_cli_on_cpu(argv):
    r = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                    "--new-tokens", "5", "--keep-logits", "1", *argv])
    n_prompt = r["prompts"].shape[1]
    assert r["tokens"].shape == (2, 5)
    assert r["cache_len"] == n_prompt + 4
    np.testing.assert_array_equal(r["logits"][0].argmax(-1),
                                  r["tokens"][0, 1:])


def test_serve_cli_refuses_what_does_not_apply():
    with pytest.raises(SystemExit, match="long_context_window"):
        serve.main(["--reduced", "--device", "cpu", "--arch", "yi-9b",
                    "--long-serve"])
    with pytest.raises(SystemExit, match="--periods"):
        serve.main(["--reduced", "--device", "cpu", "--arch", "yi-9b",
                    "--periods", "3"])
