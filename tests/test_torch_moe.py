"""The mixture-of-experts family (granite-moe-3b-a800m, deepseek-moe-16b) on
the port, held to the JAX package.

What the family adds to the dense blocks: the 'E' block (attention, then
the routed experts of ``models.moe``: a top-k router with capacity-limited
slots, the Switch auxiliary loss, deepseek's shared experts) and, for
deepseek, a prelude of one dense 'D' block of width ``dense_d_ff`` with
its own cache entry; ``train_loss`` adds ``router_aux_weight`` times the
auxiliary loss, and the trainer reports its node mean as ``aux``.

Configurations, parameter trees and full-width wire layouts are compared
exactly.  The routing is compared exactly too: the chosen experts, the
kept set and every slot's token, at a capacity factor with no drops (8,
``reduced``'s), one with drops (0.5), and an all-zero router whose ties
must go to experts ``0..k-1`` as ``lax.top_k`` takes them.  Values agree
to float32 rounding (both sides sum in other orders): ``LOSS_RTOL`` on the
loss and the auxiliary loss, ``GRAD_RTOL`` of each leaf's largest
gradient, ``LOGIT_TOL`` on outputs, logits and caches.  Greedy tokens are
equal.  The trainer is held to the reference's exchange-level runtime by
the harness of ``test_torch_train.py``, within its grid-step bounds.
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
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.params import ParamDef as JParamDef
from repro.models.params import materialize_logical
from repro.models.sharding import ParallelContext, local_context
from repro_torch.configs import get_config, reduced
from repro_torch.core import tree as T
from repro_torch.core import wire
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.launch import serve, train
from repro_torch.models import moe as M
from repro_torch.models import transformer as TF
from repro_torch.models.params import meta_params, params_from_jax

import test_torch_train
from test_torch_zoo import _perturb_norms

ARCHS = ("granite-moe-3b-a800m", "deepseek-moe-16b")
CTX = local_context()
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
LOGIT_TOL = 1e-5
B, P, DECODE = 2, 37, 12
#: moe_forward cases: (capacity factor, all-zero router)
ROUTE_CASES = {"cf8": (8.0, False), "cf0.5": (0.5, False),
               "zero-router": (0.5, True)}


def _close(a, b, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def _configs(arch, full):
    jcfg, cfg = jget_config(arch), get_config(arch)
    return (jcfg, cfg) if full else (jreduced(jcfg), reduced(cfg))


def _grads_close(got, want):
    for g, jg in zip(got, want):
        jg = np.asarray(jg)
        g = g.detach().numpy()
        assert g.shape == jg.shape
        err = np.max(np.abs(g - jg)) / np.max(np.abs(jg))
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
        assert (cfg.n_experts, cfg.capacity_factor) == (4, 8.0)
        assert cfg.top_k <= 2 and cfg.moe_d_ff <= 128
        assert cfg.n_shared_experts <= 1


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_defs_match_reference_storage(arch, full):
    """``(path, shape)`` of every leaf in the reference's flatten order:
    sorted keys put ``prelude`` after ``layers``, and ``moe`` after
    ``attn`` and the norms, its ``router < shared < w_down``."""
    jcfg, cfg = _configs(arch, full)
    want = [(jax.tree_util.keystr(p), tuple(d.shape))
            for p, d in jax.tree_util.tree_leaves_with_path(
                JT.build_defs(jcfg, CTX).storage,
                is_leaf=lambda x: isinstance(x, JParamDef))]
    got = [(p, tuple(d.shape)) for p, d in
           T.tree_flatten_with_path(TF.build_defs(cfg).storage)[0]]
    assert got == want
    paths = [p for p, _ in got]
    assert "['layers'][0]['moe']['router']" in paths
    if cfg.prelude:
        assert paths[-1] == "['prelude'][0]['norm2']"
        assert "['prelude'][0]['mlp']['w_gate']" in paths
        assert "['layers'][0]['moe']['shared']['w_up']" in paths
    # one device, no expert parallelism: the expert axis is not padded
    assert dict(got)["['layers'][0]['moe']['router']"][-1] == cfg.n_experts


def _jax_layout(cfg):
    """The reference's layout of its own tree, from shapes only."""
    defs = JT.build_defs(cfg, CTX)
    shapes = jax.eval_shape(lambda: JT.init_params(
        defs, jax.random.PRNGKey(0), CTX))
    return jwire.WireLayout.for_tree(shapes)


#: full-width payload rows of full granite, its trainer's cut on the card
#: (3 of 32 periods; 4 do not fit at 4 nodes), 4 periods, and full
#: deepseek, in the reference's layout; int8 wire bytes per node and step
#: are 2 x rows x 516
FULL_ROWS = {"granite": 6_590_432, "granite-3-periods": 885_152,
             "granite-4-periods": 1_081_888, "deepseek": 31_983_872}
FULL_WIRE_BYTES = {"granite": 6_801_325_824,
                   "granite-3-periods": 913_476_864,
                   "granite-4-periods": 1_116_508_416,
                   "deepseek": 33_007_355_904}
_FULL = {"granite": ("granite-moe-3b-a800m", None),
         "granite-3-periods": ("granite-moe-3b-a800m", 3),
         "granite-4-periods": ("granite-moe-3b-a800m", 4),
         "deepseek": ("deepseek-moe-16b", None)}


@pytest.mark.parametrize("which", list(_FULL))
def test_full_width_wire_rows_and_bytes(which):
    """The packed layout of the full tree (shapes only, nothing allocated)
    and the wire bytes per step equal the reference's."""
    arch, periods = _FULL[which]
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
    assert got.n_rows == FULL_ROWS[which]
    assert got.n_elements == cfg.param_count()
    ctx = ParallelContext(tp=1, data_size=4, n_nodes=4)
    for codec in ("int8", "mixed:norm=int4,embed=int4,*=int8"):
        rt = ConsensusRuntime(ConsensusConfig(wire_codec=codec), 4)
        jrt = JRt(JCfg(wire_codec=codec), ctx)
        got_b = rt.wire_bytes_per_step(got.n_elements, got)
        assert got_b == jrt.wire_bytes_per_step(want.n_elements,
                                                layout=want)
        if codec == "int8":
            assert got_b == 2 * got.n_rows * 516 == FULL_WIRE_BYTES[which]


# ---------------------------------------------------------------------------
# moe_forward
# ---------------------------------------------------------------------------

def _jax_slots(jp, x, jcfg):
    """The reference's routing, step by step as ``repro.models.moe``
    computes it (:67-109): top-k experts, and per expert its slots' token
    ids and use flags, ``(E, C)``."""
    xf = jnp.asarray(x.reshape(-1, x.shape[-1]))
    t = xf.shape[0]
    n_exp, k = jp["router"].shape[-1], jcfg.top_k
    probs = jax.nn.softmax((xf @ jp["router"]).astype(jnp.float32), axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    cap = max(1, int(np.ceil(t * k / jcfg.n_experts * jcfg.capacity_factor)))
    flat_e = top_e.reshape(-1)
    flat_tok = jnp.repeat(jnp.arange(t), k)
    toks, used = [], []
    for e in range(n_exp):
        mask = flat_e == e
        pos = jnp.cumsum(mask) - 1
        keep = mask & (pos < cap)
        slot = jnp.where(keep, pos, cap)
        toks.append(jnp.zeros((cap + 1,), jnp.int32).at[slot].set(
            jnp.where(keep, flat_tok, 0), mode="drop")[:cap])
        used.append(jnp.zeros((cap + 1,), jnp.bool_).at[slot].set(
            keep, mode="drop")[:cap])
    return (np.asarray(top_e), cap, np.asarray(jnp.stack(toks)),
            np.asarray(jnp.stack(used)))


def _port_slots(r: M.Routing, n_exp):
    """The port's routing as the reference's ``(E, C)`` tables."""
    cap = r.capacity
    tok = np.zeros(n_exp * cap + 1, np.int64)
    used = np.zeros(n_exp * cap + 1, bool)
    slot = r.slot.reshape(-1).numpy()
    tok[slot] = np.repeat(np.arange(r.top_e.shape[0]), r.top_e.shape[1])
    used[slot] = True
    return tok[:-1].reshape(n_exp, cap), used[:-1].reshape(n_exp, cap)


@pytest.mark.parametrize("case", list(ROUTE_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_jax(arch, case):
    """One MoE layer at reduced size: the chosen experts, the kept set and
    every slot exactly; the output and the auxiliary loss within
    ``LOSS_RTOL``; the gradients of router, experts and shared experts
    within ``GRAD_RTOL`` of each leaf's largest."""
    cf, zero_router = ROUTE_CASES[case]
    jcfg, cfg = _configs(arch, False)
    jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    cfg = dataclasses.replace(cfg, capacity_factor=cf)
    jp = materialize_logical(JM.moe_defs(jcfg, CTX, jnp.float32),
                             jax.random.PRNGKey(1))
    if zero_router:
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = params_from_jax(jax.device_get(jp), M.moe_defs(cfg), device="cpu")
    x = np.random.default_rng(2).standard_normal(
        (3, 29, cfg.d_model)).astype(np.float32)

    top_e, cap, jtok, jused = _jax_slots(jp, x, jcfg)
    r = M.route(p["router"], torch.from_numpy(x.reshape(-1, cfg.d_model)),
                cfg)
    assert r.capacity == cap
    np.testing.assert_array_equal(r.top_e.numpy(), top_e)
    tok, used = _port_slots(r, cfg.n_experts)
    np.testing.assert_array_equal(used, jused)
    np.testing.assert_array_equal(np.where(used, tok, 0), jtok)
    dropped = int((~r.keep).sum())
    assert dropped == r.keep.numel() - int(jused.sum())
    assert (dropped == 0) == (cf == 8.0)
    if zero_router:
        np.testing.assert_array_equal(
            top_e, np.broadcast_to(np.arange(cfg.top_k), top_e.shape))

    def jloss(jp):
        out, aux = JM.moe_forward(jp, jnp.asarray(x), jcfg, CTX)
        return jnp.sum(jnp.sin(out)) + aux, (out, aux)

    (_, (jout, jaux)), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    leaves, treedef = T.tree_flatten(p)
    leaves = [a.requires_grad_(True) for a in leaves]
    out, aux = M.moe_forward(T.tree_unflatten(treedef, leaves),
                             torch.from_numpy(x), cfg)
    _close(out.detach().numpy(), jout)
    assert float(aux.detach()) == pytest.approx(float(jaux), rel=LOSS_RTOL)
    grads = torch.autograd.grad(torch.sin(out).sum() + aux, leaves)
    _grads_close(grads, jax.tree_util.tree_leaves(jg))


def test_capacity_is_reckoned_in_python_floats():
    """The slot count the reference computes from Python floats, at the
    full configs' decode and prefill shapes."""
    granite, deepseek = get_config(ARCHS[0]), get_config(ARCHS[1])
    x = torch.zeros((1, granite.d_model))
    for cfg, t, want in ((granite, 32, 8), (granite, 63_488, 15_872),
                         (granite, 2048, 512), (deepseek, 2, 1),
                         (deepseek, 3968, 465)):
        r = M.route(torch.zeros((cfg.d_model, cfg.n_experts)),
                    x.new_zeros((t, cfg.d_model)), cfg)
        assert r.capacity == want
    del x


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
    """``ce + router_aux_weight * aux``, its parts and every gradient."""
    jcfg, jdefs, jparams, defs, params, _ = model
    batch = SyntheticLMDataset(jcfg.vocab_size, 48, 2, seed=3).batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jparts), jgrads = jax.value_and_grad(JT.train_loss,
                                                 has_aux=True)(
        jparams, jdefs, jbatch, CTX)
    module = TF.Transformer(defs, params)
    loss, parts = module({k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, T.tree_leaves(module.tree()))
    for got, want in ((loss, jloss), (parts["ce"], jparts["ce"]),
                      (parts["aux"], jparts["aux"])):
        assert float(got.detach()) == pytest.approx(float(want),
                                                     rel=LOSS_RTOL)
    # top_k per MoE layer for a near-uniform router, more when skewed
    n_moe = jcfg.n_periods
    assert float(parts["aux"].detach()) >= 0.9 * jcfg.top_k * n_moe
    _grads_close(grads, jax.tree_util.tree_leaves(jgrads))


def _caches(cache):
    """(path, array) of every K/V entry, the prelude's included."""
    pairs, _ = T.tree_flatten_with_path(
        {k: v for k, v in cache.items() if k != "len"})
    return [(p, np.asarray(a)) for p, a in pairs]


def _close_caches(got, want):
    g, w = _caches(got), _caches(want)
    assert [p for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in
                                 jax.tree_util.tree_leaves_with_path(
                                     {k: v for k, v in want.items()
                                      if k != "len"})]
    for (_, a), (_, b) in zip(g, w):
        assert a.shape == b.shape
        _close(a, b)


def test_prefill_matches_jax(model):
    jcfg, jdefs, jparams, defs, params, tokens = model
    prompt = tokens[:, :P]
    jl, jc, _ = JT.model_apply(jparams, jdefs,
                               {"tokens": jnp.asarray(prompt)}, CTX,
                               mode="prefill")
    tl, tc = TF.model_apply(params, defs,
                            {"tokens": torch.from_numpy(prompt)},
                            mode="prefill")
    _close(tl.numpy(), jl)
    assert tc["len"] == int(jc["len"]) == P
    assert ("prelude" in tc) == bool(jcfg.prelude) == ("prelude" in jc)
    _close_caches(tc, jc)


def _jax_prefill_cache(jparams, jdefs, prompt, capacity):
    """The reference's prefill, its cache padded to ``capacity``
    positions (axis 2 of the stacked entries, axis 1 of the prelude's)."""
    jl, jc, _ = JT.model_apply(jparams, jdefs,
                               {"tokens": jnp.asarray(prompt)}, CTX,
                               mode="prefill")
    pad = capacity - prompt.shape[1]

    def grow(a):
        if a.ndim < 4:
            return a
        widths = [(0, 0)] * a.ndim
        widths[a.ndim - 3] = (0, pad)
        return jnp.pad(a, widths)
    return jl, jax.tree.map(grow, jc)


def test_decode_matches_jax_token_by_token(model):
    """Teacher-forced decode of 12 tokens after the prompt: logits against
    the reference's decode and the port's own train-mode forward (no
    assignment drops at capacity factor 8), and the caches, prelude
    included."""
    jcfg, jdefs, jparams, defs, params, tokens = model
    cap = P + DECODE
    _, jcache = _jax_prefill_cache(jparams, jdefs, tokens[:, :P], cap)
    jdecode = jax.jit(lambda p, tok, c: JT.model_apply(
        p, jdefs, {"tokens": tok}, CTX, mode="decode", cache=c,
        remat=False)[:2])
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
    _close(np.stack(got, 1), np.stack(want, 1))
    _close(np.stack(got, 1), forward.numpy())
    _close_caches(cache, jcache)


def test_greedy_tokens_match_jax(model):
    """Prefill plus 12 greedy decode steps through the serve setups: the
    same 13 tokens per sequence as the reference's ``greedy_decode_step``.
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


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def train_result(request):
    """The harness of ``test_torch_train.py`` (4 nodes, int8 packed ADC-DGD
    against the reference's exchange-level runtime) on a reduced MoE arch,
    2 steps of 32-token sequences; the reference's per-node loss is its
    ``train_loss``, aux included."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        test_torch_train.REPO, "src"))
    env.pop("XLA_FLAGS", None)
    body = (test_torch_train.BODY.replace("__STEPS__", "2")
            .replace("1e-2, 8, 64", "1e-2, 8, 32")
            .replace('"smollm-135m"', repr(request.param)))
    assert body.count(repr(request.param)) == 2 and "8, 32\n" in body
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


@pytest.mark.parametrize("arch,microbatches", [
    ("granite-moe-3b-a800m", 1), ("granite-moe-3b-a800m", 2),
    ("smollm-135m", 1)], ids=["granite", "granite-microbatches-2", "dense"])
def test_trainer_aux_metric(arch, microbatches):
    """The step metrics' ``aux``: the node mean of the reference's
    per-node auxiliary loss from the same weights on the same shards; 0
    for a dense model; absent with microbatches, as in the reference."""
    n, bsz, seq = 2, 4, 32
    jcfg = jreduced(jget_config(arch))
    jdefs = JT.build_defs(jcfg, CTX)
    p0 = jax.device_get(JT.init_params(jdefs, jax.random.PRNGKey(4), CTX))
    setup = train.build_train_setup(reduced(get_config(arch)),
                                    consensus_nodes=n, device="cpu",
                                    microbatches=microbatches)
    state = train.init_train_state(setup, params=params_from_jax(
        p0, setup.defs.storage, device="cpu", n_nodes=n))
    batch = SyntheticLMDataset(jcfg.vocab_size, seq, bsz,
                               n_shards=n).global_batch_arrays(0)
    _, metrics = train.train_step(setup, state, batch)
    if microbatches > 1:
        assert "aux" not in metrics
        return
    bn = bsz // n
    aux_of = jax.jit(lambda p, b: JT.train_loss(p, jdefs, b, CTX)[1]["aux"])
    want = np.mean([float(aux_of(p0, {k: jnp.asarray(v[i * bn:(i + 1) * bn])
                                      for k, v in batch.items()}))
                    for i in range(n)])
    if jcfg.n_experts:
        assert metrics["aux"] == pytest.approx(want, rel=LOSS_RTOL)
        assert metrics["aux"] > 0
    else:
        assert metrics["aux"] == want == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_on_cpu(arch):
    """``train --arch <arch> --reduced --periods 1 --device cpu``: 2 int8
    steps on 2 nodes, with the wire bytes of the cut tree and the aux
    metric."""
    hist = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--nodes", "2", "--batch", "4", "--seq", "32",
                       "--steps", "2", "--lr", "1e-2", "--periods", "1"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert all(h["aux"] > 0 for h in hist)
    cfg = dataclasses.replace(reduced(get_config(arch)), n_periods=1)
    layout = wire.WireLayout.for_tree(meta_params(
        TF.build_defs(cfg).storage))
    assert hist[-1]["wire_bytes_per_step"] == 2 * layout.n_rows * 516


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch):
    r = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "19", "--new-tokens",
                    "5", "--keep-logits", "1"])
    assert r["tokens"].shape == (2, 5)
    assert r["cache_len"] == 19 + 4
    np.testing.assert_array_equal(r["logits"][0].argmax(-1),
                                  r["tokens"][0, 1:])
