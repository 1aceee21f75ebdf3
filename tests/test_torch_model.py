"""The port's model, optimizers, schedules and data held to the JAX package.

From the same parameters (carried over with ``params_from_jax``) and the
same batch, the port's ``train_loss`` and its autograd gradients are held
to the reference's single-device ``T.train_loss`` and ``jax.grad`` — the
oracle of the reference's own distributed-gradient tests.  Both run
float32 on the CPU but sum in different orders (XLA vs PyTorch matmuls,
the reference's online softmax vs a plain one), so values agree to float32
rounding, not bit for bit: ``LOSS_RTOL`` on the loss, ``GRAD_RTOL`` of each
leaf's largest gradient on the gradients.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data import SyntheticLMDataset as JDataset
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.sharding import local_context
from repro_torch import optim
from repro_torch.configs import get_config, reduced
from repro_torch.core import tree as T
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.models.params import params_from_jax

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = jreduced(jget_config("smollm-135m"))
    jdefs = JT.build_defs(jcfg, local_context())
    jparams = JT.init_params(jdefs, jax.random.PRNGKey(0))
    # non-zero norm weights, so the (1 + w) scaling is exercised too
    jparams = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(1),
                                                 a.shape)
        if "norm" in jax.tree_util.keystr(p) else a, jparams)
    defs = TF.build_defs(reduced(get_config("smollm-135m")))
    params = params_from_jax(jax.device_get(jparams), defs.storage,
                             device="cpu")
    batch = SyntheticLMDataset(jcfg.vocab_size, 64, 4, seed=3).batch(0)
    return jcfg, jdefs, jparams, defs, params, batch


def test_dataset_batches_identical():
    for kw in (dict(vocab_size=1024, seq_len=64, global_batch=8, seed=0,
                    n_shards=4),
               dict(vocab_size=49152, seq_len=128, global_batch=4, seed=5,
                    n_shards=2)):
        a, b = JDataset(**kw), SyntheticLMDataset(**kw)
        for step in (0, 3):
            ga, gb = a.global_batch_arrays(step), b.global_batch_arrays(step)
            for k in ga:
                assert ga[k].dtype == gb[k].dtype
                np.testing.assert_array_equal(ga[k], gb[k])


def test_weight_carry_keeps_structure(setup):
    _, _, jparams, defs, params, _ = setup
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    tl, _ = T.tree_flatten_with_path(params)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_train_loss_and_grads_match_jax(setup):
    jcfg, jdefs, jparams, defs, params, batch = setup
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(JT.train_loss, has_aux=True)(
        jparams, jdefs, jbatch, local_context())
    model = TF.Transformer(defs, params)
    loss, parts = model({k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, T.tree_leaves(model.tree()))
    loss = float(loss.detach())
    assert loss == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert float(parts["ce"].detach()) == loss
    for g, jg in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        jg = np.asarray(jg)
        assert g.shape == jg.shape
        err = np.max(np.abs(g.numpy() - jg)) / np.max(np.abs(jg))
        assert err < GRAD_RTOL, err


def test_transformer_module_shares_storage(setup):
    _, _, _, defs, params, batch = setup
    model = TF.Transformer(defs, params)
    names = dict(model.named_parameters())
    assert "params.layers.0.attn.wq" in names
    assert "params.embed.table" in names and "params.final_norm" in names
    assert names["params.layers.0.attn.wq"].data_ptr() == \
        params["layers"][0]["attn"]["wq"].data_ptr()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert float(model(tb)[0].detach()) == \
        float(TF.train_loss(params, defs, tb)[0].detach())


@pytest.mark.parametrize("change", [
    {"mlp_act": "gelu_mlp"}, {"period": "AE", "mlp_act": "gelu_mlp"}])
def test_unported_model_features_say_so(change):
    """Configurations the ported layers do not compute (the plain gelu
    MLP, which the reference's own ``_act`` refuses too) are refused, not
    silently run as another model.  The dense features (periods of 'A' and
    'L', q/k norms, untied embeddings, softcaps, embedding scale, GeGLU)
    are held to the reference in ``test_torch_zoo.py``; the MoE 'E'
    blocks, the dense 'D' block and preludes in ``test_torch_moe.py``; the
    Mamba2 'M' and 'X' blocks in ``test_torch_ssm.py`` and below; the
    encoder-decoder stack in ``test_torch_whisper.py``."""
    import dataclasses
    cfg = dataclasses.replace(reduced(get_config("smollm-135m")), **change)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        TF.build_defs(cfg)


@pytest.mark.parametrize("change", [
    {"prelude": "M"}, {"prelude": "X"}, {"period": "M"}, {"period": "LAM"},
    {"period": "X"}, {"period": "EM"}])
def test_mamba_model_features_match_reference_storage(change):
    """Mamba2 blocks, plain or with experts, in the prelude or the period,
    beside attention blocks: the storage tree (every leaf's path and
    shape, in the reference's flatten order) equals the reference's
    ``build_defs`` of the same config (reduced jamba-v0.1-52b, which has
    attention, experts, a dense MLP and the SSM fields, with a sliding
    window for 'L')."""
    import dataclasses
    from repro.models.params import ParamDef as JParamDef
    change = dict(change, sliding_window=64)
    jcfg = dataclasses.replace(jreduced(jget_config("jamba-v0.1-52b")),
                               **change)
    cfg = dataclasses.replace(reduced(get_config("jamba-v0.1-52b")),
                              **change)
    want = [(jax.tree_util.keystr(p), tuple(d.shape))
            for p, d in jax.tree_util.tree_leaves_with_path(
                JT.build_defs(jcfg, local_context()).storage,
                is_leaf=lambda x: isinstance(x, JParamDef))]
    got = [(p, tuple(d.shape)) for p, d in
           T.tree_flatten_with_path(TF.build_defs(cfg).storage)[0]]
    assert got == want
    assert any("['mamba']['conv_x']" in p for p, _ in got)


@pytest.mark.parametrize("fn", ["rms_norm", "rope", "attention", "xent"])
def test_layers_match_jax(fn):
    rng = np.random.default_rng(7)
    if fn == "rms_norm":
        x = rng.standard_normal((2, 5, 64)).astype(np.float32)
        w = rng.standard_normal(64).astype(np.float32) * 0.1
        got = L.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
        want = JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
        rtol = 1e-6
    elif fn == "rope":
        x = rng.standard_normal((2, 9, 3, 64)).astype(np.float32)
        got = L.apply_rope(torch.from_numpy(x), torch.arange(9), 10_000.0)
        want = JL.apply_rope(jnp.asarray(x), jnp.arange(9), 10_000.0)
        rtol = 1e-5
    elif fn == "attention":
        q = rng.standard_normal((2, 16, 2, 3, 32)).astype(np.float32)
        k = rng.standard_normal((2, 16, 2, 32)).astype(np.float32)
        v = rng.standard_normal((2, 16, 2, 32)).astype(np.float32)
        got = L.chunked_attention(*map(torch.from_numpy, (q, k, v)))
        want = JL.chunked_attention(*map(jnp.asarray, (q, k, v)))
        rtol = 1e-5
    else:
        logits = rng.standard_normal((2, 7, 50)).astype(np.float32) * 3
        tgt = rng.integers(0, 50, (2, 7)).astype(np.int32)
        cfg = jreduced(jget_config("smollm-135m"))
        got = L.sharded_softmax_xent(torch.from_numpy(logits),
                                     torch.from_numpy(tgt))
        want = JL.sharded_softmax_xent(jnp.asarray(logits), jnp.asarray(tgt),
                                       cfg, local_context())
        rtol = 1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=rtol)


def _opt_case(rng):
    p = {"a": rng.standard_normal((3, 4)).astype(np.float32),
         "b": (rng.standard_normal(5).astype(np.float32),)}
    g = T.tree_map(lambda a: (a * 0.3 + 0.1).astype(np.float32), p)
    return p, g


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("sgd", {"weight_decay":
                                                           0.1}),
                                     ("momentum", {}),
                                     ("momentum", {"nesterov": True}),
                                     ("adam", {})])
def test_optimizers_match_jax(name, kw):
    p, g = _opt_case(np.random.default_rng(2))
    jopt, topt = joptim.by_name(name, **kw), optim.by_name(name, **kw)
    jp = jax.tree.map(jnp.asarray, p)
    tp = T.tree_map(torch.from_numpy, p)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        jp, js = jopt.step(js, jp, jax.tree.map(jnp.asarray, g),
                           jnp.float32(0.05))
        tp, ts = topt.step(ts, tp, T.tree_map(torch.from_numpy, g), 0.05)
    for a, b in zip(T.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def _predicted_moves(alpha0, ks):
    """The steps where the jitted ``alpha0 / k**0.5`` may move from the
    port's: XLA compiles it as ``alpha0 * rsqrt(k)``, and its CPU rsqrt
    is an approximation, one ulp off the correctly rounded value the port
    takes for some k.  Returns (moved mask, the reference's values there
    as predicted from XLA's own rsqrt, the port's values there)."""
    kf = np.maximum(np.float32(1), ks.astype(np.float32))
    approx = np.asarray(jax.jit(jax.lax.rsqrt)(kf))
    exact = (1.0 / np.sqrt(kf.astype(np.float64))).astype(np.float32)
    return (approx != exact, np.float32(alpha0) * approx,
            np.float32(alpha0) * exact)


@pytest.mark.parametrize("kind", ["constant", "inverse_power", "cosine"])
def test_schedules_match_jax(kind):
    """Every step 0-2,000 equals the reference's schedule as compiled
    (``jit``), bit for bit.  At eta 0.5 the steps where XLA's approximate
    rsqrt moves the reference by an ulp are predicted and checked apart."""
    ks = np.arange(0, 2001, dtype=np.int32)
    if kind == "constant":
        cases = [(joptim.constant_schedule(0.03),
                  optim.constant_schedule(0.03), None)]
    elif kind == "inverse_power":
        cases = [(joptim.inverse_power_schedule(0.03, eta),
                  optim.inverse_power_schedule(0.03, eta), eta)
                 for eta in (0.5, 0.75)]
    else:
        cases = [(joptim.cosine_warmup_schedule(0.03, w, n),
                  optim.cosine_warmup_schedule(0.03, w, n), None)
                 for w, n in ((5, 50), (100, 1000))]
    for j, t, eta in cases:
        want = np.asarray(jax.jit(jax.vmap(j))(jnp.asarray(ks)))
        got = np.array([t(int(k)) for k in ks], np.float32)
        moved = np.zeros(ks.shape, bool)
        if eta == 0.5:
            moved, predicted, port = _predicted_moves(0.03, ks)
            assert moved.any()
            np.testing.assert_array_equal(want[moved], predicted[moved])
            np.testing.assert_array_equal(got[moved], port[moved])
        np.testing.assert_array_equal(got[~moved], want[~moved])
