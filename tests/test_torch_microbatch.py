"""Gradient accumulation (``--microbatches``) held to the reference.

The reference (``repro.launch.train`` ``step_body``) splits a node's batch
into M slices, takes the first slice's gradient and loss, adds each later
one's in order (``lax.scan``) and divides by M under ``jit``.  XLA compiles
``g / M`` to ``g * f32(1/M)`` (ROADMAP hazard 6); at M = 3 that differs
from a true division, so the port multiplies by ``f32(1/M)`` too.

  * The composition, bitwise: the port's accumulated gradient and loss
    equal the reference's jitted composition applied to the port's own
    per-slice gradients, at M = 2, 4 and 3.
  * The gradient: the port's microbatched gradient against the
    reference's single-device ``train_loss`` composed the same way, within
    ``GRAD_RTOL`` of each leaf's largest gradient (float32 sums in another
    order, as ``tests/test_torch_model.py`` holds the gradient), and the
    loss within ``LOSS_RTOL``.
  * The trainer's ``--microbatches`` and its refusal of a batch that does
    not split.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.models import transformer as JT
from repro.models.sharding import local_context
from repro_torch.configs import get_config, reduced
from repro_torch.core import tree as T
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch import train
from repro_torch.models.params import params_from_jax

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BATCH, SEQ = 12, 32
MS = [2, 4, 3]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the embedding's backward accumulates in a
    thread-dependent order on the CPU, and these tests compare bits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jget_config("smollm-135m"))
    jdefs = JT.build_defs(jcfg, local_context())
    jparams = JT.init_params(jdefs, jax.random.PRNGKey(0))
    batch = SyntheticLMDataset(jcfg.vocab_size, SEQ, BATCH,
                               seed=3).global_batch_arrays(0)
    return jdefs, jparams, batch


def _port_grads(jparams, batch, m):
    """One node's (loss, gradient leaves) through the trainer's
    accumulation at ``m`` microbatches."""
    setup = train.build_train_setup(reduced(get_config("smollm-135m")),
                                    consensus_nodes=1, device="cpu",
                                    microbatches=m)
    params = params_from_jax(jax.device_get(jparams), setup.defs.storage,
                             device="cpu", n_nodes=1)
    losses, grads = train._node_grads(setup, params, batch)
    return losses[0], [g[0] for g in T.tree_leaves(grads)]


def _reference_compose(m):
    """The reference's accumulation of per-slice (loss, grads), jitted: the
    first slice outside the scan, the rest added in order, then ``/ m``."""
    def compose(losses, grads):
        def add(acc, x):
            (g_acc, l_acc), (g, l) = acc, x
            return (jax.tree.map(jnp.add, g_acc, g), l_acc + l), None
        first = (jax.tree.map(lambda g: g[0], grads), losses[0])
        rest = (jax.tree.map(lambda g: g[1:], grads), losses[1:])
        (g, l), _ = jax.lax.scan(add, first, rest)
        return l / m, jax.tree.map(lambda x: x / m, g)
    return jax.jit(compose)


def test_xla_multiplies_by_the_reciprocal():
    """Hazard 6 at the divisors of this test: jitted ``x / m`` equals ``x *
    f32(1/m)``, and at m = 3 that is not the true quotient."""
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    for m in MS:
        got = np.asarray(jax.jit(lambda a: a / m)(x))
        assert np.array_equal(got, x * (np.float32(1) / np.float32(m)))
    assert not np.array_equal(np.asarray(jax.jit(lambda a: a / 3)(x)),
                              x / np.float32(3))


@pytest.mark.parametrize("m", MS)
def test_accumulation_is_the_reference_composition_bitwise(model, m):
    _, jparams, batch = model
    loss, grads = _port_grads(jparams, batch, m)
    bm = BATCH // m
    parts = [_port_grads(jparams, {k: v[j * bm:(j + 1) * bm]
                                   for k, v in batch.items()}, 1)
             for j in range(m)]
    want_loss, want = _reference_compose(m)(
        jnp.asarray([float(p[0]) for p in parts], jnp.float32),
        [jnp.stack([p[1][i].numpy() for p in parts])
         for i in range(len(grads))])
    assert float(loss) == float(want_loss)
    for g, w in zip(grads, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("m", MS)
def test_microbatched_grads_match_reference(model, m):
    jdefs, jparams, batch = model
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: JT.train_loss(p, jdefs, b, local_context()),
        has_aux=True))
    bm = BATCH // m
    outs = [grad_fn(jparams, {k: jnp.asarray(v[j * bm:(j + 1) * bm])
                              for k, v in batch.items()})
            for j in range(m)]
    want_loss, want = _reference_compose(m)(
        jnp.stack([o[0][0] for o in outs]),
        jax.tree.map(lambda *g: jnp.stack(g), *[o[1] for o in outs]))
    loss, grads = _port_grads(jparams, batch, m)
    assert float(loss) == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    for g, w in zip(grads, jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        err = np.max(np.abs(g.numpy() - w)) / np.max(np.abs(w))
        assert err < GRAD_RTOL, err


def test_trainer_microbatches():
    argv = ["--reduced", "--device", "cpu", "--nodes", "2", "--batch", "8",
            "--seq", "16", "--steps", "2"]
    one = train.main(argv)
    two = train.main(argv + ["--microbatches", "2"])
    assert [h["loss"] for h in one] == pytest.approx(
        [h["loss"] for h in two], rel=1e-5)
    assert all(np.isfinite(h["loss"]) for h in two)
    with pytest.raises(SystemExit):
        train.main(argv + ["--microbatches", "3"])
    with pytest.raises(SystemExit):
        train.main(argv + ["--microbatches", "0"])
