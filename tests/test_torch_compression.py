"""The port's Definition-1 compressors held to the JAX package's.

Parity: each operator gets a stacked ``(N, P)`` input and, as its
uniforms, the reference's own draws: ``jax.random.uniform(key_i, shape)``
for the per-node keys ``jax.random.split(key, N)``, which is what every
``jax.random.bernoulli(key_i, p)`` inside the reference compares ``p``
against.  The reference runs under ``jit`` (``vmap`` over nodes), as the
algorithms run it, so a division by a constant is a product with the
float32 reciprocal on both sides.  Contract: ``apply`` outputs, int8 codes
and scales (fixed and adaptive, block 512 and 64), int16/int8 codes and
the ternary scale are bitwise equal; the overflow and sparsity fractions
agree (the reference's are per node, the port's over the stack).

Statistics (the port alone, mirroring ``tests/test_compression.py``):
unbiasedness within 5 standard errors of a Monte-Carlo mean, the variance
bound, the grid, the wire round trips and byte counts.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro_torch.core import compression as C
from repro_torch.kernels import quantize as Q

N, P = 4, 1300          # 1300 = 2 x 512 + 276: a padded last block


def _pairs():
    return [
        ("identity", JC.IdentityCompressor(), C.IdentityCompressor(), 1.0),
        ("rr1", JC.RandomizedRounding(1.0), C.RandomizedRounding(1.0), 30.0),
        ("rr0.1", JC.RandomizedRounding(0.1), C.RandomizedRounding(0.1), 3.0),
        ("sparsifier", JC.QuantizationSparsifier(8, 4.0),
         C.QuantizationSparsifier(8, 4.0), 3.9),
        ("ternary", JC.TernaryCompressor(), C.TernaryCompressor(), 2.0),
        ("int8-512-adaptive", JC.Int8BlockQuantizer(512, "adaptive"),
         C.Int8BlockQuantizer(512, "adaptive"), 2.0),
        ("int8-512-fixed", JC.Int8BlockQuantizer(512, "fixed", 1e-3),
         C.Int8BlockQuantizer(512, "fixed", 1e-3), 0.2),
        ("int8-64-adaptive", JC.Int8BlockQuantizer(64, "adaptive"),
         C.Int8BlockQuantizer(64, "adaptive"), 2.0),
        ("int8-64-fixed", JC.Int8BlockQuantizer(64, "fixed", 0.05),
         C.Int8BlockQuantizer(64, "fixed", 0.05), 9.0),
    ]


PAIRS = {p[0]: p[1:] for p in _pairs()}


def _inputs(seed, scale):
    rng = np.random.default_rng(seed)
    z = rng.uniform(-scale, scale, size=(N, P)).astype(np.float32)
    z[1, :300] = 0.0                       # an all-zero block
    return z


def _uniforms(op_t, key):
    """The reference's per-node uniforms, shaped as the port takes them."""
    shape = op_t.uniform_shape((N, P))
    if shape is None:
        return None, None
    keys = jax.random.split(key, N)
    u = np.array(jax.vmap(lambda k: jax.random.uniform(k, shape[1:]))(
        keys))
    return keys, torch.from_numpy(u)


@pytest.mark.parametrize("name", list(PAIRS))
def test_apply_bitwise_equal_to_jitted_reference(name):
    op_j, op_t, scale = PAIRS[name]
    z = _inputs(1, scale)
    key = jax.random.PRNGKey(7)
    keys, u = _uniforms(op_t, key)
    if keys is None:
        keys = jax.random.split(key, N)
    want = np.asarray(jax.jit(jax.vmap(op_j.apply))(keys, jnp.asarray(z)))
    got = op_t.apply(torch.from_numpy(z), u).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", [n for n in PAIRS if n.startswith("int8")])
def test_int8_encode_bytes_equal_to_jitted_reference(name):
    op_j, op_t, scale = PAIRS[name]
    z = _inputs(2, scale)
    keys, u = _uniforms(op_t, jax.random.PRNGKey(3))
    codes, scales, meta = jax.jit(jax.vmap(
        lambda k, x: op_j.encode(k, x)[:2] + (op_j.encode(k, x)[2][
            "overflow_frac"],)))(keys, jnp.asarray(z))
    t_codes, t_scales, t_meta = op_t.encode(torch.from_numpy(z), u)
    assert t_codes.dtype == torch.int8 and t_scales.dtype == torch.float32
    np.testing.assert_array_equal(t_codes.numpy(), np.asarray(codes))
    np.testing.assert_array_equal(t_scales.numpy().view(np.uint32),
                                  np.asarray(scales).view(np.uint32))
    # the reference's fraction is per node; their mean is the port's
    assert float(t_meta["overflow_frac"]) == pytest.approx(
        float(np.mean(np.asarray(meta, np.float64))), rel=1e-6)
    if "fixed" in name:
        assert float(t_meta["overflow_frac"]) > 0     # the grid clips
    np.testing.assert_array_equal(
        op_t.decode(t_codes, t_scales, t_meta).numpy(),
        op_t.apply(torch.from_numpy(z), u).numpy())


def test_int8_adaptive_scale_is_the_compiled_product():
    """Under ``jit`` the reference's ``max(...) / 127.0`` is
    ``max(...) * f32(1/127)``; the eager expression divides, and moves
    some scales by an ulp (ROADMAP hazard 6).  The port follows the
    compiled form, which kernel #3 computes."""
    op = JC.Int8BlockQuantizer(512, "adaptive")
    z = jnp.asarray(np.random.default_rng(4).normal(size=(4096 * 512,))
                    .astype(np.float32))
    key = jax.random.PRNGKey(0)
    jitted = np.asarray(jax.jit(op.encode)(key, z)[1]).ravel()
    eager = np.asarray(op.encode(key, z)[1]).ravel()
    absmax = np.maximum(np.abs(np.asarray(z)).reshape(-1, 512).max(1),
                        np.float32(1e-30))
    np.testing.assert_array_equal(jitted, absmax * np.float32(1 / 127))
    assert (eager != jitted).any()
    np.testing.assert_array_equal(eager, absmax / np.float32(127))


@pytest.mark.parametrize("name,kind", [("rr1", "int16"),
                                       ("sparsifier", "levels"),
                                       ("ternary", "ternary")])
def test_wire_codes_equal_to_jitted_reference(name, kind):
    op_j, op_t, scale = PAIRS[name]
    z = _inputs(5, scale)
    z[0, :3] = [1e6, -1e6, 40000.0]         # int16 overflow for rr1
    keys, u = _uniforms(op_t, jax.random.PRNGKey(9))
    zt = torch.from_numpy(z)
    if kind == "ternary":
        codes, s, meta = jax.jit(jax.vmap(op_j.encode))(keys, jnp.asarray(z))
        t_codes, t_s, t_meta = op_t.encode(zt, u)
        np.testing.assert_array_equal(t_s.numpy().ravel(), np.asarray(s))
    else:
        codes, meta = jax.jit(jax.vmap(op_j.encode))(keys, jnp.asarray(z))
        t_codes, t_meta = op_t.encode(zt, u)
    assert str(t_codes.dtype).split(".")[-1] == str(codes.dtype)
    np.testing.assert_array_equal(t_codes.numpy(), np.asarray(codes))
    for k in meta:
        assert float(t_meta[k]) == pytest.approx(float(np.mean(meta[k])),
                                                 abs=1e-7), k
    if kind == "int16":
        np.testing.assert_array_equal(op_t.codes(zt, u).numpy(),
                                      np.asarray(codes))


@pytest.mark.parametrize("block,kernel", [(512, True), (64, False)])
def test_int8_block_512_goes_through_kernel_3(monkeypatch, block, kernel):
    """At the kernel's block width every node's blocks go to
    ``quantize_blocks`` in one call of ``(N * n_blocks, 512)`` rows (on a
    CPU tensor it takes its plain version); other widths compute the same
    expression without it."""
    calls = []
    real = Q.quantize_blocks

    def spy(y, noise, fixed_step=None):
        calls.append(tuple(y.shape))
        return real(y, noise, fixed_step)

    monkeypatch.setattr(Q, "quantize_blocks", spy)
    op = C.Int8BlockQuantizer(block, "adaptive")
    z = torch.from_numpy(_inputs(6, 1.0))
    u = torch.rand(op.uniform_shape(z.shape))
    op.apply(z, u)
    assert calls == ([(N * 3, 512)] if kernel else [])


# ---------------------------------------------------------------------------
# statistics of the port alone (mirrors tests/test_compression.py)
# ---------------------------------------------------------------------------

OPERATORS = [
    C.IdentityCompressor(),
    C.RandomizedRounding(delta=1.0),
    C.RandomizedRounding(delta=0.25),
    C.QuantizationSparsifier(m_levels=8, big_m=4.0),
    C.TernaryCompressor(),
    C.Int8BlockQuantizer(block=64, mode="adaptive"),
    C.Int8BlockQuantizer(block=64, mode="fixed", step=0.05),
    C.Int8BlockQuantizer(block=512, mode="adaptive"),
]


def _draws(op, z, n_trials, seed):
    """``n_trials`` independent compressions of ``z`` (one trial per row)."""
    zz = z.expand(n_trials, z.shape[-1]).contiguous()
    shape = op.uniform_shape(zz.shape)
    u = None if shape is None else torch.rand(
        shape, generator=torch.Generator().manual_seed(seed))
    return op.apply(zz, u).double()


@pytest.mark.parametrize("op", OPERATORS, ids=lambda o: type(o).__name__
                         + getattr(o, "mode", "") + str(getattr(o, "block",
                                                                "")))
def test_unbiasedness_statistical(op):
    """E[C(z)] == z within 5 sigma of the Monte-Carlo error."""
    z = torch.from_numpy(np.random.default_rng(1).uniform(
        -2.0, 2.0, size=(64,)).astype(np.float32))
    if isinstance(op, C.Int8BlockQuantizer) and op.mode == "fixed":
        z = z * 0.05  # stay inside the un-clipped range of the fixed grid
    n_trials = 4000
    samples = _draws(op, z, n_trials, 0)
    mean = samples.mean(0)
    se = samples.std(0) / np.sqrt(n_trials) + 1e-12
    assert ((mean - z.double()).abs() < 5 * se + 5e-7).all()


@pytest.mark.parametrize("op", [C.RandomizedRounding(delta=1.0),
                                C.RandomizedRounding(delta=0.1)])
def test_variance_bound(op):
    z = torch.from_numpy(np.random.default_rng(3).uniform(
        -3, 3, size=(32,)).astype(np.float32))
    var = _draws(op, z, 5000, 2).var(0, unbiased=False)
    assert float(var.max()) <= op.sigma2() + 1e-3


def test_randomized_rounding_on_grid():
    op = C.RandomizedRounding(delta=1.0)
    z = torch.from_numpy(np.random.default_rng(9).uniform(
        -100, 100, size=(64,)).astype(np.float32))
    out = op.apply(z, torch.rand(64)).numpy()
    np.testing.assert_array_equal(out, np.round(out))
    assert np.all(np.abs(out - z.numpy()) <= 1.0)


def test_int8_adaptive_never_clips():
    op = C.Int8BlockQuantizer(block=32, mode="adaptive")
    g = torch.Generator().manual_seed(0)
    for scale_pow in (1, 3, 6):
        z = torch.randn(64, generator=g) * 10.0 ** scale_pow
        codes, scales, meta = op.encode(z, torch.rand(
            op.uniform_shape(z.shape), generator=g))
        assert float(meta["overflow_frac"]) == 0.0
        out = op.decode(codes, scales, meta)
        step = scales.repeat_interleave(op.block).ravel()[:64]
        assert ((out - z).abs() <= step * (1 + 1e-6)).all()


def test_randomized_rounding_int16_wire_and_overflow_guard():
    op = C.RandomizedRounding(delta=1.0)
    z = torch.from_numpy(np.random.default_rng(5).uniform(
        -50, 50, size=(128,)).astype(np.float32))
    u = torch.rand(128)
    codes = op.codes(z, u)
    assert codes.dtype == torch.int16
    assert torch.equal(op.decode(codes), op.apply(z, u))
    codes2, meta = op.encode(z, u)
    assert torch.equal(codes2, codes) and float(meta["overflow_frac"]) == 0
    big = torch.tensor([1e6, -1e6, 40000.0, 100.0])
    codes, meta = op.encode(big, torch.rand(4))
    assert int(codes.max()) == op.CODE_MAX
    assert int(codes.min()) == -op.CODE_MAX
    assert float(meta["overflow_frac"]) == pytest.approx(0.75)
    assert float(op.apply(big, torch.rand(4)).abs().max()) <= op.CODE_MAX


def test_sparsifier_zeros_and_wire_roundtrip():
    op = C.QuantizationSparsifier(m_levels=8, big_m=1.0)
    out = op.apply(torch.full((1000,), 0.05), torch.rand(1000))
    assert float((out == 0).float().mean()) > 0.5
    assert abs(float(out.mean()) - 0.05) < 0.02
    op = C.QuantizationSparsifier(m_levels=8, big_m=4.0)
    z = torch.from_numpy(np.random.default_rng(11).uniform(
        -3.9, 3.9, size=(512,)).astype(np.float32))
    u = torch.rand(512)
    codes, meta = op.encode(z, u)
    assert codes.dtype == torch.int8
    assert int(codes.abs().max()) <= op.m_levels
    assert 0.0 < float(meta["sparsity"]) < 1.0
    assert torch.equal(op.decode(codes), op.apply(z, u))
    wide, _ = C.QuantizationSparsifier(1000, 4.0).encode(z, u)
    assert wide.dtype == torch.int16


def test_ternary_wire_roundtrip():
    op = C.TernaryCompressor()
    z = torch.from_numpy(np.random.default_rng(13).normal(
        size=(2, 512)).astype(np.float32))
    u = torch.rand(2, 512)
    codes, scale, meta = op.encode(z, u)
    assert codes.dtype == torch.int8
    assert set(codes.unique().tolist()) <= {-1, 0, 1}
    assert torch.equal(scale.ravel(), z.abs().amax(1))
    assert torch.equal(op.decode(codes, scale), op.apply(z, u))


def test_wire_bytes_ordering_and_registry():
    n = 10_000
    fp32 = 4.0 * n
    assert C.RandomizedRounding().wire_bytes(n) == 0.5 * fp32
    assert C.Int8BlockQuantizer().wire_bytes(n) < 0.27 * fp32
    assert C.TernaryCompressor().wire_bytes(n) < 0.1 * fp32
    for name, kw in (("identity", {}), ("randomized_rounding", {}),
                     ("sparsifier", {}), ("ternary", {}), ("int8", {})):
        assert C.by_name(name, **kw).wire_bytes(n) == \
            JC.by_name(name, **kw).wire_bytes(n)
    assert isinstance(C.by_name("int8"), C.Int8BlockQuantizer)
    with pytest.raises(KeyError):
        C.by_name("nope")
