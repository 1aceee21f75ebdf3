"""The sub-byte and top-k wire kernels of the port held to the JAX reference.

The same inputs, drawn with numpy, go through the JAX jnp oracles
(``repro.kernels.bitpack.*_ref``), the Pallas kernels in interpret mode and
the port's device-dispatching entry points (on CPU tensors: the plain
PyTorch versions).  Encoded payloads must match byte for byte: int4,
int2 and top-k at every k.  The combines are bitwise equal to
``combine_core`` on the reference's decode, and within 2 ulps of the
operands' magnitude of the interpret-mode kernels, where XLA contracts the
decode products into the sums as FMAs (ROADMAP Queue 3, hazard 5).

The hand-written CUDA kernels themselves are held to their plain versions
in ``test_torch_cuda.py`` (on a GPU) and by ``chip_smoke.py``.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitpack as jb
from repro.kernels import ops as jops
from repro_torch.kernels import bitpack as BP
from repro_torch.kernels import ops

BLOCK = 512
MODES = {"adaptive": None, "fixed": 0.05}
TOPK_EXACT = [16, 64, 128, 256]


def _inputs(rows, seed, dtype, noise_cols=BLOCK):
    """(jax y, torch y, noise numpy) with y rounded to ``dtype`` once, by
    JAX, and handed to the port bit for bit."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((rows, BLOCK)) * 2.0).astype(np.float32)
    y[::7, ::5] *= 40.0            # a few large values: the fixed grid clips
    y[3, :] = 0.0                  # a padding row
    noise = rng.random((rows, noise_cols), dtype=np.float32)
    y_j = jnp.asarray(y).astype(dtype)
    if dtype == jnp.bfloat16:
        bits = np.asarray(jax.lax.bitcast_convert_type(y_j, jnp.uint16))
        y_t = torch.from_numpy(bits.view(np.int16).copy()).view(
            torch.bfloat16)
    else:
        y_t = torch.from_numpy(np.asarray(y_j).copy())
    return y_j, y_t, noise


def _step(mode):
    s = MODES[mode]
    return (None, None) if s is None else (jnp.float32(s), s)


# ---------------------------------------------------------------------------
# encoders: bytes exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [32, 45, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["adaptive", "fixed"])
@pytest.mark.parametrize("code_bits", [4, 2])
def test_subbyte_encode_matches_jax_ref(rows, dtype, mode, code_bits):
    y_j, y_t, noise = _inputs(rows, hash((rows, dtype, mode, code_bits))
                              % 2**31, jnp.dtype(dtype))
    step_j, step_t = _step(mode)
    want = jb.subbyte_encode_ref(y_j, jnp.asarray(noise), code_bits,
                                 fixed_step=step_j)
    got = ops.subbyte_encode_payload(y_t, torch.from_numpy(noise), code_bits,
                                     step_t)
    assert got.dtype == torch.uint8
    assert got.shape == (rows, BP.subbyte_payload_width(BLOCK, code_bits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["adaptive", "fixed"])
@pytest.mark.parametrize("code_bits", [4, 2])
def test_subbyte_encode_matches_pallas_interpret(dtype, mode, code_bits):
    """Against the interpret-mode Pallas kernel, on the whole buffer and a
    tile-aligned chunk view of a noise buffer twice as wide (the kernel
    reads its leading BLOCK columns)."""
    y_j, y_t, noise = _inputs(96, 11, jnp.dtype(dtype), 2 * BLOCK)
    step_j, step_t = _step(mode)
    for view in ({}, {"row_offset": 32, "n_rows": 32}):
        want = jb.subbyte_encode_pallas(y_j, jnp.asarray(noise), code_bits,
                                        fixed_step=step_j, interpret=True,
                                        **view)
        got = ops.subbyte_encode_payload(y_t, torch.from_numpy(noise),
                                         code_bits, step_t, **view)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", TOPK_EXACT)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["adaptive", "fixed"])
def test_topk_encode_matches_jax_ref(k, dtype, mode):
    """For k >= 16 (strata of g <= 32) XLA adds a stratum's weights left to
    right, as the port does, so the bytes are equal."""
    y_j, y_t, noise = _inputs(45, hash((k, dtype, mode)) % 2**31,
                              jnp.dtype(dtype), 2 * BLOCK)
    step_j, step_t = _step(mode)
    want = jb.topk_encode_ref(y_j, jnp.asarray(noise), k, fixed_step=step_j)
    got = ops.topk_encode_payload(y_t, torch.from_numpy(noise), k, step_t)
    assert got.shape == (45, BP.topk_payload_width(BLOCK, k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [16, 64, 256])
@pytest.mark.parametrize("mode", ["adaptive", "fixed"])
def test_topk_encode_matches_pallas_interpret(k, mode):
    y_j, y_t, noise = _inputs(64, 12, jnp.float32, 2 * BLOCK)
    step_j, step_t = _step(mode)
    for view in ({}, {"row_offset": 32, "n_rows": 32}):
        want = jb.topk_encode_pallas(y_j, jnp.asarray(noise), k,
                                     fixed_step=step_j, interpret=True,
                                     **view)
        got = ops.topk_encode_payload(y_t, torch.from_numpy(noise), k,
                                      step_t, **view)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_topk_small_k_structure(k):
    """k < 16: strata of g >= 64 weights.  XLA's CPU compiler adds
    ``sum(w)`` over such a stratum in runs of 32 (a reduce-window), then
    adds the runs' sums; the port spells that order, so the payload bytes
    equal the jitted reference's, and the eager one's, in both modes.
    Beside them: exactly one pick per stratum, and the port decodes the
    reference's own bytes exactly."""
    y_j, y_t, noise = _inputs(45, 13, jnp.float32, 2 * BLOCK)
    # the sent values y_pick * (sum(w) / w_pick) themselves, before their
    # bf16-scaled stochastic rounding hides most last-bit differences
    _, v_want = jax.jit(lambda y, u: jb._topk_select(y, u, k))(
        y_j, jnp.asarray(noise[:, :BLOCK]))
    _, v_got = BP._topk_select(y_t, torch.from_numpy(noise[:, :BLOCK]), k)
    np.testing.assert_array_equal(v_got.numpy(), np.asarray(v_want))
    for mode in MODES:
        step_j, step_t = _step(mode)
        got = ops.topk_encode_payload(y_t, torch.from_numpy(noise), k,
                                      step_t).numpy()
        want = np.array(jax.jit(lambda y, u: jb.topk_encode_ref(
            y, u, k, fixed_step=step_j))(y_j, jnp.asarray(noise)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.array(jb.topk_encode_ref(
            y_j, jnp.asarray(noise), k, fixed_step=step_j)))
    bits = np.unpackbits(got[:, :BLOCK // 8], axis=1, bitorder="little")
    assert (bits.reshape(45, k, BLOCK // k).sum(-1) == 1).all()
    dec = BP.topk_decode_plain(torch.from_numpy(want), k).numpy()
    np.testing.assert_array_equal(dec, np.asarray(jb.topk_decode_ref(
        jnp.asarray(want), BLOCK, k)))


@pytest.mark.parametrize("codec", ["int4", "int2", "topk"])
@pytest.mark.parametrize("noise_height", ["full", "chunk"])
def test_ragged_chunk_view(codec, noise_height):
    """Any row range: the JAX jnp path (its only path off the TPU tile
    grid) and the port agree on a ragged chunk of full-height y."""
    wide = codec == "topk"
    y_j, y_t, noise = _inputs(100, 5, jnp.float32,
                              2 * BLOCK if wide else BLOCK)
    off, n = 7, 41
    if noise_height == "chunk":
        noise = noise[off:off + n].copy()
    if wide:
        want = jops.topk_encode_payload(y_j, jnp.asarray(noise), 64,
                                        fixed_step=jnp.float32(0.05),
                                        row_offset=off, n_rows=n)
        got = ops.topk_encode_payload(y_t, torch.from_numpy(noise), 64, 0.05,
                                      row_offset=off, n_rows=n)
    else:
        bits = int(codec[3:])
        want = jops.subbyte_encode_payload(y_j, jnp.asarray(noise), bits,
                                           fixed_step=jnp.float32(0.05),
                                           row_offset=off, n_rows=n)
        got = ops.subbyte_encode_payload(y_t, torch.from_numpy(noise), bits,
                                         0.05, row_offset=off, n_rows=n)
    assert got.shape[0] == n
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# byte layout
# ---------------------------------------------------------------------------

def test_bf16_scale_byte_order():
    """Scale bytes are the bf16 image least significant byte first, as the
    reference's bitcast lays them out; decoding them is exact."""
    scales = np.asarray([[1.5], [-2.25], [3.0517578125e-05], [1e30]],
                        np.float32)
    exact = np.array(jb._bf16_round(jnp.asarray(scales)))
    got = BP._scale_to_bf16_bytes(torch.from_numpy(exact)).numpy()
    want = np.asarray(jb._scale_to_bf16_bytes(jnp.asarray(exact)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        BP._bf16_bytes_to_scale(torch.from_numpy(got)).numpy(), exact)


@pytest.mark.parametrize("code_bits", [4, 2])
def test_field_packing_roundtrip_matches_jax(code_bits):
    cm = BP.subbyte_code_max(code_bits)
    pack = BP.subbyte_pack(code_bits)
    q = np.random.default_rng(0).integers(-cm, cm + 1, (8, BLOCK)).astype(
        np.float32)
    got = BP._pack_fields(torch.from_numpy(q), cm, pack)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jb._pack_fields(jnp.asarray(q), cm, pack)))
    np.testing.assert_array_equal(BP._unpack_fields(got, cm, pack).numpy(), q)
    bits = np.random.default_rng(1).integers(0, 2, (8, BLOCK)).astype(bool)
    packed = BP._pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jb._pack_bits(jnp.asarray(bits))))
    np.testing.assert_array_equal(BP._unpack_bits(packed).numpy(), bits)


@pytest.mark.parametrize("codec", ["int4", "int2", "topk:k=16", "topk"])
def test_decode_matches_jax(codec):
    y_j, _, noise = _inputs(40, 6, jnp.float32, 2 * BLOCK)
    if codec.startswith("int"):
        bits = int(codec[3:])
        pay = np.array(jb.subbyte_encode_ref(
            y_j, jnp.asarray(noise[:, :BLOCK]), bits))
        want = jb.subbyte_decode_ref(jnp.asarray(pay), BLOCK, bits)
        got = BP.subbyte_decode_plain(torch.from_numpy(pay), bits)
    else:
        k = 16 if codec == "topk:k=16" else 64
        pay = np.array(jb.topk_encode_ref(y_j, jnp.asarray(noise), k))
        want = jb.topk_decode_ref(jnp.asarray(pay), BLOCK, k)
        got = BP.topk_decode_plain(torch.from_numpy(pay), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_padding_rows_encode_to_zero():
    y = torch.zeros((32, BLOCK))
    noise = torch.rand((32, 2 * BLOCK),
                       generator=torch.Generator().manual_seed(0))
    for step in (None, 1e-3):
        for bits in (4, 2):
            dec = BP.subbyte_decode_plain(
                ops.subbyte_encode_payload(y, noise, bits, step), bits)
            assert not dec.any()
        assert not BP.topk_decode_plain(
            ops.topk_encode_payload(y, noise, 64, step), 64).any()


# ---------------------------------------------------------------------------
# combines
# ---------------------------------------------------------------------------

def _payloads(codec, rows, seed):
    """Three payloads of the JAX reference, shadows, and the codec's JAX
    decode and Pallas combine."""
    rng = np.random.default_rng(seed)
    pays = []
    for i in range(3):
        y = jnp.asarray(rng.standard_normal((rows, BLOCK)).astype(np.float32)
                        * (i + 1))
        noise = jnp.asarray(rng.random((rows, 2 * BLOCK), dtype=np.float32))
        if codec.startswith("int"):
            pays.append(np.array(jb.subbyte_encode_ref(
                y, noise[:, :BLOCK], int(codec[3:]))))
        else:
            pays.append(np.array(jb.topk_encode_ref(
                y, noise, int(codec.split("=")[1]))))
    xt = rng.standard_normal((rows, BLOCK)).astype(np.float32)
    m = rng.standard_normal((rows, BLOCK)).astype(np.float32)
    return pays, xt, m


def _jax_codec(codec):
    if codec.startswith("int"):
        bits = int(codec[3:])
        return (lambda p: jb.subbyte_decode_ref(p, BLOCK, bits),
                lambda *a, **kw: jb.subbyte_combine_pallas(
                    *a, code_bits=bits, interpret=True, **kw),
                lambda *a, **kw: ops.subbyte_decode_combine(
                    *a, code_bits=bits, **kw))
    k = int(codec.split("=")[1])
    return (lambda p: jb.topk_decode_ref(p, BLOCK, k),
            lambda *a, **kw: jb.topk_combine_pallas(
                *a, k=k, interpret=True, **kw),
            lambda *a, **kw: ops.topk_decode_combine(*a, k=k, **kw))


def _operand_spacing(dec, xt, m, w_self, w_side, deamp):
    """One float32 ulp of the magnitude of each output's operands: an FMA
    in place of a rounded product moves a sum by at most one such ulp,
    however much the sum itself cancels."""
    d = [np.abs(np.asarray(x)) for x in dec]
    mx = np.abs(xt) + deamp * d[0]
    mm = np.abs(m) + w_side * deamp * (d[1] + d[2])
    return [np.spacing(a.astype(np.float32))
            for a in (mx, mm, w_self * mx + mm)]


@pytest.mark.parametrize("codec", ["int4", "int2", "topk:k=16", "topk:k=64",
                                   "topk:k=256"])
@pytest.mark.parametrize("deamp", [1.0, 0.37])
def test_combine_matches_jax(codec, deamp):
    """Bitwise equal to ``combine_core`` on the reference's decode; within
    2 ulps of the operands of the interpret-mode Pallas kernel."""
    pays, xt, m = _payloads(codec, 64, 9)
    decode, pallas, port = _jax_codec(codec)
    dec = [decode(jnp.asarray(p)) for p in pays]
    want = jb.combine_core(*dec, jnp.asarray(xt), jnp.asarray(m),
                           jnp.float32(0.5), jnp.float32(0.25),
                           jnp.float32(deamp))
    got = port(*[torch.from_numpy(a) for a in (*pays, xt, m)], 0.5, 0.25,
               deamp)
    pallas_outs = pallas(*[jnp.asarray(a) for a in (*pays, xt, m)], 0.5,
                         0.25, jnp.float32(deamp))
    spacing = _operand_spacing(dec, xt, m, 0.5, 0.25, deamp)
    for g, w, p, sp in zip(got, want, pallas_outs, spacing):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert np.all(np.abs(g.numpy() - np.asarray(p)) <= 2 * sp)


@pytest.mark.parametrize("codec", ["int4", "topk:k=64"])
@pytest.mark.parametrize("payload_height", ["full", "chunk"])
def test_combine_chunk_view(codec, payload_height):
    """Chunk-height operands are read from row 0, full-height ones at the
    offset; ragged ranges are fine."""
    pays, xt, m = _payloads(codec, 100, 4)
    off, n = 13, 50
    if payload_height == "chunk":
        pays = [p[off:off + n].copy() for p in pays]
    decode, _, port = _jax_codec(codec)
    rows = [(p if p.shape[0] == n else p[off:off + n]) for p in pays]
    want = jb.combine_core(*[decode(jnp.asarray(p)) for p in rows],
                           jnp.asarray(xt[off:off + n]),
                           jnp.asarray(m[off:off + n]), jnp.float32(0.5),
                           jnp.float32(0.25), jnp.float32(1.0))
    got = port(*[torch.from_numpy(a) for a in (*pays, xt, m)], 0.5, 0.25,
               1.0, row_offset=off, n_rows=n)
    for g, w in zip(got, want):
        assert g.shape == (n, BLOCK)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_cpu_dispatch_takes_plain_path_and_validates():
    entries = (BP.subbyte_encode_payload, BP.subbyte_decode_combine,
               BP.topk_encode_payload, BP.topk_decode_combine)
    launches = [e.launches for e in entries]
    y = torch.zeros((32, BLOCK))
    u = torch.rand((32, 2 * BLOCK))
    p4 = ops.subbyte_encode_payload(y, u, 4)
    ops.subbyte_decode_combine(p4, p4, p4, y, y, 0.5, 0.25, 1.0, 4)
    pk = ops.topk_encode_payload(y, u, 64)
    ops.topk_decode_combine(pk, pk, pk, y, y, 0.5, 0.25, 1.0, 64)
    assert [e.launches for e in entries] == launches
    with pytest.raises(ValueError, match="noise"):
        ops.topk_encode_payload(y, u[:, :BLOCK], 64)      # needs 2 * BLOCK
    with pytest.raises(ValueError, match="k must divide"):
        ops.topk_encode_payload(y, u, 63)
    with pytest.raises(ValueError, match="code_bits"):
        ops.subbyte_encode_payload(y, u, 3)
    with pytest.raises(ValueError):
        ops.subbyte_decode_combine(pk, pk, pk, y, y, 0.5, 0.25, 1.0, 4)
    with pytest.raises(ValueError):
        ops.subbyte_encode_payload(y, u, 4, row_offset=20, n_rows=20)
    with pytest.raises(TypeError):
        ops.subbyte_encode_payload(y, u.double(), 4)
