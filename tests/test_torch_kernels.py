"""Port kernels (repro_torch.kernels) held to the JAX reference.

The same inputs, drawn with numpy, go through the JAX jnp oracle
(``pack_payload(*quantize_blocks_ref(...))``), the JAX Pallas kernel in
interpret mode, and the port's device-dispatching entry points (on CPU
tensors: the plain PyTorch versions).  Quantize payloads must match byte
for byte; the dequant-combine within the ulps each test states, because
XLA may contract ``a*b + c`` into one FMA where PyTorch rounds twice.

The hand-written CUDA kernels themselves are held to their plain versions
in ``test_torch_cuda.py`` (on a GPU) and by ``chip_smoke.py``.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.dequant_combine import dequant_combine_payload_pallas
from repro.kernels.quantize import quantize_payload_pallas
from repro_torch.kernels import dequant_combine as D
from repro_torch.kernels import ops, quantize as Q

BLOCK = 512
MODES = {"adaptive": None, "fixed": 0.05}


def _inputs(rows, seed, dtype):
    """(jax y, torch y, noise numpy) with y rounded to ``dtype`` once, by
    JAX, and handed to the port bit for bit."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((rows, BLOCK)) * 2.0).astype(np.float32)
    # a few large values so the fixed grid clips at +-127
    y[::7, ::5] *= 40.0
    noise = rng.random((rows, BLOCK), dtype=np.float32)
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


@pytest.mark.parametrize("rows", [32, 45, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["adaptive", "fixed"])
def test_quantize_payload_matches_jax_ref(rows, dtype, mode):
    y_j, y_t, noise = _inputs(rows, hash((rows, dtype, mode)) % 2**31,
                              jnp.dtype(dtype))
    step_j, step_t = _step(mode)
    want = jops.pack_payload(*jref.quantize_blocks_ref(
        y_j, jnp.asarray(noise), fixed_step=step_j))
    got = ops.quantize_payload(y_t, torch.from_numpy(noise), step_t)
    assert got.dtype == torch.uint8 and got.shape == (rows, BLOCK + 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["adaptive", "fixed"])
def test_quantize_payload_matches_pallas_interpret(dtype, mode):
    y_j, y_t, noise = _inputs(96, 11, jnp.dtype(dtype))
    step_j, step_t = _step(mode)
    want = quantize_payload_pallas(y_j, jnp.asarray(noise),
                                   fixed_step=step_j, interpret=True)
    got = ops.quantize_payload(y_t, torch.from_numpy(noise), step_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # tile-aligned chunk view, read in place from full-height operands
    want_c = quantize_payload_pallas(y_j, jnp.asarray(noise),
                                     fixed_step=step_j, interpret=True,
                                     row_offset=32, n_rows=32)
    got_c = ops.quantize_payload(y_t, torch.from_numpy(noise), step_t,
                                 row_offset=32, n_rows=32)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("noise_height", ["full", "chunk"])
@pytest.mark.parametrize("mode", ["adaptive", "fixed"])
def test_quantize_payload_ragged_chunk_view(noise_height, mode):
    """Any row range: the JAX jnp path (its only path off the TPU tile
    grid) and the port agree on a ragged chunk of full-height y."""
    y_j, y_t, noise = _inputs(100, 5, jnp.float32)
    off, n = 7, 41
    if noise_height == "chunk":
        noise = noise[off:off + n].copy()
    step_j, step_t = _step(mode)
    want = jops.quantize_payload(y_j, jnp.asarray(noise), fixed_step=step_j,
                                 row_offset=off, n_rows=n)
    got = ops.quantize_payload(y_t, torch.from_numpy(noise), step_t,
                               row_offset=off, n_rows=n)
    assert got.shape == (n, BLOCK + 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_padding_rows_encode_to_zero_codes():
    y = torch.zeros((32, BLOCK))
    noise = torch.rand((32, BLOCK), generator=torch.Generator().manual_seed(0))
    for step in (None, 1e-3):
        codes, _ = ops.unpack_payload(ops.quantize_payload(y, noise, step))
        assert not codes.any()


def test_payload_byte_order():
    """Scale bytes are the fp32 image least-significant byte first, as the
    reference's XLA bitcast lays them out."""
    scales = np.asarray([[1.5], [-2.25], [3e-7], [1e30]], np.float32)
    codes = np.zeros((4, BLOCK), np.int8)
    got = ops.pack_payload(torch.from_numpy(codes), torch.from_numpy(scales))
    want = jops.pack_payload(jnp.asarray(codes), jnp.asarray(scales))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sb = got[:, BLOCK:].numpy().astype(np.uint32)
    u = (sb << (np.arange(4, dtype=np.uint32) * 8)).sum(axis=1)
    np.testing.assert_array_equal(u.astype(np.uint32).view(np.float32),
                                  scales[:, 0])


def test_payload_roundtrip():
    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(-127, 128, (64, BLOCK),
                                          dtype=np.int8))
    scales = torch.from_numpy(rng.random((64, 1), dtype=np.float32))
    payload = ops.pack_payload(codes, scales)
    assert payload.shape == (64, ops.payload_width())
    c2, s2 = ops.unpack_payload(payload)
    assert torch.equal(c2, codes) and torch.equal(s2, scales)


@pytest.mark.parametrize("n", [0, 1, 511, 512, 513, 16384, 16385, 123457])
def test_blockify_matches_jax(n):
    assert ops.padded_block_rows(n) == jops.padded_block_rows(n)
    flat = np.arange(n, dtype=np.float32)
    got = ops.blockify(torch.from_numpy(flat))
    want = np.asarray(jops.blockify(jnp.asarray(flat)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ops.unblockify(got, n).numpy(), flat)


def _payloads(rows, seed):
    rng = np.random.default_rng(seed)
    pays = []
    for i in range(3):
        y = rng.standard_normal((rows, BLOCK)).astype(np.float32) * (i + 1)
        noise = rng.random((rows, BLOCK), dtype=np.float32)
        pays.append(np.asarray(jops.pack_payload(*jref.quantize_blocks_ref(
            jnp.asarray(y), jnp.asarray(noise)))))
    xt = rng.standard_normal((rows, BLOCK)).astype(np.float32)
    m = rng.standard_normal((rows, BLOCK)).astype(np.float32)
    return [p.copy() for p in pays], xt, m


def _operand_spacing(pays, xt, m, w_self, w_side, deamp):
    """One float32 ulp of the magnitude of each output's operands:
    |x_t| + deamp |d_s|, |m| + w_side deamp (|d_l| + |d_r|) and
    w_self * (the first) + (the second).  An FMA in place of a rounded
    product moves a sum by at most one such ulp, however much the sum
    itself cancels."""
    d = [np.abs(np.asarray(jops.unpack_payload(jnp.asarray(p))[0],
                           np.float32)
                * np.asarray(jops.unpack_payload(jnp.asarray(p))[1]))
         for p in pays]
    mx = np.abs(xt) + deamp * d[0]
    mm = np.abs(m) + w_side * deamp * (d[1] + d[2])
    return [np.spacing(a.astype(np.float32))
            for a in (mx, mm, w_self * mx + mm)]


@pytest.mark.parametrize("deamp", [1.0, 0.37])
def test_dequant_combine_matches_jax(deamp):
    """Against the jnp oracle the combine is within 1 ulp (PyTorch and
    XLA's unfused CPU ops round the same sums).  The interpret-mode Pallas
    kernel lets XLA fuse the decode products with the sums into FMAs
    (hazard 2 of the reference), so there the bound is 2 ulps of the
    operands' magnitude: one per fused sum on the path to the output."""
    pays, xt, m = _payloads(96, 9)
    args_j = ([jnp.asarray(p) for p in pays]
              + [jnp.asarray(xt), jnp.asarray(m)])
    args_t = [torch.from_numpy(a) for a in (*pays, xt, m)]
    ref_outs = jops.dequant_combine_payload(*args_j, 0.5, 0.25,
                                            jnp.float32(deamp))
    pallas_outs = dequant_combine_payload_pallas(
        *args_j, 0.5, 0.25, jnp.float32(deamp), interpret=True)
    got = ops.dequant_combine_payload(*args_t, 0.5, 0.25, deamp)
    spacing = _operand_spacing(pays, xt, m, 0.5, 0.25, deamp)
    for g, r, p, sp in zip(got, ref_outs, pallas_outs, spacing):
        np.testing.assert_array_max_ulp(g.numpy(), np.asarray(r), maxulp=1)
        assert np.all(np.abs(g.numpy() - np.asarray(p)) <= 2 * sp)


@pytest.mark.parametrize("payload_height", ["full", "chunk"])
def test_dequant_combine_chunk_view(payload_height):
    """Chunk-height operands are read from row 0, full-height ones at the
    offset; ragged ranges are fine."""
    pays, xt, m = _payloads(100, 4)
    off, n = 13, 50
    if payload_height == "chunk":
        pays = [p[off:off + n].copy() for p in pays]
    ref_outs = jops.dequant_combine_payload(
        *[jnp.asarray(p) for p in pays], jnp.asarray(xt), jnp.asarray(m),
        0.5, 0.25, jnp.float32(1.0), row_offset=off, n_rows=n)
    got = ops.dequant_combine_payload(
        *[torch.from_numpy(a) for a in (*pays, xt, m)], 0.5, 0.25, 1.0,
        row_offset=off, n_rows=n)
    for g, r in zip(got, ref_outs):
        assert g.shape == (n, BLOCK)
        np.testing.assert_array_max_ulp(g.numpy(), np.asarray(r), maxulp=1)


def test_cpu_dispatch_takes_plain_path_and_validates():
    launches = (Q.quantize_payload.launches,
                D.dequant_combine_payload.launches)
    y = torch.zeros((32, BLOCK))
    ops.quantize_payload(y, torch.rand((32, BLOCK)), None)
    assert (Q.quantize_payload.launches,
            D.dequant_combine_payload.launches) == launches
    with pytest.raises(ValueError):
        ops.quantize_payload(torch.zeros((32, 256)), torch.rand((32, 256)))
    with pytest.raises(ValueError):
        ops.quantize_payload(y, torch.rand((32, BLOCK)), row_offset=20,
                             n_rows=20)
    with pytest.raises(TypeError):
        ops.quantize_payload(y, torch.rand((32, BLOCK), dtype=torch.float64))


@pytest.mark.parametrize("view", [{}, {"row_offset": 37, "n_rows": 61}],
                         ids=["full", "chunk"])
@pytest.mark.parametrize("step", [None, 1e-3])
def test_int8_encode_reads_leading_columns_of_wide_noise(view, step):
    """A plan holding top-k shares one 1,024-column noise buffer with its
    int8 run (columns 512-1023 are top-k's selection race): kernel #1's
    wrapper takes it and reads the leading 512 columns, with bytes equal
    to the reference's ``quantize_payload`` on the same buffer.  The
    wrapper took exactly BLOCK columns before and raised here."""
    rng = np.random.default_rng(11)
    y = (rng.standard_normal((128, BLOCK)) * 0.02).astype(np.float32)
    u = rng.random((128, 2 * BLOCK), dtype=np.float32)
    jstep = None if step is None else jnp.float32(step)
    want = np.asarray(jops.quantize_payload(jnp.asarray(y), jnp.asarray(u),
                                            fixed_step=jstep, **view))
    got = ops.quantize_payload(torch.from_numpy(y), torch.from_numpy(u),
                               step, **view)
    np.testing.assert_array_equal(got.numpy(), want)
    lead = ops.quantize_payload(torch.from_numpy(y),
                                torch.from_numpy(u[:, :BLOCK].copy()), step,
                                **view)
    assert torch.equal(got, lead)
    with pytest.raises(ValueError, match="noise"):
        ops.quantize_payload(torch.from_numpy(y),
                             torch.from_numpy(u[:, :BLOCK - 1].copy()))



@pytest.mark.parametrize("name", ["int8", "int4", "int2", "topk"])
def test_codec_wrappers_write_into_out(name):
    from test_torch_cuda import _codec_out_roundtrip
    _codec_out_roundtrip(name, "cpu")
