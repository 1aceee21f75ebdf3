"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode): they are
marked ``cuda`` and skip without one.  The file imports no JAX, so it runs
where only PyTorch is installed::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Encoded payloads (int8, int4, int2 and top-k) and the per-leaf codes and
scales must be byte-equal; the combines within 1 ulp (they are bitwise
equal on an H100: both sides round every product and sum); the
flash-decode partials within the float32 tolerances of the CPU test
(``test_torch_serve.py``) on the invariants ``acc / l`` and ``m + log l``,
for bf16 inputs too (both sides widen them exactly to float32).
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticLMDataset
from repro_torch.kernels import bitpack as BP
from repro_torch.kernels import dequant_combine as D
from repro_torch.kernels import gqa_decode as G
from repro_torch.kernels import quantize as Q
from repro_torch.launch import serve, train

BLOCK = 512


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("step", [None, 1e-3])
def test_cuda_quantize_kernel_matches_plain(cuda_device, dtype, step):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    y = (torch.randn((4099, BLOCK), generator=g, device=cuda_device)
         * 0.05).to(dtype)
    u = torch.rand((4099, BLOCK), generator=g, device=cuda_device)
    before = Q.quantize_payload.launches
    for view in ({}, {"row_offset": 37, "n_rows": 1001}):
        assert torch.equal(Q.quantize_payload(y, u, step, **view),
                           Q.quantize_payload_plain(y, u, step, **view))
    assert Q.quantize_payload.launches == before + 2


@pytest.mark.cuda
def test_cuda_dequant_combine_kernel_matches_plain(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    rows = 4099
    u = torch.rand((rows, BLOCK), generator=g, device=cuda_device)
    pays = [Q.quantize_payload(torch.randn((rows, BLOCK), generator=g,
                                           device=cuda_device), u, None)
            for _ in range(3)]
    xt = torch.randn((rows, BLOCK), generator=g, device=cuda_device)
    m = torch.randn((rows, BLOCK), generator=g, device=cuda_device)
    for view in ({}, {"row_offset": 37, "n_rows": 1001}):
        got = D.dequant_combine_payload(*pays, xt, m, 0.5, 0.25, 0.37, **view)
        want = D.dequant_combine_payload_plain(*pays, xt, m, 0.5, 0.25, 0.37,
                                               **view)
        for a, b in zip(got, want):
            np.testing.assert_array_max_ulp(a.cpu().numpy(), b.cpu().numpy(),
                                            maxulp=1)


@pytest.mark.cuda
def test_cuda_train_step_launches_each_kernel_once_per_node(cuda_device):
    cfg = reduced(get_config("smollm-135m"))
    setup = train.build_train_setup(cfg, consensus_nodes=4,
                                    device=cuda_device)
    state = train.init_train_state(setup, 0)
    batch = SyntheticLMDataset(cfg.vocab_size, 64, 8,
                               n_shards=4).global_batch_arrays(0)
    before = (Q.quantize_payload.launches,
              D.dequant_combine_payload.launches)
    state, metrics = train.train_step(setup, state, batch)
    torch.cuda.synchronize()
    assert (Q.quantize_payload.launches - before[0],
            D.dequant_combine_payload.launches - before[1]) == (4, 4)
    assert np.isfinite(metrics["loss"])
    assert state["consensus"]["x_tilde"].device.type == "cuda"


def _codec_inputs(device, seed, noise_cols):
    g = torch.Generator(device=device).manual_seed(seed)
    y = torch.randn((4099, BLOCK), generator=g, device=device) * 0.05
    u = torch.rand((4099, noise_cols), generator=g, device=device)
    return y, u


@pytest.mark.cuda
@pytest.mark.parametrize("code_bits", [4, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("step", [None, 1e-3])
def test_cuda_subbyte_encode_kernel_matches_plain(cuda_device, code_bits,
                                                  dtype, step):
    y, u = _codec_inputs(cuda_device, 2, 2 * BLOCK)   # reads the lead BLOCK
    y = y.to(dtype)
    before = BP.subbyte_encode_payload.launches
    for view in ({}, {"row_offset": 37, "n_rows": 1001}):
        assert torch.equal(
            BP.subbyte_encode_payload(y, u, code_bits, step, **view),
            BP.subbyte_encode_plain(y, u, code_bits, step, **view))
    assert BP.subbyte_encode_payload.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 64, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("step", [None, 1e-3])
def test_cuda_topk_encode_kernel_matches_plain(cuda_device, k, dtype, step):
    y, u = _codec_inputs(cuda_device, 3, 2 * BLOCK)
    y = y.to(dtype)
    before = BP.topk_encode_payload.launches
    for view in ({}, {"row_offset": 37, "n_rows": 1001}):
        got = BP.topk_encode_payload(y, u, k, step, **view)
        want = BP.topk_encode_plain(y, u, k, step, **view)
        assert torch.equal(got, want), int((got != want).any(1).sum())
    assert BP.topk_encode_payload.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["int4", "int2", "topk:k=1", "topk:k=16",
                                   "topk", "topk:k=256"])
def test_cuda_codec_combine_kernel_matches_plain(cuda_device, codec):
    from repro_torch.core.codec import by_name
    cd = by_name(codec)
    y, u = _codec_inputs(cuda_device, 4, cd.noise_cols())
    pays = [cd.encode_payload(y * (i + 1), u) for i in range(3)]
    g = torch.Generator(device=cuda_device).manual_seed(5)
    xt = torch.randn((4099, BLOCK), generator=g, device=cuda_device)
    m = torch.randn((4099, BLOCK), generator=g, device=cuda_device)
    entry = (BP.subbyte_decode_combine if codec.startswith("int")
             else BP.topk_decode_combine)
    plain = (BP.subbyte_combine_plain if codec.startswith("int")
             else BP.topk_combine_plain)
    param = getattr(cd, "code_bits", None) or cd.k
    before = entry.launches
    for view in ({}, {"row_offset": 37, "n_rows": 1001}):
        got = cd.decode_combine(*pays, xt, m, 0.5, 0.25, 0.37, **view)
        want = plain(*pays, xt, m, 0.5, 0.25, 0.37, param, **view)
        for a, b in zip(got, want):
            np.testing.assert_array_max_ulp(a.cpu().numpy(), b.cpu().numpy(),
                                            maxulp=1)
    assert entry.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["int4", "int2", "topk"])
def test_cuda_train_step_launches_codec_kernels(cuda_device, codec):
    cfg = reduced(get_config("smollm-135m"))
    setup = train.build_train_setup(cfg, consensus_nodes=4, wire_codec=codec,
                                    device=cuda_device)
    state = train.init_train_state(setup, 0)
    batch = SyntheticLMDataset(cfg.vocab_size, 64, 8,
                               n_shards=4).global_batch_arrays(0)
    enc, comb = ((BP.subbyte_encode_payload, BP.subbyte_decode_combine)
                 if codec.startswith("int")
                 else (BP.topk_encode_payload, BP.topk_decode_combine))
    before = (enc.launches, comb.launches, Q.quantize_payload.launches)
    state, metrics = train.train_step(setup, state, batch)
    torch.cuda.synchronize()
    assert (enc.launches - before[0], comb.launches - before[1],
            Q.quantize_payload.launches - before[2]) == (4, 4, 0)
    assert np.isfinite(metrics["loss"]) and metrics["codec"] == codec


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("step", [None, 1e-3])
def test_cuda_quantize_blocks_kernel_matches_plain(cuda_device, dtype, step):
    y, u = _codec_inputs(cuda_device, 6, BLOCK)
    y = y.to(dtype)
    before = Q.quantize_blocks.launches
    codes, scales = Q.quantize_blocks(y, u, step)
    want_c, want_s = Q.quantize_blocks_plain(y, u, step)
    assert Q.quantize_blocks.launches == before + 1
    assert torch.equal(codes, want_c)
    assert torch.equal(scales.view(torch.int32), want_s.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("deamp", [1.0, 0.37])
def test_cuda_dequant_combine_kernel_matches_plain(cuda_device, deamp):
    g = torch.Generator(device=cuda_device).manual_seed(7)
    rows = 4099
    u = torch.rand((rows, BLOCK), generator=g, device=cuda_device)
    sides = []
    for i in range(3):
        sides += Q.quantize_blocks(torch.randn(
            (rows, BLOCK), generator=g, device=cuda_device) * (i + 1), u)
    xt = torch.randn((rows, BLOCK), generator=g, device=cuda_device)
    m = torch.randn((rows, BLOCK), generator=g, device=cuda_device)
    before = D.dequant_combine.launches
    got = D.dequant_combine(*sides, xt, m, 0.5, 0.25, deamp)
    want = D.dequant_combine_plain(*sides, xt, m, 0.5, 0.25, deamp)
    assert D.dequant_combine.launches == before + 1
    for a, b in zip(got, want):
        np.testing.assert_array_max_ulp(a.cpu().numpy(), b.cpu().numpy(),
                                        maxulp=1)


def _decode_invariants(m, l, acc):
    l = torch.clamp_min(l, 1e-30)
    return acc / l[..., None], m + torch.log(l)


def _holes_mask(S, seed, device):
    """About 30% of the positions valid at random, and every position in
    a 128-block whose index is 1 mod 3 masked: fully masked tiles of every
    tile size lie between valid ones."""
    pos = np.arange(S)
    valid = ((np.random.default_rng(seed).random(S) < 0.3)
             & ((pos // 128) % 3 != 1))
    return torch.from_numpy(valid).to(device)


def _check_decode(q, k, v, valid, cap, ranges=None):
    before = G.gqa_decode.launches
    got = G.gqa_decode(q, k, v, valid, softcap=cap, ranges=ranges)
    want = G.gqa_decode_plain(q, k, v, valid, softcap=cap)
    assert G.gqa_decode.launches == before + 1
    # both sides widen bf16 exactly and sum in float32: they differ only in
    # the order of summation, whatever the input type
    tol, lse_tol = 1e-5, 5e-5
    (o, lse), (wo, wlse) = (_decode_invariants(*got),
                            _decode_invariants(*want))
    torch.testing.assert_close(o, wo, atol=tol, rtol=tol)
    torch.testing.assert_close(lse, wlse, atol=lse_tol, rtol=0)
    if not valid.any():
        assert torch.all(got[1] == 0) and torch.all(got[2] == 0)
        assert torch.all(got[0] == -1e30)


#: the operand types #9 is held in: float32, bfloat16, and (q, K and V)
#: a float32 q over a bfloat16 cache (float32 compute with
#: ``--cache-dtype bfloat16``: the bfloat16 kernel reads q in three
#: bfloat16 slices whose sum is q, so it keeps the float32 tolerances)
DECODE_DTYPES = [torch.float32, torch.bfloat16,
                 (torch.float32, torch.bfloat16)]


def _decode_inputs(device, seed, b, kvh, g, hd, S, dtype, q_dtype=None):
    """q (b, kvh, g, hd) in ``q_dtype`` (``dtype`` when None), k and v (b,
    S, kvh, hd) in ``dtype``, from one generator: a float32 q over a
    bfloat16 cache is the float32 draw itself, not bfloat16-representable.
    ``dtype`` may be a (q dtype, cache dtype) pair of DECODE_DTYPES."""
    if isinstance(dtype, tuple):
        q_dtype, dtype = dtype
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=device).to(dt)
                 for shape, dt in (((b, kvh, g, hd), q_dtype or dtype),
                                   ((b, S, kvh, hd), dtype),
                                   ((b, S, kvh, hd), dtype)))


#: (b, kvh, g, hd, S, softcap) of the small-cache decode cases
DECODE_CASES = [
    (2, 2, 4, 128, 1024, None), (1, 4, 1, 64, 512, 30.0),
    (2, 1, 7, 128, 2048, None), (1, 8, 2, 128, 512, None),
    (32, 3, 3, 64, 2048, None), (3, 3, 3, 64, 700, 30.0),
    (3, 3, 3, 64, 37, None),         # S below one tile
    (2, 3, 3, 64, 513, 30.0),        # one past a boundary of every tile
    (2, 2, 8, 128, 1024, None),      # g = 8 at hd 128
    (1, 8, 2, 256, 1024, 50.0),      # gemma2-9b's heads: hd 256, g 2
    (2, 2, 8, 256, 700, None),       # g = 8 at hd 256
    (1, 3, 3, 256, 37, None),        # hd 256, S below one tile
    (2, 2, 3, 256, 513, 30.0)]       # hd 256, one past a tile boundary
#: (b, kvh, g, hd, S, softcap, window) of the dense zoo's decodes
ZOO_CASES = [
    (32, 8, 2, 128, 2048, None, None),       # qwen3-0.6b serving
    (8, 4, 8, 128, 2048, None, None),        # yi-9b
    (4, 8, 8, 128, 2048, None, None),        # chameleon-34b
    (4, 8, 2, 256, 6144, 50.0, 4096),        # gemma2-9b, an 'L' block
    (1, 8, 2, 256, 32896, 50.0, 32768)]      # gemma2-9b long-serve, 'A'


@pytest.mark.cuda
@pytest.mark.parametrize("b,kvh,g,hd,S,cap", DECODE_CASES)
@pytest.mark.parametrize("dtype", DECODE_DTYPES)
def test_cuda_gqa_decode_kernel_matches_plain(cuda_device, b, kvh, g, hd, S,
                                              cap, dtype):
    q, k, v = _decode_inputs(cuda_device, S + g, b, kvh, g, hd, S, dtype)
    for valid in (torch.arange(S, device=cuda_device) < S - 37,
                  torch.arange(S, device=cuda_device) < 100,
                  torch.zeros(S, dtype=torch.bool, device=cuda_device),
                  _holes_mask(S, S + g, cuda_device)):
        _check_decode(q, k, v, valid, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("b,kvh,g,hd,S,cap,window", ZOO_CASES)
@pytest.mark.parametrize("dtype", DECODE_DTYPES)
def test_cuda_gqa_decode_zoo_heads(cuda_device, b, kvh, g, hd, S, cap,
                                   window, dtype):
    """#9 at the dense zoo's decode shapes, with the model's softcap and
    its decode window (``gpos > pos - window``) where it has one."""
    q, k, v = _decode_inputs(cuda_device, S + g + hd, b, kvh, g, hd, S,
                             dtype)
    gpos = torch.arange(S, device=cuda_device)
    pos = S - 38
    masks = [gpos <= pos, _holes_mask(S, S + g, cuda_device)]
    if window:
        masks.append((gpos <= pos) & (gpos > pos - window))
    for valid in masks:
        _check_decode(q, k, v, valid, cap)


def _plain_invariants(q, k, v, valid, cap=None, p_bf16=False):
    """The plain version's acc / l and m + log l, with p rounded to one
    bfloat16 before ``p v`` when ``p_bf16``: what a kernel that cut p to
    one slice would compute."""
    m, l, acc = G.gqa_decode_plain(q, k, v, valid, softcap=cap)
    if p_bf16:
        s = torch.einsum("bhgd,bkhd->bhgk", q.float(), k.float()) \
            / q.shape[-1] ** 0.5
        p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
        acc = torch.einsum("bhgk,bkhd->bhgd", p.bfloat16().float(),
                           v.float())
    return _decode_invariants(m, l, acc)


@pytest.mark.cuda
@pytest.mark.parametrize("b,kvh,g,hd,S", [(4, 3, 3, 64, 700),
                                          (2, 4, 8, 128, 1024)])
def test_cuda_gqa_decode_f32_query_low_bits_matter(cuda_device, b, kvh, g,
                                                   hd, S):
    """A float32 q that bfloat16 cannot hold, over a bfloat16 cache: the
    plain version of q cut to one bfloat16 lies outside the tolerance,
    so only a kernel that keeps every bit of q (three slices) passes."""
    q, k, v = _decode_inputs(cuda_device, 17 + hd, b, kvh, g, hd, S,
                             torch.bfloat16, torch.float32)
    q = q * 3.0
    assert (q.bfloat16().float() != q).float().mean() > 0.9
    valid = _holes_mask(S, hd, cuda_device)
    o, lse = _plain_invariants(q, k, v, valid)
    o1, lse1 = _plain_invariants(q.bfloat16(), k, v, valid)
    assert not torch.allclose(o1, o, atol=1e-5, rtol=1e-5)
    _check_decode(q, k, v, valid, None)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_cuda_gqa_decode_bf16_scores_over_many_binades(cuda_device,
                                                       q_dtype):
    """Scores from 0 down to about -80 (no softcap), so p spans ~115
    binades: the plain version with p cut to one bfloat16 lies outside the
    tolerance, so only a kernel that keeps every bit of p (three slices)
    passes."""
    b, kvh, g, hd, S = 2, 2, 4, 64, 1024
    rng = np.random.default_rng(80)
    q = np.zeros((b, kvh, g, hd), np.float32)
    q[..., 0] = hd ** 0.5              # the score is k[..., 0], plus a bit
    q[..., 1:] = rng.standard_normal((b, kvh, g, hd - 1)) * 0.01
    k = rng.standard_normal((b, S, kvh, hd)).astype(np.float32) * 0.1
    k[..., 0] = -rng.uniform(0.0, 80.0, (b, S, kvh))
    v = rng.standard_normal((b, S, kvh, hd)).astype(np.float32)
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in (q, k, v))
    q, k, v = q.to(q_dtype), k.bfloat16(), v.bfloat16()
    valid = torch.arange(S, device=cuda_device) < S - 5
    o, _ = _plain_invariants(q, k, v, valid)
    o1, _ = _plain_invariants(q, k, v, valid, p_bf16=True)
    assert not torch.allclose(o1, o, atol=1e-5, rtol=1e-5)
    _check_decode(q, k, v, valid, None)
    _check_decode(q, k, v, _holes_mask(S, 80, cuda_device), None)


@pytest.mark.cuda
@pytest.mark.parametrize("ranges", [1, 2, 8, 16])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_cuda_gqa_decode_bf16_merges_forced_ranges(cuda_device, q_dtype,
                                                   ranges):
    """The bfloat16 kernel at the serve shape (b 32, S 2,048, kvh 3, g 3,
    hd 64) with each row forced into 1, 2, 8 or 16 ranges (a non-portable
    cluster), merged inside the one launch."""
    b, kvh, g, hd, S = 32, 3, 3, 64, 2048
    n_sms = torch.cuda.get_device_properties(cuda_device) \
        .multi_processor_count
    assert G.decode_splits(b * kvh, S, n_sms, G.MMA_CHUNK, ranges,
                           kv_bytes=4 * hd)[1] == ranges
    q, k, v = _decode_inputs(cuda_device, 7 + ranges, b, kvh, g, hd, S,
                             torch.bfloat16, q_dtype)
    for cap in (None, 30.0):
        for valid in (torch.arange(S, device=cuda_device) < 1990,
                      _holes_mask(S, 6, cuda_device)):
            _check_decode(q, k, v, valid, cap, ranges)


@pytest.mark.cuda
@pytest.mark.parametrize("ranges", [None, 2, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gqa_decode_merges_ranges_in_one_launch(cuda_device, dtype,
                                                     ranges):
    """At the serve shape (b 32, S 2,048, kvh 3, g 3, hd 64) the ranges of
    a row (decode_splits's choice: 3 in float32, 1 in bfloat16, whose 96
    rows are near 3/4 of the SMs already; or 2, or a full cluster of 8)
    merge inside the one launch."""
    b, kvh, g, hd, S = 32, 3, 3, 64, 2048
    n_sms = torch.cuda.get_device_properties(cuda_device) \
        .multi_processor_count
    bf16 = dtype == torch.bfloat16
    _, n_ranges = G.decode_splits(b * kvh, S, n_sms,
                                  G.decode_tile(hd, dtype), ranges,
                                  kv_bytes=4 * hd if bf16 else None)
    if ranges:
        assert n_ranges == ranges
    elif bf16:
        assert n_ranges == 1
    else:
        assert n_ranges > 1
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device)
               .to(dtype) for shape in ((b, kvh, g, hd), (b, S, kvh, hd),
                                        (b, S, kvh, hd)))
    for cap in (None, 30.0):
        for valid in (torch.arange(S, device=cuda_device) < 1990,
                      _holes_mask(S, 6, cuda_device)):
            _check_decode(q, k, v, valid, cap, ranges)


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["adc_dgd", "compressed_dgd"])
def test_cuda_per_leaf_train_step_launches_block_kernels(cuda_device,
                                                         algorithm):
    cfg = reduced(get_config("smollm-135m"))
    setup = train.build_train_setup(cfg, consensus_nodes=4,
                                    algorithm=algorithm,
                                    wire_packing="per_leaf",
                                    device=cuda_device)
    state = train.init_train_state(setup, 0)
    batch = SyntheticLMDataset(cfg.vocab_size, 64, 8,
                               n_shards=4).global_batch_arrays(0)
    before = (Q.quantize_blocks.launches, D.dequant_combine.launches,
              Q.quantize_payload.launches)
    state, metrics = train.train_step(setup, state, batch)
    torch.cuda.synchronize()
    n_leaves = 11
    want = (4 * n_leaves, 4 * n_leaves if algorithm == "adc_dgd" else 0, 0)
    assert (Q.quantize_blocks.launches - before[0],
            D.dequant_combine.launches - before[1],
            Q.quantize_payload.launches - before[2]) == want
    assert np.isfinite(metrics["loss"])


@pytest.mark.cuda
def test_cuda_serve_decode_launches_kernel_per_layer(cuda_device):
    before = G.gqa_decode.launches
    r = serve.main(["--reduced", "--batch", "2", "--prompt-len", "16",
                    "--new-tokens", "5"])
    cfg = reduced(get_config("smollm-135m"))
    assert G.gqa_decode.launches - before == cfg.n_periods * 4
    assert r["tokens"].shape == (2, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,extra", [
    ("qwen3-0.6b", ()), ("yi-9b", ()), ("chameleon-34b", ()),
    ("gemma2-9b", ()), ("gemma2-9b", ("--long-serve",))])
def test_cuda_zoo_serve_launches_kernel_per_layer(cuda_device, arch, extra):
    """Reduced zoo serving on the card: #9 once per layer and decode step,
    prompts longer than reduced gemma2's window (64) and cap (128)."""
    before = G.gqa_decode.launches
    r = serve.main(["--arch", arch, "--reduced", "--batch", "2",
                    "--prompt-len", "131", "--new-tokens", "5", *extra])
    cfg = reduced(get_config(arch))
    assert G.gqa_decode.launches - before == cfg.n_layers * 4
    assert r["tokens"].shape == (2, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [None, 50.0])
@pytest.mark.parametrize("dtype", DECODE_DTYPES)
def test_cuda_gqa_decode_half_million_positions_hd256(cuda_device, dtype,
                                                       cap):
    """The longest cache the reference serves (``long_500k``: 524,288
    positions) at gemma2-9b's heads (kvh 8, g 2, hd 256, softcap 50): 16
    ranges of 32,768 positions per row, merged over one non-portable
    cluster of 16 in the one launch.  K and V are 4.3 GB each in
    float32; float32, bfloat16 and a float32 q over the bfloat16 cache.
    Masks: a ragged frontier, random holes, and a 4,096-position
    sliding window before the frontier."""
    b, kvh, g, hd, S = 1, 8, 2, 256, 524_288
    q, k, v = _decode_inputs(cuda_device, 524, b, kvh, g, hd, S, dtype)
    assert G.decode_grid(q, k)[:2] == (32768, 16)
    pos = torch.arange(S, device=cuda_device)
    frontier = S - 37
    for valid in (pos < frontier, _holes_mask(S, 7, cuda_device),
                  (pos < frontier) & (pos >= frontier - 4096)):
        _check_decode(q, k, v, valid, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("step", [None, 1e-3])
def test_cuda_quantize_kernel_reads_lead_of_wide_noise(cuda_device, dtype,
                                                       step):
    """Kernel #1 on a 1,024-column noise buffer (a plan holding top-k
    shares one): the noise row stride is the buffer's, the leading 512
    columns are read, bytes equal to the plain version's."""
    y, u = _codec_inputs(cuda_device, 6, 2 * BLOCK)
    y = y.to(dtype)
    before = Q.quantize_payload.launches
    for view in ({}, {"row_offset": 37, "n_rows": 1001}):
        got = Q.quantize_payload(y, u, step, **view)
        assert torch.equal(got, Q.quantize_payload_plain(y, u, step, **view))
        assert torch.equal(got, Q.quantize_payload(
            y, u[:, :BLOCK].contiguous(), step, **view))
    assert Q.quantize_payload.launches == before + 4


PLANS = {"int8": "int8", "planA": "mixed:norm=int4,embed=int4,*=int8",
         "planB": "mixed:embed=topk:k=64,norm=int2,*=int8"}


def _exchange_inputs(seed=0):
    """Reduced smollm-135m x 4 nodes: x_prev, x_half (a few entries
    beyond the fixed grid) on the CPU, made with numpy."""
    from repro_torch.core import tree as T
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import meta_params
    rng = np.random.default_rng(seed)
    tmpl = meta_params(TF.build_defs(reduced(get_config("smollm-135m")))
                       .storage)
    xp = T.tree_map(lambda a: torch.from_numpy(np.broadcast_to(
        (rng.standard_normal(a.shape) * 0.05).astype(np.float32),
        (4,) + a.shape).copy()), tmpl)

    def step(a):
        d = (rng.standard_normal(a.shape) * 2e-3).astype(np.float32)
        d.reshape(-1)[::997] *= 300.0
        return a + torch.from_numpy(d)
    return xp, T.tree_map(step, xp)


def _exchanges(device, spec, packing="packed", chunks=4, steps=2):
    """``steps`` exchanges on ``device`` from the same inputs and noise
    (async at staleness 0): (x_next, state, metrics) per step."""
    from repro_torch.core import tree as T
    from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
    rt = ConsensusRuntime(ConsensusConfig(
        wire_codec=spec, wire_packing=packing, pipeline_chunks=chunks,
        staleness=0), 4)
    xp, xh = (T.tree_map(lambda a: a.to(device), t)
              for t in _exchange_inputs())
    state = rt.init_state(xp)
    layout = rt.state_layout(xp)
    out = []
    for k in range(1, steps + 1):
        noise = torch.rand((4, layout.n_rows, rt.noise_cols_for(layout)),
                           generator=torch.Generator().manual_seed(k))
        x, state, m = rt.exchange(xp, xh, state, k, noise=noise.to(device))
        out.append((x, state, m))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["planA", "planB"])
def test_cuda_plan_exchange_matches_cpu(cuda_device, plan):
    """One exchange step of a mixed plan on the card (every run on its
    kernel) against the CPU (plain versions) from the same inputs, state
    and noise: x_tilde, m_agg and x_next within 1 ulp (the combines' own
    contract), overflow equal; the launches are one per node and run."""
    from repro_torch.core import tree as T
    before = {e: e.launches for e in (Q.quantize_payload,
                                      D.dequant_combine_payload,
                                      BP.subbyte_encode_payload,
                                      BP.topk_encode_payload)}
    (gx, gs, gm), = _exchanges(cuda_device, PLANS[plan], steps=1)
    (cx, cs, cm), = _exchanges("cpu", PLANS[plan], steps=1)
    for key in ("x_tilde", "m_agg"):
        np.testing.assert_array_max_ulp(gs[key].cpu().numpy(),
                                        cs[key].numpy(), maxulp=1)
    for a, b in zip(T.tree_leaves(gx), T.tree_leaves(cx)):
        np.testing.assert_array_max_ulp(a.cpu().numpy(), b.numpy(),
                                        maxulp=1)
    assert torch.equal(gm["overflow_frac"].cpu(), cm["overflow_frac"])
    assert gm["wire_bytes_per_step"] == cm["wire_bytes_per_step"]
    small = (BP.subbyte_encode_payload if plan == "planA"
             else BP.topk_encode_payload)
    assert (Q.quantize_payload.launches - before[Q.quantize_payload],
            D.dequant_combine_payload.launches
            - before[D.dequant_combine_payload],
            small.launches - before[small]) == (4, 4, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", list(PLANS))
def test_cuda_pipelined_equals_packed(cuda_device, plan):
    """On the card, two exchanges pipelined over 4 and 7 chunks and on the
    async transport at staleness 0 give the packed exchange's bits."""
    from repro_torch.core import tree as T
    want = _exchanges(cuda_device, PLANS[plan])
    for packing, chunks in (("pipelined", 4), ("pipelined", 7),
                            ("async", 4)):
        got = _exchanges(cuda_device, PLANS[plan], packing, chunks)
        for (gx, gs, _), (wx, ws, _) in zip(got, want):
            assert all(torch.equal(a, b) for a, b in zip(T.tree_leaves(gx),
                                                          T.tree_leaves(wx)))
            assert all(torch.equal(gs[k], ws[k])
                       for k in ("x_tilde", "m_agg"))


def _codec_out_roundtrip(name, device):
    """Encode and combine through ``out=``: the caller's tensors (row
    views of larger buffers) come back written, equal to fresh outputs."""
    from repro_torch.core.codec import by_name
    cd = by_name(name)
    g = torch.Generator(device=device).manual_seed(3)
    rows, lo, n = 96, 13, 61
    y = torch.randn((rows, BLOCK), generator=g, device=device) * 0.05
    u = torch.rand((rows, cd.noise_cols()), generator=g, device=device)
    width = cd.payload_width()
    flat = torch.zeros(8 + (n + 1) * width, dtype=torch.uint8, device=device)
    align = {"int8": 4, "int4": 2, "int2": 2}.get(name, 1)
    seg = flat[width:width + n * width].view(n, width)
    got = cd.encode_payload(y, u, 1e-3, row_offset=lo, n_rows=n, out=seg)
    assert got.data_ptr() == seg.data_ptr() and seg.data_ptr() % align == 0
    assert torch.equal(seg, cd.encode_payload(y, u, 1e-3, row_offset=lo,
                                              n_rows=n))
    pays = [cd.encode_payload(y * (i + 1), u) for i in range(3)]
    xt = torch.randn((rows, BLOCK), generator=g, device=device)
    m = torch.randn((rows, BLOCK), generator=g, device=device)
    big = torch.full((3, 2, rows, BLOCK), 7.0, device=device)
    outs = [big[k, 1, lo:lo + n] for k in range(3)]
    got = cd.decode_combine(*pays, xt, m, 0.5, 0.25, 0.37, row_offset=lo,
                            n_rows=n, out=outs)
    want = cd.decode_combine(*pays, xt, m, 0.5, 0.25, 0.37, row_offset=lo,
                             n_rows=n)
    for o, a, b in zip(outs, got, want):
        assert a.data_ptr() == o.data_ptr() and torch.equal(a, b)
    assert (big[:, 0] == 7.0).all() and (big[:, 1, :lo] == 7.0).all()
    with pytest.raises(ValueError, match="out"):
        cd.encode_payload(y, u, 1e-3, out=seg)          # rows != n_full
    return flat


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["int8", "int4", "int2", "topk"])
def test_cuda_codec_kernels_write_into_out(cuda_device, name):
    """Kernels #1, #2 and #5-#8 write into the caller's row views (what the
    exchange hands them), equal to fresh outputs; an int8 or sub-byte
    payload view off its store alignment is refused."""
    from repro_torch.core.codec import by_name
    flat = _codec_out_roundtrip(name, cuda_device)
    if name in ("int8", "int4", "int2"):
        cd = by_name(name)
        y, u = _codec_inputs(cuda_device, 6, cd.noise_cols())
        width = cd.payload_width()
        off = flat[1:1 + 4 * width].view(4, width)
        with pytest.raises(ValueError, match="aligned"):
            cd.encode_payload(y, u, None, n_rows=4, out=off)


class _plain_kernels:
    """Within the block the exchange's kernel entry points (``ops``) run
    their plain PyTorch versions on the card instead of the kernels."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.saved = ops, {
            k: getattr(ops, k) for k in ("quantize_payload",
                                         "dequant_combine_payload",
                                         "quantize_blocks", "dequant_combine")}
        ops.quantize_payload = (
            lambda y, noise, fixed_step=None, row_offset=0, n_rows=None,
            out=None: Q._into(out, Q.quantize_payload_plain(
                y, noise, fixed_step, row_offset, n_rows)))
        ops.dequant_combine_payload = (
            lambda ps, pl, pr, xt, mb, w_self, w_side, deamp, row_offset=0,
            n_rows=None, out=None: Q._into(
                out, D.dequant_combine_payload_plain(
                    ps, pl, pr, xt, mb, w_self, w_side, deamp, row_offset,
                    n_rows)))
        ops.quantize_blocks = (lambda y, noise, fixed_step=None:
                               Q.quantize_blocks_plain(y, noise, fixed_step))
        ops.dequant_combine = D.dequant_combine_plain
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.ops, k, v)
        return False


def _fault_exchanges(device, steps=2, **kw):
    """``steps`` exchanges of the reduced 4-node tree on ``device`` under
    ``ConsensusConfig(**kw)`` from the same inputs and noise: the final
    (x_next, state) and the launches of #1-#4 over the run."""
    from repro_torch.core import tree as T
    from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
    rt = ConsensusRuntime(ConsensusConfig(**kw), 4)
    xp, xh = (T.tree_map(lambda a: a.to(device), t)
              for t in _exchange_inputs())
    state = rt.init_state(xp)
    layout = rt.state_layout(xp)
    kernels = (Q.quantize_payload, D.dequant_combine_payload,
               Q.quantize_blocks, D.dequant_combine)
    before = [k.launches for k in kernels]
    for k in range(1, steps + 1):
        noise = torch.rand((4, layout.n_rows, rt.noise_cols_for(layout)),
                           generator=torch.Generator().manual_seed(k))
        x, state, _ = rt.exchange(xp, xh, state, k, noise=noise.to(device))
        xp, xh = x, T.tree_map(lambda a: a * 1.001, x)
    torch.cuda.synchronize()
    return x, state, [k.launches - b for k, b in zip(kernels, before)]


def _same_exchange(a, b):
    from repro_torch.core import tree as T
    return (all(torch.equal(p, q) for p, q in zip(T.tree_leaves(a[0]),
                                                   T.tree_leaves(b[0])))
            and sorted(a[1]) == sorted(b[1])
            and all(torch.equal(a[1][k], b[1][k]) for k in a[1]))


#: (label, ConsensusConfig keywords, launches of #1-#4 over 2 steps)
FAULT_CASES = [
    ("lossy packed", dict(link_loss=0.3, loss_seed=1), [8, 8, 0, 0]),
    ("lossy per-leaf", dict(link_loss=0.3, loss_seed=1,
                            wire_packing="per_leaf"), [0, 0, 88, 88]),
    ("lossy async s1 + straggle", dict(
        link_loss=0.3, loss_seed=1, wire_packing="async", straggle_rate=0.3),
     [8, 8, 0, 0]),
    ("directed lossy packed", dict(topology="directed-ring", link_loss=0.2,
                                   loss_seed=1), [8, 8, 0, 0]),
    ("directed lossy pipelined", dict(
        topology="directed-ring", link_loss=0.2, loss_seed=1,
        wire_packing="pipelined", pipeline_chunks=3), [24, 24, 0, 0]),
    ("directed lossy per-leaf", dict(
        topology="directed-ring", link_loss=0.2, loss_seed=1,
        wire_packing="per_leaf"), [0, 0, 88, 88])]


@pytest.mark.cuda
@pytest.mark.parametrize("label,kw,launches", FAULT_CASES,
                         ids=[c[0] for c in FAULT_CASES])
def test_cuda_fault_exchange_matches_plain(cuda_device, label, kw, launches):
    """Two exchange steps under link loss (and straggler deadlines, and the
    directed ring with push-sum) through the kernels and through their
    plain versions on the card: parameters and the whole consensus state
    (push-sum weights and in-flight payloads included) bitwise equal; the
    kernels launched once per node, transfer unit (or leaf) and step."""
    got = _fault_exchanges(cuda_device, **kw)
    with _plain_kernels():
        want = _fault_exchanges(cuda_device, **kw)
    assert _same_exchange(got, want)
    assert got[2] == launches and want[2] == [0, 0, 0, 0]
    if "ps_w" in got[1]:
        assert torch.equal(got[1]["ps_w"].cpu(), torch.ones(4, 1))


#: (label, ConsensusConfig keywords, launches of #1-#4 over 2 steps): the
#: hole mask encodes and combines 3 of the 4 nodes, the pod ring 2 pods
ELASTIC_CASES = [
    ("hole packed", dict(membership=((True, True, False, True),)),
     [6, 6, 0, 0]),
    ("hole async s1", dict(membership=((True, True, False, True),),
                           wire_packing="async"), [6, 6, 0, 0]),
    ("churn pipelined", dict(membership=((True,) * 4,
                                         (True, True, False, True)),
                             wire_packing="pipelined", pipeline_chunks=3),
     [21, 21, 0, 0]),
    ("pods 2 packed", dict(hierarchy=2), [4, 4, 0, 0]),
    ("pods 2 async s1 lossy", dict(hierarchy=2, wire_packing="async",
                                   link_loss=0.3, loss_seed=1),
     [4, 4, 0, 0])]


@pytest.mark.cuda
@pytest.mark.parametrize("label,kw,launches", ELASTIC_CASES,
                         ids=[c[0] for c in ELASTIC_CASES])
def test_cuda_elastic_exchange_matches_plain(cuda_device, label, kw,
                                             launches):
    """Two exchange steps under a membership mask and on the pod ring
    through the kernels and through their plain versions on the card:
    parameters and the consensus state (in-flight payloads included)
    bitwise equal; an inactive node's rows frozen; pod members bitwise
    replicas."""
    from repro_torch.core import tree as T
    got = _fault_exchanges(cuda_device, **kw)
    with _plain_kernels():
        want = _fault_exchanges(cuda_device, **kw)
    assert _same_exchange(got, want)
    assert got[2] == launches and want[2] == [0, 0, 0, 0]
    if "hierarchy" in kw:
        for a in T.tree_leaves(got[0]) + list(got[1].values()):
            assert torch.equal(a[0::2], a[1::2])
    if label.startswith("hole"):
        xp, _ = _exchange_inputs()
        for a, b in zip(T.tree_leaves(got[0]), T.tree_leaves(xp)):
            assert torch.equal(a[2].cpu(), b[2])


#: (label, ConsensusConfig keywords) of the telemetry cases on the card
TELEMETRY_CASES = [("packed", {}),
                   ("pipelined", dict(wire_packing="pipelined",
                                      pipeline_chunks=3)),
                   ("async s1 lossy", dict(wire_packing="async",
                                           link_loss=0.3, loss_seed=1))]


@pytest.mark.cuda
@pytest.mark.parametrize("label,kw", TELEMETRY_CASES,
                         ids=[c[0] for c in TELEMETRY_CASES])
def test_cuda_telemetry_is_bitwise_and_measured(cuda_device, label, kw):
    """Two exchange steps with ``telemetry`` and a span recorder installed
    equal the same steps without, bitwise, with the same launches; the
    recorder's CUDA events measure every phase, and the phases and the glue
    read from their own stamps add up to the window."""
    from repro_torch.core import telemetry
    plain = _fault_exchanges(cuda_device, **kw)
    rec = telemetry.SpanRecorder(cuda_device).install()
    try:
        rec.step_begin()
        with telemetry.exchange_window():
            got = _fault_exchanges(cuda_device, telemetry=True, **kw)
        torch.cuda.synchronize()
        split = rec.measure()
    finally:
        rec.uninstall()
    assert _same_exchange(got, plain) and got[2] == plain[2]
    assert set(split["phases"]) == {"quantize", "launch", "retire",
                                    "dequant_combine"}
    total = sum(split["phases"].values()) + sum(split["glue_parts"].values())
    assert abs(total - split["window_s"]) < 1e-4
    assert all(v >= 0 for v in split["phases"].values())
    assert rec.to_perfetto()["otherData"]["spans"] == "cuda-events"


@pytest.mark.cuda
@pytest.mark.parametrize("packing", ["packed", "async"])
def test_cuda_checkpoint_resume_is_bitwise(cuda_device, tmp_path, packing):
    """A reduced 4-node run saved after step 2 and resumed into a fresh
    state on the card equals the uninterrupted 4-step run bit for bit."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.core import tree as T
    argv = ["--reduced", "--nodes", "4", "--batch", "8", "--seq", "32",
            "--steps", "4", "--wire-packing", packing, "--checkpoint-dir",
            str(tmp_path), "--checkpoint-every", "2"]
    _, full = train.main(argv, return_state=True)
    cfg = reduced(get_config("smollm-135m"))
    setup = train.build_train_setup(cfg, consensus_nodes=4, lr=3e-2,
                                    track_consensus_error=True,
                                    wire_packing=packing)
    state, step = load_checkpoint(str(tmp_path),
                                  train.init_train_state(setup, 9), step=2)
    assert all(a.device.type == "cuda" for a in T.tree_leaves(state)
               if torch.is_tensor(a))
    ds = SyntheticLMDataset(cfg.vocab_size, 32, 8, n_shards=4)
    for k in (2, 3):
        state, _ = train.train_step(setup, state, ds.global_batch_arrays(k))
    assert state["step"] == full["step"] == 4
    assert all(torch.equal(a, b) for a, b in zip(T.tree_leaves(state),
                                                  T.tree_leaves(full))
               if torch.is_tensor(a))


@pytest.mark.cuda
@pytest.mark.parametrize("b,kvh,g,hd,S", [
    (32, 8, 3, 64, 2048),           # granite-moe-3b-a800m serving
    (2, 16, 1, 128, 2048)])         # deepseek-moe-16b: g = 1 (MHA)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gqa_decode_moe_heads(cuda_device, b, kvh, g, hd, S, dtype):
    """#9 at the MoE archs' decode shapes, g 1 included."""
    gen = torch.Generator(device=cuda_device).manual_seed(S + g + hd)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device)
               .to(dtype) for shape in ((b, kvh, g, hd), (b, S, kvh, hd),
                                        (b, S, kvh, hd)))
    gpos = torch.arange(S, device=cuda_device)
    for cap in (None, 30.0):
        for valid in (gpos <= S - 38, _holes_mask(S, S + g, cuda_device)):
            _check_decode(q, k, v, valid, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-moe-16b"])
def test_cuda_moe_routing_matches_per_token_loop(cuda_device, arch):
    """One full-width MoE layer on the card at capacity factor 1.25, on
    tokens that share a component (so that experts overflow): the chosen
    experts and the kept set equal a per-token loop over the card's own
    probabilities, and the output a per-expert computation of the kept
    tokens, added per token in ascending expert id."""
    import dataclasses
    import math
    from repro_torch.models import moe
    from repro_torch.models.layers import _act
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(get_config(arch), capacity_factor=1.25)
    p = init_params(moe.moe_defs(cfg), 3, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    t, d, k = 512, cfg.d_model, cfg.top_k
    x = (torch.randn((1, t, d), generator=gen, device=cuda_device)
         + 0.5 * torch.randn((d,), generator=gen, device=cuda_device))
    with torch.no_grad():
        r = moe.route(p["router"], x[0], cfg)
        out, _ = moe.moe_forward(p, x, cfg)
    probs = r.probs.cpu().numpy()
    top_e = np.argsort(-probs, axis=1, kind="stable")[:, :k]
    cap = max(1, int(math.ceil(t * k / cfg.n_experts
                               * cfg.capacity_factor)))
    fill = np.zeros(cfg.n_experts, np.int64)
    keep = np.zeros((t, k), bool)
    for i in range(t):
        for j in range(k):
            keep[i, j] = fill[top_e[i, j]] < cap
            fill[top_e[i, j]] += 1
    np.testing.assert_array_equal(r.top_e.cpu().numpy(), top_e)
    np.testing.assert_array_equal(r.keep.cpu().numpy(), keep)
    assert 0 < (~keep).sum()
    w = r.top_p
    want = torch.zeros((t, d), device=cuda_device)
    with torch.no_grad():
        for e in range(cfg.n_experts):
            rows, cols = np.nonzero((top_e == e) & keep)
            if len(rows):
                toks = torch.from_numpy(rows).to(cuda_device)
                xe = x[0, toks]
                y = (_act(cfg.mlp_act, xe @ p["w_gate"][e])
                     * (xe @ p["w_up"][e])) @ p["w_down"][e]
                want[toks] += y * w[toks, torch.from_numpy(cols)
                                    .to(cuda_device)][:, None]
        if "shared" in p:
            sp = p["shared"]
            want += (_act(cfg.mlp_act, x[0] @ sp["w_gate"])
                     * (x[0] @ sp["w_up"])) @ sp["w_down"]
    torch.testing.assert_close(out[0], want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-moe-16b"])
def test_cuda_moe_serve_launches_kernel_per_layer(cuda_device, arch):
    """Reduced MoE serving on the card: #9 once per layer (deepseek's
    prelude included) and decode step."""
    before = G.gqa_decode.launches
    r = serve.main(["--arch", arch, "--reduced", "--batch", "2",
                    "--prompt-len", "37", "--new-tokens", "5"])
    cfg = reduced(get_config(arch))
    assert G.gqa_decode.launches - before == cfg.n_layers * 4
    assert r["tokens"].shape == (2, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gqa_decode_jamba_heads(cuda_device, dtype):
    """#9 at jamba-v0.1-52b's decode shape (b 4, S 2,112, 8 KV heads of
    128, g 4)."""
    b, kvh, g, hd, S = 4, 8, 4, 128, 2112
    gen = torch.Generator(device=cuda_device).manual_seed(S + g + hd)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device)
               .to(dtype) for shape in ((b, kvh, g, hd), (b, S, kvh, hd),
                                        (b, S, kvh, hd)))
    gpos = torch.arange(S, device=cuda_device)
    for cap in (None, 30.0):
        for valid in (gpos <= S - 2, _holes_mask(S, S + g, cuda_device)):
            _check_decode(q, k, v, valid, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_cuda_ssm_serve_launches_kernel_per_attention_layer(cuda_device,
                                                            arch):
    """Reduced state-space serving on the card: #9 once per 'A' layer and
    decode step (none for mamba2-1.3b), the prompt two chunks long."""
    before = G.gqa_decode.launches
    r = serve.main(["--arch", arch, "--reduced", "--batch", "2",
                    "--prompt-len", "64", "--new-tokens", "5"])
    cfg = reduced(get_config(arch))
    n_attn = (cfg.prelude + cfg.period * cfg.n_periods).count("A")
    assert G.gqa_decode.launches - before == n_attn * 4
    assert r["tokens"].shape == (2, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_cuda_ssm_prefill_and_decode_match_cpu(cuda_device, arch):
    """Reduced state-space model, the same weights on the card and on the
    CPU: prefill logits and caches, then 4 teacher-forced decode steps,
    within 1e-4 (float32 products sum in other orders on the two)."""
    from repro_torch.core import tree as T
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params
    cfg = reduced(get_config(arch))
    defs = TF.build_defs(cfg)
    params = init_params(defs.storage, 0, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 68)))
    out = {}
    for dev in ("cpu", cuda_device):
        p = T.tree_map(lambda a: a.to(dev), params)
        cache = TF.init_cache(cfg, 2, 68, device=dev)
        with torch.inference_mode():
            logits, cache = TF.model_apply(
                p, defs, {"tokens": tokens[:, :64].to(dev)}, mode="prefill",
                cache=cache)
            steps = [logits]
            for t in range(64, 68):
                lg, cache = TF.model_apply(
                    p, defs, {"tokens": tokens[:, t:t + 1].to(dev)},
                    mode="decode", cache=cache)
                steps.append(lg)
        out[str(dev)] = [a.cpu() for a in steps + T.tree_leaves(
            {k: v for k, v in cache.items() if k != "len"})]
    for a, b in zip(out["cpu"], out[str(cuda_device)]):
        assert torch.allclose(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("S,all_valid", [(448, False), (1504, True)],
                         ids=["self", "cross"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gqa_decode_whisper_heads(cuda_device, S, all_valid, dtype):
    """#9 at whisper-small's decode shapes (b 32, 12 KV heads of 64, g 1):
    the decoder's self-attention over its 448-position context, and its
    cross attention over 1,504 frames, every one valid."""
    b, kvh, g, hd = 32, 12, 1, 64
    gen = torch.Generator(device=cuda_device).manual_seed(S + hd)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device)
               .to(dtype) for shape in ((b, kvh, g, hd), (b, S, kvh, hd),
                                        (b, S, kvh, hd)))
    gpos = torch.arange(S, device=cuda_device)
    masks = [gpos >= 0] if all_valid else [gpos <= S - 2,
                                           _holes_mask(S, S, cuda_device)]
    for cap in (None, 30.0):
        for valid in masks:
            _check_decode(q, k, v, valid, cap)


@pytest.mark.cuda
def test_cuda_whisper_serve_launches_kernel_twice_per_layer(cuda_device):
    """Reduced whisper-small serving on the card: #9 twice per decoder
    layer and decode step (self and cross attention)."""
    before = G.gqa_decode.launches
    r = serve.main(["--arch", "whisper-small", "--reduced", "--batch", "2",
                    "--prompt-len", "16", "--new-tokens", "5"])
    cfg = reduced(get_config("whisper-small"))
    assert G.gqa_decode.launches - before == 2 * cfg.n_layers * 4
    assert r["tokens"].shape == (2, 5) and r["frames"].shape == (2, 32, 256)


@pytest.mark.cuda
def test_cuda_whisper_prefill_and_decode_match_cpu(cuda_device):
    """Reduced whisper-small, the same weights and frames on the card and
    on the CPU: prefill logits and both caches, then 4 teacher-forced
    decode steps through #9 (self and cross), within 1e-4 (float32
    products sum in other orders on the two)."""
    from repro_torch.core import tree as T
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params
    cfg = reduced(get_config("whisper-small"))
    defs = TF.build_defs(cfg)
    params = init_params(defs.storage, 0, "cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 20)))
    frames = torch.from_numpy(rng.standard_normal(
        (2, cfg.encoder_frames, cfg.d_model), dtype=np.float32))
    out = {}
    for dev in ("cpu", cuda_device):
        p = T.tree_map(lambda a: a.to(dev), params)
        cache = TF.init_cache(cfg, 2, 20, device=dev)
        with torch.inference_mode():
            logits, cache = TF.model_apply(
                p, defs, {"tokens": tokens[:, :16].to(dev),
                          "enc_frames": frames.to(dev)},
                mode="prefill", cache=cache)
            steps = [logits]
            for t in range(16, 20):
                lg, cache = TF.model_apply(
                    p, defs, {"tokens": tokens[:, t:t + 1].to(dev)},
                    mode="decode", cache=cache)
                steps.append(lg)
        out[str(dev)] = [a.cpu() for a in steps + T.tree_leaves(
            {k: v for k, v in cache.items() if k != "len"})]
    for a, b in zip(out["cpu"], out[str(cuda_device)]):
        assert torch.allclose(a, b, atol=1e-4, rtol=1e-4)


#: bfloat16 on the card against the CPU: both are bfloat16 forwards that
#: round in other places (products sum in other orders), each within a few
#: bfloat16 roundings of a float64 forward (tests/test_torch_precision.py),
#: so values are held to this share of the largest one
BF16_RTOL = 2.0 ** -5


def _bf16_close(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    assert float((a - b).abs().max()) <= BF16_RTOL * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "gemma2-9b"])
def test_cuda_bf16_prefill_and_decode_match_cpu(cuda_device, arch):
    """Reduced ``arch`` at bfloat16 compute and cache, the same weights on
    the card and on the CPU: prefill logits and caches, then 4
    teacher-forced decode steps, #9 reading the bfloat16 cache once per
    layer and step."""
    from repro_torch.core import tree as T
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params
    cfg = reduced(get_config(arch))
    defs = TF.build_defs(cfg, dtype=torch.bfloat16)
    params = init_params(defs.storage, 0, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 84)))
    out = {}
    for dev in ("cpu", cuda_device):
        p = T.tree_map(lambda a: a.to(dev), params)
        pre = serve.build_prefill_setup(cfg, device=dev,
                                        compute_dtype=torch.bfloat16)
        first, cache = pre.prefill_step(p, {"tokens": tokens[:, :80].to(dev)},
                                        84)
        before = G.gqa_decode.launches
        steps = []
        with torch.inference_mode():
            for t in range(80, 84):
                lg, cache = TF.model_apply(
                    p, defs, {"tokens": tokens[:, t:t + 1].to(dev)},
                    mode="decode", cache=cache, compute_dtype=torch.bfloat16)
                steps.append(lg)
        leaves = T.tree_leaves({k: v for k, v in cache.items()
                                if k != "len"})
        assert {a.dtype for a in leaves} == {torch.bfloat16}
        if dev != "cpu":
            assert G.gqa_decode.launches - before == 4 * cfg.n_layers
        out[str(dev)] = [first.cpu()] + [a.cpu() for a in steps + leaves]
    for a, b in zip(out["cpu"][1:], out[str(cuda_device)][1:]):
        _bf16_close(b, a)


@pytest.mark.cuda
def test_cuda_gqa_decode_on_a_bf16_model_cache(cuda_device):
    """#9 on the bfloat16 K and V cache of a reduced prefill on the card
    (its bfloat16 branch), against its plain version, within the decode
    tolerances of the float32 tests (both widen bfloat16 exactly)."""
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import init_params
    cfg = reduced(get_config("smollm-135m"))
    defs = TF.build_defs(cfg, dtype=torch.bfloat16)
    params = init_params(defs.storage, 0, cuda_device)
    pre = serve.build_prefill_setup(cfg, device=cuda_device,
                                    compute_dtype=torch.bfloat16)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 96))).to(cuda_device)
    _, cache = pre.prefill_step(params, {"tokens": tokens}, 128)
    entry = cache["layers"][0]["attn"]
    k, v = entry["k"][1], entry["v"][1]
    assert k.dtype == v.dtype == torch.bfloat16
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn((4, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                     cfg.resolved_head_dim), generator=g,
                    device=cuda_device)
    valid = torch.arange(128, device=cuda_device) < 96
    before = G.gqa_decode.launches
    m, l, acc = G.gqa_decode(q, k, v, valid)
    assert G.gqa_decode.launches == before + 1
    pm, pl, pacc = G.gqa_decode_plain(q, k, v, valid)
    assert torch.allclose(acc / l[..., None], pacc / pl[..., None],
                          atol=1e-5, rtol=1e-5)
    assert torch.allclose(m + torch.log(l), pm + torch.log(pl), atol=5e-5,
                          rtol=5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [True, False], ids=["full", "none"])
def test_cuda_bf16_train_step_matches_cpu(cuda_device, remat):
    """A bfloat16 trainer step of reduced smollm-135m on 4 nodes, the same
    weights, batch and quantization noise on the card and on the CPU: #1
    and #2 once per node, losses within 1e-3, bfloat16 parameters within
    BF16_RTOL of the CPU's and 2 grid steps, float32 shadows within 2
    grid steps (a rounding may move a code: hazard 4's tests)."""
    from repro_torch.core import tree as T
    cfg = reduced(get_config("smollm-135m"))
    batch = SyntheticLMDataset(cfg.vocab_size, 64, 8,
                               n_shards=4).global_batch_arrays(0)
    out = {}
    base = None
    for dev in ("cpu", cuda_device):
        setup = train.build_train_setup(cfg, consensus_nodes=4, device=dev,
                                        compute_dtype=torch.bfloat16,
                                        remat=remat)
        state = train.init_train_state(setup, 0, params=None if base is None
                                       else T.tree_map(lambda a: a.to(dev),
                                                       base))
        base = state["params"]
        rows = setup.consensus.state_layout(base).n_rows
        noise = torch.rand((4, rows, BLOCK), generator=torch.Generator(
            ).manual_seed(5)).to(dev)
        before = (Q.quantize_payload.launches,
                  D.dequant_combine_payload.launches)
        state, metrics = train.train_step(setup, state, batch, noise=noise)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert (Q.quantize_payload.launches - before[0],
                    D.dequant_combine_payload.launches - before[1]) == (4, 4)
        assert {a.dtype for a in T.tree_leaves(state["params"])} == {
            torch.bfloat16}
        assert state["consensus"]["x_tilde"].dtype == torch.float32
        out[str(dev)] = (metrics["loss"], T.tree_leaves(state["params"]),
                         state["consensus"]["x_tilde"])
    cpu, card = out["cpu"], out[str(cuda_device)]
    assert card[0] == pytest.approx(cpu[0], rel=1e-3)
    # the gradients round apart, so a stochastic rounding may land on the
    # other side of its threshold: an element of x_tilde (and the step it
    # adds to a parameter) moves by a grid step (fixed_step0 at step 1)
    grid = 2 * setup.consensus.cfg.fixed_step0
    for a, b in zip(card[1], cpu[1]):
        assert float((a.float().cpu() - b.float()).abs().max()) <= \
            grid + BF16_RTOL * float(b.float().abs().max())
    assert float((card[2].cpu() - cpu[2]).abs().max()) <= grid
