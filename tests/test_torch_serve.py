"""The port's serving path held to the JAX package.

Kernel, on numpy/JAX draws: the flash-decode partials of
``kernels.gqa_decode`` (on CPU tensors: the plain version) against JAX
``gqa_decode_ref`` and the interpret-mode ``gqa_decode_pallas``, on the
cases of the reference's own kernel test, in float32 and bf16.  Partials
may differ in how they are summed, so the invariants are compared: the
normalised output ``acc / l`` and the log-sum-exp ``m + log l``, at the
reference test's tolerances.  Plus a cache whose later tiles are all
masked, one whose length is no multiple of 512, and a row with no valid
position at all (``l = 0``, ``acc = 0`` exactly).

Model, reduced smollm-135m with the reference's weights carried over by
``params_from_jax``: prefill logits and cache against
``T.model_apply(mode="prefill")``, 16 tokens of token-by-token decode
against ``mode="decode"``, both against the port's own train-mode logits,
the decode cache against ``T.init_cache``, and the greedy tokens of a
prefill plus 6 decode steps against ``T.greedy_decode_step``.  Both sides
run float32 on the CPU but sum in other orders: logits agree within
``LOGIT_TOL`` (absolute and relative; the reference's own decode test
allows 2e-3).
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.kernels import ref as jref
from repro.kernels.gqa_decode import gqa_decode_pallas
from repro.models import transformer as JT
from repro.models.sharding import local_context
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import gqa_decode as G
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.models.params import params_from_jax

CTX = local_context()
LOGIT_TOL = 1e-5
B, P = 2, 16


def _t(a):
    """A JAX array as a torch tensor with the same bits (bf16 included)."""
    if a.dtype == jnp.bfloat16:
        bits = np.asarray(jax.lax.bitcast_convert_type(a, jnp.uint16))
        return torch.from_numpy(bits.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _invariants(m, l, acc):
    m, l, acc = (np.asarray(x, np.float32) for x in (m, l, acc))
    out = acc / np.maximum(l, 1e-30)[..., None]
    return out, m + np.log(np.maximum(l, 1e-30))


def _qkv(b, kvh, g, hd, S, dtype, seed):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (jax.random.normal(ks[0], (b, kvh, g, hd), dtype),
            jax.random.normal(ks[1], (b, S, kvh, hd), dtype),
            jax.random.normal(ks[2], (b, S, kvh, hd), dtype))


@pytest.mark.parametrize("b,kvh,g,hd,S,cap", [
    (2, 2, 4, 128, 1024, None),      # GQA, 2 S-tiles
    (1, 4, 1, 64, 512, 30.0),        # MHA-ish + softcap, single tile
    (2, 1, 7, 128, 2048, None),      # odd group size, 4 tiles
    (1, 8, 2, 128, 512, None),       # many kv heads
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gqa_decode_matches_jax(b, kvh, g, hd, S, cap, dtype):
    q, k, v = _qkv(b, kvh, g, hd, S, dtype, 42)
    valid = np.arange(S) < (S - 37)
    before = G.gqa_decode.launches
    got = ops.gqa_decode(_t(q), _t(k), _t(v), torch.from_numpy(valid),
                         softcap=cap)
    assert G.gqa_decode.launches == before          # CPU: the plain path
    assert [tuple(x.shape) for x in got] == [(b, kvh, g), (b, kvh, g),
                                             (b, kvh, g, hd)]
    assert all(x.dtype == torch.float32 for x in got)
    out, lse = _invariants(*got)
    tol = 1e-5 if dtype == jnp.float32 else 3e-2
    lse_tol = 5e-5 if dtype == jnp.float32 else 5e-2
    for want in (jref.gqa_decode_ref(q, k, v, jnp.asarray(valid),
                                     softcap=cap),
                 gqa_decode_pallas(q, k, v, jnp.asarray(valid), softcap=cap,
                                   interpret=True)):
        w_out, w_lse = _invariants(*want)
        np.testing.assert_allclose(out, w_out, atol=tol, rtol=tol)
        np.testing.assert_allclose(lse, w_lse, atol=lse_tol)


def test_gqa_decode_all_masked_tiles():
    """Only the first of four 512-position tiles holds valid positions."""
    q, k, v = _qkv(1, 2, 2, 128, 2048, jnp.float32, 7)
    valid = np.arange(2048) < 100
    got = _invariants(*ops.gqa_decode(_t(q), _t(k), _t(v),
                                      torch.from_numpy(valid)))
    for want in (jref.gqa_decode_ref(q, k, v, jnp.asarray(valid)),
                 gqa_decode_pallas(q, k, v, jnp.asarray(valid),
                                   interpret=True)):
        for a, w in zip(got, _invariants(*want)):
            np.testing.assert_allclose(a, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S", [700, 1])
def test_gqa_decode_any_length(S):
    """Cache lengths the TPU kernel refuses (S % 512 != 0): the port takes
    them, and so does the reference's shape-free oracle."""
    q, k, v = _qkv(2, 3, 3, 64, S, jnp.float32, 3)
    valid = np.arange(S) <= S - 2 if S > 1 else np.ones(1, bool)
    got = _invariants(*ops.gqa_decode(_t(q), _t(k), _t(v),
                                      torch.from_numpy(valid)))
    want = _invariants(*jref.gqa_decode_ref(q, k, v, jnp.asarray(valid)))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, w, atol=1e-5, rtol=1e-5)


def test_gqa_decode_fully_masked_row_is_zero():
    q, k, v = _qkv(1, 2, 3, 64, 600, jnp.float32, 5)
    valid = np.zeros(600, bool)
    m, l, acc = ops.gqa_decode(_t(q), _t(k), _t(v), torch.from_numpy(valid))
    jm, jl, jacc = jref.gqa_decode_ref(q, k, v, jnp.asarray(valid))
    assert torch.all(l == 0) and torch.all(acc == 0)
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    out = L.combine_decode_partials(m, l, acc)
    assert torch.all(out == 0)


def test_gqa_decode_validates():
    q, k, v = (_t(x) for x in _qkv(1, 2, 2, 64, 64, jnp.float32, 1))
    with pytest.raises(ValueError):
        ops.gqa_decode(q, k, v, torch.ones(63, dtype=torch.bool))
    with pytest.raises(ValueError):
        ops.gqa_decode(q, k[:, :, :1], v[:, :, :1],
                       torch.ones(64, dtype=torch.bool))
    with pytest.raises(TypeError):
        ops.gqa_decode(q, k.double(), v.double(),
                       torch.ones(64, dtype=torch.bool))


def test_gqa_decode_mask_with_holes_matches_jax():
    """An arbitrary mask: about 30% of the positions valid at random, and
    whole 128-position blocks masked between valid ones."""
    S = 2048
    q, k, v = _qkv(2, 3, 3, 64, S, jnp.float32, 11)
    pos = np.arange(S)
    valid = ((np.random.default_rng(11).random(S) < 0.3)
             & ((pos // 128) % 3 != 1))
    for cap in (None, 30.0):
        got = _invariants(*ops.gqa_decode(_t(q), _t(k), _t(v),
                                          torch.from_numpy(valid),
                                          softcap=cap))
        for want in (jref.gqa_decode_ref(q, k, v, jnp.asarray(valid),
                                         softcap=cap),
                     gqa_decode_pallas(q, k, v, jnp.asarray(valid),
                                       softcap=cap, interpret=True)):
            w_out, w_lse = _invariants(*want)
            np.testing.assert_allclose(got[0], w_out, atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(got[1], w_lse, atol=5e-5)


@pytest.mark.parametrize("rows,seq,tile,want", [
    (96, 2048, 32, (704, 3)),        # smollm serve: b 32 x kvh 3, f32
    (384, 32768, 32, (16384, 2)),    # decode_32k: b 128 x kvh 3, f32
    (256, 2048, 16, (688, 3)),       # qwen3-0.6b serve: kvh 8, hd 128
    (3, 100, 32, (128, 1)),
    (2, 0, 32, (32, 1)),
    (1, 100_000, 16, (12512, 8)),    # ranges capped at one cluster
    (8, 524_288, 8, (32768, 16)),    # long_500k at hd 256, f32: 16 ranges
])
def test_decode_splits_cover_the_cache(rows, seq, tile, want):
    range_len, n = G.decode_splits(rows, seq, 132, tile)
    assert (range_len, n) == want
    assert range_len % tile == 0 and range_len * n >= seq
    assert seq == 0 or range_len * (n - 1) < seq
    assert range_len <= G.MAX_RANGE and n <= G.MAX_RANGES


@pytest.mark.parametrize("hd,dtype,rows,seq", [
    (64, torch.float32, 96, 2048),       # serve
    (64, torch.float32, 384, 32768),     # decode_32k
    (64, torch.float32, 9, 700),         # ragged
    (128, torch.float32, 3, 37),         # below one tile
    (64, torch.bfloat16, 6, 513),        # one past a tile boundary
    (128, torch.bfloat16, 1, 262_144),   # the longest cache taken
])
def test_decode_partition_covers_each_position_once(hd, dtype, rows, seq):
    tile = G.decode_tile(hd, dtype)
    if dtype == torch.float32:
        assert tile * hd * 4 == 8192
        range_len, n = G.decode_splits(rows, seq, 132, tile)
    else:
        assert tile == G.MMA_CHUNK == 16
        range_len, n = G.decode_splits(rows, seq, 132, tile, kv_bytes=4 * hd)
    _assert_covers_once(seq, range_len, n, tile)


def _assert_covers_once(seq, range_len, n, tile):
    count = np.zeros(seq, np.int64)
    for r in range(n):               # the positions CTA r of a row walks
        lo = r * range_len
        hi = min(seq, lo + range_len)
        assert lo < hi or seq == 0   # no range is empty
        for t in range(lo, hi, tile):
            count[t:min(hi, t + tile)] += 1
    assert np.all(count == 1)
    assert n <= G.MAX_RANGES and range_len <= G.MAX_RANGE


#: (b, S, kvh, g, hd) of the bfloat16 decodes, and the split pinned for
#: each on 132 SMs: rows x ranges near 3/4 of the SMs, one CTA each
#: (99 CTAs), at most 8 ranges unless the cache needs more
BF16_SPLITS = {
    "serve": ((32, 2048, 3, 3, 64), (2048, 1)),
    "chameleon-34b": ((4, 2048, 8, 8, 128), (688, 3)),
    "yi-9b": ((8, 2048, 4, 8, 128), (688, 3)),
    "jamba-v0.1-52b": ((4, 2112, 8, 4, 128), (704, 3)),
    "whisper-small cross": ((32, 1504, 12, 1, 64), (1504, 1)),
    "decode_32k": ((128, 32768, 3, 3, 64), (32768, 1)),
    "long_500k": ((1, 524_288, 8, 2, 256), (32768, 16)),
}


@pytest.mark.parametrize("shape", list(BF16_SPLITS))
def test_decode_splits_bf16_grids(shape):
    """The bfloat16 kernel's grid on a 132-SM card, sized by bytes: one
    CTA per SM on at most 3/4 of them (or one range per row where the rows
    alone exceed that), clusters of at most 8 unless MAX_RANGE forces more
    (long_500k: 16), each position in one range, ranges within MAX_RANGES x
    MAX_RANGE."""
    (b, seq, kvh, g, hd), want = BF16_SPLITS[shape]
    rows, n_sms = b * kvh, 132
    tile = G.decode_tile(hd, torch.bfloat16)
    got = G.decode_splits(rows, seq, n_sms, tile, kv_bytes=4 * hd)
    assert got == want
    range_len, n = got
    forced = -(-seq // G.MAX_RANGE)
    assert n == forced or rows * n <= max(rows, G.FILL * n_sms)
    assert n <= max(G.PORTABLE_RANGES, forced)
    assert range_len * rows * 4 * hd >= min(G.MIN_RANGE_BYTES,
                                            seq * rows * 4 * hd)
    assert n <= G.MAX_RANGES and range_len <= G.MAX_RANGE
    assert range_len % tile == 0
    _assert_covers_once(seq, range_len, n, tile)


def test_decode_splits_bf16_keeps_clusters_resident():
    """Where the card holds fewer clusters of n ranges than there are rows,
    the bfloat16 split takes fewer ranges, down to what MAX_RANGE needs;
    and it cuts no range below MIN_RANGE_BYTES."""
    rows, seq, hd = 8, 32896, 256            # gemma2-9b long-serve
    assert G.decode_splits(rows, seq, 132, 16, kv_bytes=4 * hd) == (4112, 8)
    held = {8: 7, 7: 7, 6: 9}                # clusters resident, by size
    assert G.decode_splits(rows, seq, 132, 16, kv_bytes=4 * hd,
                           clusters=lambda n: held.get(n, 99)) == (5488, 6)
    assert G.decode_splits(1, 524_288, 132, 16, kv_bytes=4 * hd,
                           clusters=lambda n: 0) == (32768, 16)
    # 256 positions of 512 B: two ranges of 64 KB, not eight of 16 KB
    assert G.decode_splits(4, 256, 132, 16, kv_bytes=512) == (128, 2)


def test_decode_splits_refuses_too_long_a_cache():
    with pytest.raises(ValueError):
        G.decode_splits(1, G.MAX_RANGES * G.MAX_RANGE + 1, 132, 32)
    with pytest.raises(ValueError):
        G.decode_splits(96, 2048, 132, 32, ranges=G.MAX_RANGES + 1)
    assert G.decode_splits(96, 2048, 132, 32, ranges=8) == (256, 8)


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jget_config("smollm-135m"))
    jdefs = JT.build_defs(jcfg, CTX)
    jparams = JT.init_params(jdefs, jax.random.PRNGKey(0), CTX)
    defs = TF.build_defs(reduced(get_config("smollm-135m")))
    params = params_from_jax(jax.device_get(jparams), defs.storage,
                             device="cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, P),
                                               dtype=np.int32)
    return jcfg, jdefs, jparams, defs, params, tokens


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_prefill_matches_jax(model):
    jcfg, jdefs, jparams, defs, params, tokens = model
    jl, jc, _ = JT.model_apply(jparams, jdefs, {"tokens": jnp.asarray(tokens)},
                               CTX, mode="prefill")
    tl, tc = TF.model_apply(params, defs,
                            {"tokens": torch.from_numpy(tokens)},
                            mode="prefill")
    _close(tl.numpy(), jl)
    assert tc["len"] == int(jc["len"]) == P
    for key in ("k", "v"):
        want = jc["layers"][0]["attn"][key]
        got = tc["layers"][0]["attn"][key]
        assert tuple(got.shape) == tuple(want.shape)
        _close(got.numpy(), want)
    train, none = TF.model_apply(params, defs,
                                 {"tokens": torch.from_numpy(tokens)})
    assert none is None
    _close(tl.numpy(), train.numpy())


def test_init_cache_matches_jax(model):
    jcfg, _, _, defs, _, _ = model
    want = JT.init_cache(jcfg, CTX, b_local=B, capacity=40,
                         cache_seq_axes=())
    got = TF.init_cache(defs.cfg, B, 40)
    assert got["len"] == int(want["len"]) == 0
    for key in ("k", "v"):
        w = want["layers"][0]["attn"][key]
        g = got["layers"][0]["attn"][key]
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32
        assert not g.any()


def test_decode_matches_jax_token_by_token(model):
    """Teacher-forced decode of 16 tokens from an empty cache."""
    jcfg, jdefs, jparams, defs, params, tokens = model
    train, _ = TF.model_apply(params, defs,
                              {"tokens": torch.from_numpy(tokens)})
    jcache = JT.init_cache(jcfg, CTX, b_local=B, capacity=P + 4,
                           cache_seq_axes=())
    jdecode = jax.jit(lambda p, tok, c: JT.model_apply(
        p, jdefs, {"tokens": tok}, CTX, mode="decode", cache=c,
        remat=False)[:2])
    cache = TF.init_cache(defs.cfg, B, P + 4)
    for t in range(P):
        jl, jcache = jdecode(jparams, jnp.asarray(tokens[:, t:t + 1]), jcache)
        tl, cache = TF.model_apply(
            params, defs, {"tokens": torch.from_numpy(tokens[:, t:t + 1])},
            mode="decode", cache=cache)
        assert tl.shape == (B, 1, jcfg.vocab_size)
        _close(tl[:, 0].numpy(), jl[:, 0])
        _close(tl[:, 0].numpy(), train[:, t].numpy())
        assert cache["len"] == int(jcache["len"]) == t + 1
    for key in ("k", "v"):
        _close(cache["layers"][0]["attn"][key].numpy(),
               jcache["layers"][0]["attn"][key])


def test_greedy_tokens_match_jax(model):
    """Prefill plus 6 greedy decode steps: the same 7 tokens per
    sequence."""
    jcfg, jdefs, jparams, defs, params, tokens = model
    steps, cap = 6, P + 6
    jl, jc, _ = JT.model_apply(jparams, jdefs, {"tokens": jnp.asarray(tokens)},
                               CTX, mode="prefill")
    jtok = jnp.argmax(jl[:, -1:, :], axis=-1).astype(jnp.int32)
    jc = jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, cap - P), (0, 0), (0, 0)])
        if a.ndim == 5 else a, jc)
    want = [np.asarray(jtok)]
    jstep = jax.jit(lambda p, tok, c: JT.greedy_decode_step(p, jdefs, tok, c,
                                                            CTX))
    for _ in range(steps):
        jtok, jc = jstep(jparams, jtok, jc)
        want.append(np.asarray(jtok))

    pre = serve.build_prefill_setup(defs.cfg, device="cpu")
    srv = serve.build_serve_setup(defs.cfg, device="cpu")
    first, cache = pre.prefill_step(
        params, {"tokens": torch.from_numpy(tokens)}, cap)
    assert cache["layers"][0]["attn"]["k"].shape[2] == cap
    state = {"params": params, "cache": cache, "tokens": first}
    got = [first.numpy()]
    for _ in range(steps):
        state = srv.serve_step(state)
        got.append(state["tokens"].numpy())
    assert state["cache"]["len"] == P + steps
    assert got[0].dtype == np.int32 and got[0].shape == (B, 1)
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))


def test_prefill_longer_than_capacity_raises(model):
    _, _, _, defs, params, tokens = model
    pre = serve.build_prefill_setup(defs.cfg, device="cpu")
    with pytest.raises(ValueError, match="exceeds the cache"):
        pre.prefill_step(params, {"tokens": torch.from_numpy(tokens)}, P - 1)


def test_greedy_sample_ties_go_to_lowest_id():
    logits = torch.zeros((2, 1, 10))
    logits[0, 0, [3, 7]] = 1.0
    logits[1, 0, [9, 2]] = 5.0
    assert L.sharded_greedy_sample(logits).tolist() == [[3], [2]]


def test_serve_cli_on_cpu():
    r = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "8", "--new-tokens", "5",
                    "--keep-logits", "1"])
    assert r["tokens"].shape == (2, 5) and r["prompts"].shape == (2, 8)
    assert r["cache_len"] == 12 and r["logits"].shape == (1, 4, 1024)
    assert ((r["tokens"] >= 0) & (r["tokens"] < 1024)).all()
    # each kept step's logits predict the token it emitted
    np.testing.assert_array_equal(r["logits"][0].argmax(-1),
                                  r["tokens"][0, 1:])


def test_serve_main_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced", "--batch", "1", "--prompt-len", "4",
                    "--new-tokens", "2"])
