"""The port's per-leaf transport and ``compressed_dgd`` held to the JAX
package.

Kernels, in this process, on numpy inputs:
  * ``quantize_blocks`` (the plain version on CPU tensors): codes and
    scales byte-equal to JAX ``quantize_blocks_ref`` and to the
    interpret-mode ``quantize_blocks_pallas``, fixed and adaptive, float32
    and bf16, several row counts;
  * ``dequant_combine``: bitwise equal to JAX ``dequant_combine_ref``, and
    within 2 ulps of the operands of the interpret-mode
    ``dequant_combine_pallas``, where XLA fuses the decode products into
    the sums (hazard 5 of the reference).

Exchanges, in one subprocess with 4 host devices: the reference's
``ConsensusRuntime(wire_packing="per_leaf")`` and
``ConsensusRuntime(algorithm="compressed_dgd")`` (packed and per-leaf)
under ``shard_map``, one node per device, against the port's stacked-node
runtime, 3 steps on a 4-node ring over the reduced smollm-135m tree, fixed
and adaptive mode, shared noise.  Every step, started from the
reference's state: the codes and scales each node sends are exact,
``x_tilde``, ``m_agg`` and ``x_next`` agree within ``STATE_ULPS`` ulps of
each buffer's largest magnitude (the reference's FMA contraction, hazard
4), ``overflow_frac``, ``wire_bytes_per_step`` and
``collectives_per_step`` are equal.

In the port alone: per-leaf equals packed bit for bit over 5 exchanges
for both algorithms, and the configurations the reference refuses are
refused.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.dequant_combine import dequant_combine_pallas
from repro.kernels.quantize import quantize_blocks_pallas
from repro_torch.configs import get_config, reduced
from repro_torch.core import tree as T
from repro_torch.core import wire
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.kernels import dequant_combine as D
from repro_torch.kernels import ops, quantize as Q
from repro_torch.launch import train
from repro_torch.models import transformer as TF
from repro_torch.models.params import init_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 512
STEPS = 3
STATE_ULPS = 2
#: largest share of elements a code moved by XLA's reciprocal product may
#: reach (compressed_dgd: the reference's constant grid step)
MAX_FLIP_FRAC = 1e-4
MODES = {"adaptive": None, "fixed": 0.05}


def _y(rows, seed, dtype):
    """(jax y, torch y, noise) with y rounded to ``dtype`` once, by JAX,
    and handed to the port bit for bit."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((rows, BLOCK)) * 2.0).astype(np.float32)
    y[::7, ::5] *= 40.0                  # the fixed grid clips at +-127
    noise = rng.random((rows, BLOCK), dtype=np.float32)
    y_j = jnp.asarray(y).astype(dtype)
    if dtype == jnp.bfloat16:
        bits = np.asarray(jax.lax.bitcast_convert_type(y_j, jnp.uint16))
        y_t = torch.from_numpy(bits.view(np.int16).copy()).view(
            torch.bfloat16)
    else:
        y_t = torch.from_numpy(np.asarray(y_j).copy())
    return y_j, y_t, noise


@pytest.mark.parametrize("rows", [32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["adaptive", "fixed"])
def test_quantize_blocks_matches_jax(rows, dtype, mode):
    y_j, y_t, noise = _y(rows, rows + len(dtype) + len(mode),
                         jnp.dtype(dtype))
    step = MODES[mode]
    step_j = None if step is None else jnp.float32(step)
    before = Q.quantize_blocks.launches
    codes, scales = ops.quantize_blocks(y_t, torch.from_numpy(noise), step)
    assert Q.quantize_blocks.launches == before      # CPU: the plain path
    assert codes.dtype == torch.int8 and codes.shape == (rows, BLOCK)
    assert scales.dtype == torch.float32 and scales.shape == (rows, 1)
    for want_c, want_s in (
            jref.quantize_blocks_ref(y_j, jnp.asarray(noise),
                                     fixed_step=step_j),
            quantize_blocks_pallas(y_j, jnp.asarray(noise),
                                   fixed_step=step_j, interpret=True)):
        np.testing.assert_array_equal(codes.numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(scales.numpy().view(np.uint32),
                                      np.asarray(want_s).view(np.uint32))
    if mode == "fixed":
        assert (codes.abs() == 127).any()


def _blocks(rows, seed):
    rng = np.random.default_rng(seed)
    sides = []
    for i in range(3):
        y = rng.standard_normal((rows, BLOCK)).astype(np.float32) * (i + 1)
        noise = rng.random((rows, BLOCK), dtype=np.float32)
        c, s = jref.quantize_blocks_ref(jnp.asarray(y), jnp.asarray(noise))
        sides += [np.array(c), np.array(s)]
    xt = rng.standard_normal((rows, BLOCK)).astype(np.float32)
    m = rng.standard_normal((rows, BLOCK)).astype(np.float32)
    return sides, xt, m


@pytest.mark.parametrize("deamp", [1.0, 0.37])
def test_dequant_combine_matches_jax(deamp):
    """Bitwise equal to the jnp oracle; within 2 ulps of the operands'
    magnitude of the interpret-mode Pallas kernel (one per fused sum on the
    path to each output)."""
    sides, xt, m = _blocks(96, 7)
    args_j = [jnp.asarray(a) for a in (*sides, xt, m)]
    args_t = [torch.from_numpy(a) for a in (*sides, xt, m)]
    before = D.dequant_combine.launches
    got = ops.dequant_combine(*args_t, 0.5, 0.25, deamp)
    assert D.dequant_combine.launches == before
    want = jref.dequant_combine_ref(*args_j, 0.5, 0.25, jnp.float32(deamp))
    pallas = dequant_combine_pallas(*args_j, 0.5, 0.25, jnp.float32(deamp),
                                    interpret=True)
    d = [np.abs(sides[2 * i].astype(np.float32) * sides[2 * i + 1])
         for i in range(3)]
    mx = np.abs(xt) + deamp * d[0]
    mm = np.abs(m) + 0.25 * deamp * (d[1] + d[2])
    spacing = [np.spacing(a.astype(np.float32))
               for a in (mx, mm, 0.5 * mx + mm)]
    for g, w, p, sp in zip(got, want, pallas, spacing):
        assert g.dtype == torch.float32 and g.shape == (96, BLOCK)
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w).view(np.uint32))
        assert np.all(np.abs(g.numpy() - np.asarray(p)) <= 2 * sp)


def test_dequant_combine_validates():
    sides, xt, m = _blocks(32, 1)
    args = [torch.from_numpy(a) for a in (*sides, xt, m)]
    bad = list(args)
    bad[1] = bad[1].reshape(-1)                       # scales not (n, 1)
    with pytest.raises(ValueError):
        ops.dequant_combine(*bad, 0.5, 0.25, 1.0)
    bad = list(args)
    bad[0] = bad[0].to(torch.int16)
    with pytest.raises(TypeError):
        ops.dequant_combine(*bad, 0.5, 0.25, 1.0)


def test_from_leaf_rows_matches_jax_and_roundtrips():
    from repro.core import wire as jwire
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 700)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "c": rng.standard_normal((1030,)).astype(np.float32)}
    tl = wire.WireLayout.for_tree(T.tree_map(torch.from_numpy, tree))
    jl = jwire.WireLayout.for_tree(jax.tree.map(jnp.asarray, tree))
    packed = tl.pack(T.tree_map(torch.from_numpy, tree))
    rows = [tl.leaf_rows(packed, i) for i in range(tl.n_leaves)]
    back = tl.from_leaf_rows(rows)
    assert torch.equal(back, packed) and back.shape == (tl.n_rows, BLOCK)
    want = jl.from_leaf_rows([jnp.asarray(r.numpy()) for r in rows])
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    stacked = torch.stack([packed, 2 * packed])       # leading node axis
    back2 = tl.from_leaf_rows([tl.leaf_rows(stacked, i)
                               for i in range(tl.n_leaves)])
    assert torch.equal(back2, stacked)
    with pytest.raises(ValueError):
        tl.from_leaf_rows(rows[:-1])


BODY = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax, jax.numpy as jnp, numpy as np, torch
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import wire as jwire
from repro.core.distributed import ConsensusConfig as JCfg
from repro.core.distributed import ConsensusRuntime as JRt
from repro.kernels import ops as jops
from repro.models import transformer as JT
from repro.models.sharding import ParallelContext, local_context
from repro.models.sharding import shard_map_compat
from repro_torch.core import tree as T
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)
N, STEPS = 4, __STEPS__
mesh = Mesh(np.array(jax.devices()[:N]), ("data",))
ctx = ParallelContext(tp=1, data_size=N, n_nodes=N, in_shard_map=True)

defs = JT.build_defs(jreduced(jget_config("smollm-135m")), local_context())
tmpl = JT.init_params(defs, jax.random.PRNGKey(0))   # structure only
rng = np.random.default_rng(0)
x0 = jax.tree.map(lambda a: np.broadcast_to(
    (rng.standard_normal(a.shape) * 0.05).astype(np.float32),
    (N,) + a.shape).copy(), tmpl)

def delta(k):
    r = np.random.default_rng([1, k])
    def one(a):
        d = (r.standard_normal((N,) + a.shape) * 2e-3).astype(np.float32)
        d.reshape(-1)[::997] *= 300.0      # a few clip the fixed grid
        return d
    return jax.tree.map(one, tmpl)

layout = jwire.WireLayout.for_tree(jax.tree.map(lambda a: a[0], x0))

def noise(k):
    return np.random.default_rng([2, k]).random(
        (N, layout.n_rows, 512), dtype=np.float32)

def inputs():
    x_prev = x0
    for k in range(1, STEPS + 1):
        x_half = jax.tree.map(np.add, x_prev, delta(k))
        yield k, x_prev, x_half, noise(k)
        x_prev = x_half

def ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / np.spacing(np.max(np.abs(b))))

tt = lambda tree: T.tree_map(torch.from_numpy, tree)
pspec = jax.tree.map(lambda a: P("data"), x0)
wspec = {"collectives_per_step": P(), "wire_bytes_per_step": P()}

def sent_codes(packed_nodes, nz, step):
    # the (codes, scales) every node quantizes: each leaf's rows of the
    # packed (N, n_rows, 512) numpy buffers, padded to its own height, all
    # in one call per side (rows are quantized independently)
    rows, u = [], []
    for slot in layout.slots:
        pad = ((0, 0), (0, jops.padded_block_rows(slot.size) - slot.n_rows),
               (0, 0))
        rows.append(np.pad(packed_nodes[:, slot.row_start:slot.row_end], pad))
        u.append(np.pad(nz[:, slot.row_start:slot.row_end], pad))
    rows = np.concatenate(rows, axis=1).reshape(-1, 512)
    u = np.concatenate(u, axis=1).reshape(-1, 512)
    cj, sj = jops.quantize_blocks(jnp.asarray(rows), jnp.asarray(u),
                                  fixed_step=step)
    ct, st = tops.quantize_blocks(torch.from_numpy(rows), torch.from_numpy(u),
                                  None if step is None else float(step))
    return (np.array_equal(np.asarray(cj), ct.numpy())
            and np.array_equal(np.asarray(sj).view(np.uint32),
                               st.numpy().view(np.uint32)))

out = {}
for mode in ("fixed", "adaptive"):
    # -- ADC-DGD on the per-leaf transport ------------------------------
    jrt = JRt(JCfg(quant_mode=mode, wire_packing="per_leaf"), ctx)
    cspec = {"x_tilde": P("data", None, None), "m_agg": P("data", None, None)}
    init_f = jax.jit(shard_map_compat(
        lambda p: jax.tree.map(lambda a: a[None], jrt.init_state(p)), mesh,
        in_specs=(pspec,), out_specs=cspec, check=False))
    mspec = {"overflow_frac": P("data"), "residual_norm": P("data")}
    def jstep(xp, xh, s, k, nz):
        s = jax.tree.map(lambda a: a[0], s)
        xn, s2, m = jrt.exchange(xp, xh, s, k, jax.random.PRNGKey(7),
                                 noise=nz[0])
        return (xn, jax.tree.map(lambda a: a[None], s2),
                {k2: m[k2][None] for k2 in mspec},
                {k2: m[k2] for k2 in wspec})
    step_f = jax.jit(shard_map_compat(
        jstep, mesh, in_specs=(pspec, pspec, cspec, P(), P("data")),
        out_specs=(pspec, cspec, mspec, wspec), check=False))
    js = init_f(x0)
    rt = ConsensusRuntime(ConsensusConfig(quant_mode=mode,
                                          wire_packing="per_leaf"), N)
    res = {"codes_equal": [], "xt_ulps": [], "m_ulps": [], "x_ulps": [],
           "overflow": [], "residual": []}
    for k, xp, xh, nz in inputs():
        synced = {key: torch.from_numpy(np.array(v))
                  for key, v in js.items()}
        step_k = jrt._step_k(jnp.asarray(k, jnp.int32))
        y = np.stack([np.asarray(layout.pack(jax.tree.map(
            lambda a: a[i], xh))) for i in range(N)]) - np.asarray(
            js["x_tilde"])
        res["codes_equal"].append(sent_codes(y, nz, step_k))
        jxn, js, jm, jw = step_f(xp, xh, js, jnp.asarray(k, jnp.int32), nz)
        txn, ts, tm = rt.exchange(tt(xp), tt(xh), synced, k,
                                  noise=torch.from_numpy(nz))
        res["xt_ulps"].append(ulps(ts["x_tilde"], js["x_tilde"]))
        res["m_ulps"].append(ulps(ts["m_agg"], js["m_agg"]))
        res["x_ulps"].append(max(ulps(a, b) for a, b in zip(
            T.tree_leaves(txn), jax.tree_util.tree_leaves(jxn))))
        res["overflow"].append([tm["overflow_frac"].tolist(),
                                np.asarray(jm["overflow_frac"]).tolist()])
        res["residual"].append([tm["residual_norm"].tolist(),
                                np.asarray(jm["residual_norm"]).tolist()])
    res["wire"] = [tm["wire_bytes_per_step"],
                   float(jw["wire_bytes_per_step"])]
    res["collectives"] = [tm["collectives_per_step"],
                          float(jw["collectives_per_step"])]
    out["adc_dgd/per_leaf/" + mode] = res

    # -- compressed_dgd, packed and per-leaf ----------------------------
    for packing in ("packed", "per_leaf"):
        jrt = JRt(JCfg(algorithm="compressed_dgd", quant_mode=mode,
                       wire_packing=packing), ctx)
        def cstep(xp, xh, k, nz):
            xn, _, m = jrt.exchange(xp, xh, {}, k, jax.random.PRNGKey(7),
                                    noise=nz[0])
            return xn, {k2: m[k2] for k2 in wspec}
        cf = jax.jit(shard_map_compat(
            cstep, mesh, in_specs=(pspec, pspec, P(), P("data")),
            out_specs=(pspec, wspec), check=False))
        rt = ConsensusRuntime(ConsensusConfig(
            algorithm="compressed_dgd", quant_mode=mode,
            wire_packing=packing), N)
        res = {"codes_equal": [], "x_ulps": []}
        step0 = np.float32(jrt.cfg.fixed_step0)
        for k, xp, xh, nz in inputs():
            xpp = np.stack([np.asarray(layout.pack(jax.tree.map(
                lambda a: a[i], xp))) for i in range(N)])
            if packing == "packed":
                tx = rt.state_layout(tt(xp)).pack(tt(xp))
                res["codes_equal"].append(all(np.array_equal(
                    np.asarray(jops.quantize_payload(
                        jnp.asarray(xpp[i]), jnp.asarray(nz[i]),
                        fixed_step=step0)),
                    tops.quantize_payload(tx[i], torch.from_numpy(nz[i]),
                                          float(step0)).numpy())
                    for i in range(N)))
            else:
                res["codes_equal"].append(sent_codes(xpp, nz, step0))
            jxn, jw = cf(xp, xh, jnp.asarray(k, jnp.int32), nz)
            txn, _, tm = rt.exchange(tt(xp), tt(xh), {}, k,
                                     noise=torch.from_numpy(nz))
            # the reference's step is a compile-time constant here, and XLA
            # rewrites y / step as y * f32(1 / step): where that product
            # rounds a code the other way, a neighbour's value moves by one
            # grid step.  Those elements are predicted from the inputs.
            recip = np.float32(1.0) / step0
            q = xpp * recip
            lo = np.floor(q)
            flips = np.clip(lo + (nz < q - lo), -127, 127) != np.clip(
                np.floor(xpp / step0) + (nz < xpp / step0
                                         - np.floor(xpp / step0)), -127, 127)
            n_flips = (np.roll(flips, 1, axis=0).astype(np.float32)
                       + np.roll(flips, -1, axis=0))
            pk = lambda tree: np.stack([np.asarray(layout.pack(jax.tree.map(
                lambda a: np.asarray(a)[i], tree))) for i in range(N)])
            a_all = pk(T.tree_map(lambda t: t.numpy(), txn))
            b_all = pk(jxn)
            kept, excess = 0.0, 0.0
            for slot in layout.slots:
                cut = lambda z: z[:, slot.row_start:slot.row_end].reshape(
                    N, -1)[:, :slot.size]
                a, b, nf = cut(a_all), cut(b_all), cut(n_flips)
                sp = np.spacing(np.max(np.abs(b)))
                d = np.abs(a - b)
                kept = max(kept, float(np.max(np.where(nf == 0, d, 0)) / sp))
                excess = max(excess, float(np.max(np.abs(
                    d - nf * np.float32(0.25) * step0)[nf > 0], initial=0)
                    / sp))
            res["x_ulps"].append(kept)
            res.setdefault("flip_excess_ulps", []).append(excess)
            res.setdefault("flip_frac", []).append(float(
                (n_flips > 0).mean()))
        res["wire"] = [tm["wire_bytes_per_step"],
                       float(jw["wire_bytes_per_step"])]
        res["collectives"] = [tm["collectives_per_step"],
                              float(jw["collectives_per_step"])]
        out[f"compressed_dgd/{packing}/{mode}"] = res
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def result():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", BODY.replace("__STEPS__", str(STEPS))],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    if proc.returncode != 0:
        raise AssertionError(f"subprocess failed:\n{proc.stderr[-4000:]}")
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise AssertionError(f"no RESULT line:\n{proc.stdout[-2000:]}")


CASES = [f"{alg}/{mode}" for alg in ("adc_dgd/per_leaf",
                                     "compressed_dgd/packed",
                                     "compressed_dgd/per_leaf")
         for mode in ("fixed", "adaptive")]


@pytest.mark.parametrize("case", CASES)
def test_sent_codes_and_scales_exact_every_step(result, case):
    assert result[case]["codes_equal"] == [True] * STEPS


@pytest.mark.parametrize("case", CASES)
def test_state_within_ulps_every_step(result, case):
    """For ``compressed_dgd`` the bound holds on every element whose
    neighbours' codes XLA's reciprocal product leaves alone; on the others
    the step differs by exactly those codes' grid steps (times the side
    weight), to within the same bound, and they are a tiny share."""
    r = result[case]
    for key in ("xt_ulps", "m_ulps", "x_ulps", "flip_excess_ulps"):
        if key in r:
            assert max(r[key]) <= STATE_ULPS, (key, r[key])
    if "flip_frac" in r:
        assert max(r["flip_frac"]) <= MAX_FLIP_FRAC, r["flip_frac"]


@pytest.mark.parametrize("case", CASES)
def test_wire_accounting_matches(result, case):
    r = result[case]
    assert r["wire"][0] == r["wire"][1] > 0
    assert r["collectives"][0] == r["collectives"][1]
    want = 2.0 if "/packed/" in case else 4.0 * 11     # 11 leaves
    assert r["collectives"][0] == want


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_per_leaf_overflow_and_residual_match(result, mode):
    r = result["adc_dgd/per_leaf/" + mode]
    for got, want in r["overflow"]:
        assert got == want
    if mode == "fixed":
        assert any(x > 0 for got, _ in r["overflow"] for x in got)
    for got, want in r["residual"]:
        assert got == pytest.approx(want, rel=1e-5)


@pytest.fixture
def one_thread():
    """One intra-op thread while the test runs: the many small tensor ops
    of a per-leaf exchange only contend when the CPU is shared with other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _exchanges(algorithm, packing, mode, steps=5):
    """``steps`` exchanges of a 4-node ring over the reduced smollm-135m
    tree: each step adds the same seeded optimizer delta (a few entries
    large enough to clip the fixed grid) and draws its noise from (seed,
    step, node)."""
    defs = TF.build_defs(reduced(get_config("smollm-135m")))
    x = init_params(defs.storage, 0, "cpu", n_nodes=4)
    rt = ConsensusRuntime(ConsensusConfig(algorithm=algorithm,
                                          quant_mode=mode,
                                          wire_packing=packing), 4)
    state = rt.init_state(x)
    metrics = []
    for k in range(1, steps + 1):
        g = torch.Generator().manual_seed(k)

        def step(a):
            d = torch.randn(a.shape, generator=g) * 2e-3
            d.view(-1)[::997] *= 300.0
            return a + d

        x, state, m = rt.exchange(x, T.tree_map(step, x), state, k, seed=0)
        metrics.append(m)
    return x, state, metrics


@pytest.mark.parametrize("algorithm,mode", [("adc_dgd", "fixed"),
                                            ("adc_dgd", "adaptive"),
                                            ("compressed_dgd", "fixed")])
def test_per_leaf_equals_packed_bit_for_bit(one_thread, algorithm, mode):
    """Drawn from the same (seed, step, node) noise, the two transports of
    the port give the same parameters, shadows and overflow over 5
    steps."""
    (xp, sp, mp), (xl, sl, ml) = (_exchanges(algorithm, p, mode)
                                  for p in ("packed", "per_leaf"))
    for a, b in zip(T.tree_leaves(xp), T.tree_leaves(xl)):
        assert torch.equal(a, b)
    assert sp.keys() == sl.keys()
    for key in sp:
        assert torch.equal(sp[key], sl[key])
    for a, b in zip(mp, ml):
        if "overflow_frac" in a:
            assert torch.equal(a["overflow_frac"], b["overflow_frac"])
        assert a["wire_bytes_per_step"] < b["wire_bytes_per_step"]
    if algorithm == "adc_dgd" and mode == "fixed":
        assert any(float(m["overflow_frac"].max()) > 0 for m in mp)


def test_config_validation():
    with pytest.raises(ValueError):
        ConsensusConfig(wire_packing="per_leaf", wire_codec="int4")
    with pytest.raises(ValueError):
        ConsensusConfig(algorithm="compressed_dgd", wire_codec="topk")
    with pytest.raises(ValueError):
        ConsensusConfig(wire_packing="ragged")
    for packing in ("pipelined", "async"):
        assert ConsensusConfig(wire_packing=packing).wire_packing == packing
    with pytest.raises(ValueError, match="per-leaf"):
        ConsensusConfig(wire_packing="per_leaf",
                        wire_codec="mixed:norm=int4,*=int8")
    assert ConsensusRuntime(ConsensusConfig(algorithm="compressed_dgd"),
                            4).init_state({"w": torch.zeros(4, 3)}) == {}


def test_trainer_cli_flags(one_thread):
    hist = train.main(["--reduced", "--device", "cpu", "--nodes", "4",
                       "--batch", "4", "--seq", "16", "--steps", "1",
                       "--algorithm", "compressed_dgd", "--wire-packing",
                       "per_leaf"])
    assert hist[0]["collectives_per_step"] == 44.0
    assert "codec" not in hist[0] and np.isfinite(hist[0]["loss"])
    with pytest.raises(SystemExit):
        train.main(["--wire-packing", "ragged"])
