"""The port's cost model and the three examples, held to the JAX package.

* ``launch.analysis``: ``roofline`` and ``model_flops_per_step`` equal the
  reference's on a grid of inputs, with the reference's ``HW`` passed in
  (the port's default is the H100's, the reference's a TPU v5e's); ``HW``
  carries no TPU figure;
* ``configs``: ``input_specs``, ``all_configs`` and ``shape_applicable``
  against the reference for every architecture and input shape (shapes,
  dtypes, skip reasons);
* ``launch.op_cost``: the matrix-product FLOPs the counter finds in a
  train-mode forward of each of the ten reduced architectures on ``meta``
  equal ``repro.launch.hlo_cost.parse_hlo_cost(...).flops`` of the
  reference's jitted forward of the same inputs, exactly (FLOPs are
  integers here; no product is dropped or folded by XLA in these
  forwards: measured equal for all ten); each kernel's reported bytes at
  ``PERF.md`` section 6's shapes equal that table's bound column (GB to
  the 4 decimals the table gives);
* the examples ``examples/torch_quickstart.py``,
  ``torch_serve_batched.py`` and ``torch_decentralized_train.py`` run end
  to end with ``--device cpu`` at a cut size; the quickstart's runs, fed
  the reference's uniforms, match the reference's ``consensus.run`` at the
  same settings within ``RUN_RTOL`` (``tests/test_torch_paper.py``'s).
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as jall_configs
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.configs import reduced as jreduced
from repro.configs import shape_applicable as jshape_applicable
from repro.core import compression as JC
from repro.core import consensus as JK
from repro.core import problems as JP
from repro.core import topology as JT
from repro.launch import analysis as janalysis
from repro.launch.hlo_cost import parse_hlo_cost
from repro.models import transformer as JTF
from repro.models.config import INPUT_SHAPES as JINPUT_SHAPES
from repro.models.sharding import local_context
from repro_torch.configs import (ARCH_IDS, all_configs, get_config,
                                 input_specs, reduced, shape_applicable)
from repro_torch.kernels import bitpack as BP
from repro_torch.kernels import dequant_combine as D
from repro_torch.kernels import gqa_decode as G
from repro_torch.kernels import quantize as Q
from repro_torch.launch import analysis
from repro_torch.launch.op_cost import CostCounter
from repro_torch.models import transformer as TF
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.models.params import meta_params

from test_torch_paper import RUN_RTOL, _reference_uniforms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CTX = local_context()


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- analysis -----------------------------------------------------------------

@pytest.mark.parametrize("flops", [0.0, 1e9, 3.7e15])
@pytest.mark.parametrize("hbm", [0.0, 5e8, 2.2e12])
@pytest.mark.parametrize("coll", [0.0, 2.7e8, 4e10])
def test_roofline_matches_reference(flops, hbm, coll):
    hw = janalysis.HW()
    for chips in (1, 4, 512):
        want = janalysis.roofline(flops, hbm, coll, chips, hw)
        assert analysis.roofline(flops, hbm, coll, chips, hw) == want


def test_model_flops_per_step_matches_reference():
    for n in (1.35e8, 5.2e10):
        for tokens in (1, 128, 256 * 4096):
            for kind in ("train", "serve"):
                assert analysis.model_flops_per_step(n, tokens, kind) == \
                    janalysis.model_flops_per_step(n, tokens, kind)


def test_hw_is_the_h100():
    hw = analysis.HW()
    assert hw.peak_flops == {"float32": 67e12, "bfloat16": 989e12}
    assert (hw.hbm_bw, hw.hbm_bytes, hw.link_bw) == (3.35e12, 80e9, 450e9)
    tpu = janalysis.HW()
    for value in (tpu.peak_flops, tpu.hbm_bw, tpu.link_bw):
        assert value not in (*hw.peak_flops.values(), hw.hbm_bw, hw.link_bw)
    # the compute term takes the dtype's peak
    assert analysis.roofline(67e12, 0, 0, 1)["compute_s"] == 1.0
    assert analysis.roofline(989e12, 0, 0, 1,
                             dtype="bfloat16")["compute_s"] == 1.0


# -- configs ------------------------------------------------------------------

def test_all_configs_match_reference():
    port, ref = all_configs(), jall_configs()
    assert list(port) == list(ref) == list(ARCH_IDS)
    for arch in ARCH_IDS:
        assert dataclasses.asdict(port[arch]) == dataclasses.asdict(ref[arch])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_applicability_match_reference(arch):
    assert list(INPUT_SHAPES) == list(JINPUT_SHAPES)
    for name in INPUT_SHAPES:
        for cfg, jcfg in ((get_config(arch), jget_config(arch)),
                          (reduced(get_config(arch)),
                           jreduced(jget_config(arch)))):
            assert shape_applicable(cfg, INPUT_SHAPES[name]) == \
                jshape_applicable(jcfg, JINPUT_SHAPES[name])
            got = input_specs(cfg, INPUT_SHAPES[name])
            want = jinput_specs(jcfg, JINPUT_SHAPES[name])
            assert list(got) == list(want)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == want[k].shape
                assert str(t.dtype).removeprefix("torch.") == \
                    str(want[k].dtype)


# -- FLOPs against the reference's static cost model --------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counted_forward_flops_equal_reference_hlo_cost(arch):
    b, s = 2, 64
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jdefs = JTF.build_defs(jcfg, CTX)
    shapes = jax.eval_shape(lambda: JTF.init_params(
        jdefs, jax.random.PRNGKey(0), CTX))
    jbatch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32,
                                   device="meta")}
    if cfg.frontend == "audio_frames":
        frames = (b, cfg.encoder_frames, cfg.d_model)
        jbatch["enc_frames"] = jax.ShapeDtypeStruct(frames, jnp.float32)
        batch["enc_frames"] = torch.empty(frames, device="meta")
    hlo = jax.jit(lambda p, x: JTF.model_apply(
        p, jdefs, x, CTX, mode="train", remat=False)[0]).lower(
            shapes, jbatch).compile().as_text()
    want = parse_hlo_cost(hlo).flops
    defs = TF.build_defs(cfg)
    with torch.no_grad(), CostCounter() as counter:
        logits, _ = TF.model_apply(meta_params(defs.storage), defs, batch,
                                   mode="train", remat=False)
    assert logits.shape == (b, s, cfg.vocab_size)
    assert want > 0 and counter.cost.flops == want
    assert counter.cost.kernels == {}     # no kernel in a train forward


# -- the kernels' reported bytes ----------------------------------------------

#: PERF.md section 6's bound column (GB, 4 decimals) at its shapes: rows
#: 1-8 at 262,752 payload rows (3-4: 262,880), #9 at the serve shape (b 32,
#: S 2,048, kvh 3, g 3, hd 64) and decode_32k's (b 128, S 32,768)
N_ROWS, LEAF_ROWS = 262_752, 262_880
PERF_BOUND_GB = {
    "quantize_payload": 1.2118, "dequant_combine_payload": 3.0973,
    "quantize_blocks": 1.2124, "dequant_combine": 3.0988,
    "subbyte_encode_payload int4": 1.1440,
    "subbyte_encode_payload int2": 1.1104,
    "subbyte_decode_combine int4": 2.8940,
    "subbyte_decode_combine int2": 2.7931,
    "topk_encode_payload": 1.1777, "topk_decode_combine": 2.7931,
    "gqa_decode serve": 0.1008, "gqa_decode decode_32k": 6.4429}


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _kernel_calls():
    y, u = _meta(N_ROWS, Q.BLOCK), _meta(N_ROWS, 2 * Q.BLOCK)
    xt = _meta(N_ROWS, Q.BLOCK)
    yb, xb = _meta(LEAF_ROWS, Q.BLOCK), _meta(LEAF_ROWS, Q.BLOCK)
    codes = _meta(LEAF_ROWS, Q.BLOCK, dtype=torch.int8)
    scales = _meta(LEAF_ROWS, 1)

    def pays(width):
        return [_meta(N_ROWS, width, dtype=torch.uint8)] * 3

    def decode(b, s, kvh=3, g=3, hd=64):
        return lambda: G.gqa_decode(
            _meta(b, kvh, g, hd), _meta(b, s, kvh, hd), _meta(b, s, kvh, hd),
            _meta(s, dtype=torch.bool))

    return {
        "quantize_payload": lambda: Q.quantize_payload(y, u[:, :512], 1e-3),
        "dequant_combine_payload": lambda: D.dequant_combine_payload(
            *pays(516), xt, xt, 0.5, 0.25, 1.0),
        "quantize_blocks": lambda: Q.quantize_blocks(yb, yb, 1e-3),
        "dequant_combine": lambda: D.dequant_combine(
            codes, scales, codes, scales, codes, scales, xb, xb, 0.5, 0.25,
            1.0),
        "subbyte_encode_payload int4": lambda: BP.subbyte_encode_payload(
            y, u, 4, 1e-3),
        "subbyte_encode_payload int2": lambda: BP.subbyte_encode_payload(
            y, u, 2, 1e-3),
        "subbyte_decode_combine int4": lambda: BP.subbyte_decode_combine(
            *pays(258), xt, xt, 0.5, 0.25, 1.0, 4),
        "subbyte_decode_combine int2": lambda: BP.subbyte_decode_combine(
            *pays(130), xt, xt, 0.5, 0.25, 1.0, 2),
        "topk_encode_payload": lambda: BP.topk_encode_payload(
            y, u, 64, 1e-3),
        "topk_decode_combine": lambda: BP.topk_decode_combine(
            *pays(130), xt, xt, 0.5, 0.25, 1.0, 64),
        "gqa_decode serve": decode(32, 2048),
        "gqa_decode decode_32k": decode(128, 32768),
    }


@pytest.mark.parametrize("label", list(PERF_BOUND_GB))
def test_kernel_bytes_equal_perf_bound_column(label):
    call = _kernel_calls()[label]
    with CostCounter() as counter:
        out = call()
    name = label.split()[0]
    assert counter.cost.kernels == {name: 1}
    assert dict(counter.cost.launches) == {}     # the meta path is free
    got = counter.cost.kernel_bytes[name]
    if label == "gqa_decode decode_32k":
        # the table counts that row's 32,767 valid positions; the static
        # count reads every position's K and V row (2 x 128 x 3 x 64 x 4)
        got -= 2 * 128 * 3 * 64 * 4
    assert round(got / 1e9, 4) == PERF_BOUND_GB[label]
    for t in (out if isinstance(out, tuple) else (out,)):
        assert t.device.type == "meta"
    if name == "gqa_decode":
        b, s = (32, 2048) if "serve" in label else (128, 32768)
        assert counter.cost.kernel_flops[name] == 4 * b * 3 * 3 * s * 64
    else:
        assert counter.cost.kernel_flops[name] == 0


def test_kernel_meta_outputs_have_the_kernels_shapes():
    """The meta path returns what the CPU path returns, in shape and
    dtype, and counts the CPU path's ops as the kernel's alone."""
    g = torch.Generator().manual_seed(0)
    y = torch.randn((64, 512), generator=g)
    u = torch.rand((64, 1024), generator=g)
    xt = torch.randn((64, 512), generator=g)
    for enc, comb, arg in (
            (Q.quantize_payload, D.dequant_combine_payload, None),
            (BP.subbyte_encode_payload, BP.subbyte_decode_combine, 4),
            (BP.topk_encode_payload, BP.topk_decode_combine, 16)):
        outs = []
        for dev in ("cpu", "meta"):
            yy, uu, xx = (t.to(dev) for t in (y, u, xt))
            extra = () if arg is None else (arg,)
            with CostCounter() as counter:
                if enc is Q.quantize_payload:
                    p = enc(yy, uu[:, :512], 1e-3)
                else:
                    p = enc(yy, uu, *extra, 1e-3)
                o = comb(p, p, p, xx, xx, 0.5, 0.25, 1.0, *extra)
            assert dict(counter.cost.launches) == {}, dev
            outs.append((p, o, dict(counter.cost.kernel_bytes)))
        (pc, oc, bc), (pm, om, bm) = outs
        assert (pm.shape, pm.dtype) == (pc.shape, pc.dtype)
        assert [(t.shape, t.dtype) for t in om] == \
            [(t.shape, t.dtype) for t in oc]
        assert bm == bc
    q = torch.randn((2, 2, 3, 64), generator=g)
    k = torch.randn((2, 40, 2, 64), generator=g)
    valid = torch.ones(40, dtype=torch.bool)
    cpu = G.gqa_decode(q, k, k, valid)
    meta = G.gqa_decode(*(t.to("meta") for t in (q, k, k, valid)))
    assert [(t.shape, t.dtype) for t in meta] == \
        [(t.shape, t.dtype) for t in cpu]
    with pytest.raises(ValueError, match="one CUDA device"):
        Q.quantize_payload(y.to("meta"), u[:, :512])   # mixed devices


# -- the examples -------------------------------------------------------------

def test_quickstart_matches_reference_runs():
    mod = _example("torch_quickstart")
    steps, sched_steps = 150, 120
    jprob, jmix = JP.paper_4node(), JT.paper_fig3()
    jcomp = JC.RandomizedRounding(delta=1.0)
    jss = JK.StepSize(alpha0=0.02, eta=0.0)
    jsched = JT.ErdosRenyiSchedule(4, p=0.6, horizon=sched_steps, seed=3)
    jss_dim = JK.StepSize(alpha0=0.02, eta=0.5)
    ref = {"DGD (uncompressed, 8B/elem)": (JK.DGD(jmix, jss), 0, steps),
           "DGD + direct compression   ": (
               JK.CompressedDGD(jmix, jcomp, jss), 0, steps),
           "ADC-DGD (paper Alg. 2)     ": (
               JK.ADCDGD(jmix, jcomp, jss, gamma=1.0), 0, steps),
           "ADC-DGD, i.i.d. Erdos-Renyi topology": (
               JK.ADCDGD(jsched, jcomp, jss_dim, gamma=1.0), 1, sched_steps),
           "CHOCO-SGD (error feedback), same W(k)": (
               JK.CHOCOGossip(jsched, jcomp, jss_dim, consensus_lr=0.3), 1,
               sched_steps)}

    def uniforms(name, alg, prob, n):
        return _reference_uniforms(alg, prob, ref[name][1], n)

    out = mod.main(["--device", "cpu", "--steps", str(steps),
                    "--gamma-steps", "60", "--trials", "2",
                    "--schedule-steps", str(sched_steps)], uniforms=uniforms)
    got = {**out["compare"], **out["schedule"]}
    assert set(got) == set(ref)
    for name, (jalg, key, n) in ref.items():
        want = JK.run(jalg, jprob, n, key=key)
        np.testing.assert_array_equal(got[name]["bytes"], want["bytes"])
        for m in ("obj", "grad_norm", "consensus", "max_tx", "x_final"):
            np.testing.assert_allclose(got[name][m], want[m], rtol=RUN_RTOL,
                                       atol=1e-6, err_msg=f"{name} {m}")
    assert set(out["gamma"]) == set(mod.GAMMAS)
    assert all(np.isfinite(v).all() for v in out["gamma"].values())


@pytest.mark.parametrize("arch", ["smollm-135m", "whisper-small",
                                  "jamba-v0.1-52b"])
def test_serve_batched_example_on_cpu(arch):
    from repro_torch.launch import serve
    mod = _example("torch_serve_batched")
    res = mod.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                    "--prompt-len", "32", "--new-tokens", "5"])
    assert res["tokens"].shape == (2, 5)
    # the same tokens as the serving CLI from the same seed
    cli = serve.main(["--device", "cpu", "--reduced", "--arch", arch,
                      "--batch", "2", "--prompt-len", "32",
                      "--new-tokens", "5"])
    np.testing.assert_array_equal(res["prompts"], cli["prompts"])
    np.testing.assert_array_equal(res["tokens"], cli["tokens"])


def test_decentralized_train_example_on_cpu():
    from repro_torch.launch import train
    mod = _example("torch_decentralized_train")
    res = mod.main(["--device", "cpu", "--steps", "3", "--batch", "4",
                    "--seq", "32"])
    assert list(res) == ["adc_dgd", "dgd", "allreduce"]
    for r in res.values():
        assert len(r["losses"]) == 3 and np.isfinite(r["losses"]).all()
    assert len(res["adc_dgd"]["cerr"]) == 3 and res["allreduce"]["cerr"] == []
    # the wire bytes are the runtime's static accounting: the int8 payload
    # of 516 bytes a row, both directions; fp32 DGD 4 bytes an element
    setup = train.build_train_setup(reduced(get_config("smollm-135m")),
                                    consensus_nodes=2, device="cpu")
    params = train.init_train_state(setup, 0)["params"]
    layout = setup.consensus.state_layout(params)
    assert res["adc_dgd"]["wire"] == 2 * layout.n_rows * 516
    assert res["dgd"]["wire"] == 2 * 4 * res["dgd"]["n_params"]
    assert res["allreduce"]["wire"] == 0
