"""Tensor parallelism over ranks: the reference's ``model`` axis.

A grid of ``N_NODES x tp`` gloo ranks on the CPU (``launch.mesh.
run_ranks``; the ranks' work is ``tests/torch_tp_work.py``, which imports
no JAX) runs reduced smollm-135m and qwen3-0.6b head-sharded at tp 2 (a
kv head per rank) and tp 4 (fewer kv heads than ranks: replicated kv
projections, each rank slicing its one), and smollm-135m
sequence-sharded at tp 3 (``n_heads % 3 != 0``; ``d_ff`` 384 so that 3
divides it, which also pads the vocabulary from 1,024 to 1,152).  Every
case runs on weights drawn here with numpy at the padded vocabulary
(norms drawn too, around their init, so that their gradients are not
trivial), and is held

* to the reference in one JAX subprocess on 8 host devices, started
  before the ranks and run beside them: the train-mode logits of each
  node's rows against ``model_apply`` of those rows alone under
  ``shard_map`` on a ``(1, tp)`` mesh, the loss, every rank's gradient against ``jax.grad`` of
  ``train_loss`` and its parameters after one step against the
  reference's ``algorithm="none"`` train step, both on a ``(data=2,
  model=tp)`` mesh with 2 consensus nodes, and a prefill plus
  ``DECODE`` greedy tokens against ``build_prefill_setup`` /
  ``build_serve_setup`` on a ``(1, tp)`` mesh;
* to the port's own tp = 1 run of the same config and weights (its
  gradient sliced to the rank);
* to itself: every leaf replicated over a node's ranks has the same
  gradient bits on each, and every rank returns the same tokens.

qwen3-0.6b at tp 2 also trains ``ADC_STEPS`` steps of int8 packed
ADC-DGD on the grid: each rank's payload bytes, x_next, x_tilde and m_agg
at every step are bitwise the port's stacked runtime's over the stack of
that model index's shards, replaying the ranks' optimizer outputs with the
same seed.  The reference's ADC trainer at tp > 1 fails on this jax
(ROADMAP hazard 1), so the exchange is held to the stacked runtime and
the model step to the reference's ``algorithm="none"`` step.

Tolerances (float32 on both sides; the sums are split over the ranks in
other places than in one matmul): ``LOGIT_TOL`` 1e-5 absolute on the
logits and the loss, ``GRAD_RTOL`` relative to each leaf's largest
gradient, ``PARAM_ATOL`` on the parameters after a step of lr 1e-2.

The harness (:func:`make_inputs`, :func:`make_runs` and the ``check_*``
functions) also serves the other families' files, ``test_torch_tp_moe.py``,
``test_torch_tp_ssm.py`` and ``test_torch_tp_whisper.py``: an
encoder-decoder's batch and prompts carry frames, a config with Mamba2
blocks trains on ``torch_tp_work.seq_len`` tokens (a multiple of its scan
chunk), and where the grid pads the expert axis the weights are drawn at
the padded shapes and the port's tp = 1 run takes the live experts only
(the dead ones sliced off; its gradient is compared with zeros on them).
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import os
import pickle
import subprocess
import sys
import tempfile
import types

import numpy as np
import pytest
import torch

import torch_tp_work as W

from repro_torch.checkpoint import save_checkpoint
from repro_torch.core import tree as T
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import transformer as TF
from repro_torch.models.params import params_from_jax, tp_slice
from repro_torch.models.sharding import ParallelContext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = 1e-5
#: measured at 2.2e-6 against the port's tp = 1 (relative to each leaf's
#: largest gradient entry)
GRAD_RTOL = 2e-5
PARAM_ATOL = 1e-7

#: (name, arch, tp, config overrides)
CASES = [("smollm tp2", "smollm-135m", 2, {}),
         ("qwen3 tp2", "qwen3-0.6b", 2, {}),
         ("smollm tp4", "smollm-135m", 4, {}),
         ("qwen3 tp4", "qwen3-0.6b", 4, {}),
         ("smollm tp3 seq", "smollm-135m", 3, {"d_ff": 384})]
ADC_CASE = "qwen3 tp2"
NAMES = [c[0] for c in CASES]


def _grid_defs(cfg, tp):
    """The ParamDef tree at ``tp`` (only ``ctx.tp`` is read)."""
    return TF.build_defs(cfg, ctx=types.SimpleNamespace(tp=tp))


def _draw(cfg, seed: int, tp: int = 1):
    """Every leaf of ``cfg``'s full logical tree at ``tp`` (the padded
    expert axis) from numpy: the port's init scale for the normal leaves,
    and for the leaves declared zeros or ones (the norms, Mamba2's
    ``a_log``, ``d_skip`` and ``dt_bias``) that value plus 0.1 * normal,
    so that their gradients are not trivial."""
    rng = np.random.default_rng(seed)

    def one(d):
        if d.init != "normal":
            return (float(d.init == "ones")
                    + 0.1 * rng.standard_normal(d.shape)).astype(np.float32)
        fan = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        return (rng.standard_normal(d.shape) * d.scale
                / np.sqrt(fan)).astype(np.float32)
    return T.tree_map(one, _grid_defs(cfg, tp).storage)


def make_inputs(specs, adc_names) -> list:
    """The cases of ``specs`` ((name, arch, tp, config overrides), ...):
    weights, a training batch, serve prompts and, for the names in
    ``adc_names``, ``ADC_STEPS`` more batches, drawn with numpy; an
    encoder-decoder's batches and prompts carry standard normal frames
    ``(b, encoder_frames, d_model)``, drawn after the rest."""
    cases = []
    for i, (name, arch, tp, ov) in enumerate(specs):
        case = {"name": name, "arch": arch, "tp": tp, "overrides": ov}
        cfg = W.config(case, tp)
        rng = np.random.default_rng(100 + i)
        real = W.config(case, 1).vocab_size
        s = W.seq_len(cfg)

        def toks(shape):
            return rng.integers(0, real, shape, dtype=np.int32)
        case.update(weights=_draw(cfg, i, tp), batch={
            "tokens": toks((W.B, s)), "labels": toks((W.B, s))},
            prompts=toks((W.SERVE_B, W.PROMPT)), adc=name in adc_names)
        if case["adc"]:
            case["adc_batches"] = [{"tokens": toks((W.B, s)),
                                    "labels": toks((W.B, s))}
                                   for _ in range(W.ADC_STEPS)]
        if cfg.is_encoder_decoder:
            def frames(b):
                return rng.standard_normal(
                    (b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
            case["batch"]["enc_frames"] = frames(W.B)
            case["serve_frames"] = frames(W.SERVE_B)
        cases.append(case)
    return cases


JAX_BODY = r'''
import os, sys, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_config, reduced
from repro.launch.mesh import make_cpu_mesh
from repro.launch import train as LT
from repro.launch.serve import build_prefill_setup, build_serve_setup
from repro.models import transformer as T
from repro.models.params import ParamDef
from repro.models.sharding import make_context, shard_map_compat

inp = pickle.load(open(sys.argv[1], "rb"))
W = inp["W"]
isdef = lambda x: isinstance(x, ParamDef)
out = {}
def specs(batch, two, three):
    return {k: three if v.ndim == 3 else two for k, v in batch.items()}
for case in inp["cases"]:
    tp = case["tp"]
    cfg = dataclasses.replace(reduced(get_config(case["arch"])),
                              **case["overrides"], vocab_size=case["vocab"])
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    # (data=2, model=tp), 2 consensus nodes: grads and the "none" step
    mesh = make_cpu_mesh(data=2, model=tp)
    setup = LT.build_train_setup(cfg, mesh, consensus_nodes=2,
                                 algorithm="none", lr=W["LR"],
                                 global_batch=W["B"], remat=True)
    fd, td = jax.tree_util.tree_flatten(setup.defs.storage, is_leaf=isdef)
    logical = case["weights"]
    storage = [np.concatenate([w, w], axis=d.fsdp_dim)
               for d, w in zip(fd, logical)]
    params = jax.tree_util.tree_unflatten(td, [jnp.asarray(a) for a in storage])
    ctx = setup.ctx
    pspec = LT._param_specs(setup.defs.storage, ctx)
    bspec = specs(batch, LT.batch_partition_spec(ctx, W["B"]),
                  LT.batch_partition_spec(ctx, W["B"], extra_dims=2))
    def gfn(p, b):
        return jax.grad(lambda p: T.train_loss(p, setup.defs, b, ctx)[0])(p)
    grads = jax.jit(shard_map_compat(gfn, mesh, in_specs=(pspec, bspec),
                                     out_specs=pspec))(params, batch)
    state = {"params": params, "opt": setup.optimizer.init(params),
             "consensus": {}, "step": jnp.zeros((), jnp.int32)}
    state = jax.device_put(state, setup.state_sharding)
    state, m = setup.train_step(state, jax.device_put(batch,
                                                      setup.batch_sharding))
    res = {"loss": float(m["loss"]),
           "grads": [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)],
           "params1": [np.asarray(a) for a in
                       jax.tree_util.tree_leaves(state["params"])]}
    # (1, tp): the train-mode logits and serving
    mesh1 = make_cpu_mesh(data=1, model=tp)
    ctx1 = make_context(mesh1, consensus_nodes=1)
    defs1 = T.build_defs(cfg, ctx1)
    params1 = jax.tree_util.tree_unflatten(td, [jnp.asarray(a) for a in logical])
    pspec1 = LT._param_specs(defs1.storage, ctx1)
    lfn = lambda p, b: T.model_apply(p, defs1, b, ctx1, remat=False)[0]
    fwd = {k: v for k, v in batch.items() if k != "labels"}
    lfn = jax.jit(shard_map_compat(
        lfn, mesh1, in_specs=(pspec1, specs(fwd, P(None, None),
                                            P(None, None, None))),
        out_specs=P(None, None, "model"), check=False))
    # each node's rows on their own, as its ranks route them (an MoE
    # layer's capacity counts the tokens routed together)
    bn = W["B"] // 2
    res["logits"] = np.concatenate([np.asarray(lfn(params1, {
        k: v[i * bn:(i + 1) * bn] for k, v in fwd.items()}))
        for i in range(2)])
    pre = build_prefill_setup(cfg, mesh1, global_batch=W["SERVE_B"],
                              seq_len=W["PROMPT"])
    pp = jax.device_put(params1, pre.params_sharding)
    prompt = {"tokens": jnp.asarray(case["prompts"])}
    if case.get("serve_frames") is not None:
        prompt["enc_frames"] = jnp.asarray(case["serve_frames"])
    first, cache = pre.prefill_step(pp, prompt)
    srv = build_serve_setup(cfg, mesh1, global_batch=W["SERVE_B"],
                            capacity=W["PROMPT"] + W["DECODE"])
    def pad_to(p, s):
        return p if p.shape == s.shape else jnp.pad(
            p, [(0, b - a) for a, b in zip(p.shape, s.shape)])
    cache = jax.tree.map(pad_to, cache, srv.state_shape["cache"],
                         is_leaf=lambda x: hasattr(x, "shape")
                         and not isinstance(x, dict))
    st = jax.device_put({"params": pp, "cache": cache, "tokens": first},
                        srv.state_sharding)
    toks = [np.asarray(first)]
    for _ in range(W["DECODE"]):
        st = srv.serve_step(st)
        toks.append(np.asarray(st["tokens"]))
    res["tokens"] = np.concatenate(toks, axis=1)
    out[case["name"]] = res
pickle.dump(out, open(sys.argv[2], "wb"))
'''


def make_runs(cases) -> dict:
    """The reference (a subprocess, beside the ranks), a grid of
    ``N_NODES x tp`` ranks for each tp of ``cases``, and the port's tp = 1
    runs."""
    with tempfile.TemporaryDirectory(prefix="tp-") as tmp:
        inp, outp = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(inp, "wb") as f:
            pickle.dump({"W": {k: getattr(W, k) for k in (
                "B", "LR", "SERVE_B", "PROMPT", "DECODE")},
                "cases": [{**{k: c.get(k) for k in (
                    "name", "arch", "tp", "overrides", "batch", "prompts",
                    "serve_frames")},
                    "vocab": W.config(c, c["tp"]).vocab_size,
                    "weights": T.tree_leaves(c["weights"])}
                    for c in cases]}, f)
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
        env.pop("XLA_FLAGS", None)
        jax_proc = subprocess.Popen(
            [sys.executable, "-c", JAX_BODY, inp, outp], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            ranks = {}
            for tp in sorted({c["tp"] for c in cases}):
                mine = [c for c in cases if c["tp"] == tp]
                ranks[tp] = run_ranks(W.grid, W.N_NODES * tp, tp, mine,
                                      timeout_s=300)
            ones = {c["name"]: _tp1(c) for c in cases}
            _, err = jax_proc.communicate(timeout=600)
        finally:
            if jax_proc.poll() is None:
                jax_proc.kill()
                jax_proc.wait()
        assert jax_proc.returncode == 0, err[-4000:]
        with open(outp, "rb") as f:
            ref = pickle.load(f)
    return {"cases": {c["name"]: c for c in cases}, "ranks": ranks,
            "ref": ref, "ones": ones}


@pytest.fixture(scope="module")
def runs():
    """The dense cases: grids of 4, 6 and 8 ranks."""
    return make_runs(make_inputs(CASES, (ADC_CASE,)))


def _live(a, d):
    """The leaf ``a`` of the grid's (padded) tree cut to the tp = 1 shape
    of ``d``: the live experts."""
    return a[tuple(slice(0, n) for n in d.shape)]


def _tp1(case) -> dict:
    """The port at tp = 1 on the same config and weights (the live
    experts of a padded expert axis), both nodes stacked: gradients
    (zero on the dead experts, at the grid's shapes), one ``none`` step,
    the served tokens."""
    cfg = W.config(case, case["tp"])
    setup = W.setup_for(cfg)
    weights = T.tree_map(_live, case["weights"], setup.defs.storage)
    params = params_from_jax(weights, setup.defs.storage, "cpu",
                             n_nodes=W.N_NODES)
    losses, grads = train._node_grads(setup, params, case["batch"])
    pre = serve.build_prefill_setup(cfg, device="cpu")
    srv = serve.build_serve_setup(cfg, device="cpu")
    p = params_from_jax(weights, pre.defs.storage, "cpu")
    batch = {"tokens": torch.as_tensor(case["prompts"])}
    if case.get("serve_frames") is not None:
        batch["enc_frames"] = torch.as_tensor(case["serve_frames"])
    ids, cache = pre.prefill_step(p, batch, W.PROMPT + W.DECODE)
    st, toks = {"params": p, "cache": cache, "tokens": ids}, [ids]
    for _ in range(W.DECODE):
        st = srv.serve_step(st)
        toks.append(st["tokens"])

    def pad(g, w):
        out = g.new_zeros(g.shape[:1] + w.shape)
        out[(slice(None),) + tuple(slice(0, n) for n in g.shape[1:])] = g
        return out
    return {"losses": losses,
            "grads": [pad(g, w) for g, w in zip(T.tree_leaves(grads),
                                                 T.tree_leaves(
                                                     case["weights"]))],
            "tokens": torch.cat(toks, dim=1).numpy()}


def _each_rank(runs, name):
    case = runs["cases"][name]
    tp = case["tp"]
    defs = T.tree_leaves(_grid_defs(W.config(case, tp), tp).storage)
    for r, res in enumerate(runs["ranks"][tp]):
        node, m = divmod(r, tp)           # data-major
        assert (res["node"], res["m"]) == (node, m)
        yield node, m, defs, res[name]


def check_forward(runs, name, tol=LOGIT_TOL):
    """Each rank's logits of its node's rows within ``tol`` of the
    reference's columns of the rank, the loss within ``LOGIT_TOL``."""
    ref = runs["ref"][name]
    bn = W.B // W.N_NODES
    for node, m, _, res in _each_rank(runs, name):
        v_l = res["logits"].shape[-1]
        want = ref["logits"][node * bn:(node + 1) * bn, :,
                             m * v_l:(m + 1) * v_l]
        np.testing.assert_allclose(res["logits"].numpy(), want,
                                   atol=tol, rtol=0)
        assert abs(res["loss"] - ref["loss"]) <= LOGIT_TOL


def check_gradient_and_step(runs, name):
    """The reference's storage leaves (both nodes' replicas on each
    leaf's ``fsdp_dim``) carried to each rank by ``params_from_jax``."""
    ref = runs["ref"][name]
    tp = runs["cases"][name]["tp"]
    storage = _grid_defs(W.config(runs["cases"][name], tp), tp).storage
    _, treedef = T.tree_flatten(storage)

    def carry(leaves, node, m):
        return T.tree_leaves(params_from_jax(
            T.tree_unflatten(treedef, leaves), storage, "cpu", tp=tp,
            tp_rank=m, node=node))
    for node, m, defs, res in _each_rank(runs, name):
        for d, g, want, p1, want1 in zip(
                defs, res["grads"], carry(ref["grads"], node, m),
                res["params1"], carry(ref["params1"], node, m)):
            err = (g - want).abs().max() / want.abs().max().clamp_min(1e-30)
            assert err <= GRAD_RTOL, (name, node, m, d.shape, float(err))
            assert (p1 - want1).abs().max() <= PARAM_ATOL


def check_gradient_tp1(runs, name):
    one = runs["ones"][name]
    tp = runs["cases"][name]["tp"]
    for node, m, defs, res in _each_rank(runs, name):
        assert abs(res["node_loss"] - float(one["losses"][node])) \
            <= LOGIT_TOL
        for d, g, g1 in zip(defs, res["grads"], one["grads"]):
            want = tp_slice(g1[node], d, tp, m)
            err = (g - want).abs().max() / want.abs().max().clamp_min(1e-30)
            assert err <= GRAD_RTOL, (name, node, m, d.shape, float(err))


def check_replicated_bitwise(runs, name):
    by_node = {}
    for node, m, defs, res in _each_rank(runs, name):
        by_node.setdefault(node, []).append(res)
    n_rep = 0
    for results in by_node.values():
        for i, d in enumerate(defs):
            if d.tp_dim is None:
                n_rep += 1
                for res in results[1:]:
                    assert torch.equal(res["grads"][i],
                                       results[0]["grads"][i])
                    assert torch.equal(res["params1"][i],
                                       results[0]["params1"][i])
    assert n_rep


def check_serve_tokens(runs, name):
    """Every rank's tokens are the reference's and the port's tp = 1
    ones, and its cache has the shapes of ``init_cache`` at its tp."""
    ref, one = runs["ref"][name], runs["ones"][name]
    case = runs["cases"][name]
    tp = case["tp"]
    np.testing.assert_array_equal(ref["tokens"], one["tokens"])
    cfg = W.config(case, tp)
    frames = case.get("serve_frames")
    want = T.tree_map(lambda a: tuple(a.shape), {
        k: v for k, v in TF.init_cache(
            cfg, W.SERVE_B, W.PROMPT + W.DECODE, device="meta", tp=tp,
            enc_len=None if frames is None else frames.shape[1]).items()
        if k != "len"})
    for node, m, _, res in _each_rank(runs, name):
        np.testing.assert_array_equal(res["serve"]["tokens"], ref["tokens"])
        assert res["serve"]["cache_shapes"] == want


def check_adc(runs, name):
    """Each rank's exchange of every step against the stacked runtime
    over the model index's shards of both nodes."""
    case = runs["cases"][name]
    tp = case["tp"]
    cfg = W.config(case, tp)
    ranks = runs["ranks"][tp]
    for m in range(tp):
        mine = [res[name]["adc"] for r, res in enumerate(ranks)
                if r % tp == m]
        rt = ConsensusRuntime(ConsensusConfig(), W.N_NODES)

        def stack(key, k=None):
            return [torch.cat([(a[key] if k is None else a[key][k])[i]
                               for a in mine])
                    for i in range(len(mine[0]["x0"]))]
        treedef = T.tree_flatten(_grid_defs(cfg, tp).storage)[1]
        x = T.tree_unflatten(treedef, stack("x0"))
        state = rt.init_state(x)
        pays = []
        encode = rt._encode_unit

        def spy(*args, **kw):
            out = encode(*args, **kw)
            pays.append([W.digest(p) for p in out])
            return out
        rt._encode_unit = spy
        for k in range(W.ADC_STEPS):
            del pays[:]
            half = T.tree_unflatten(treedef, stack("halves", k))
            x, state, _ = rt.exchange(x, half, state, k + 1,
                                      seed=W.ADC_SEED)
            for node, a in enumerate(mine):
                got = a["steps"][k]
                assert got["pays"] == [[p[node]] for p in pays]
                assert got["x"] == [W.digest(t[node:node + 1])
                                    for t in T.tree_leaves(x)]
                assert got["x_tilde"] == W.digest(
                    state["x_tilde"][node:node + 1])
                assert got["m_agg"] == W.digest(state["m_agg"][node:node + 1])
    steps = [res[name]["adc"]["steps"] for res in ranks]
    assert all(s[-1]["loss"] == steps[0][-1]["loss"] for s in steps)
    assert np.isfinite(steps[0][-1]["consensus_err"])


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(runs, name):
    check_forward(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_gradient_and_step_match_reference(runs, name):
    check_gradient_and_step(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_gradient_matches_tp1(runs, name):
    check_gradient_tp1(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_replicated_leaves_bitwise_across_tp_ranks(runs, name):
    check_replicated_bitwise(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_serve_tokens_match_reference(runs, name):
    check_serve_tokens(runs, name)


def test_adc_bitwise_stacked(runs):
    check_adc(runs, ADC_CASE)


def test_refusals():
    """What tensor parallelism still refuses: bfloat16 in every family
    (item 5d-2), widths that do not split (a dense MLP's ``d_ff``, the
    SSM heads; an MoE block's ``d_ff`` is not split, its experts are
    padded), serving and training options of items 5d-2 and 5d-3."""
    cfg = W.config({"arch": "qwen3-0.6b"}, 2)
    grid = types.SimpleNamespace(tp=2)
    for arch in ("qwen3-0.6b", "granite-moe-3b-a800m", "deepseek-moe-16b",
                 "mamba2-1.3b", "jamba-v0.1-52b", "whisper-small"):
        TF.build_defs(W.config({"arch": arch}, 2), ctx=grid)
        with pytest.raises(NotImplementedError, match="item 5d-2"):
            TF.build_defs(W.config({"arch": arch}, 2), dtype=torch.bfloat16,
                          ctx=grid)
    grid3 = types.SimpleNamespace(tp=3)
    with pytest.raises(ValueError, match="SSM heads"):
        TF.build_defs(W.config({"arch": "mamba2-1.3b"}, 3), ctx=grid3)
    with pytest.raises(ValueError, match="d_ff 512"):
        TF.build_defs(W.config({"arch": "smollm-135m"}, 3), ctx=grid3)
    with pytest.raises(ValueError, match="shared experts"):
        TF.build_defs(W.config({"arch": "deepseek-moe-16b"}, 3), ctx=grid3)
    TF.build_defs(W.config({"arch": "granite-moe-3b-a800m"}, 3), ctx=grid3)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ParallelContext(tp=2)
    with pytest.raises(NotImplementedError, match="FSDP"):
        ParallelContext(data_size=4, n_nodes=2)
    fake = ParallelContext(tp=2, n_nodes=2, data_size=2, group=object(),
                           rank=1, tp_rank=1, tp_group=object())
    assert (fake.global_rank, fake.grid_rank(0)) == (3, 1)
    for kw in (dict(wire_packing="async"), dict(wire_packing="pipelined"),
               dict(wire_packing="per_leaf"), dict(wire_codec="int4"),
               dict(ring_strides=(1, 2)), dict(topology="directed-ring"),
               dict(link_loss=0.1), dict(wire_packing="async",
                                         straggle_rate=0.1),
               dict(membership=((1, 1),)), dict(hierarchy=2),
               dict(telemetry=True), dict(algorithm="compressed_dgd")):
        with pytest.raises(NotImplementedError, match="item 5d"):
            ConsensusRuntime(ConsensusConfig(**kw), 2, ctx=fake)
    with pytest.raises(NotImplementedError, match="item 5d"):
        train.build_train_setup(cfg, microbatches=2, device="cpu", ctx=fake)
    with pytest.raises(NotImplementedError, match="item 5d"):
        save_checkpoint("unused", 1, {"x": torch.zeros(1, 2)}, ctx=fake)
    for argv in (["--model", "2", "--checkpoint-dir", "x"],
                 ["--model", "2", "--microbatches", "2"],
                 ["--model", "2", "--telemetry"],
                 ["--model", "2", "--wire-codec", "adaptive"]):
        with pytest.raises(NotImplementedError, match="item 5d"):
            train.main(argv + ["--reduced", "--device", "cpu"])


def test_cli_refuses_fsdp_data_axis():
    with pytest.raises(NotImplementedError, match="FSDP"):
        train.main(["--reduced", "--device", "cpu", "--nodes", "2",
                    "--data", "4", "--steps", "1"])
