"""The dry run and the trainer's exchange probe on the CPU.

* ``launch.dryrun``: a step built on ``meta`` tensors counts the same
  FLOPs, HBM bytes, launches per aten op and kernel calls as the same step
  built on CPU tensors (exactly: both are counts of the same ops on the
  same shapes), for the reduced smollm-135m trainer on 2 nodes (packed
  int8, per-leaf int8, int4, top-k pipelined), its prefill and one decode
  step; the
  records carry the reference's keys but its HLO-only ones; every
  applicable combination of a reduced registry is priced and a failure is
  counted and exits 1;
* ``launch.train``'s ``build_exchange_probe`` / ``measure_consensus_
  overhead``: the probe leaves the train state bitwise unchanged, its
  ``x_next`` is the trainer's exchange of the same state bitwise, the
  measurement returns the reference's keys, and none runs for ``dgd`` or
  one node; the CLI prints the keys on the step lines of an ``adc_dgd``
  run.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import json
import os

import pytest
import torch

from repro.launch import analysis as janalysis
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.core import tree as T
from repro_torch.launch import analysis, dryrun, train
from repro_torch.models.config import INPUT_SHAPES, InputShape

SMOLLM = reduced(get_config("smollm-135m"))
SHAPES = {"train": InputShape("train", 32, 4, "train"),
          "prefill": InputShape("prefill", 48, 2, "prefill"),
          "decode": InputShape("decode", 48, 2, "decode")}


def _counted(shape, device, **kw):
    step = dryrun.build_step(SMOLLM, shape, device, nodes=2, **kw)
    return (*dryrun.count_step(step), step)


@pytest.mark.parametrize("kind,kw", [
    ("train", {}), ("train", {"wire_packing": "per_leaf"}),
    ("train", {"wire_codec": "int4", "remat": "none"}),
    ("train", {"wire_codec": "topk", "wire_packing": "pipelined"}),
    ("prefill", {}), ("decode", {})])
def test_meta_step_counts_what_the_cpu_step_counts(kind, kw):
    meta, meta_mem, meta_step = _counted(SHAPES[kind], "meta", **kw)
    cpu, cpu_mem, _ = _counted(SHAPES[kind], "cpu", **kw)
    assert meta.as_dict() == cpu.as_dict()
    assert meta_mem == cpu_mem
    assert meta.flops > 0 and meta.hbm_bytes > 0
    if kind == "train":
        units = 0
        if kw.get("wire_packing") == "pipelined":
            rt = meta_step.setup.consensus
            units = rt.pipeline_chunks_for(rt.state_layout(
                meta_step.state["params"]))
        kernels = ({"quantize_blocks": 2 * 11, "dequant_combine": 2 * 11}
                   if kw.get("wire_packing") == "per_leaf" else
                   {"subbyte_encode_payload": 2,
                    "subbyte_decode_combine": 2}
                   if kw.get("wire_codec") == "int4" else
                   {"topk_encode_payload": 2 * units,
                    "topk_decode_combine": 2 * units}
                   if kw.get("wire_codec") == "topk" else
                   {"quantize_payload": 2, "dequant_combine_payload": 2})
        assert dict(meta.kernels) == kernels
        assert meta_mem["saved_bytes"] > 0
    elif kind == "decode":
        assert dict(meta.kernels) == {"gqa_decode": SMOLLM.n_layers}
    else:
        assert dict(meta.kernels) == {}


def test_state_bytes_are_the_states_tensors():
    step = dryrun.build_step(SMOLLM, SHAPES["train"], "cpu", nodes=2)
    setup = train.build_train_setup(SMOLLM, consensus_nodes=2,
                                    optimizer="sgd", device="cpu")
    state = train.init_train_state(setup, 0)
    want = sum(t.numel() * t.element_size() for t in T.tree_leaves(state)
               if torch.is_tensor(t))
    assert step.state_bytes == want
    dec = dryrun.build_step(SMOLLM, SHAPES["decode"], "meta")
    # a full float32 cache of 48 positions: k and v of every layer
    cache = 2 * SMOLLM.n_layers * 2 * 48 * SMOLLM.n_kv_heads \
        * SMOLLM.resolved_head_dim * 4
    params = sum(t.numel() * 4 for t in T.tree_leaves(
        dryrun._params(setup.defs.storage, "meta")))
    assert dec.state_bytes == cache + params + 2 * 4     # + the tokens


def test_run_combo_records_the_reference_keys(tmp_path):
    rec = dryrun.run_combo("smollm-135m", "decode_32k", str(tmp_path),
                           cfg=SMOLLM)
    ref_keys = {"arch", "shape", "mesh", "chips", "hlo_flops_per_chip",
                "hlo_bytes_per_chip", "collective_bytes_per_chip",
                "collective_breakdown", "compute_s", "memory_s",
                "collective_s", "dominant", "bound_s",
                "model_flops_per_chip", "useful_flops_ratio",
                "memory_analysis", "xla_cost_analysis_flops",
                "xla_cost_analysis_bytes", "unknown_trip_loops"}
    hlo_only = {"xla_cost_analysis_flops", "xla_cost_analysis_bytes",
                "unknown_trip_loops", "memory_analysis"}
    assert ref_keys - hlo_only <= set(rec)
    assert not hlo_only & set(rec)
    assert rec["kernels"] == {"gqa_decode": SMOLLM.n_layers}
    assert rec["model_flops_per_chip"] == janalysis.model_flops_per_step(
        SMOLLM.active_param_count(), 128, "serve")
    assert rec["fits"] and rec["hw"] == analysis.H100.name
    files = os.listdir(tmp_path)
    assert files == ["smollm-135m__decode_32k__h100x1__adc_int8__float32"
                     ".json"]
    with open(tmp_path / files[0]) as f:
        assert json.load(f) == rec
    skipped = dryrun.run_combo("smollm-135m", "long_500k", str(tmp_path),
                               cfg=SMOLLM)
    assert skipped["skipped"] and "sub-quadratic" in skipped["reason"]


def test_train_record_prices_the_wire(tmp_path):
    rec = dryrun.run_combo("smollm-135m", "train_4k", str(tmp_path),
                           cfg=dataclasses.replace(SMOLLM, n_periods=1),
                           consensus_nodes=4, remat="none")
    setup = train.build_train_setup(SMOLLM, consensus_nodes=4,
                                    device="cpu")
    assert rec["kernels"] == {"quantize_payload": 4,
                              "dequant_combine_payload": 4}
    assert rec["collective_s"] == rec["collective_bytes_per_chip"] / 450e9
    assert rec["nodes"] == 4 and setup.n_nodes == 4
    assert rec["saved_bytes"] > 0 and rec["exchange_bytes"] > 0
    assert rec["peak_bytes_estimate"] == rec["state_bytes"] + max(
        rec["grad_bytes"] + rec["saved_bytes"], rec["exchange_bytes"])


def test_main_prices_every_applicable_combo_and_counts_failures(
        tmp_path, monkeypatch):
    real = dryrun.build_step

    def small(cfg, shape, device="meta", **kw):
        cfg = dataclasses.replace(reduced(cfg), n_periods=1,
                                  vocab_size=128)
        shape = dataclasses.replace(shape, seq_len=min(shape.seq_len, 32),
                                    global_batch=min(shape.global_batch, 4))
        return real(cfg, shape, device, **kw)

    monkeypatch.setattr(dryrun, "build_step", small)
    recs = dryrun.main(["--out", str(tmp_path), "--remat", "none"])
    assert len(recs) == len(ARCH_IDS) * len(INPUT_SHAPES)
    priced = [r for r in recs if not r.get("skipped")]
    assert len(priced) == len(ARCH_IDS) * 3 + sum(
        get_config(a).supports_long_context for a in ARCH_IDS)
    assert all(r["hlo_flops_per_chip"] > 0 for r in priced)

    def broken(*a, **kw):
        raise RuntimeError("cannot price")

    monkeypatch.setattr(dryrun, "build_step", broken)
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--out", str(tmp_path), "--arch", "yi-9b", "--shape",
                     "train_4k", "--force"])
    assert exc.value.code == 1


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "smollm-135m"])
def test_main_takes_the_ssm_chunk_and_tag_suffix(tmp_path, monkeypatch,
                                                 arch):
    """``--ssm-chunk`` replaces an SSM config's chunk as the reference's
    ``run_combo`` does (other configs keep theirs), a chunk that does not
    divide the length fails the combination (hazard 30), and
    ``--tag-suffix`` ends the tag as it ends the reference's."""
    from repro.configs import get_config as jget_config
    real, seen = dryrun.build_step, []

    def small(cfg, shape, device="meta", **kw):
        seen.append(cfg.ssm_chunk)
        cfg = dataclasses.replace(reduced(cfg), n_periods=1, vocab_size=128,
                                  ssm_chunk=min(cfg.ssm_chunk, 32))
        shape = dataclasses.replace(shape, seq_len=32, global_batch=4)
        return real(cfg, shape, device, **kw)

    monkeypatch.setattr(dryrun, "build_step", small)
    recs = dryrun.main(["--out", str(tmp_path), "--arch", arch, "--shape",
                        "train_4k", "--remat", "none", "--ssm-chunk", "128",
                        "--tag-suffix", "__chunk128"])
    jcfg = jget_config(arch)
    want = (dataclasses.replace(jcfg, ssm_chunk=128) if jcfg.ssm_state
            else jcfg).ssm_chunk
    assert seen == [want] and recs[0]["hlo_flops_per_chip"] > 0
    # the reference's tag is f"{arch}__{shape}__{mesh}__{variant}{suffix}"
    assert os.listdir(tmp_path) == [
        f"{arch}__train_4k__h100x1__adc_int8__float32__chunk128.json"]
    if jcfg.ssm_state:
        with pytest.raises(SystemExit) as exc:
            dryrun.main(["--out", str(tmp_path), "--arch", arch, "--shape",
                         "train_4k", "--ssm-chunk", "3000", "--force"])
        assert exc.value.code == 1 and len(seen) == 1


# -- the exchange probe ------------------------------------------------------

def _trained(nodes=4, steps=2, **kw):
    setup = train.build_train_setup(SMOLLM, consensus_nodes=nodes,
                                    device="cpu", **kw)
    state = train.init_train_state(setup, 0)
    g = torch.Generator().manual_seed(1)
    for _ in range(steps):
        batch = {k: torch.randint(0, SMOLLM.vocab_size, (2 * nodes, 16),
                                  generator=g, dtype=torch.int32)
                 for k in ("tokens", "labels")}
        state, _ = train.train_step(setup, state, batch)
    return setup, state


def _copy(state):
    return T.tree_map(lambda a: a.clone() if torch.is_tensor(a) else a,
                      state)


def _same(a, b):
    la, lb = T.tree_leaves(a), T.tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if torch.is_tensor(x) else x == y
        for x, y in zip(la, lb))


@pytest.mark.parametrize("packing", ["packed", "async", "per_leaf"])
def test_probe_leaves_the_state_and_is_the_trainers_exchange(packing):
    setup, state = _trained(wire_packing=packing)
    before = _copy(state)
    probe = train.build_exchange_probe(setup)
    k = state["step"] + 1
    x_next, cons, _ = probe(state["params"], state["consensus"], k)
    assert _same(state, before)
    want, want_cons, _ = setup.consensus.exchange(
        before["params"], before["params"], before["consensus"], k,
        seed=setup.seed)
    assert _same(x_next, want) and _same(cons, want_cons)
    res = train.measure_consensus_overhead(setup, state, 0.5, repeats=2)
    assert set(res) == {"consensus_exchange_s", "consensus_overhead_frac"}
    assert res["consensus_overhead_frac"] == res["consensus_exchange_s"] / 0.5
    assert set(train.measure_consensus_overhead(
        setup, state, None, repeats=1)) == {"consensus_exchange_s"}
    assert _same(state, before)


def test_probe_keeps_the_runtimes_fault_count():
    setup, state = _trained(link_loss=0.5, loss_seed=3)
    rt = setup.consensus
    zero = rt.zero_payloads
    assert zero > 0
    train.measure_consensus_overhead(setup, state, 1.0, repeats=1)
    assert rt.zero_payloads == zero


@pytest.mark.parametrize("nodes,algorithm", [(4, "dgd"), (1, "adc_dgd"),
                                             (2, "allreduce")])
def test_no_probe_without_an_adc_exchange(nodes, algorithm):
    setup, state = _trained(nodes=nodes, steps=1, algorithm=algorithm)
    assert train.build_exchange_probe(setup) is None
    assert train.measure_consensus_overhead(setup, state, 1.0) == {}


def test_cli_prints_the_probe_on_adc_step_lines(capsys):
    hist = train.main(["--reduced", "--device", "cpu", "--nodes", "2",
                       "--batch", "4", "--seq", "16", "--steps", "3"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step ")]
    assert len(lines) == 3
    assert "consensus_exchange_s" not in lines[0]   # no step time yet
    for ln in lines[1:]:
        assert "consensus_exchange_s=" in ln
        assert "consensus_overhead_frac=" in ln
    # printed, not recorded: the history holds the step's own metrics
    assert all("consensus_exchange_s" not in h for h in hist)
    train.main(["--reduced", "--device", "cpu", "--nodes", "2", "--batch",
                "4", "--seq", "16", "--steps", "2", "--algorithm", "dgd"])
    assert "consensus_exchange_s" not in capsys.readouterr().out
