"""Dry run: price every (architecture x input shape) on one card, on ``meta``.

Counterpart of ``repro.launch.dryrun`` on one card.  For every architecture
of ``configs.ARCH_IDS`` and every input shape that ``shape_applicable``
admits, it builds the port's own step:

* ``train_4k``: ``train_step`` of ``build_train_setup``, with
  ``--nodes`` consensus nodes (default 4) and the global batch split over
  them as the trainer splits it;
* ``prefill_32k``: ``prefill_step`` of ``build_prefill_setup``;
* ``decode_32k`` and ``long_500k``: one ``serve_step`` of
  ``build_serve_setup`` (``long_serve`` at ``long_500k``) on a full cache,
  the new token written at its last position;

and runs it once on ``meta`` tensors (``models.params.meta_params``,
``configs.input_specs``, meta consensus state, cache and noise) under the
op counter of ``launch.op_cost``: nothing is allocated on any device and
nothing is computed, so a configuration that does not fit the card is
priced all the same.  The counted step is the one the card would run: the
same ops, FLOPs, bytes and launches (``chip_smoke.py`` holds the
smollm-135m trainer's meta count to its count on the card).

Each combination writes one ``analysis.summarize_combo`` record as JSON to
``--out`` (``obs/dryrun/`` by default), with a memory account in place of
the reference's ``memory_analysis()``:

* ``state_bytes``: what lives across steps, every tensor of the state
  once: for train the parameters, the optimizer's state and the consensus
  state (the float32 shadows ``x_tilde`` / ``m_agg``, the async in-flight
  payloads); for serving the parameters and the cache;
* for train, ``grad_bytes`` (the stacked gradient tree),
  ``saved_bytes`` (what autograd saves for the backward of one node's
  forward over one microbatch, outside the recomputed regions, through
  ``torch.autograd.graph.saved_tensors_hooks``, counted in a forward of
  its own after the step: the nodes' forwards run one after another) and
  ``exchange_bytes`` (the exchange's transient buffers: ``x_half``, the
  packed differential, the noise, the three combine outputs and the
  payloads);
* ``peak_bytes_estimate``: state plus the larger of the backward's and the
  exchange's transients, and ``fits`` against the card's 80 GB.

A combination that cannot be priced is a failure: it is printed and
counted, and the run exits 1, as the reference's does.

Usage (no card needed; the records price the H100 of ``analysis.HW``)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
        --shape train_4k --variant dgd_fp32 --compute-dtype bfloat16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --shape train_4k \\
        --wire-packing per_leaf          # or --wire-codec int4, topk, ...

``--ssm-chunk`` and ``--tag-suffix`` are the reference's (an SSM
config's chunk of the scan, which must divide the length; a suffix of
each record's tag).  ``--mesh`` and ``--serve-layout`` of the reference
wait for tensor parallelism and FSDP priced on ``meta`` (ROADMAP Queue 1,
item 5d-5).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable

import torch

from repro_torch.core import tree as T
from repro_torch.launch import analysis
from repro_torch.launch.op_cost import CostCounter, OpCost
from repro_torch.models.config import InputShape

__all__ = ["VARIANTS", "DTYPES", "Step", "build_step", "count_step",
           "run_combo", "main"]

#: the reference's variants: the consensus algorithm each trains with
VARIANTS = {"adc_int8": "adc_dgd", "dgd_fp32": "dgd",
            "allreduce": "allreduce"}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
REMATS = {"full": True, "dots": "dots", "none": False}


@dataclasses.dataclass
class Step:
    """One built step: ``run()`` runs it once; the rest is its account."""

    run: Callable[[], Any]
    kind: str                     # train | serve
    tokens_per_step: int
    state_bytes: int
    collective_bytes_per_chip: float = 0.0
    grad_bytes: int = 0
    exchange_bytes: int = 0
    #: the step's inputs apart from its state: the batch, the noise
    input_bytes: int = 0
    #: train: the bytes autograd saves in one node's forward over one
    #: microbatch (counted apart from the step, after it)
    saved_bytes: Callable[[], int] | None = None
    #: what the step runs on: its setup and its state
    setup: Any = None
    state: Any = None


def _nbytes(tree) -> int:
    """Bytes of every tensor of ``tree``, each storage once."""
    seen, total = set(), 0
    for t in T.tree_leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
        # a view of a storage counted before adds nothing
    return total


def _storages(tree) -> set:
    return {t.untyped_storage()._cdata for t in T.tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


def _tensor(shape, dtype, device, gen: torch.Generator | None,
            high: int | None = None) -> torch.Tensor:
    """``meta`` stand-in, or on a real device data drawn there from
    ``gen``: ids below ``high``, standard normal floats, uniform ``[0,
    1)`` noise when ``high`` is 0."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    if high:
        return torch.randint(0, high, shape, generator=gen, device=device,
                             dtype=dtype)
    if high == 0:
        return torch.rand(shape, generator=gen, device=device, dtype=dtype)
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def _params(defs, device, lead: tuple = ()):
    """Parameters of ``defs`` with a leading ``lead`` axis: ``meta``
    stand-ins, or ``init_params`` from seed 0 on a real device."""
    if torch.device(device).type == "meta":
        return T.tree_map(lambda d: torch.empty(lead + d.shape,
                                                dtype=d.dtype, device="meta"),
                          defs)
    from repro_torch.models.params import init_params
    return init_params(defs, 0, device, n_nodes=lead[0] if lead else None)


def _batch(cfg, shape: InputShape, device, gen) -> dict:
    """The inputs of ``configs.input_specs``: on ``meta`` themselves, on a
    real device drawn from ``gen`` (token ids, standard normal frames)."""
    from repro_torch.configs import input_specs
    specs = input_specs(cfg, shape)
    return {k: _tensor(v.shape, v.dtype, device, gen,
                       cfg.vocab_size if k != "enc_frames" else None)
            for k, v in specs.items()}


def build_step(cfg, shape: InputShape, device="meta", *,
               variant: str = "adc_int8", nodes: int = 4,
               remat: str = "full", microbatches: int = 1,
               compute_dtype: str = "float32", wire_codec: str = "int8",
               wire_packing: str = "packed") -> Step:
    """The port's step of ``cfg`` at ``shape`` on ``device``: ``meta``
    (a dry run) or a real device, where the state and inputs are drawn
    from seed 0 (parameters by ``init_params``, token ids, frames and the
    exchange's noise by a generator on the device)."""
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer as TF
    dt = DTYPES[compute_dtype]
    gen = None
    if torch.device(device).type != "meta":
        gen = torch.Generator(device=device).manual_seed(0)
    if shape.kind == "train":
        setup = train.build_train_setup(
            cfg, consensus_nodes=nodes, algorithm=VARIANTS[variant],
            optimizer="sgd", compute_dtype=dt, remat=REMATS[remat],
            microbatches=microbatches, wire_codec=wire_codec,
            wire_packing=wire_packing, device=device)
        if shape.global_batch % (nodes * microbatches):
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"split over {nodes} nodes x {microbatches} "
                             "microbatches")
        params = _params(setup.defs.storage, device, (nodes,))
        state = train.init_train_state(setup, params=params)
        rt = setup.consensus
        layout = rt.state_layout(params)
        noise = None
        if VARIANTS[variant] == "adc_dgd":
            noise = _tensor((rt.ring_len, layout.n_rows,
                             rt.noise_cols_for(layout)), torch.float32,
                            device, gen, high=0)
        batch = _batch(cfg, shape, device, gen)
        packed = nodes * layout.n_rows * layout.block * 4
        p_bytes = _nbytes(params)
        if VARIANTS[variant] == "adc_dgd":
            pay = rt.wire_plan_for(layout).payload_bytes
            # x_half, the differential, the noise, three combine outputs,
            # every node's payload
            exchange = (p_bytes + packed + noise.numel() * 4 + 3 * packed
                        + nodes * pay)
        else:
            exchange = 2 * p_bytes               # x_half and x_next

        def saved_bytes() -> int:
            # one node's forward over one microbatch, as _node_grads runs
            # it; its saved tensors stay alive until its graph is dropped,
            # so no storage is freed and reused while they are counted
            bm = shape.global_batch // (nodes * microbatches)
            model = TF.Transformer(setup.defs,
                                   T.tree_map(lambda a: a[0], params),
                                   compute_dtype=dt, remat=REMATS[remat])
            skip, seen = _storages(state), {}

            def pack(t):
                key = t.untyped_storage()._cdata
                if key not in skip:
                    seen[key] = t.untyped_storage().nbytes()
                return t

            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                loss, _ = model({k: v[:bm] for k, v in batch.items()})
            del loss
            return sum(seen.values())

        return Step(run=lambda: train.train_step(setup, state, batch,
                                                 noise=noise),
                    kind="train",
                    tokens_per_step=shape.global_batch * shape.seq_len,
                    state_bytes=_nbytes(state),
                    collective_bytes_per_chip=rt.wire_bytes_per_step(
                        layout.n_elements, layout),
                    grad_bytes=p_bytes, exchange_bytes=exchange,
                    input_bytes=_nbytes([batch, noise]),
                    saved_bytes=saved_bytes, setup=setup, state=state)
    long_serve = shape.name == "long_500k"
    if shape.kind == "prefill":
        pre = serve.build_prefill_setup(cfg, device=device, compute_dtype=dt,
                                        long_serve=long_serve)
        params = _params(pre.defs.storage, device)
        batch = _batch(cfg, shape, device, gen)
        cache_bytes = _nbytes(_decode_cache(cfg, shape, dt, "meta"))
        return Step(run=lambda: pre.prefill_step(params, batch,
                                                 shape.seq_len, dt),
                    kind="serve",
                    tokens_per_step=shape.global_batch * shape.seq_len,
                    state_bytes=_nbytes(params) + cache_bytes,
                    input_bytes=_nbytes(batch), setup=pre,
                    state={"params": params})
    srv = serve.build_serve_setup(cfg, device=device, compute_dtype=dt,
                                  long_serve=long_serve)
    params = _params(srv.defs.storage, device)
    cache = _decode_cache(cfg, shape, dt, device)
    tokens = _batch(cfg, shape, device, gen)["tokens"]
    state = {"params": params, "cache": cache, "tokens": tokens}
    return Step(run=lambda: srv.serve_step(state), kind="serve",
                tokens_per_step=shape.global_batch,
                state_bytes=_nbytes(state), setup=srv, state=state)


def _decode_cache(cfg, shape: InputShape, dtype, device) -> dict:
    """A cache of ``shape.seq_len`` positions holding ``seq_len - 1``:
    the decode step writes the last one (an encoder-decoder's cross K/V
    over its ``encoder_frames``)."""
    from repro_torch.models import transformer as TF
    cache = TF.init_cache(cfg, shape.global_batch, shape.seq_len,
                          dtype=dtype, device=device)
    cache["len"] = shape.seq_len - 1
    return cache


def count_step(step: Step) -> tuple[OpCost, dict]:
    """Run ``step`` once under a counter: (its cost, its memory account)."""
    with CostCounter() as counter:
        step.run()
    mem = {"state_bytes": step.state_bytes}
    peak = step.state_bytes
    if step.kind == "train":
        saved = step.saved_bytes()
        mem.update(grad_bytes=step.grad_bytes, saved_bytes=saved,
                   exchange_bytes=step.exchange_bytes)
        peak += max(step.grad_bytes + saved, step.exchange_bytes)
    mem["peak_bytes_estimate"] = peak
    mem["fits"] = peak <= analysis.H100.hbm_bytes
    return counter.cost, mem


def run_combo(arch_id: str, shape_name: str, out_dir: str,
              variant: str = "adc_int8", consensus_nodes: int = 4,
              skip_existing: bool = True, remat: str = "full",
              microbatches: int = 1, compute_dtype: str = "float32",
              wire_codec: str = "int8", wire_packing: str = "packed",
              cfg=None, ssm_chunk: int | None = None,
              tag_suffix: str = "") -> dict:
    """Price one combination on ``meta`` and write its record; ``cfg``
    overrides the registry's config (e.g. a reduced one).  As the
    reference's: ``ssm_chunk`` replaces an SSM config's chunk of the scan
    (ValueError unless it is positive and, where the scan runs, divides
    the length: hazard 30), and ``tag_suffix`` is appended to the tag (the
    record's file name)."""
    from repro_torch.configs import get_config, shape_applicable
    from repro_torch.models.config import INPUT_SHAPES

    mesh_name = "h100x1"
    wire = "" if (wire_codec, wire_packing) == ("int8", "packed") else (
        f"__{wire_codec.replace(':', '-')}-{wire_packing}")
    tag = (f"{arch_id}__{shape_name}__{mesh_name}__{variant}__"
           f"{compute_dtype}{wire}{tag_suffix}")
    path = os.path.join(out_dir, tag + ".json")
    if skip_existing and os.path.exists(path):
        print(f"[skip existing] {tag}")
        with open(path) as f:
            return json.load(f)
    cfg = cfg or get_config(arch_id)
    shape = INPUT_SHAPES[shape_name]
    if ssm_chunk is not None and cfg.ssm_state:
        if ssm_chunk < 1:
            raise ValueError(f"ssm_chunk must be positive, got {ssm_chunk}")
        cfg = dataclasses.replace(cfg, ssm_chunk=ssm_chunk)
        if shape.kind != "decode":
            from repro_torch.models.mamba2 import chunk_len
            chunk_len(cfg, shape.seq_len)
    ok, why = shape_applicable(cfg, shape)
    os.makedirs(out_dir, exist_ok=True)
    if not ok:
        rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
               "variant": variant, "skipped": True, "reason": why}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[skip n/a] {tag}: {why}")
        return rec
    t0 = time.time()
    step = build_step(cfg, shape, "meta", variant=variant,
                      nodes=consensus_nodes, remat=remat,
                      microbatches=microbatches, compute_dtype=compute_dtype,
                      wire_codec=wire_codec, wire_packing=wire_packing)
    cost, mem = count_step(step)
    count_s = time.time() - t0
    rec = analysis.summarize_combo(
        arch_id, shape_name, mesh_name, 1, cost,
        step.collective_bytes_per_chip,
        n_active_params=cfg.active_param_count(),
        tokens_per_step=step.tokens_per_step, kind=step.kind,
        dtype=compute_dtype,
        extra={"variant": variant, "nodes": consensus_nodes
               if shape.kind == "train" else None,
               "wire_codec": wire_codec, "wire_packing": wire_packing,
               "remat": remat, "microbatches": microbatches,
               "count_s": count_s, "n_params": cfg.param_count(),
               "n_active_params": cfg.active_param_count(), **mem})
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[done] {tag}: compute={rec['compute_s'] * 1e3:.2f}ms "
          f"memory={rec['memory_s'] * 1e3:.2f}ms "
          f"collective={rec['collective_s'] * 1e3:.2f}ms "
          f"dominant={rec['dominant']} "
          f"useful={rec['useful_flops_ratio']:.2f} "
          f"launches={rec['n_launches']} "
          f"peak~{mem['peak_bytes_estimate'] / 1e9:.2f}GB "
          f"fits={mem['fits']} (counted in {count_s:.1f}s)", flush=True)
    return rec


def main(argv=None) -> list:
    """Command-line entry point; returns the records."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.models.config import INPUT_SHAPES

    ap = argparse.ArgumentParser(description="price every (arch x shape) "
                                 "on the meta device (PyTorch port)")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--variant", default="adc_int8", choices=list(VARIANTS))
    ap.add_argument("--out", default="obs/dryrun")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--remat", default="full", choices=list(REMATS))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compute-dtype", default="float32",
                    choices=sorted(DTYPES))
    ap.add_argument("--wire-codec", default="int8",
                    help="the train step's wire: int8 | int4 | int2 | topk "
                         "| topk:k=<int> | a mixed: plan (the trainer's)")
    ap.add_argument("--wire-packing", default="packed",
                    choices=["packed", "pipelined", "async", "per_leaf"])
    ap.add_argument("--ssm-chunk", type=int, default=None,
                    help="replace an SSM config's chunk of the scan (it "
                         "must divide the length)")
    ap.add_argument("--tag-suffix", default="",
                    help="appended to each record's tag (file name), for "
                         "perf experiments")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    failures, records = [], []
    for arch in archs:
        for shape in shapes:
            try:
                records.append(run_combo(
                    arch, shape, args.out, variant=args.variant,
                    consensus_nodes=args.nodes,
                    skip_existing=not args.force, remat=args.remat,
                    microbatches=args.microbatches,
                    compute_dtype=args.compute_dtype,
                    wire_codec=args.wire_codec,
                    wire_packing=args.wire_packing,
                    ssm_chunk=args.ssm_chunk, tag_suffix=args.tag_suffix))
            except Exception as e:  # noqa: BLE001 — report and continue
                failures.append((arch, shape, repr(e)))
                print(f"[FAIL] {arch} {shape}: {e}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nall dry-run combos priced OK")
    return records


if __name__ == "__main__":
    main()
