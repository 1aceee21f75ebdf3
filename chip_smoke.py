#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. setup   — prints the card's name and power limit, builds every CUDA
             kernel from ``src/repro_torch/kernels/csrc`` (one nvcc each, in
             parallel) and prints the build seconds;
2. kernels — holds each kernel to its plain PyTorch version on the card at
             the main path's shape (the payload rows of the full smollm-135m
             wire layout, 262,752) and on a ragged chunk view: quantize
             payload bytes must be equal (fixed and adaptive, float32 and
             bfloat16), dequant-combine outputs bitwise equal or within 1
             ulp;
3. main    — ``repro_torch.launch.train.main`` on the full smollm-135m, 4
             ADC-DGD nodes (fixed int8 grid), 5 steps: losses finite and near
             ln(vocab) at random init, each kernel launched 4 x steps times
             (counters zeroed just before), then 2 steps in adaptive mode;
4. parity  — reduced smollm-135m, 2 steps on the card and on the CPU from
             the same weights and quantization noise: final parameters
             agree to float32 rounding but in at most MAX_FRAC_OFF of the
             elements, and those within MAX_GRID_STEPS quantization grid
             steps; losses within LOSS_RTOL;
5. timing  — each kernel and its plain version, median of 25 launches
             timed with CUDA events, beside the least time the card needs
             for the bytes and operations (H100 SXM data sheet rates);
             the step time, the exchange time and the peak memory.

Prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``.  Needs one card; exits non-zero with no result without one, or
when run outside a checkout of the repository.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, and float32 rate outside the
#: tensor cores.  Both assume the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

BLOCK, PAYLOAD = 512, 516
NODES, STEPS = 4, 5
TIMING_REPS = 25

#: card-vs-CPU parity: float32 matmuls sum in other orders on the two
#: devices, so now and then a stochastic rounding lands on the other side
#: of its threshold and moves one element by one grid step (fixed_step0 at
#: step 1); every other element agrees to float32 rounding (FLOAT_ATOL on
#: parameters of magnitude below 1)
MAX_GRID_STEPS, MAX_FRAC_OFF, FLOAT_ATOL, LOSS_RTOL = 2.0, 1e-4, 1e-6, 1e-5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def ulp_diff(a, b) -> int:
    """Largest distance in units in the last place between two float32
    tensors of finite values."""
    import torch
    ia = a.view(torch.int32).to(torch.int64)
    ib = b.view(torch.int32).to(torch.int64)
    # map the sign-magnitude float order onto a monotone integer line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def time_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median device time of one call, CUDA events around each call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_path_rows(train) -> int:
    """Payload rows per node of the main path: the wire layout of the full
    smollm-135m parameter tree (shapes only, on the ``meta`` device)."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.models.params import meta_params
    setup = train.build_train_setup(get_config("smollm-135m"),
                                    consensus_nodes=NODES, device="cuda")
    params = T.tree_map(lambda a: a.expand((NODES,) + a.shape),
                        meta_params(setup.defs.storage))
    return setup.consensus.state_layout(params).n_rows


def decoded(Q, payload):
    """The values a payload carries: codes times their row's scale."""
    codes, scales = Q.unpack_payload(payload)
    return codes.float() * scales


def phase_kernels(torch, Q, D, n_rows):
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    # differentials at the scale the trainer produces them (lr * grad),
    # with heavy tails so the fixed grid also clips
    y = torch.randn((n_rows, BLOCK), generator=g, device=dev) * 0.05
    u = torch.rand((n_rows, BLOCK), generator=g, device=dev)
    ragged = dict(row_offset=37, n_rows=1001)
    q_abs = 0.0
    for dt in (torch.float32, torch.bfloat16):
        yy = y.to(dt)
        for step in (None, 1e-3):
            for view in ({}, ragged):
                a = Q.quantize_payload(yy, u, step, **view)
                b = Q.quantize_payload_plain(yy, u, step, **view)
                torch.cuda.synchronize()
                if not torch.equal(a, b):
                    fail(f"quantize_payload {dt} step={step} view={view}: "
                         f"{int((a != b).sum())} bytes differ from the "
                         "plain version")
                q_abs = max(q_abs, float((decoded(Q, a) - decoded(Q, b))
                                         .abs().max()))
    print(f"[kernels] quantize_payload: bytes equal to the plain version "
          f"(fixed+adaptive, f32+bf16, full {n_rows} rows + ragged view), "
          f"max |decoded diff| {q_abs}")
    pays = [Q.quantize_payload(y * (i + 1), u, None) for i in range(3)]
    xt = torch.randn((n_rows, BLOCK), generator=g, device=dev)
    mb = torch.randn((n_rows, BLOCK), generator=g, device=dev)
    worst_ulp, worst_abs = 0, 0.0
    cases = [(pays, {}), ([p[37:1038].contiguous() for p in pays], ragged),
             (pays, ragged)]
    for deamp in (1.0, 0.37):
        for ps, view in cases:
            a = D.dequant_combine_payload(*ps, xt, mb, 0.5, 0.25, deamp,
                                          **view)
            b = D.dequant_combine_payload_plain(*ps, xt, mb, 0.5, 0.25,
                                                deamp, **view)
            torch.cuda.synchronize()
            for x, z in zip(a, b):
                worst_ulp = max(worst_ulp, ulp_diff(x, z))
                worst_abs = max(worst_abs, float((x - z).abs().max()))
    if worst_ulp > 1:
        fail(f"dequant_combine_payload differs from the plain version by "
             f"{worst_ulp} ulp")
    why = ("bitwise equal" if worst_ulp == 0 else
           "1 ulp: a product/sum rounded in another order")
    print(f"[kernels] dequant_combine_payload: {why} (max ulp {worst_ulp})")
    return {"quantize_payload": q_abs, "dequant_combine_payload": worst_abs}


def phase_main(torch, train, Q, D):
    Q.quantize_payload.launches = 0
    D.dequant_combine_payload.launches = 0
    torch.cuda.reset_peak_memory_stats()
    hist = train.main(["--arch", "smollm-135m", "--algorithm", "adc_dgd",
                       "--nodes", str(NODES), "--batch", str(4 * NODES),
                       "--seq", "512", "--steps", str(STEPS),
                       "--quant-mode", "fixed", "--lr", "1e-2",
                       "--device", "cuda"])
    launches = {"quantize_payload": Q.quantize_payload.launches,
                "dequant_combine_payload":
                    D.dequant_combine_payload.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = NODES * STEPS
    for name, n in launches.items():
        if n != want:
            fail(f"{name} launched {n} times on the main path, want "
                 f"{want} (4 nodes x {STEPS} steps)")
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    if abs(losses[0] - math.log(49152)) > 0.5:
        fail(f"step-1 loss {losses[0]} far from ln(49152) at random init")
    step_s = [h["step_s"] for h in hist[1:]]
    print(f"[main] smollm-135m x {NODES} nodes, adc_dgd fixed: losses "
          f"{losses}; launches {launches}; wire_bytes_per_step "
          f"{hist[-1]['wire_bytes_per_step']:.0f}; overflow_frac "
          f"{[h['overflow_frac'] for h in hist]}; median step "
          f"{statistics.median(step_s):.4f} s; peak memory {peak_gb:.2f} GB")
    hist_a = train.main(["--arch", "smollm-135m", "--nodes", str(NODES),
                         "--batch", str(4 * NODES), "--seq", "512",
                         "--steps", "2", "--quant-mode", "adaptive",
                         "--lr", "1e-2", "--device", "cuda"])
    if not all(math.isfinite(h["loss"]) for h in hist_a):
        fail(f"non-finite adaptive-mode loss: {hist_a}")
    print(f"[main] adaptive mode: losses {[h['loss'] for h in hist_a]}")
    return launches, statistics.median(step_s), peak_gb


def phase_parity(torch, train):
    """The same two steps of reduced smollm-135m on the card and on the
    CPU (plain versions), from the same weights, batches and noise."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.core import tree as T
    cfg = reduced(get_config("smollm-135m"))
    base = None
    results = {}
    for dev in ("cpu", "cuda"):
        setup = train.build_train_setup(cfg, consensus_nodes=NODES, lr=1e-2,
                                        device=dev)
        state = train.init_train_state(
            setup, 0, params=None if base is None else T.tree_map(
                lambda a: a.to(dev), base))
        base = state["params"]
        ds = SyntheticLMDataset(cfg.vocab_size, 64, 2 * NODES,
                                n_shards=NODES)
        layout = setup.consensus.state_layout(state["params"])
        losses = []
        for step in range(2):
            noise = torch.rand((NODES, layout.n_rows, BLOCK),
                               generator=torch.Generator().manual_seed(step))
            state, m = train.train_step(setup, state,
                                        ds.global_batch_arrays(step),
                                        noise=noise.to(dev))
            losses.append(m["loss"])
        results[dev] = (losses, T.tree_map(lambda a: a.cpu(),
                                           state["params"]))
    (l_cpu, p_cpu), (l_gpu, p_gpu) = results["cpu"], results["cuda"]
    diffs = [(a - b).abs() for a, b in
             zip(T.tree_leaves(p_cpu), T.tree_leaves(p_gpu))]
    diff = max(float(d.max()) for d in diffs)
    frac_off = (sum(int((d > FLOAT_ATOL).sum()) for d in diffs)
                / sum(d.numel() for d in diffs))
    grid = setup.consensus.cfg.fixed_step0
    if (diff > MAX_GRID_STEPS * grid or frac_off > MAX_FRAC_OFF
            or any(abs(a - b) > LOSS_RTOL * abs(a)
                   for a, b in zip(l_cpu, l_gpu))):
        fail(f"card vs CPU: params differ by up to {diff} (limit "
             f"{MAX_GRID_STEPS * grid}) in a share {frac_off} of the "
             f"elements (limit {MAX_FRAC_OFF}), losses {l_cpu} vs {l_gpu}")
    print(f"[parity] reduced smollm-135m, 2 steps card vs CPU: max |param "
          f"diff| {diff!r}, share off by more than {FLOAT_ATOL} "
          f"{frac_off!r}, losses {l_gpu} vs {l_cpu}")


def phase_timing(torch, Q, D, launches, errs, n_rows):
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    y = torch.randn((n_rows, BLOCK), generator=g, device="cuda") * 0.05
    u = torch.rand((n_rows, BLOCK), generator=g, device="cuda")
    xt = torch.randn((n_rows, BLOCK), generator=g, device="cuda")
    mb = torch.randn((n_rows, BLOCK), generator=g, device="cuda")
    pays = [Q.quantize_payload(y * (i + 1), u, 1e-3) for i in range(3)]
    q_bytes = 2 * n_rows * BLOCK * 4 + n_rows * PAYLOAD
    q_ops = n_rows * BLOCK * 10      # abs/max, div, floor, sub, cmp, add, clip
    d_bytes = 3 * n_rows * PAYLOAD + 5 * n_rows * BLOCK * 4
    d_ops = n_rows * BLOCK * 13      # 3 decodes, x_t, m, comb
    rows = []
    for name, fn, plain, nb, no, src, repl in (
            ("quantize_payload",
             lambda: Q.quantize_payload(y, u, 1e-3),
             lambda: Q.quantize_payload_plain(y, u, 1e-3), q_bytes, q_ops,
             "src/repro_torch/kernels/csrc/quantize_payload.cu",
             "src/repro/kernels/quantize.py:246"),
            ("dequant_combine_payload",
             lambda: D.dequant_combine_payload(*pays, xt, mb, 0.5, 0.25, 1.0),
             lambda: D.dequant_combine_payload_plain(*pays, xt, mb, 0.5,
                                                     0.25, 1.0),
             d_bytes, d_ops,
             "src/repro_torch/kernels/csrc/dequant_combine_payload.cu",
             "src/repro/kernels/dequant_combine.py:113")):
        ms = time_ms(fn)
        plain_ms = time_ms(plain)
        b_ms, b_by = bound(nb, no)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
        print(f"[timing] {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms by {b_by}: {nb / 1e9:.4f} GB, "
              f"{ms and b_ms / ms:.1%} of it)")
    return rows


def phase_exchange_time(torch, train):
    """Device time of one consensus exchange of the full 4-node smollm
    state (quantize + combine + packing), beside the step time."""
    from repro_torch.configs import get_config
    setup = train.build_train_setup(get_config("smollm-135m"),
                                    consensus_nodes=NODES, device="cuda")
    state = train.init_train_state(setup, 0)
    from repro_torch.core import tree as T
    x_half = T.tree_map(lambda a: a + 1e-4, state["params"])
    ms = time_ms(lambda: setup.consensus.exchange(
        state["params"], x_half, state["consensus"], 1), reps=5)
    print(f"[timing] one 4-node exchange (pack, noise, 4+4 launches, "
          f"unpack): {ms:.2f} ms")
    return ms


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an "
             "NVIDIA GPU")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"{SRC}/repro_torch not found: run from a checkout of the "
             "repository")
    sys.path.insert(0, SRC)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels import dequant_combine as D
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch import train
    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"[setup] built {sorted(report)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    n_rows = main_path_rows(train)
    errs = phase_kernels(torch, Q, D, n_rows)
    launches, step_s, peak_gb = phase_main(torch, train, Q, D)
    phase_parity(torch, train)
    rows = phase_timing(torch, Q, D, launches, errs, n_rows)
    phase_exchange_time(torch, train)
    print(f"[summary] step {step_s:.4f} s, peak memory {peak_gb:.2f} GB, "
          f"card {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
