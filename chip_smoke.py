#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. setup   — prints the card's name and power limit, builds every CUDA
             kernel from ``src/repro_torch/kernels/csrc`` (one nvcc each, in
             parallel) and prints the build seconds;
2. kernels — holds each kernel to its plain PyTorch version on the card at
             the main path's shape (the payload rows of the full smollm-135m
             wire layout, 262,752) and on a ragged chunk view, fixed and
             adaptive, float32 and bfloat16: int8, int4, int2 and top-k
             (k = 16, 64, 256) payload bytes must be equal, the three
             combines' outputs bitwise equal or within 1 ulp;
3. main    — ``repro_torch.launch.train.main`` on the full smollm-135m, 4
             ADC-DGD nodes (fixed grid), each run with every launch counter
             zeroed just before it: 5 steps of the int8 wire, then 3 steps
             each of ``--wire-codec int4``, ``int2`` and ``topk``: losses
             finite and near ln(vocab) at random init, the codec's two
             kernels launched 4 x steps times and no other kernel, the wire
             bytes per step as the codec's payload width says; then 6 steps
             of ``--wire-codec adaptive`` over int2/int4/int8 with a codec
             period of 2, whose launches must match the codec it chose at
             each step; then 2 steps of the int8 wire in adaptive mode;
4. parity  — reduced smollm-135m, 2 steps on the card and on the CPU from
             the same weights and quantization noise, for the int8, int4
             and top-k wires: final parameters agree to float32 rounding but
             in at most MAX_FRAC_OFF of the elements, and those within
             MAX_GRID_STEPS quantization grid steps; losses within LOSS_RTOL;
5. timing  — each kernel and its plain version, median of 25 launches
             timed with CUDA events, beside the least time the card needs
             for the bytes and operations (H100 SXM data sheet rates);
             the step time of each codec, the exchange time of each codec
             and the peak memory.

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
CODEC_STEPS, ADAPTIVE_STEPS = 3, 6
TIMING_REPS = 25

#: bytes one node puts on the ring per step at the main path's 262,752
#: payload rows: 2 x rows x payload width (516, 258, 130 and 130 bytes)
WIRE_BYTES = {"int8": 271_160_064, "int4": 135_580_032,
              "int2": 68_315_520, "topk": 68_315_520}

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


def phase_codec_kernels(torch, BP, n_rows):
    """The sub-byte and top-k encoders and combines against their plain
    versions at the main path's rows and on a ragged chunk view."""
    from repro_torch.core.codec import by_name
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    y = torch.randn((n_rows, BLOCK), generator=g, device=dev) * 0.05
    # one noise buffer of top-k's width; the sub-byte encoders read its
    # leading BLOCK columns through the row stride
    u = torch.rand((n_rows, 2 * BLOCK), generator=g, device=dev)
    ragged = dict(row_offset=37, n_rows=1001)
    errs = {}
    for name, kernel, plain, decode, params in (
            ("subbyte_encode_payload", BP.subbyte_encode_payload,
             BP.subbyte_encode_plain, BP.subbyte_decode_plain, (4, 2)),
            ("topk_encode_payload", BP.topk_encode_payload,
             BP.topk_encode_plain, BP.topk_decode_plain, (16, 64, 256))):
        worst = 0.0
        for param in params:
            for dt in (torch.float32, torch.bfloat16):
                yy = y.to(dt)
                for step in (None, 1e-3):
                    for view in ({}, ragged):
                        a = kernel(yy, u, param, step, **view)
                        b = plain(yy, u, param, step, **view)
                        torch.cuda.synchronize()
                        if not torch.equal(a, b):
                            fail(f"{name} {param} {dt} step={step} "
                                 f"view={view}: {int((a != b).any(1).sum())}"
                                 " rows differ from the plain version")
                        worst = max(worst, float(
                            (decode(a, param) - decode(b, param)).abs().max()))
        errs[name] = worst
        print(f"[kernels] {name}: bytes equal to the plain version for "
              f"{params} (fixed+adaptive, f32+bf16, full {n_rows} rows + "
              f"ragged view), max |decoded diff| {worst}")
    xt = torch.randn((n_rows, BLOCK), generator=g, device=dev)
    mb = torch.randn((n_rows, BLOCK), generator=g, device=dev)
    for name, codecs in (("subbyte_decode_combine", ("int4", "int2")),
                         ("topk_decode_combine",
                          ("topk:k=16", "topk", "topk:k=256"))):
        worst_ulp, worst_abs = 0, 0.0
        for spec in codecs:
            cd = by_name(spec)
            param = getattr(cd, "code_bits", None) or cd.k
            plain = (BP.subbyte_combine_plain if name.startswith("subbyte")
                     else BP.topk_combine_plain)
            pays = [cd.encode_payload(y * (i + 1), u, 1e-3) for i in range(3)]
            cases = [(pays, {}),
                     ([p[37:1038].contiguous() for p in pays], ragged),
                     (pays, ragged)]
            for deamp in (1.0, 0.37):
                for ps, view in cases:
                    a = cd.decode_combine(*ps, xt, mb, 0.5, 0.25, deamp,
                                          **view)
                    b = plain(*ps, xt, mb, 0.5, 0.25, deamp, param, **view)
                    torch.cuda.synchronize()
                    for x, z in zip(a, b):
                        worst_ulp = max(worst_ulp, ulp_diff(x, z))
                        worst_abs = max(worst_abs, float((x - z).abs().max()))
        if worst_ulp > 1:
            fail(f"{name} differs from the plain version by {worst_ulp} ulp")
        why = ("bitwise equal" if worst_ulp == 0 else
               "1 ulp: a product/sum rounded in another order")
        print(f"[kernels] {name} {codecs}: {why} (max ulp {worst_ulp})")
        errs[name] = worst_abs
    return errs


#: the two kernels each codec's exchange launches
CODEC_KERNELS = {
    "int8": ("quantize_payload", "dequant_combine_payload"),
    "int4": ("subbyte_encode_payload", "subbyte_decode_combine"),
    "int2": ("subbyte_encode_payload", "subbyte_decode_combine"),
    "topk": ("topk_encode_payload", "topk_decode_combine"),
}


def train_argv(steps: int, *extra: str) -> list[str]:
    return ["--arch", "smollm-135m", "--algorithm", "adc_dgd", "--nodes",
            str(NODES), "--batch", str(4 * NODES), "--seq", "512",
            "--steps", str(steps), "--quant-mode", "fixed", "--lr", "1e-2",
            "--device", "cuda", *extra]


def run_counted(torch, train, entries, argv):
    """One trainer run with every launch counter zeroed just before it and
    read just after; also its peak device memory."""
    for entry in entries.values():
        entry.launches = 0
    torch.cuda.reset_peak_memory_stats()
    hist = train.main(argv)
    launches = {name: entry.launches for name, entry in entries.items()}
    return hist, launches, torch.cuda.max_memory_allocated() / 1e9


def expected_launches(entries, codecs) -> dict:
    """Launches per kernel for a run whose steps used ``codecs``."""
    want = {name: 0 for name in entries}
    for codec in codecs:
        for name in CODEC_KERNELS[codec]:
            want[name] += NODES
    return want


def phase_main(torch, train, entries):
    main_launches = {name: 0 for name in entries}
    step_s, peak_gb = {}, {}
    for codec, steps in (("int8", STEPS), ("int4", CODEC_STEPS),
                         ("int2", CODEC_STEPS), ("topk", CODEC_STEPS)):
        extra = () if codec == "int8" else ("--wire-codec", codec)
        hist, launches, peak_gb[codec] = run_counted(
            torch, train, entries, train_argv(steps, *extra))
        want = expected_launches(entries, [codec] * steps)
        if launches != want:
            fail(f"{codec} run launched {launches}, want {want} "
                 f"({NODES} nodes x {steps} steps of its two kernels)")
        for name in CODEC_KERNELS[codec]:
            main_launches[name] += launches[name]
        losses = [h["loss"] for h in hist]
        if not all(math.isfinite(x) for x in losses):
            fail(f"{codec}: non-finite loss: {losses}")
        if abs(losses[0] - math.log(49152)) > 0.5:
            fail(f"{codec}: step-1 loss {losses[0]} far from ln(49152) at "
                 "random init")
        wire = hist[-1]["wire_bytes_per_step"]
        if wire != WIRE_BYTES[codec] or {h["codec"] for h in hist} != {codec}:
            fail(f"{codec}: wire_bytes_per_step {wire} (want "
                 f"{WIRE_BYTES[codec]}), codecs {[h['codec'] for h in hist]}")
        step_s[codec] = statistics.median(h["step_s"] for h in hist[1:])
        print(f"[main] smollm-135m x {NODES} nodes, adc_dgd fixed, "
              f"{codec} wire: losses {losses}; launches "
              f"{ {n: v for n, v in launches.items() if v} }; "
              f"wire_bytes_per_step {wire:.0f}; overflow_frac "
              f"{[h['overflow_frac'] for h in hist]}; median step "
              f"{step_s[codec]:.4f} s; peak memory {peak_gb[codec]:.2f} GB")
    hist, launches, _ = run_counted(
        torch, train, entries, train_argv(
            ADAPTIVE_STEPS, "--wire-codec", "adaptive", "--codec-ladder",
            "int2,int4,int8", "--codec-period", "2"))
    codecs = [h["codec"] for h in hist]
    want = expected_launches(entries, codecs)
    if launches != want or not all(math.isfinite(h["loss"]) for h in hist):
        fail(f"adaptive codec run: codecs per step {codecs}, launches "
             f"{launches}, want {want}, losses {[h['loss'] for h in hist]}")
    print(f"[main] adaptive codec (ladder int2,int4,int8, period 2): codec "
          f"per step {codecs}; launches "
          f"{ {n: v for n, v in launches.items() if v} } match them")
    hist_a = train.main(["--arch", "smollm-135m", "--nodes", str(NODES),
                         "--batch", str(4 * NODES), "--seq", "512",
                         "--steps", "2", "--quant-mode", "adaptive",
                         "--lr", "1e-2", "--device", "cuda"])
    if not all(math.isfinite(h["loss"]) for h in hist_a):
        fail(f"non-finite adaptive-mode loss: {hist_a}")
    print(f"[main] adaptive mode: losses {[h['loss'] for h in hist_a]}")
    return main_launches, step_s, peak_gb


def phase_parity(torch, train):
    """The same two steps of reduced smollm-135m on the card and on the
    CPU (plain versions), from the same weights, batches and noise, for the
    int8, int4 and top-k wires."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.core import tree as T
    cfg = reduced(get_config("smollm-135m"))
    for codec in ("int8", "int4", "topk"):
        base = None
        results = {}
        for dev in ("cpu", "cuda"):
            setup = train.build_train_setup(cfg, consensus_nodes=NODES,
                                            lr=1e-2, wire_codec=codec,
                                            device=dev)
            state = train.init_train_state(
                setup, 0, params=None if base is None else T.tree_map(
                    lambda a: a.to(dev), base))
            base = state["params"]
            ds = SyntheticLMDataset(cfg.vocab_size, 64, 2 * NODES,
                                    n_shards=NODES)
            layout = setup.consensus.state_layout(state["params"])
            cols = setup.consensus.codec.noise_cols(BLOCK)
            losses = []
            for step in range(2):
                noise = torch.rand(
                    (NODES, layout.n_rows, cols),
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
            fail(f"{codec} card vs CPU: params differ by up to {diff} (limit "
                 f"{MAX_GRID_STEPS * grid}) in a share {frac_off} of the "
                 f"elements (limit {MAX_FRAC_OFF}), losses {l_cpu} vs "
                 f"{l_gpu}")
        print(f"[parity] reduced smollm-135m, {codec} wire, 2 steps card vs "
              f"CPU: max |param diff| {diff!r}, share off by more than "
              f"{FLOAT_ATOL} {frac_off!r}, losses {l_gpu} vs {l_cpu}")


def phase_timing(torch, Q, D, BP, launches, errs, n_rows):
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    y = torch.randn((n_rows, BLOCK), generator=g, device="cuda") * 0.05
    u = torch.rand((n_rows, 2 * BLOCK), generator=g, device="cuda")
    u8 = u[:, :BLOCK].contiguous()
    xt = torch.randn((n_rows, BLOCK), generator=g, device="cuda")
    mb = torch.randn((n_rows, BLOCK), generator=g, device="cuda")
    pays = [Q.quantize_payload(y * (i + 1), u8, 1e-3) for i in range(3)]
    p4 = [BP.subbyte_encode_payload(y * (i + 1), u, 4, 1e-3)
          for i in range(3)]
    p2 = [BP.subbyte_encode_payload(y * (i + 1), u, 2, 1e-3)
          for i in range(3)]
    pk = [BP.topk_encode_payload(y * (i + 1), u, 64, 1e-3) for i in range(3)]
    rows_b = n_rows * BLOCK * 4              # one fp32 (n_rows, 512) operand

    def enc_bytes(noise_cols, width):        # y + the noise read + payload
        return rows_b + n_rows * noise_cols * 4 + n_rows * width

    def comb_bytes(width):                   # 3 payloads + 2 shadows + 3 out
        return 3 * n_rows * width + 5 * rows_b

    ops_per = n_rows * BLOCK
    # (name, kernel, plain, bytes, float ops, source, TPU kernel replaced);
    # ops per element: encoders ~10 (abs/max, div, floor, sub, cmp, add,
    # clip), top-k ~25 (one logf counted as 15), combines 13-14
    cases = [
        ("quantize_payload", lambda: Q.quantize_payload(y, u8, 1e-3),
         lambda: Q.quantize_payload_plain(y, u8, 1e-3),
         enc_bytes(BLOCK, PAYLOAD), ops_per * 10,
         "src/repro_torch/kernels/csrc/quantize_payload.cu",
         "src/repro/kernels/quantize.py:246"),
        ("dequant_combine_payload",
         lambda: D.dequant_combine_payload(*pays, xt, mb, 0.5, 0.25, 1.0),
         lambda: D.dequant_combine_payload_plain(*pays, xt, mb, 0.5, 0.25,
                                                 1.0),
         comb_bytes(PAYLOAD), ops_per * 13,
         "src/repro_torch/kernels/csrc/dequant_combine_payload.cu",
         "src/repro/kernels/dequant_combine.py:113"),
        ("subbyte_encode_payload",
         lambda: BP.subbyte_encode_payload(y, u, 4, 1e-3),
         lambda: BP.subbyte_encode_plain(y, u, 4, 1e-3),
         enc_bytes(BLOCK, 258), ops_per * 10,
         "src/repro_torch/kernels/csrc/subbyte_encode.cu",
         "src/repro/kernels/bitpack.py:430"),
        ("subbyte_decode_combine",
         lambda: BP.subbyte_decode_combine(*p4, xt, mb, 0.5, 0.25, 1.0, 4),
         lambda: BP.subbyte_combine_plain(*p4, xt, mb, 0.5, 0.25, 1.0, 4),
         comb_bytes(258), ops_per * 13,
         "src/repro_torch/kernels/csrc/subbyte_combine.cu",
         "src/repro/kernels/bitpack.py:441"),
        ("topk_encode_payload",
         lambda: BP.topk_encode_payload(y, u, 64, 1e-3),
         lambda: BP.topk_encode_plain(y, u, 64, 1e-3),
         enc_bytes(BLOCK + 64, 130), ops_per * 25,
         "src/repro_torch/kernels/csrc/topk_encode.cu",
         "src/repro/kernels/bitpack.py:455"),
        ("topk_decode_combine",
         lambda: BP.topk_decode_combine(*pk, xt, mb, 0.5, 0.25, 1.0, 64),
         lambda: BP.topk_combine_plain(*pk, xt, mb, 0.5, 0.25, 1.0, 64),
         comb_bytes(130), ops_per * 14,
         "src/repro_torch/kernels/csrc/topk_combine.cu",
         "src/repro/kernels/bitpack.py:467"),
    ]
    rows = []
    for name, fn, plain, nb, no, src, repl in cases:
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
    # int2 runs the same two kernels as int4 (template on the code width)
    for name, fn, nb in (
            ("subbyte_encode_payload int2",
             lambda: BP.subbyte_encode_payload(y, u, 2, 1e-3),
             enc_bytes(BLOCK, 130)),
            ("subbyte_decode_combine int2",
             lambda: BP.subbyte_decode_combine(*p2, xt, mb, 0.5, 0.25, 1.0,
                                               2),
             comb_bytes(130))):
        ms = time_ms(fn)
        b_ms, _ = bound(nb, 0)
        print(f"[timing] {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by bytes: "
              f"{nb / 1e9:.4f} GB, {ms and b_ms / ms:.1%} of it)")
    return rows


def phase_exchange_time(torch, train):
    """Device time of one consensus exchange of the full 4-node smollm
    state (encode + combine + packing + noise) for each codec."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    setup = train.build_train_setup(get_config("smollm-135m"),
                                    consensus_nodes=NODES, device="cuda")
    state = train.init_train_state(setup, 0)
    x_half = T.tree_map(lambda a: a + 1e-4, state["params"])
    out = {}
    for codec in ("int8", "int4", "int2", "topk"):
        rt = train.with_codec(setup, codec).consensus
        out[codec] = time_ms(lambda: rt.exchange(
            state["params"], x_half, state["consensus"], 1), reps=5)
        print(f"[timing] one 4-node {codec} exchange (pack, noise, 4+4 "
              f"launches, unpack): {out[codec]:.2f} ms")
    return out


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
    from repro_torch.kernels import bitpack as BP
    from repro_torch.kernels import dequant_combine as D
    from repro_torch.kernels import quantize as Q
    from repro_torch.launch import train
    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"[setup] built {sorted(report)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    entries = {"quantize_payload": Q.quantize_payload,
               "dequant_combine_payload": D.dequant_combine_payload,
               "subbyte_encode_payload": BP.subbyte_encode_payload,
               "subbyte_decode_combine": BP.subbyte_decode_combine,
               "topk_encode_payload": BP.topk_encode_payload,
               "topk_decode_combine": BP.topk_decode_combine}
    n_rows = main_path_rows(train)
    errs = phase_kernels(torch, Q, D, n_rows)
    errs.update(phase_codec_kernels(torch, BP, n_rows))
    launches, step_s, peak_gb = phase_main(torch, train, entries)
    phase_parity(torch, train)
    rows = phase_timing(torch, Q, D, BP, launches, errs, n_rows)
    exchange_ms = phase_exchange_time(torch, train)
    for codec in step_s:
        print(f"[summary] {codec}: step {step_s[codec]:.4f} s, exchange "
              f"{exchange_ms[codec]:.2f} ms, peak memory "
              f"{peak_gb[codec]:.2f} GB, card {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
