"""Decentralized LM training on the PyTorch port: ADC-DGD vs DGD vs all-reduce.

The port's counterpart of ``examples/decentralized_train.py``: data-parallel
training where the parameter exchange between consensus nodes goes over
slow links, so it ships int8-compressed amplified differentials (the
paper's Algorithm 2) instead of fp32 parameters or an all-reduce.  Two
consensus nodes are a stacked axis of one card (``launch.train``), with
no FSDP; the exchange of ADC-DGD launches the quantize and dequant-combine
kernels once per node and step.  It trains a reduced SmolLM-family model
(``--full-size`` the full config) and reports loss, consensus error and
the wire bytes per step of each algorithm.

Run (on ``cuda`` unless ``--device cpu``)::

    PYTHONPATH=src python examples/torch_decentralized_train.py
    PYTHONPATH=src python examples/torch_decentralized_train.py --steps 300
    PYTHONPATH=src python examples/torch_decentralized_train.py \\
        --arch qwen3-0.6b --device cpu --steps 20
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device

NODES = 2
ALGORITHMS = (("adc_dgd", {"quant_mode": "adaptive"}), ("dgd", {}),
              ("allreduce", {}))


def main(argv=None) -> dict:
    """Prints the losses and the summary; returns ``{algorithm: {"losses",
    "cerr", "wire", "dt"}}`` (``wire``: bytes one node puts on the ring
    per step, both directions)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1.0)
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--full-size", action="store_true",
                    help="train the full config instead of the reduced one")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduced
    from repro_torch.core import tree as T
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch import train as LT

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = reduced(cfg)
    print(f"arch={cfg.arch_id}  params={cfg.param_count() / 1e6:.1f}M  "
          f"device={dev}  consensus nodes={NODES} (stacked on one device)")
    ds_kw = {}
    if cfg.frontend == "audio_frames":
        ds_kw = dict(enc_frames=cfg.encoder_frames, d_model=cfg.d_model)
    ds = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch,
                            n_shards=NODES, **ds_kw)

    results = {}
    for alg, kw in ALGORITHMS:
        setup = LT.build_train_setup(
            cfg, consensus_nodes=NODES, algorithm=alg, lr=args.lr,
            gamma=args.gamma, track_consensus_error=(alg != "allreduce"),
            device=dev, **kw)
        state = LT.init_train_state(setup, 0)
        rt = setup.consensus
        layout = rt.state_layout(state["params"])
        wire = rt.wire_bytes_per_step(layout.n_elements, layout)
        losses, cerr = [], []
        t0 = time.perf_counter()
        for step in range(args.steps):
            state, m = LT.train_step(setup, state,
                                     ds.global_batch_arrays(step))
            losses.append(m["loss"])
            if "consensus_err" in m:
                cerr.append(m["consensus_err"])
            if step % max(1, args.steps // 6) == 0:
                extra = f" cerr={cerr[-1]:.3g}" if cerr else ""
                print(f"  [{alg:>9}] step {step:4d} loss={losses[-1]:.4f}"
                      f"{extra}", flush=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        results[alg] = dict(losses=losses, cerr=cerr, wire=wire, dt=dt,
                            n_params=sum(a[0].numel() for a in
                                         T.tree_leaves(state["params"])))
        print(f"  [{alg:>9}] done in {dt:.1f}s "
              f"({dt / args.steps * 1e3:.0f} ms/step), "
              f"wire bytes/step/node={wire:,.0f}")

    print("\nsummary (mean of last 10 losses):")
    for alg, r in results.items():
        tail = float(np.mean(r["losses"][-10:]))
        print(f"  {alg:>9}: loss={tail:.4f}  "
              f"wire/step/node={r['wire']:>12,.0f} B"
              + (f"  consensus_err={r['cerr'][-1]:.4g}" if r["cerr"]
                 else ""))
    adc, dgd = results["adc_dgd"], results["dgd"]
    if dgd["wire"]:
        gap = abs(np.mean(adc["losses"][-10:]) - np.mean(dgd["losses"][-10:]))
        print(f"\nADC-DGD transmits {dgd['wire'] / adc['wire']:.2f}x fewer "
              f"bytes than uncompressed DGD while tracking its loss within "
              f"{gap:.3f}.")
    return results


if __name__ == "__main__":
    main()
