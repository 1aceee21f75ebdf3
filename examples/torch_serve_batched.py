"""Batched serving on the PyTorch port: prefill + greedy decode on one card.

The port's counterpart of ``examples/serve_batched.py``:
  1. prefill a batch of prompts (``build_prefill_setup``), which writes the
     decode cache of ``prompt + new tokens`` positions,
  2. decode token by token with single-token serve steps
     (``build_serve_setup``): every attention layer's step is the
     flash-decode kernel (``kernels.gqa_decode``) on the card.

Works for every architecture of the registry, reduced (``--full-size``
serves the full config): attention archs (KV cache), state-space archs
(recurrent state; ``--arch mamba2-1.3b``), hybrids (``--arch
jamba-v0.1-52b``) and the encoder-decoder (``--arch whisper-small``, with
its frames).  The reference's mesh and sharded cache wait for a ring over
several cards.

Run (on ``cuda`` unless ``--device cpu``)::

    PYTHONPATH=src python examples/torch_serve_batched.py
    PYTHONPATH=src python examples/torch_serve_batched.py --arch mamba2-1.3b
    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device


def main(argv=None) -> dict:
    """Prints the first tokens, the decode rate and every sequence;
    returns ``{"tokens": (batch, new_tokens) int32, "prompts", "prefill_s",
    "decode_s_per_token"}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--full-size", action="store_true",
                    help="serve the full config instead of the reduced one")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import (build_prefill_setup,
                                          build_serve_setup)
    from repro_torch.models.params import init_params

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = reduced(cfg)
    capacity = args.prompt_len + args.new_tokens
    print(f"arch={cfg.arch_id} device={dev} batch={args.batch} "
          f"prompt={args.prompt_len} +{args.new_tokens} tokens")

    # --- params (one replica; serving has no consensus nodes) ----------
    pre = build_prefill_setup(cfg, device=dev)
    params = init_params(pre.defs.storage, args.seed, dev)

    # --- prefill -------------------------------------------------------
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           dtype=np.int32)
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    if cfg.frontend == "audio_frames":
        batch["enc_frames"] = torch.as_tensor(rng.standard_normal(
            (args.batch, cfg.encoder_frames, cfg.d_model), dtype=np.float32),
            device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    first_ids, cache = pre.prefill_step(params, batch, capacity)
    sync()
    prefill_s = time.perf_counter() - t0
    print(f"prefill: {prefill_s:.3f}s -> first tokens "
          f"{first_ids[:, 0].tolist()}")

    # --- decode: the cache already holds `capacity` positions ----------
    serve = build_serve_setup(cfg, device=dev)
    state = {"params": params, "cache": cache, "tokens": first_ids}
    out = [first_ids]
    t0 = time.perf_counter()
    for _ in range(args.new_tokens - 1):
        state = serve.serve_step(state)
        out.append(state["tokens"])
    sync()
    dt = time.perf_counter() - t0
    gen = torch.cat(out, dim=1).cpu().numpy()
    print(f"decode: {args.new_tokens - 1} steps in {dt:.3f}s "
          f"({dt / max(args.new_tokens - 1, 1) * 1e3:.1f} ms/token/batch)")
    for b in range(args.batch):
        print(f"  seq {b}: {gen[b].tolist()}")
    if not ((gen >= 0) & (gen < cfg.vocab_size)).all():
        raise SystemExit("serve_batched: a token id outside the vocabulary")
    print("ok: batched serve produced tokens")
    return {"tokens": gen, "prompts": prompts, "prefill_s": prefill_s,
            "decode_s_per_token": dt / max(args.new_tokens - 1, 1)}


if __name__ == "__main__":
    main()
