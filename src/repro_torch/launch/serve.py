"""Serving: prefill a batch of prompts, then greedy decode token by token.

Counterpart of ``repro.launch.serve``: no FSDP and no consensus nodes
(serving uses one consensus-complete replica of the parameters, as in the
reference), on one device or tensor-parallel over ``T`` ranks (``ctx``, a
process grid's context: the reference's ``(1, T)`` mesh, the batch on
every rank).  At tp > 1 each rank holds its slice of the weights, prefill
and decode run with the tp collectives (``models.layers``), the next
token comes from ``sharded_greedy_sample`` over the ranks' vocabulary
columns (ties to the lowest global id), and every rank returns the same
tokens.  Every architecture serves so in float32: an MoE rank runs its
experts (every rank routes every token alike, so each sees the node's
drops), a Mamba2 rank its SSM heads with their share of the state, and
whisper's frames pass the encoder on every rank, whose cross cache holds
the rank's kv heads::

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.serve --model 2 --arch qwen3-0.6b \\
        --device cuda:0 --batch 4 --prompt-len 512 --new-tokens 16
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.serve --model 2 --arch whisper-small \\
        --periods 4 --encoder-layers 4 --device cuda:0 --batch 4 \\
        --prompt-len 384 --new-tokens 16

``build_prefill_setup`` carries ``prefill_step(params, batch, capacity)
-> (first_ids, cache)``: the full-sequence forward over the prompts, whose
last position gives the first generated token (only that position is
projected onto the vocabulary: the reference's step reads the same
``logits[:, -1:]``), and whose K and V are written into a decode cache of
``capacity`` positions.  An encoder-decoder's batch also carries its
frames ``enc_frames`` (b, T, d): the prefill runs the encoder over them and
writes the cross attention's K and V over all T frames into the cache,
which the decode steps read (a decode batch carries tokens only, as the
reference's).
``build_serve_setup`` carries ``serve_step(state) -> state`` with ``state
= {params, cache, tokens}``: one greedy decode step of every sequence
(``transformer.greedy_decode_step``), through the flash-decode kernel
(``kernels.gqa_decode``), with the next token in ``tokens``.  With
``long_serve`` both cap the attention of 'A' blocks at the config's
``long_context_window`` (gemma2-9b: 32,768); the reference's prefill setup
takes no such flag, its ``model_apply`` does.

CLI (runs on ``cuda`` unless ``--device cpu``; weights are random from
``--seed`` and prompts are token ids drawn from it, then for an
encoder-decoder the frames, standard normal float32 ``(batch,
encoder_frames, d_model)`` from the same generator; ``--periods`` cuts
the depth and keeps the widths, ``--encoder-layers`` an encoder's)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --batch 32 --prompt-len 1984 --new-tokens 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \\
        --periods 2 --long-serve --batch 1 --prompt-len 32832 \\
        --new-tokens 64
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-moe-3b-a800m --batch 32 --prompt-len 1984 \\
        --new-tokens 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
        --batch 32 --prompt-len 2048 --new-tokens 64
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba-v0.1-52b --periods 1 --batch 4 --prompt-len 2048 \\
        --new-tokens 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \\
        --batch 32 --prompt-len 384 --new-tokens 64

The mixture-of-experts archs (granite-moe-3b-a800m, deepseek-moe-16b,
whose dense layer 0 is a prelude with its own cache entry) route with the
reference's capacity: it depends on the tokens a call routes, so a
decode step (``b`` tokens) can drop other assignments than the prefill.
The state-space archs (mamba2-1.3b; jamba-v0.1-52b, whose 'X' blocks route
likewise and whose one 'A' block per period decodes through the
flash-decode kernel) keep a fixed-size state per Mamba2 block, and their
chunked scan takes a prompt whose length is a multiple of ``min(ssm_chunk,
prompt)``: 256 at full size, so 2,048 tokens and not 1,984.  Another
length is refused, as the reference asserts; it is not padded.
whisper-small's decoder learns 32,768 positions, so a larger capacity
(prompt + new tokens) is refused (ValueError); its own decoder context is
448, as in the run above.

``--compute-dtype bfloat16`` declares the weights and runs the model in
bfloat16, and ``--cache-dtype`` sets the decode cache's dtype (the
compute dtype when not given), the reference's ``compute_dtype`` and
``cache_dtype``: the prefill's K and V (and a Mamba2 block's state,
rounded to the compute dtype first) are cast into the cache once, and a
decode step writes its K and V in the cache's dtype; the flash-decode
kernel reads a bfloat16 cache as bfloat16.  The reference's production
serving is bfloat16 for both::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chameleon-34b \\
        --compute-dtype bfloat16 --cache-dtype bfloat16 --batch 4 \\
        --prompt-len 1984 --new-tokens 64
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import mamba2
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import sharded_greedy_sample

__all__ = ["PrefillSetup", "ServeSetup", "build_prefill_setup",
           "build_serve_setup", "main"]


@dataclasses.dataclass
class PrefillSetup:
    cfg: ModelConfig
    defs: TF.ModelDefs
    device: torch.device
    prefill_step: Any


@dataclasses.dataclass
class ServeSetup:
    cfg: ModelConfig
    defs: TF.ModelDefs
    device: torch.device
    serve_step: Any
    cache_dtype: torch.dtype = torch.float32


#: the CLI's names of the compute and cache dtypes
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_prefill_setup(cfg: ModelConfig, device=None, *,
                        compute_dtype=torch.float32,
                        long_serve: bool = False, ctx=None) -> PrefillSetup:
    """Prefill on ``device`` (``cuda`` unless ``device="cpu"``) at
    ``compute_dtype`` (the weights' dtype); ``ctx`` a process grid's
    context runs it over the rank's node group at its ``tp``."""
    dev = resolve_device(device)
    defs = TF.build_defs(cfg, dtype=compute_dtype, ctx=ctx)

    @torch.inference_mode()
    def prefill_step(params, batch, capacity=None, cache_dtype=None):
        """The cache holds ``capacity`` positions (the prompt's length
        when None) in ``cache_dtype`` (the compute dtype when None): the
        prefill's K and V are cast into it once, as the reference's caller
        casts its prefill's compute-dtype cache into the serve cache."""
        tokens, frames = batch["tokens"], batch.get("enc_frames")
        cache = TF.init_cache(cfg, tokens.shape[0],
                              capacity or tokens.shape[1],
                              dtype=cache_dtype or compute_dtype,
                              device=tokens.device,
                              enc_len=None if frames is None
                              else frames.shape[1], tp=defs.tp)
        logits, cache = TF.model_apply(params, defs, batch, mode="prefill",
                                       cache=cache,
                                       compute_dtype=compute_dtype,
                                       long_serve=long_serve,
                                       logits_from=tokens.shape[1] - 1)
        return sharded_greedy_sample(logits, defs.ctx), cache

    return PrefillSetup(cfg=cfg, defs=defs, device=dev,
                        prefill_step=prefill_step)


def build_serve_setup(cfg: ModelConfig, *, device=None,
                      compute_dtype=torch.float32, cache_dtype=None,
                      keep_logits: int = 0,
                      long_serve: bool = False, ctx=None) -> ServeSetup:
    """Decode on ``device`` (``cuda`` unless ``device="cpu"``) at
    ``compute_dtype`` against the state's cache, whose capacity bounds the
    positions and whose dtype is ``cache_dtype`` (the compute dtype when
    None, as in the reference; the setup records it for the prefill).
    With ``keep_logits`` > 0 each step also leaves the logits of the first
    ``keep_logits`` sequences in ``state["logits"]`` (for checks against a
    full forward; at tp > 1 the rank's vocabulary columns).  ``ctx``: as
    :func:`build_prefill_setup`."""
    dev = resolve_device(device)
    defs = TF.build_defs(cfg, dtype=compute_dtype, ctx=ctx)

    @torch.inference_mode()
    def serve_step(state):
        ids, cache, logits = TF.greedy_decode_step(
            state["params"], defs, state["tokens"], state["cache"],
            compute_dtype=compute_dtype, long_serve=long_serve)
        out = {"params": state["params"], "cache": cache, "tokens": ids}
        if keep_logits:
            out["logits"] = logits[:keep_logits]
        return out

    return ServeSetup(cfg=cfg, defs=defs, device=dev, serve_step=serve_step,
                      cache_dtype=cache_dtype or compute_dtype)


def main(argv=None) -> dict:
    """Command-line entry point: prefill ``--batch`` random prompts of
    ``--prompt-len`` tokens, then decode until each sequence has
    ``--new-tokens`` new tokens.  Returns the prompts, an
    encoder-decoder's frames (``frames``) and the generated tokens
    (numpy), the prefill and per-token decode seconds, the peak device
    memory (GB, on the card) and, with ``--keep-logits K``, the logits of
    the first K sequences at each decode step ``(K, new_tokens - 1, V)``:
    step t fed new token t - 1 and predicted new token t."""
    from repro_torch.configs import cut_depth, get_config, reduced
    from repro_torch.models.params import init_params

    ap = argparse.ArgumentParser(description="batched greedy serving "
                                 "(PyTorch port, one device)")
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", help="smoke-size model")
    ap.add_argument("--periods", type=int, default=None,
                    help="cut the depth to this many periods of the layer "
                         "pattern (widths unchanged)")
    ap.add_argument("--encoder-layers", type=int, default=None,
                    help="cut an encoder-decoder's encoder to this many "
                         "layers (widths unchanged)")
    ap.add_argument("--long-serve", action="store_true",
                    help="cap the attention of 'A' blocks at the config's "
                         "long_context_window (long-context serving)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the prompts")
    ap.add_argument("--keep-logits", type=int, default=0,
                    help="return the logits of the first K sequences")
    ap.add_argument("--compute-dtype", default="float32",
                    choices=sorted(DTYPES),
                    help="dtype of the weights and of the model's arithmetic "
                         "(the reference's compute_dtype)")
    ap.add_argument("--cache-dtype", default=None, choices=sorted(DTYPES),
                    help="dtype of the decode cache (default: the compute "
                         "dtype)")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel ranks (the reference's model "
                         "axis): start WORLD_SIZE = model ranks with python "
                         "-m torch.distributed.run")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.new_tokens < 1:
        raise SystemExit("--new-tokens must be at least 1")
    ctx = None
    if args.model > 1:
        from repro_torch.launch.mesh import make_process_context
        ctx = make_process_context(args.device, tp=args.model)
        if ctx.total_consensus_nodes != 1:
            raise NotImplementedError(
                f"--model {args.model} over {ctx.total_consensus_nodes} "
                "nodes: serving with the batch split over a data axis is "
                "not yet ported (ROADMAP Queue 1 item 5d); start WORLD_SIZE "
                "= --model ranks")
    say = print if ctx is None or ctx.global_rank == 0 else (
        lambda *a, **k: None)
    # float32 products in full float32, never TF32 (as the trainer)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    try:
        cfg = cut_depth(cfg, args.periods, args.encoder_layers)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if args.long_serve and not cfg.long_context_window:
        raise SystemExit(f"--long-serve: {cfg.arch_id} has no "
                         "long_context_window")
    if set(cfg.prelude + cfg.period) & set("MX"):
        # the chunked scan's rule, before the weights are built
        mamba2.chunk_len(cfg, args.prompt_len)
    capacity = args.prompt_len + args.new_tokens
    compute_dtype = DTYPES[args.compute_dtype]
    pre = build_prefill_setup(cfg, device=args.device if ctx is None
                              else ctx.device,
                              compute_dtype=compute_dtype,
                              long_serve=args.long_serve, ctx=ctx)
    dev = pre.device
    keep = min(args.keep_logits, args.batch)
    serve = build_serve_setup(
        cfg, device=dev, compute_dtype=compute_dtype,
        cache_dtype=DTYPES[args.cache_dtype] if args.cache_dtype else None,
        keep_logits=keep, long_serve=args.long_serve, ctx=ctx)
    params = init_params(pre.defs.storage, args.seed, dev, tp=args.model,
                         tp_rank=0 if ctx is None else ctx.tp_rank)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           dtype=np.int32)
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    if cfg.frontend == "audio_frames":
        frames = rng.standard_normal(
            (args.batch, cfg.encoder_frames, cfg.d_model), dtype=np.float32)
        batch["enc_frames"] = torch.as_tensor(frames, device=dev)
    say(f"arch={cfg.arch_id} layers={cfg.n_layers} device={dev} "
          f"batch={args.batch} prompt={args.prompt_len} +{args.new_tokens} "
          f"tokens (capacity {capacity}) compute {args.compute_dtype} "
        f"cache {str(serve.cache_dtype).removeprefix('torch.')}"
        + (" long-serve" if args.long_serve else "")
        + (f" tp={args.model}" if ctx is not None else ""), flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync()
    t0 = time.perf_counter()
    first_ids, cache = pre.prefill_step(params, batch, capacity,
                                        serve.cache_dtype)
    sync()
    prefill_s = time.perf_counter() - t0
    logits = []
    state = {"params": params, "cache": cache, "tokens": first_ids}
    out = [first_ids]
    sync()
    t0 = time.perf_counter()
    for _ in range(args.new_tokens - 1):
        state = serve.serve_step(state)
        out.append(state["tokens"])
        if keep:
            logits.append(state["logits"])
    sync()
    steps = args.new_tokens - 1
    decode_s = (time.perf_counter() - t0) / max(steps, 1)
    gen = torch.cat(out, dim=1).cpu().numpy()
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)
    say(f"prefill: {prefill_s:.4f} s; decode: {steps} steps, "
        f"{decode_s * 1e3:.3f} ms/token for the batch"
        + (f"; peak memory {peak:.2f} GB" if peak is not None else ""))
    for b in range(min(args.batch, 4)):
        say(f"  seq {b}: {gen[b].tolist()}")
    result = {"prompts": prompts, "tokens": gen, "prefill_s": prefill_s,
              "decode_s_per_token": decode_s, "peak_gb": peak,
              "cache_len": state["cache"]["len"]}
    if "enc_frames" in batch:
        result["frames"] = frames
    if ctx is not None:
        result["tp_stats"] = ctx.tp_stats()
    if keep:
        result["logits"] = (torch.stack(logits, dim=1).cpu().numpy()
                            if logits else np.zeros(
                                (keep, 0, pre.defs.storage["embed"]["table"]
                                 .shape[0] // args.model), np.float32))
    return result


if __name__ == "__main__":
    main()
