"""PyTorch/CUDA port of the ADC-DGD decentralized-training system.

Mirrors the layout of the JAX reference package ``repro`` (same subpackage
and module names), but imports neither ``jax`` nor ``repro``.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; every Pallas TPU
kernel on the ported path is a hand-written CUDA kernel for Hopper
(``repro_torch.kernels``) with a plain PyTorch version beside it.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    Raises when CUDA is asked for (explicitly or by default) but absent —
    the port never falls back to the CPU on its own; pass ``device="cpu"``
    to run the plain PyTorch versions of the kernels there.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return dev
