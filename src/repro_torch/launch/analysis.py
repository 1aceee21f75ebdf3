"""Roofline terms and the model-FLOPs account of a step, on one H100.

Counterpart of ``repro.launch.analysis``.  A step's cost comes from
``launch.op_cost`` (the ops it runs, counted as it runs, on the card or on
the ``meta`` device) instead of the reference's HLO, and the hardware model
is the card's, not a TPU's.  Roofline terms, in seconds per step::

    compute    = flops / peak_flops[compute dtype]
    memory     = hbm_bytes / hbm_bw
    collective = collective_bytes_per_chip / link_bw

On one card the consensus nodes are a stacked axis, so nothing crosses a
link; ``collective_bytes_per_chip`` is the exchange's static wire bytes per
node and step (``ConsensusRuntime.wire_bytes_per_step``), what one node
would put on the ring of several cards, priced at ``link_bw``.
``roofline`` takes any ``hw``, so a caller can price the paper's slow link
instead.

``collective_bytes(hlo_text)`` of the reference is not ported: it reads the
collectives of an SPMD HLO module, which the port's grids do not compile
to (ROADMAP Queue 1, item 5d-5).
"""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["HW", "H100", "roofline", "model_flops_per_step",
           "summarize_combo"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One card's published rates (NVIDIA's H100 SXM data sheet, dense,
    at its 700 W power limit)."""

    name: str = "NVIDIA H100 80GB HBM3"
    #: FLOP/s per compute dtype: float32 outside the tensor cores (the
    #: port's float32 products run without TF32) and bfloat16 dense
    peak_flops: dict = dataclasses.field(default_factory=lambda: {
        "float32": 67e12, "bfloat16": 989e12})
    hbm_bw: float = 3.35e12            # bytes/s
    hbm_bytes: float = 80e9            # device memory
    #: bytes/s one way between two cards: NVLink 4 at 900 GB/s both ways,
    #: the link a ring over several cards of one host would take
    link_bw: float = 450e9


H100 = HW()


def _peak(hw, dtype: str) -> float:
    """The compute rate of ``hw`` at ``dtype``: its table's entry, or a
    plain rate (the reference's ``HW`` has one ``peak_flops``)."""
    peak = hw.peak_flops
    return peak[dtype] if isinstance(peak, dict) else float(peak)


def roofline(flops: float, hbm_bytes: float, coll_bytes_per_chip: float,
             chips: int, hw: Any = H100,
             dtype: str = "float32") -> dict[str, Any]:
    """Three roofline terms (seconds) of per-chip ``flops`` and
    ``hbm_bytes`` and the bytes one chip puts on its link; the dominant
    one is the step's bound.  ``dtype`` picks the peak (``hw.peak_flops``
    may also be one number, as the reference's)."""
    compute_s = flops / _peak(hw, dtype)
    memory_s = hbm_bytes / hw.hbm_bw
    collective_s = coll_bytes_per_chip / hw.link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    terms["dominant"] = dominant
    terms["bound_s"] = terms[dominant]
    return terms


def model_flops_per_step(n_active_params: float, tokens_per_step: float,
                         kind: str = "train") -> float:
    """MODEL_FLOPS = 6*N*D for training, 2*N*D for inference-forward."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens_per_step


def summarize_combo(arch: str, shape: str, mesh_name: str, chips: int,
                    cost, collective_bytes_per_chip: float,
                    n_active_params: float, tokens_per_step: float,
                    kind: str, dtype: str = "float32", hw: Any = H100,
                    extra: dict | None = None) -> dict:
    """The reference's record of one (arch x shape x mesh) from a counted
    step (``op_cost.OpCost``): its FLOPs and bytes, the roofline terms, the
    model FLOPs and their share of the counted ones.  The reference's
    HLO-only keys (``xla_cost_analysis_*``, ``unknown_trip_loops``) have
    no counterpart; ``launches`` and ``kernels`` are the port's."""
    flops, hbm = cost.flops / chips, cost.hbm_bytes / chips
    rf = roofline(flops, hbm, collective_bytes_per_chip, chips, hw, dtype)
    mflops_per_chip = model_flops_per_step(n_active_params, tokens_per_step,
                                           kind) / chips
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "chips": chips,
        "hw": hw.name, "dtype": dtype,
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": hbm,
        "collective_bytes_per_chip": collective_bytes_per_chip,
        "collective_breakdown": {"ring": collective_bytes_per_chip},
        **rf,
        "model_flops_per_chip": mflops_per_chip,
        "useful_flops_ratio": (mflops_per_chip / flops) if flops else 0.0,
        "n_launches": cost.n_launches,
        "kernels": dict(sorted(cost.kernels.items())),
    }
    if extra:
        rec.update(extra)
    return rec
