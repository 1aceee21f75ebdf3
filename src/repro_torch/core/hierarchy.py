"""Two-level hierarchical consensus: port of ``repro.core.hierarchy``.

Inside a pod the links are fast, between pods they are slow, so only the
pod ring is worth compressing.  :class:`HierarchySpec` declares the two
levels over the consensus-node ring:

  inner   every pod of ``m = n // pods`` consecutive nodes averages its
          optimizer delta each step in fp32, so all members enter the
          outer exchange holding the same parameters;
  outer   one representative per pod runs the compressed ADC exchange
          over the pod ring (any transport or wire plan, under a
          membership schedule whose masks index pods).

The effective mixing is ``W_outer (x) (1/m) 11^T``
(:func:`repro_torch.core.topology.hierarchical_mixing`).  ``pods == n`` is
the flat ring and ``pods == 1`` the all-reduce, bit for bit.  The runtime
lives in :mod:`repro_torch.core.distributed` (``ConsensusConfig(hierarchy=
...)``), the single-process rule in :func:`repro_torch.core.consensus.
run_hierarchical`.
"""
from __future__ import annotations

import dataclasses

__all__ = ["HierarchySpec"]

#: fp32 element size of the inner all-reduce's wire model
_INNER_ITEMSIZE = 4.0


@dataclasses.dataclass(frozen=True)
class HierarchySpec:
    """``pods`` equal groups of consecutive consensus nodes.  ``pods``
    counts groups (the outer ring's length): ``pods == n`` means singleton
    pods (the flat ring), ``pods == 1`` one pod of every node."""

    pods: int = 1

    def __post_init__(self):
        if self.pods < 1:
            raise ValueError(f"hierarchy pods must be >= 1, got {self.pods}")

    @classmethod
    def from_spec(cls, spec) -> "HierarchySpec":
        """An int, ``"pods=P"`` (the trainer's ``--hierarchy``) or a
        :class:`HierarchySpec`, as a spec."""
        if isinstance(spec, HierarchySpec):
            return spec
        if isinstance(spec, int):
            return cls(pods=spec)
        s = str(spec).strip()
        if s.startswith("pods="):
            try:
                return cls(pods=int(s[len("pods="):]))
            except ValueError:
                pass
        raise ValueError(
            f"unrecognized hierarchy spec {spec!r}; expected 'pods=P', "
            "an int pod count, or a HierarchySpec")

    def pod_size(self, n_nodes: int) -> int:
        """Members per pod (``m``); pods must tile the nodes exactly."""
        if n_nodes % self.pods != 0:
            raise ValueError(
                f"hierarchy pods={self.pods} does not divide the "
                f"{n_nodes}-node consensus set into equal pods")
        return n_nodes // self.pods

    def pod_psum_groups(self, n_nodes: int, fsdp: int) -> tuple:
        """The inner average's groups of device indices: one pod's ``m``
        members at one FSDP rank each (ranks hold different shards)."""
        m = self.pod_size(n_nodes)
        return tuple(
            tuple((g * m + j) * fsdp + f for j in range(m))
            for g in range(self.pods) for f in range(fsdp))

    def inner_bytes_per_step(self, n_elements: int, n_nodes: int) -> float:
        """Intra-pod bytes per member per step of an fp32 ring all-reduce,
        ``2 (m-1)/m * 4 * n_elements``; zero for singleton pods."""
        m = self.pod_size(n_nodes)
        if m <= 1:
            return 0.0
        return 2.0 * (m - 1) / m * _INNER_ITEMSIZE * n_elements

    def describe(self, n_nodes: int) -> str:
        m = self.pod_size(n_nodes)
        return (f"hierarchy[{self.pods} pods x {m} nodes: inner fp32 "
                f"psum-average, outer compressed ring over {self.pods} "
                "representatives]")
