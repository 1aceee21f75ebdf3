"""Deterministic synthetic LM data pipeline (a copy of the reference's).

Numpy only, so this is ``repro.data.pipeline.SyntheticLMDataset`` verbatim:
the same (seed, step, shard) gives byte-identical batches in both packages.

Generates a learnable token stream: a mixture of (a) a fixed-order Markov
chain over the vocabulary (so a real model can reduce loss well below
log(V)) and (b) copy spans (induction-head food).  Deterministic in
(seed, step, shard), so every consensus node sees a *distinct* local data
distribution slice — the per-node local objective f_i of paper Problem (1) —
while remaining exactly reproducible across restarts.

Everything is generated with numpy on the host; the trainer copies each
node's shard to the device.  ``node_rows`` is the counterpart of the
reference's ``make_batch_specs`` (the global batch
sharded over the node axis): node i of N takes rows ``i * B/N`` to ``(i +
1) * B/N``, which is shard i of ``global_batch_arrays``, on the stacked
axis and on a rank of the process ring alike.  For whisper the pipeline
additionally emits synthetic encoder frames correlated with the target
tokens.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticLMDataset", "node_rows"]


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_order: int = 1
    copy_frac: float = 0.3
    n_shards: int = 1            # data-parallel shards (consensus nodes x fsdp)
    enc_frames: int | None = None
    d_model: int | None = None

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # sparse-ish Markov transition: each token has ~8 likely successors
        k = min(8, v)
        self._succ = rng.integers(0, v, size=(v, k))
        self._start = rng.integers(0, v, size=(1024,))

    def _gen_seq(self, rng: np.random.Generator) -> np.ndarray:
        v, s = self.vocab_size, self.seq_len + 1
        out = np.empty(s, dtype=np.int32)
        out[0] = self._start[rng.integers(0, len(self._start))]
        for t in range(1, s):
            if rng.random() < 0.1:  # re-randomize occasionally
                out[t] = rng.integers(0, v)
            else:
                out[t] = self._succ[out[t - 1], rng.integers(0, self._succ.shape[1])]
        # copy spans: repeat an earlier span verbatim
        if rng.random() < self.copy_frac and s > 64:
            span = rng.integers(16, 33)
            src = rng.integers(0, s - 2 * span)
            dst = rng.integers(src + span, s - span)
            out[dst:dst + span] = out[src:src + span]
        return out

    def batch(self, step: int, shard: int = 0, n_shards: int | None = None
              ) -> dict[str, np.ndarray]:
        """Global or per-shard batch for a given step (deterministic)."""
        n_shards = n_shards or self.n_shards
        b_local = self.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        seqs = np.stack([self._gen_seq(rng) for _ in range(b_local)])
        out = {"tokens": seqs[:, :-1].astype(np.int32),
               "labels": seqs[:, 1:].astype(np.int32)}
        if self.enc_frames:
            # audio stub: frames weakly correlated with the token stream
            proj = rng.normal(size=(self.enc_frames, self.d_model)).astype(np.float32)
            base = seqs[:, : self.enc_frames, None].astype(np.float32)
            out["enc_frames"] = (np.tanh(base / self.vocab_size) +
                                 0.1 * proj[None]).astype(np.float32)
        return out

    def global_batch_arrays(self, step: int) -> dict[str, np.ndarray]:
        shards = [self.batch(step, s) for s in range(self.n_shards)]
        return {k: np.concatenate([sh[k] for sh in shards]) for k in shards[0]}


def node_rows(global_batch: int, n_nodes: int, node: int) -> slice:
    """The rows of the global batch that node ``node`` of ``n_nodes``
    trains on."""
    if global_batch % n_nodes:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{n_nodes} nodes")
    if not 0 <= node < n_nodes:
        raise ValueError(f"node {node} outside the ring of {n_nodes}")
    bn = global_batch // n_nodes
    return slice(node * bn, (node + 1) * bn)
