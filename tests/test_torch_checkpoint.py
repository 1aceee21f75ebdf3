"""Checkpoints of the port's train state.

  * Round trip (float32, uint8 and the int step), ``latest_step``, and the
    refusals of a template of another structure, shape or dtype.
  * A run resumed from the trainer's ``--checkpoint-every 2`` checkpoint
    (loaded into a fresh state of another seed, steps 3-4 through
    ``train_step``) equals the uninterrupted 4-step run bit for bit:
    params, optimizer state, every consensus entry and the step; on the
    packed and async (staleness 1) transports, the directed ring with
    push-sum and loss, and under churn across a resync.
  * The manifest has the reference's leaf layout: the reference's train
    state of the same run (its ``save_checkpoint``) holds the same leaves
    in the same order, shapes and dtypes.
  * ROADMAP hazard 21: the adaptive controller's state is not saved.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core.distributed import ConsensusConfig as JCfg
from repro.core.distributed import ConsensusRuntime as JRt
from repro.models import transformer as JTF
from repro.models.sharding import ParallelContext, local_context
from repro_torch.checkpoint import latest_step, load_checkpoint
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.core import tree as T
from repro_torch.core.topology import MembershipSchedule
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch import train

N, BATCH, SEQ = 4, 8, 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the embedding's backward accumulates in a
    thread-dependent order on the CPU, and these tests compare bits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _manifest(path):
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["manifest"]))


def test_round_trip_and_latest_step(tmp_path):
    d = str(tmp_path / "ck")
    assert latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(d, {})
    tree = {"params": {"w": torch.randn(3, 5), "b": (torch.zeros(2),)},
            "consensus": {"fly_self": torch.arange(7, dtype=torch.uint8)},
            "opt": (), "step": 7}
    for k in (7, 12, 3):
        save_checkpoint(d, k, tree)
    assert latest_step(d) == 12
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000003.npz", "step_00000007.npz", "step_00000012.npz"]
    template = T.tree_map(lambda a: torch.empty_like(a) if torch.is_tensor(a)
                          else 0, tree)
    got, step = load_checkpoint(d, template, step=7)
    assert step == 7 and got["step"] == 7 and type(got["step"]) is int
    assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(
        T.tree_leaves(got)[:-1], T.tree_leaves(tree)[:-1]))
    m = _manifest(tmp_path / "ck" / "step_00000007.npz")
    assert m["n_leaves"] == 4 and m["step"] == 7
    assert m["dtypes"] == ["uint8", "float32", "float32", "int32"]
    bad = [{**template, "extra": torch.zeros(1)},
           {**template, "params": {"w": torch.zeros(3, 4),
                                   "b": (torch.zeros(2),)}},
           {**template, "params": {"w": torch.zeros(3, 5),
                                   "b": (torch.zeros(2, dtype=torch.int32),)}}]
    for tmpl in bad:
        with pytest.raises(ValueError):
            load_checkpoint(d, tmpl, step=7)


RESUME = {
    "packed": ((), {}),
    "async1": (("--wire-packing", "async"), {"wire_packing": "async"}),
    "directed": (("--topology", "directed-ring", "--link-loss", "0.2"),
                 {"topology": "directed-ring", "link_loss": 0.2}),
    "churn": (("--node-failures", "2@1:2", "--schedule-period", "1"),
              {"membership": MembershipSchedule.from_spec("2@1:2", N).masks,
               "schedule_period": 1}),
}


def _same(a, b) -> bool:
    la, ta = T.tree_flatten(a)
    lb, tb = T.tree_flatten(b)
    return ta == tb and all(
        torch.equal(x, y) and x.dtype == y.dtype if torch.is_tensor(x)
        else x == y for x, y in zip(la, lb))


@pytest.mark.parametrize("label", list(RESUME))
def test_resumed_run_is_bitwise_uninterrupted(tmp_path, label):
    argv_extra, kw = RESUME[label]
    d = str(tmp_path)
    _, full = train.main(
        ["--reduced", "--device", "cpu", "--nodes", str(N), "--batch",
         str(BATCH), "--seq", str(SEQ), "--steps", "4", "--checkpoint-dir",
         d, "--checkpoint-every", "2", *argv_extra], return_state=True)
    assert latest_step(d) == 4
    cfg = reduced(get_config("smollm-135m"))
    setup = train.build_train_setup(cfg, consensus_nodes=N, lr=3e-2,
                                    total_steps=4, device="cpu",
                                    track_consensus_error=True, **kw)
    template = train.init_train_state(setup, seed=123)
    state, step = load_checkpoint(d, template, step=2)
    assert step == 2 == state["step"]
    ds = SyntheticLMDataset(cfg.vocab_size, SEQ, BATCH, n_shards=N)
    for k in (2, 3):
        state, _ = train.train_step(setup, state, ds.global_batch_arrays(k))
    assert _same(state, full)
    assert sorted(state["consensus"]) == sorted(full["consensus"])
    last, _ = load_checkpoint(d, template)
    assert _same(last, full)


def test_manifest_has_the_reference_leaf_layout(tmp_path):
    """The reference's train state of a 4-node async push-sum run
    (stacked parameters, its runtime's per-node consensus entries stacked
    device-major, SGD's empty state, an int32 step) and the port's hold
    the same leaves in the same order, shapes and dtypes."""
    kw = dict(wire_packing="async", topology="directed-ring")
    jdefs = JTF.build_defs(jreduced(jget_config("smollm-135m")),
                           local_context())
    p1 = JTF.init_params(jdefs, jax.random.PRNGKey(0))
    jrt = JRt(JCfg(**kw), ParallelContext(tp=1, data_size=N, n_nodes=N,
                                          in_shard_map=False))
    cons1 = jrt.init_state(p1)
    stack = lambda a: np.stack([np.asarray(a)] * N)  # noqa: E731
    jstate = {"params": jax.tree.map(stack, p1), "opt": (),
              "consensus": {k: stack(v) for k, v in cons1.items()},
              "step": jnp.zeros((), jnp.int32)}
    want = _manifest(jsave(str(tmp_path / "jax"), 0, jstate))
    setup = train.build_train_setup(reduced(get_config("smollm-135m")),
                                    consensus_nodes=N, device="cpu", **kw)
    got = _manifest(save_checkpoint(str(tmp_path / "port"), 0,
                                    train.init_train_state(setup, 0)))
    for key in ("step", "n_leaves", "shapes", "dtypes"):
        assert got[key] == want[key], key


def test_adaptive_controller_state_is_not_saved(tmp_path):
    """Hazard 21: as in the reference, a checkpoint holds the train state
    only.  An adaptive run's checkpoint has exactly the leaves of a fixed
    int8 run's, so a run resumed from it starts a fresh controller (its
    epoch's residuals and its last pick are gone) and may pick another
    codec than the uninterrupted run."""
    manifests = []
    for extra in (("--wire-codec", "adaptive", "--codec-period", "1"), ()):
        d = tmp_path / str(len(manifests))
        train.main(["--reduced", "--device", "cpu", "--nodes", str(N),
                    "--batch", str(BATCH), "--seq", str(SEQ), "--steps", "2",
                    "--checkpoint-dir", str(d), "--checkpoint-every", "2",
                    *extra])
        manifests.append(_manifest(d / "step_00000002.npz"))
    assert manifests[0] == manifests[1]
