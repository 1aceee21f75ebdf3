"""Tensor parallelism for the mixture-of-experts family (expert
parallelism): the reference's ``model`` axis through the 'E' and 'D'
blocks.

``test_torch_tp.py``'s harness (its module docstring) on reduced
granite-moe-3b-a800m head-sharded at tp 2 (2 of its 4 experts a rank) and
sequence-sharded at tp 3 (``n_heads % 3 != 0``; the 4 experts padded to
6, the 2 dead ones masked out of the router), and reduced
deepseek-moe-16b at tp 2 (its dense prelude layer split as an MLP, its
shared expert split over ``moe_d_ff``).  The reduced configs route at
capacity factor 8, so nothing is dropped and the reference's routing is
the port's; granite at tp 2 runs once more at capacity factor 1, where
the training batch, the prefill and the decode steps drop assignments
(``test_drop_case_drops``), so that each rank's slots of its experts and
the kept mask of the assignments past the capacity are held to the
reference too.  Each case is held to the reference (logits, loss, every
rank's gradient of the router, the experts and the rest, one
``algorithm="none"`` step, greedy tokens), to the port's tp = 1 run (the
live experts; the dead ones' gradients must be zero) and to itself
(replicated leaves, the router among them, bitwise equal over a node's
ranks).  granite at tp 2 also trains ``ADC_STEPS`` steps of int8 packed
ADC-DGD, each rank's exchange bitwise the stacked runtime's over its
model index's shards (the experts' rows are exchanged as any leaf's).
The router's gradient has two parts, the experts' rank-partial one and
the auxiliary loss's complete one: counting the second once per rank
moves the router's gradient away from the reference's, which
``test_gradient_and_step_match_reference`` sees.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import types

import pytest

import test_torch_tp as H
import torch_tp_work as W

from repro_torch.models import moe
from repro_torch.models import transformer as TF

CASES = [("granite tp2", "granite-moe-3b-a800m", 2, {}),
         ("granite tp3 seq", "granite-moe-3b-a800m", 3, {}),
         ("deepseek tp2", "deepseek-moe-16b", 2, {}),
         ("granite tp2 drops", "granite-moe-3b-a800m", 2,
          {"capacity_factor": 1.0})]
ADC_CASE = "granite tp2"
DROP_CASE = "granite tp2 drops"
NAMES = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def runs():
    """Grids of 4 and 6 ranks."""
    return H.make_runs(H.make_inputs(CASES, (ADC_CASE,)))


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(runs, name):
    H.check_forward(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_gradient_and_step_match_reference(runs, name):
    H.check_gradient_and_step(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_gradient_matches_tp1(runs, name):
    H.check_gradient_tp1(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_replicated_leaves_bitwise_across_tp_ranks(runs, name):
    H.check_replicated_bitwise(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_serve_tokens_match_reference(runs, name):
    H.check_serve_tokens(runs, name)


def test_adc_bitwise_stacked(runs):
    H.check_adc(runs, ADC_CASE)


@pytest.mark.parametrize("arch,tp,want", [
    ("granite-moe-3b-a800m", 2, 4), ("granite-moe-3b-a800m", 3, 6),
    ("granite-moe-3b-a800m", 4, 4), ("deepseek-moe-16b", 2, 4)])
def test_padded_expert_axis(arch, tp, want):
    """``padded_experts`` rounds the reduced configs' 4 experts up to a
    multiple of tp; the router gains the dead columns, the experts split
    on their leading axis."""
    cfg = W.config({"arch": arch}, tp)
    assert moe.padded_experts(cfg, tp) == want
    defs = TF.build_defs(cfg, ctx=types.SimpleNamespace(tp=tp)).storage
    p = defs["layers"][0]["moe"]
    assert p["router"].shape == (cfg.n_periods, cfg.d_model, want)
    assert p["router"].tp_dim is None
    for key in ("w_gate", "w_up", "w_down"):
        assert p[key].shape[1] == want and p[key].tp_dim == 1


def test_dead_experts_are_never_routed():
    """The dead experts' router columns are masked to -1e30: their
    probability is 0 and no token chooses them, and the auxiliary loss
    is the live experts' alone."""
    import torch
    cfg = W.config({"arch": "granite-moe-3b-a800m"}, 3)
    g = torch.Generator().manual_seed(0)
    xf = torch.randn(64, cfg.d_model, generator=g)
    router = torch.randn(cfg.d_model, 6, generator=g) * 10
    r = moe.route(router, xf, cfg)
    live = moe.route(router[:, :4].contiguous(), xf, cfg)
    assert torch.equal(r.probs[:, 4:], torch.zeros(64, 2))
    assert int(r.top_e.max()) < 4
    assert torch.equal(r.top_e, live.top_e)
    assert torch.equal(r.keep, live.keep)
    torch.testing.assert_close(r.aux, live.aux, rtol=1e-6, atol=0)


def test_drop_case_drops(runs, monkeypatch):
    """The drop case's routing drops assignments in the training forward,
    the prefill and the decode steps (the port at tp = 1, whose tokens and
    gradients its checks hold the grid's to)."""
    seen = []
    real = moe.route

    def spy(router, xf, cfg):
        r = real(router, xf, cfg)
        seen.append((xf.shape[0], int((~r.keep).sum())))
        return r
    monkeypatch.setattr(moe, "route", spy)
    H._tp1(runs["cases"][DROP_CASE])
    for t in (W.B // W.N_NODES * W.S, W.SERVE_B * W.PROMPT, W.SERVE_B):
        assert sum(d for n, d in seen if n == t) > 0, (t, seen)
