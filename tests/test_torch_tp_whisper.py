"""Tensor parallelism for the encoder-decoder (whisper-small): the
reference's ``model`` axis through the encoder, the decoder's self and
cross attention and its MLPs.

``test_torch_tp.py``'s harness (its module docstring) on reduced
whisper-small (2 encoder and 2 decoder layers, 4 heads of 64 on 2 kv
heads) head-sharded at tp 2 and sequence-sharded at tp 3 (``n_heads % 3
!= 0``; ``d_ff`` 384 so that 3 divides it, and 48 frames in place of 32
so that 3 divides the encoder's sequence as well).  Every batch and every
prompt carries its frames.  Head-sharded, each rank's encoder runs its
heads and ``d_ff`` columns, and its cross attention projects the
encoder's output on its kv heads and writes them, alone, into its cross
cache; sequence-sharded, the encoder's attention takes the rank's frames
and the cross attention is replicated compute over every frame, its cache
whole on every rank.  Each case is held to the reference (logits, loss,
every rank's gradient, one ``algorithm="none"`` step, greedy tokens), to
the port's tp = 1 run and to itself (replicated leaves bitwise equal over
a node's ranks), and each rank's cache, the cross entries too, has the
shapes of ``init_cache`` at its tp.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import types

import pytest

import test_torch_tp as H
import torch_tp_work as W

from repro_torch.models import transformer as TF

CASES = [("whisper tp2", "whisper-small", 2, {}),
         ("whisper tp3 seq", "whisper-small", 3,
          {"d_ff": 384, "encoder_frames": 48})]
NAMES = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def runs():
    """Grids of 4 and 6 ranks."""
    return H.make_runs(H.make_inputs(CASES, ()))


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


@pytest.mark.parametrize("tp,split", [(2, True), (3, False)])
def test_encoder_and_cross_leaves_split(tp, split):
    """The encoder's blocks and the decoder's cross attention take the
    reference's ``tp_dim`` (q / k / v columns and o rows head-sharded,
    replicated when sequence-sharded; the encoder's MLP split on
    ``d_ff``), not the one-device layout."""
    case = CASES[0] if tp == 2 else CASES[1]
    cfg = W.config({"arch": "whisper-small", "overrides": case[3]}, tp)
    defs = TF.build_defs(cfg, ctx=types.SimpleNamespace(tp=tp)).storage
    enc = defs["encoder"]["layers"][0]
    cross = defs["layers"][0]["cross"]
    for attn in (enc["attn"], cross):
        assert attn["wq"].tp_dim == (2 if split else None)
        assert attn["wo"].tp_dim == (1 if split else None)
    assert enc["mlp"]["w_gate"].tp_dim == 2
    assert enc["mlp"]["w_down"].tp_dim == 1
