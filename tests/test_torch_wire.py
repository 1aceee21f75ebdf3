"""Port wire layout (repro_torch.core.wire) held to the JAX reference.

The layout of full smollm-135m is built on the ``meta`` device (shapes
only) and must have the reference's slot paths, row starts and heights —
the contract that makes the two packages' packed buffers and payloads
line up row for row.
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import wire as jwire
from repro.models import transformer as JT
from repro.models.params import ParamDef as JParamDef
from repro.models.params import local_block_shape
from repro.models.sharding import local_context
from repro_torch.configs import get_config, reduced
from repro_torch.core import tree as T
from repro_torch.core import wire
from repro_torch.models import transformer as TF
from repro_torch.models.params import meta_params


def _jax_layout(cfg):
    defs = JT.build_defs(cfg, local_context())
    local = jax.tree.map(
        lambda d: jax.ShapeDtypeStruct(local_block_shape(d, 1, 1), d.dtype),
        defs.storage, is_leaf=lambda x: isinstance(x, JParamDef))
    return jwire.WireLayout.for_tree(local)


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
def test_smollm_layout_matches_jax(full):
    jcfg = jget_config("smollm-135m")
    cfg = get_config("smollm-135m")
    if not full:
        jcfg, cfg = jreduced(jcfg), reduced(cfg)
    want = _jax_layout(jcfg)
    got = wire.WireLayout.for_tree(meta_params(TF.build_defs(cfg).storage))
    assert [s.path for s in got.slots] == [s.path for s in want.slots]
    assert [(s.shape, s.row_start, s.n_rows, s.size) for s in got.slots] == \
        [(s.shape, s.row_start, s.n_rows, s.size) for s in want.slots]
    assert (got.n_rows, got.n_data_rows, got.n_elements) == \
        (want.n_rows, want.n_data_rows, want.n_elements)
    if full:
        assert got.n_leaves == 11
        assert got.n_elements == 134_515_008
        assert got.n_rows == 262_752
        assert got.slots[0].path == "['embed']['table']"
        assert got.slots[2].path == "['layers'][0]['attn']['wk']"
        assert got.slots[2].shape == (30, 576, 192)


def _odd_tree(rng, lead=()):
    def arr(shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(lead + shape).astype(
            np.float32)).to(dtype)
    return {"w": arr((3, 37)), "b": arr((513,), torch.bfloat16),
            "scalar": arr(()),
            "deep": ({"m": arr((7, 11, 2))}, arr((1, 129), torch.bfloat16))}


@pytest.mark.parametrize("lead", [(), (4,)], ids=["node", "stacked"])
def test_pack_matches_jax_and_roundtrips(lead):
    rng = np.random.default_rng(0)
    tree = _odd_tree(rng, lead)
    per_node = T.tree_map(lambda a: a[0] if lead else a, tree)
    layout = wire.WireLayout.for_tree(per_node)
    packed = layout.pack(tree)
    assert packed.shape == lead + (layout.n_rows, layout.block)
    back = layout.unpack(packed)
    for a, b in zip(T.tree_leaves(back), T.tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jtree = T.tree_map(
        lambda a: jnp.asarray(a.float().numpy()).astype(
            jnp.bfloat16 if a.dtype == torch.bfloat16 else jnp.float32),
        per_node)
    want = np.asarray(jwire.WireLayout.for_tree(jtree).pack(jtree))
    first = packed[0] if lead else packed
    np.testing.assert_array_equal(first.numpy(), want)
    # padding rows are exact zeros (the quantizer keeps them at code 0)
    for i, slot in enumerate(layout.slots):
        rows = layout.leaf_rows(first, i).reshape(-1)
        assert not rows[slot.size:].any()
    assert not first[layout.n_data_rows:].any()


def test_with_placement_matches_jax():
    rng = np.random.default_rng(1)
    tree = _odd_tree(rng)
    layout = wire.WireLayout.for_tree(tree)
    jtree = T.tree_map(lambda a: jnp.zeros(tuple(a.shape)), tree)
    want = jwire.WireLayout.for_tree(jtree).with_placement((4, 2, 0, 3, 1))
    got = layout.with_placement((4, 2, 0, 3, 1))
    assert [s.row_start for s in got.slots] == \
        [s.row_start for s in want.slots]
    np.testing.assert_array_equal(
        got.pack(tree).numpy(),
        np.asarray(want.pack(T.tree_map(
            lambda a: jnp.asarray(a.float().numpy()), tree))))
    with pytest.raises(ValueError):
        layout.with_placement((0, 0, 1, 2, 3))


@pytest.mark.parametrize("chunks", [1, 2, 3, 4, 7, 100])
def test_chunked_split_matches_jax(chunks):
    tree = {"big": torch.zeros(40_000), "x": torch.zeros(3, 5)}
    layout = wire.WireLayout.for_tree(tree)
    want = jwire.ChunkedLayout.split(
        jwire.WireLayout.for_tree({"big": jnp.zeros(40_000),
                                   "x": jnp.zeros((3, 5))}), chunks)
    got = wire.ChunkedLayout.split(layout, chunks)
    assert got.bounds == want.bounds
    assert got.n_chunks == min(chunks, layout.n_rows // 32)
    row = 0
    for start, rows in got.bounds:      # contiguous, tile-aligned cover
        assert start == row and rows % 32 == 0 and rows > 0
        row += rows
    assert row == layout.n_rows
    with pytest.raises(ValueError):
        wire.ChunkedLayout.split(layout, 0)
