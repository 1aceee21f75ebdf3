"""The port's wire plans (``repro_torch.core.wireplan``) held to the JAX
reference (``repro.core.wireplan``); mirrors ``tests/test_wireplan.py``.

Geometry is compared list for list with the reference module's output on
the same layouts: runs, fragments, transfer units, chunk bounds, byte
offsets (also under hypothesis), grouped placement, and the smollm-135m
numbers of the three plans the trainer ships.  Encode bytes equal the
reference's ``plan.encode`` on the same noise; the controller's plan mode
prices and decides as the reference's; ``WirePlanCompressor`` and
``on_wire_plan`` step as the jitted reference (codes exact, state within
STATE_ULPS).
"""
import torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import codec as JC
from repro.core import consensus as JK
from repro.core import problems as JP
from repro.core import topology as JTop
from repro.core import wire as jwire
from repro.core import wireplan as JW
from repro.models import transformer as JT
from repro.models.params import ParamDef as JParamDef
from repro.models.params import local_block_shape
from repro.models.sharding import local_context
from repro_torch.configs import get_config
from repro_torch.core import codec as C
from repro_torch.core import consensus as K
from repro_torch.core import problems as P
from repro_torch.core import topology as Top
from repro_torch.core import tree as T
from repro_torch.core import wire, wireplan
from repro_torch.core.distributed import ConsensusConfig, ConsensusRuntime
from repro_torch.kernels import ops
from repro_torch.models import transformer as TF
from repro_torch.models.params import meta_params

BLOCK, TILE = ops.BLOCK, ops.TILE_N
MIXED_SIZES = {"embed": 3000, "norm1": 513, "norm2": 7, "proj": 70000}
MIXED_SPEC = "mixed:norm=int2,embed=int4,*=int8"
PLAN_A = "mixed:norm=int4,embed=int4,*=int8"
PLAN_B = "mixed:embed=topk:k=64,norm=int2,*=int8"
SPECS = ("int8", "int4", "topk:k=16", MIXED_SPEC, PLAN_A, PLAN_B,
         "mixed:norm=topk,*=int4",
         "mixed:embed=int2,norm1=int8,norm2=int4,proj=int8")
#: the on_wire_plan parity: x is held within STATE_ULPS of its largest
#: magnitude (XLA contracts W x - alpha g into FMAs, as in
#: tests/test_torch_paper.py); the transmitted codes are exact
STATE_ULPS = 4
PARITY_STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: its many small tensor
    ops only contend when the CPU is shared with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _layouts(sizes: dict):
    """(port layout, reference layout) of one flat-leaf tree."""
    got = wire.WireLayout.for_tree(
        {k: torch.empty(int(v), device="meta") for k, v in sizes.items()})
    want = jwire.WireLayout.for_tree(
        {k: jax.ShapeDtypeStruct((int(v),), jnp.float32)
         for k, v in sizes.items()})
    return got, want


def _runs(plan):
    return [(r.codec, r.row_start, r.n_rows, r.byte_start) for r in plan.runs]


def _units(units):
    return [[(f.codec, f.row_start, f.n_rows, f.byte_start)
             for f in u.fragments] for u in units]


def _geometry(plan):
    """Everything static a plan exposes, as plain values."""
    return {"runs": _runs(plan), "slot_codecs": plan.slot_codecs,
            "payload_bytes": plan.payload_bytes,
            "wire_bytes": [plan.wire_bytes(), plan.wire_bytes(push_sum=True)],
            "noise_cols": plan.noise_cols(), "codes": plan.codes_total(),
            "hot": plan.hot_codec, "uniform": plan.is_uniform,
            "describe": plan.describe(),
            "packed": _units(plan.transfer_units(None)),
            "fallback": [plan.fallback_fragments(k)
                         for k in (None, 1, 2, 3, 4, 7)],
            "retier": [plan.retier_hot(n).payload_bytes
                       for n in ("int2", "int4", "int8", "topk")],
            **{f"chunks{k}": (plan.chunk_bounds(k), plan.n_chunks(k),
                              _units(plan.transfer_units(k)))
               for k in (1, 2, 3, 4, 7, 64)}}


# ---------------------------------------------------------------------------
# spec grammar and slot resolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS + ("mixed:*=int4,norm=int2",
                                          "mixed:default=int2,proj=int4",
                                          "mixed:embed=int4"))
def test_parse_spec_matches_reference(spec):
    got, want = wireplan.parse_spec(spec), JW.parse_spec(spec)
    assert (got.rules, got.default) == (want.rules, want.default)
    assert got.to_string() == want.to_string()
    assert (got.is_uniform, got.uniform_codec, got.hot_codec) == \
        (want.is_uniform, want.uniform_codec, want.hot_codec)
    for tier in ("int2", "int4", "int8", "topk:k=32"):
        for hot in (None, "int2", "int8"):
            a, b = got.with_hot_tier(tier, hot), want.with_hot_tier(tier, hot)
            assert (a.rules, a.default) == (b.rules, b.default)
    assert wireplan.parse_spec(got.to_string()).rules == got.rules


@pytest.mark.parametrize("bad,match", [
    ("int3", "wire_codec"), ("mixed:norm=fp8", "wire_codec"),
    ("mixed:norm", "pattern=codec"), ("mixed:", "no rules"),
    ("mixed:*=int8,default=int4", "two default"), (3, "string")])
def test_spec_errors_match_reference(bad, match):
    with pytest.raises(ValueError, match=match) as got:
        wireplan.parse_spec(bad)
    with pytest.raises(ValueError) as want:
        JW.parse_spec(bad)
    assert str(got.value) == str(want.value)


def test_programmatic_paths_share_valueerror_contract():
    layout, _ = _layouts(MIXED_SIZES)
    with pytest.raises(ValueError, match="unknown wire codec"):
        wireplan.WirePlan.from_rules(layout, [("norm", "int3")])
    with pytest.raises(ValueError, match="unknown wire codec"):
        wireplan.WirePlan.from_slot_codecs(layout, ("int8", "fp8", "int8",
                                                    "int8"))
    with pytest.raises(ValueError, match="slot codecs"):
        wireplan.WirePlan.from_slot_codecs(layout, ("int8",))
    with pytest.raises(ValueError, match="unknown wire codec"):
        wireplan.PlanSpec(rules=(("norm", "int3"),))
    with pytest.raises(ValueError, match="empty pattern"):
        wireplan.PlanSpec(rules=(("", "int8"),))
    with pytest.raises(ValueError, match="unknown wire codec"):
        wireplan.parse_spec(MIXED_SPEC).with_hot_tier("int3")
    with pytest.raises(ValueError, match="pipeline_chunks"):
        wireplan.parse_spec(MIXED_SPEC).build(layout).chunk_bounds(0)
    with pytest.raises(ValueError, match="outside plan rows"):
        wireplan.parse_spec(MIXED_SPEC).build(layout).run_at(10 ** 6)


def test_with_hot_tier_follows_built_plan_when_rules_dead():
    layout, _ = _layouts(MIXED_SIZES)
    spec = wireplan.parse_spec("mixed:norm=int2,embed=int2,proj=int2,*=int8")
    plan = spec.build(layout)
    assert (plan.hot_codec, spec.hot_codec) == ("int2", "int8")
    naive = spec.with_hot_tier("int4").build(layout)
    assert naive.payload_bytes == plan.payload_bytes
    shifted = spec.with_hot_tier("int4", hot=plan.hot_codec).build(layout)
    assert shifted.payload_bytes == plan.retier_hot("int4").payload_bytes
    assert shifted.payload_bytes > plan.payload_bytes


def test_slot_resolution_matches_reference():
    layout, jlayout = _layouts(MIXED_SIZES)
    assert [s.path for s in layout.slots] == [s.path for s in jlayout.slots]
    for spec in SPECS + ("mixed:norm1=topk,norm=int2,*=int8",):
        got = wireplan.parse_spec(spec).build(layout).slot_codecs
        assert got == JW.parse_spec(spec).build(jlayout).slot_codecs
    assert wireplan.parse_spec(MIXED_SPEC).build(layout).slot_codecs == (
        "int4", "int2", "int2", "int8")
    got = wireplan.WirePlan.from_rules(layout, [("*norm?*", "int2")],
                                       default="int4")
    want = JW.WirePlan.from_rules(jlayout, [("*norm?*", "int2")],
                                  default="int4")
    assert got.slot_codecs == want.slot_codecs == ("int4", "int2", "int2",
                                                   "int4")


# ---------------------------------------------------------------------------
# geometry: runs, byte offsets, fragments, units, chunk bounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_plan_geometry_matches_reference(spec):
    layout, jlayout = _layouts(MIXED_SIZES)
    got = _geometry(wireplan.parse_spec(spec).build(layout))
    want = _geometry(JW.parse_spec(spec).build(jlayout))
    assert got == want
    # the port launches one run-fragment per (unit, run)
    plan = wireplan.parse_spec(spec).build(layout)
    for k in (None, 1, 4, 7):
        for unit in plan.transfer_units(k):
            frags = plan.unit_runs(unit)
            assert sum(f.n_rows for f in frags) == unit.n_rows
            assert frags[0].byte_start == unit.byte_start
            assert len(frags) == sum(
                1 for r in plan.runs if r.row_start < unit.row_end
                and r.row_end > unit.row_start)


def test_uniform_plan_chunks_match_chunkedlayout():
    layout, _ = _layouts({"big": 10 * TILE * BLOCK - 5})
    plan = wireplan.WirePlan.uniform(layout, "int8")
    for k in (1, 2, 4, 7, 10, 64):
        cl = wire.ChunkedLayout.split(layout, k)
        assert plan.chunk_bounds(k) == cl.bounds
        assert plan.n_chunks(k) == cl.n_chunks


def test_plan_property_based_geometry_matches_reference():
    """Random slot sizes and codec assignments: the port's geometry is the
    reference's, and runs, prefix-sum offsets and snapped chunks hold
    their invariants."""
    from hypothesis import given, settings, strategies as st

    names = st.sampled_from(C.CODEC_NAMES)

    @given(st.lists(st.tuples(st.integers(1, 3 * BLOCK * TILE), names),
                    min_size=1, max_size=12))
    @settings(max_examples=40, deadline=None)
    def check(slots):
        sizes = {f"leaf{i:02d}": n for i, (n, _) in enumerate(slots)}
        codecs = tuple(name for _, name in slots)
        layout, jlayout = _layouts(sizes)
        plan = wireplan.WirePlan.from_slot_codecs(layout, codecs)
        assert _geometry(plan) == _geometry(
            JW.WirePlan.from_slot_codecs(jlayout, codecs))
        row = byte = 0
        for r in plan.runs:
            assert (r.row_start, r.byte_start) == (row, byte)
            row += r.n_rows
            byte += r.n_rows * C.by_name(r.codec).payload_width()
        assert (row, byte) == (layout.n_rows, plan.payload_bytes)
        for k in (1, 2, 4, 7):
            for start, rows in plan.chunk_bounds(k):
                assert start + rows <= plan.run_at(start).row_end

    check()


def _smollm_layouts():
    """(port params on ``meta``, stacked for 4 nodes; reference layout) of
    the full smollm-135m tree."""
    defs = JT.build_defs(jget_config("smollm-135m"), local_context())
    local = jax.tree.map(
        lambda d: jax.ShapeDtypeStruct(local_block_shape(d, 1, 1), d.dtype),
        defs.storage, is_leaf=lambda x: isinstance(x, JParamDef))
    params = T.tree_map(lambda a: a.expand((4,) + a.shape), meta_params(
        TF.build_defs(get_config("smollm-135m")).storage))
    return params, local


#: (spec, runs (codec, rows), bytes per step, noise cols, units at 4)
SMOLLM = [
    ("int8", [("int8", 262_752)], 271_160_064, 512,
     [65_696, 65_696, 65_696, 65_664]),
    (PLAN_A, [("int4", 55_366), ("int8", 207_386)], 242_591_208, 512,
     [55_366, 69_146, 69_120, 69_120]),
    (PLAN_B, [("topk:k=64", 55_296), ("int2", 70), ("int8", 207_386)],
     228_417_512, 1024, [55_296, 70, 103_706, 103_680]),
]


@pytest.mark.parametrize("spec,runs,wire_bytes,cols,units", SMOLLM,
                         ids=["int8", "planA", "planB"])
def test_smollm_plan_geometry(spec, runs, wire_bytes, cols, units):
    """The three wires of the 4-node smollm-135m trainer: the runtime's
    grouped layout and plan equal the reference runtime's, with the
    numbers of the plan table."""
    from repro.core.distributed import ConsensusConfig as JCfg
    from repro.core.distributed import ConsensusRuntime as JRt
    from repro.models.sharding import ParallelContext
    params, local = _smollm_layouts()
    rt = ConsensusRuntime(ConsensusConfig(wire_codec=spec,
                                          wire_packing="pipelined"), 4)
    jrt = JRt(JCfg(wire_codec=spec, wire_packing="pipelined"),
              ParallelContext(tp=1, data_size=4, n_nodes=4))
    layout, jlayout = rt.state_layout(params), jrt.state_layout(local)
    assert layout.placement == jlayout.placement
    assert [(s.row_start, s.n_rows) for s in layout.slots] == \
        [(s.row_start, s.n_rows) for s in jlayout.slots]
    plan, jplan = rt.wire_plan_for(layout), jrt.wire_plan_for(jlayout)
    assert _geometry(plan) == _geometry(jplan)
    assert [(r.codec, r.n_rows) for r in plan.runs] == runs
    assert rt.wire_bytes_per_step(layout.n_elements, layout) == wire_bytes \
        == jrt.wire_bytes_per_step(jlayout.n_elements, layout=jlayout)
    assert rt.noise_cols_for(layout) == cols == jrt.noise_cols_for(jlayout)
    assert [u.n_rows for u in plan.transfer_units(4)] == units
    assert rt.pipeline_chunks_for(layout) == jrt.pipeline_chunks_for(jlayout)
    assert rt.collectives_per_step(layout.n_leaves, layout=layout) == \
        jrt.collectives_per_step(layout.n_leaves, layout=jlayout) == 8.0


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _interleaved():
    sizes = (3 * BLOCK, 5 * BLOCK + 7, 7 * BLOCK, 2 * BLOCK + 1, 9 * BLOCK)
    layout = wire.WireLayout.for_tree(
        tuple(torch.empty(s, device="meta") for s in sizes))
    jlayout = jwire.WireLayout.for_tree(
        tuple(jax.ShapeDtypeStruct((s,), jnp.float32) for s in sizes))
    return sizes, layout, jlayout, ("int8", "int2", "int8", "int2", "int8")


def test_grouped_placement_matches_reference():
    _, layout, jlayout, codecs = _interleaved()
    for cs in (codecs, ("int8",) * 5, ("int2", "int2", "int8", "int8",
                                       "int8"), ("int4", "topk", "int4",
                                                 "int8", "topk")):
        assert wireplan.grouped_placement(layout, cs) == \
            JW.grouped_placement(jlayout, cs)
    assert wireplan.grouped_placement(layout, codecs) == (0, 2, 4, 1, 3)
    with pytest.raises(ValueError, match="slot codecs"):
        wireplan.grouped_placement(layout, ("int8",))
    re = layout.with_placement(wireplan.grouped_placement(layout, codecs))
    jre = jlayout.with_placement(JW.grouped_placement(jlayout, codecs))
    flat = wireplan.WirePlan.from_slot_codecs(layout, codecs)
    grouped = wireplan.WirePlan.from_slot_codecs(re, codecs)
    assert (flat.n_runs, grouped.n_runs) == (5, 2)
    assert grouped.fallback_fragments() < flat.fallback_fragments()
    assert _geometry(grouped) == _geometry(
        JW.WirePlan.from_slot_codecs(jre, codecs))


def test_reordered_layout_roundtrip_bit_identical():
    """pack and unpack under a grouped placement are exact, each leaf's
    rows are its flat-layout rows wherever they land, and the packed
    buffer equals the reference's."""
    sizes, layout, jlayout, codecs = _interleaved()
    re = layout.with_placement(wireplan.grouped_placement(layout, codecs))
    jre = jlayout.with_placement(JW.grouped_placement(jlayout, codecs))
    assert re.buffer_order == jre.buffer_order == (0, 2, 4, 1, 3)
    rng = np.random.default_rng(3)
    arrays = tuple(rng.standard_normal(s).astype(np.float32) for s in sizes)
    tree = tuple(torch.from_numpy(a) for a in arrays)
    packed = re.pack(tree)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(
        jre.pack(tuple(jnp.asarray(a) for a in arrays))))
    for a, b in zip(tree, re.unpack(packed)):
        assert torch.equal(a, b)
    flat = layout.pack(tree)
    for i in range(len(sizes)):
        assert torch.equal(re.leaf_rows(packed, i), layout.leaf_rows(flat, i))
    assert torch.equal(re.from_leaf_rows(
        [re.leaf_rows(packed, i) for i in range(len(sizes))]), packed)


def test_state_layout_groups_only_for_mixed_plans():
    params = {"a_norm": torch.zeros(4, 513),
              "b_proj": torch.zeros(4, 3 * BLOCK),
              "c_norm": torch.zeros(4, 7),
              "d_proj": torch.zeros(4, 2 * BLOCK + 1)}
    rt = ConsensusRuntime(ConsensusConfig(
        wire_codec="mixed:norm=int2,*=int8"), 4)
    lo = rt.state_layout(params)
    assert lo.placement == (0, 2, 1, 3)
    assert rt.wire_plan_for(lo).n_runs == 2
    assert rt.wire_plan_for(lo) is rt.wire_plan_for(lo)      # cached
    assert ConsensusRuntime(ConsensusConfig(), 4).state_layout(
        params).placement == ()
    # a re-tiered runtime keeps the placement it is given
    kept = ConsensusRuntime(ConsensusConfig(wire_codec="int2"), 4,
                            layout_spec=rt.plan_spec)
    assert kept.state_layout(params).placement == (0, 2, 1, 3)


# ---------------------------------------------------------------------------
# encode and decode bytes against the reference
# ---------------------------------------------------------------------------

def _inputs(layout, cols, seed):
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((layout.n_rows, BLOCK)) * 0.02).astype(
        np.float32)
    y[layout.n_data_rows:] = 0.0
    return y, rng.random((layout.n_rows, cols), dtype=np.float32)


@pytest.mark.parametrize("spec", [MIXED_SPEC, PLAN_A, PLAN_B,
                                  "mixed:norm=topk:k=16,*=int4"])
def test_mixed_plan_encode_bytes_match_reference(spec):
    """The flat payload equals the reference's ``plan.encode`` (jnp path)
    on the same noise, fixed and adaptive; every chunking concatenates to
    it; ``decode_dense`` and the saturation census equal the
    reference's."""
    layout, jlayout = _layouts(MIXED_SIZES)
    plan, jplan = (wireplan.parse_spec(spec).build(layout),
                   JW.parse_spec(spec).build(jlayout))
    y, u = _inputs(layout, plan.noise_cols(), 5)
    yt, ut = torch.from_numpy(y), torch.from_numpy(u)
    for step in (None, 1e-3):
        jstep = None if step is None else jnp.float32(step)
        want = np.asarray(jplan.encode(jnp.asarray(y), jnp.asarray(u),
                                       fixed_step=jstep))
        full = plan.encode(yt, ut, step)
        assert full.shape == (plan.payload_bytes,) and full.dtype == \
            torch.uint8
        np.testing.assert_array_equal(full.numpy(), want)
        for k in (1, 2, 4, 7):
            parts = [plan.encode_unit(un, yt, ut, step)
                     for un in plan.transfer_units(k)]
            assert torch.equal(torch.cat(parts), full)
        np.testing.assert_array_equal(
            plan.decode_dense(full).numpy(),
            np.asarray(jplan.decode_dense(jnp.asarray(want))))
        assert float(plan.count_saturated(yt, step, full)) == float(
            jplan.count_saturated(jnp.asarray(y), jstep, jnp.asarray(want)))


def test_fragment_views_copy_only_off_alignment():
    """An int8 run after an odd number of int2 rows starts 2 bytes off the
    4-byte words its combine kernel reads: that fragment's view is a copy
    with the same bytes; aligned fragments stay views."""
    layout, _ = _layouts({"a_norm": BLOCK, "b_proj": 40 * BLOCK})
    plan = wireplan.parse_spec("mixed:norm=int2,*=int8").build(layout)
    assert [(r.codec, r.byte_start % 4) for r in plan.runs] == [
        ("int2", 0), ("int8", 2)]
    y, u = _inputs(layout, plan.noise_cols(), 9)
    full = plan.encode(torch.from_numpy(y), torch.from_numpy(u), 1e-3)
    for f in plan.unit_runs(plan.transfer_units(None)[0]):
        view = plan.fragment_payload(full, f)
        width = C.by_name(f.codec).payload_width()
        assert torch.equal(view.reshape(-1), full[
            f.byte_start:f.byte_start + f.n_rows * width])
        assert (view.data_ptr() == full.data_ptr() + f.byte_start) == \
            (f.codec == "int2")


# ---------------------------------------------------------------------------
# runtime accounting, config validation, the controller's plan mode
# ---------------------------------------------------------------------------

def test_config_plan_validation():
    rt = ConsensusRuntime(ConsensusConfig(wire_codec="int4"), 4)
    assert rt.plan_spec.is_uniform and rt.wire_name == "int4"
    rt2 = ConsensusRuntime(ConsensusConfig(wire_codec=MIXED_SPEC), 4)
    assert not rt2.plan_spec.is_uniform and rt2.wire_name == MIXED_SPEC
    # the runtime's encode is the exchange's: each node's flat plan payload
    layout, _ = _layouts(MIXED_SIZES)
    plan = rt2.wire_plan_for(layout)
    g = torch.Generator().manual_seed(7)
    y = torch.randn((4, layout.n_rows, BLOCK), generator=g) * 0.01
    u = torch.rand((4, layout.n_rows, plan.noise_cols(BLOCK)), generator=g)
    got = rt2.encode(y, u, 3, layout)
    for i in range(4):
        assert got[i].shape == (plan.payload_bytes,)
        assert torch.equal(got[i], plan.encode(y[i], u[i], rt2._step_k(3)))
    for kw, match in (
            ({"wire_codec": MIXED_SPEC, "wire_packing": "per_leaf"},
             "per-leaf"),
            ({"wire_codec": "mixed:norm=fp8"}, "wire_codec"),
            ({"algorithm": "compressed_dgd", "wire_codec": MIXED_SPEC},
             "compressed_dgd"),
            ({"wire_packing": "async", "algorithm": "dgd"}, "async"),
            ({"pipeline_chunks": 0}, "pipeline_chunks"),
            ({"staleness": 2}, "staleness")):
        with pytest.raises(ValueError, match=match):
            ConsensusConfig(**kw)
    for packing in ("packed", "pipelined", "async"):
        ConsensusConfig(wire_codec=PLAN_B, wire_packing=packing)


def test_runtime_accounting_matches_reference():
    from repro.core.distributed import ConsensusConfig as JCfg
    from repro.core.distributed import ConsensusRuntime as JRt
    from repro.models.sharding import ParallelContext
    ctx = ParallelContext(tp=1, data_size=4, n_nodes=4)
    layout, jlayout = _layouts(MIXED_SIZES)
    for spec in ("int8", MIXED_SPEC, PLAN_B):
        for packing, chunks in (("packed", 4), ("pipelined", 3),
                                ("pipelined", 7), ("async", 4)):
            kw = dict(wire_codec=spec, wire_packing=packing,
                      pipeline_chunks=chunks)
            rt, jrt = ConsensusRuntime(ConsensusConfig(**kw), 4), JRt(
                JCfg(**kw), ctx)
            assert rt.wire_bytes_per_step(layout.n_elements, layout) == \
                jrt.wire_bytes_per_step(jlayout.n_elements, layout=jlayout)
            assert rt.pipeline_chunks_for(layout) == \
                jrt.pipeline_chunks_for(jlayout)
            assert rt.noise_cols_for(layout) == jrt.noise_cols_for(jlayout)
            for n_chunks in (None, 2):
                assert rt.collectives_per_step(
                    4, n_chunks=n_chunks, layout=layout) == \
                    jrt.collectives_per_step(4, n_chunks=n_chunks,
                                             layout=jlayout)
    kw = dict(algorithm="compressed_dgd", wire_packing="pipelined",
              pipeline_chunks=3)
    assert ConsensusRuntime(ConsensusConfig(**kw), 4).collectives_per_step(
        4, layout=layout) == JRt(JCfg(**kw), ctx).collectives_per_step(
            4, layout=jlayout)


@pytest.mark.parametrize("budget_off", [None, -1, 0])
def test_controller_plan_mode_matches_reference(budget_off):
    """Candidates price the re-tiered plans' whole payloads, and the
    decisions equal the reference controller's over one feedback
    sequence."""
    layout, jlayout = _layouts(MIXED_SIZES)
    plan = wireplan.parse_spec(MIXED_SPEC).build(layout)
    jplan = JW.parse_spec(MIXED_SPEC).build(jlayout)
    budget = (None if budget_off is None
              else 2.0 * plan.payload_bytes + budget_off)
    n = layout.n_rows

    def script(ctl):
        return [ctl.candidates(n), ctl.initial(n), ctl.candidate_table(n),
                [ctl.wire_bytes(x, n) for x in ("int2", "int4", "int8")],
                ctl.select(1, 0.01, 0.0, n), ctl.select(2, 0.01, 0.0, n),
                ctl.select(50, 0.01, 0.5, n)]

    kw = dict(byte_budget=budget, fixed_step0=0.1, patience=1)
    got = script(C.AdaptiveBitController(plan=plan, **kw))
    assert got == script(JC.AdaptiveBitController(plan=jplan, **kw))
    assert got[3] == [2.0 * plan.retier_hot(x).payload_bytes
                      for x in ("int2", "int4", "int8")]
    if budget_off == -1:
        assert "int8" not in got[0] and got[1] == "int4"


# ---------------------------------------------------------------------------
# the reference algorithms' wire: WirePlanCompressor and on_wire_plan
# ---------------------------------------------------------------------------

def _two_leaf(spec=PLAN_A, proj_rows=8):
    """The two-leaf layout of ``benchmarks/consensus_step.py``'s equal-
    bytes comparison (a ``proj`` leaf and a ``norm1`` leaf)."""
    sizes = {"proj": proj_rows * BLOCK, "norm1": 200}
    layout, jlayout = _layouts(sizes)
    return (wireplan.parse_spec(spec).build(layout),
            JW.parse_spec(spec).build(jlayout))


@pytest.mark.parametrize("spec", ["int8", PLAN_A, PLAN_B])
def test_wireplan_compressor_matches_reference(spec):
    plan, jplan = _two_leaf(spec)
    comp, jcomp = wireplan.WirePlanCompressor(plan), \
        JW.WirePlanCompressor(jplan)
    dim = plan.layout.n_elements
    assert comp.wire_bytes(dim) == jcomp.wire_bytes(dim) == \
        plan.payload_bytes
    with pytest.raises(ValueError, match="plan elements"):
        comp.wire_bytes(dim + 1)
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    z = np.array(jax.random.normal(jax.random.PRNGKey(0), (3, dim)))
    assert comp.uniform_shape(z.shape) == (3, plan.layout.n_rows,
                                           plan.noise_cols())
    u = np.stack([np.array(jax.random.uniform(
        k, comp.uniform_shape(z.shape)[1:])) for k in keys])
    got = comp.apply(torch.from_numpy(z), torch.from_numpy(u))
    want = np.stack([np.asarray(jcomp.apply(k, jnp.asarray(zi)))
                     for k, zi in zip(keys, z)])
    assert got.shape == z.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="iterate shape"):
        comp.apply(torch.zeros(3, dim + 1), torch.from_numpy(u))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = np.spacing(np.float32(max(np.max(np.abs(b)), 1e-30)))
    return float(np.max(np.abs(a - b)) / scale)


@pytest.mark.parametrize("alg", ["adc_dgd", "choco"])
def test_on_wire_plan_step_parity_with_jitted_reference(alg):
    """ADC-DGD and CHOCO gossiping through plan A on the benchmark's two-
    leaf layout, stepped beside the jitted reference from its own state
    with its own uniforms: ADC-DGD's x_tilde, which integrates the codes,
    exact; x within STATE_ULPS.  CHOCO compresses x - alpha g, which XLA
    computes as fused multiply-adds over its own summation order, so a
    row's adaptive scale may move by an ulp: its x_hat is held within
    STATE_ULPS too.  Equal bytes per iteration for the two."""
    plan, jplan = _two_leaf()
    dim = plan.layout.n_elements
    jprob = JP.paper_circle_problem(4, seed=0, dim=dim)
    tprob = P.paper_circle_problem(4, seed=0, dim=dim, device="cpu")
    kw = {"gamma": 1.0} if alg == "adc_dgd" else {"consensus_lr": 0.1}
    jalg = JK.on_wire_plan(alg, JTop.ring(4), jplan,
                           JK.StepSize(0.05, 0.5), **kw)
    talg = K.on_wire_plan(alg, Top.ring(4), plan, K.StepSize(0.05, 0.5),
                          **kw)
    assert type(talg).__name__ == type(jalg).__name__
    assert talg.bytes_per_iteration(tprob) == jalg.bytes_per_iteration(
        jprob) == 2 * 4 * plan.payload_bytes
    jstep = jax.jit(lambda st, key: jalg.step(st, jprob, key))
    jst = jalg.init(jprob)
    keys = jax.random.split(jax.random.PRNGKey(11), PARITY_STEPS)
    shape = talg.uniform_shape(tprob)
    for i in range(PARITY_STEPS):
        tst = {k: (int(v) if k == "k" else torch.from_numpy(np.array(v)))
               for k, v in jst.items()}
        node_keys = jax.random.split(keys[i], 4)
        u = torch.from_numpy(np.array(jax.vmap(
            lambda k: jax.random.uniform(k, shape[1:]))(node_keys)))
        tnew, tm = talg.step(tst, tprob, u)
        jst, jm = jstep(jst, keys[i])
        if alg == "adc_dgd":
            assert float(tm["max_transmitted"]) == float(
                jm["max_transmitted"])
        for name in set(tnew) - {"k"}:
            got, want = tnew[name].numpy(), np.asarray(jst[name])
            if name == "x_tilde":
                np.testing.assert_array_equal(got, want, f"{name} {i}")
            else:
                assert _ulps(got, want) <= STATE_ULPS, (name, i)


def test_choco_and_adc_through_plan_equal_bytes_and_converge():
    plan, _ = _two_leaf(MIXED_SPEC, proj_rows=4)
    prob = P.paper_circle_problem(4, seed=0, dim=plan.layout.n_elements,
                                  device="cpu")
    ss = K.StepSize(0.05, 0.5)
    adc = K.on_wire_plan("adc_dgd", Top.ring(4), plan, ss, gamma=1.0)
    choco = K.on_wire_plan("choco", Top.ring(4), plan, ss, consensus_lr=0.1)
    assert isinstance(choco, K.CHOCOGossip) and isinstance(adc, K.ADCDGD)
    r_adc = K.run(adc, prob, 300, key=11)
    r_choco = K.run(choco, prob, 300, key=11)
    assert r_adc["bytes"][-1] == r_choco["bytes"][-1] == \
        300 * 2 * 4 * plan.payload_bytes
    assert r_adc["grad_norm"][-1] < r_adc["grad_norm"][0]
    assert r_choco["grad_norm"][-1] < r_choco["grad_norm"][0]
    assert np.mean(r_adc["consensus"][-50:]) <= \
        10 * np.mean(r_choco["consensus"][-50:])
