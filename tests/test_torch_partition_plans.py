"""The port's partition plans vs the JAX reference's, device-free.

``repro_torch.hopper.partition.plan_for`` against
``repro.kernels.partition.plan_for`` on the same mesh dict and the same
shapes, for every case of the reference's rule tests
(``tests/test_partition.py``: ``MESH8``, ``MESH_2POD``, ``{"model": 4}``,
size-1 and missing axes, the ladder, the ring, and the plans its
sharded-equivalence scripts assert): levels, note, in/out specs,
collectives (kind, axis, nbytes, n), overlappable, hops, ``pre``/``post``
and the ladder's ``None`` with its warning. No rank runs: the port's
operands are ``device="meta"`` tensors, the reference's
``jax.ShapeDtypeStruct``s. Also the level vocabularies,
``local_operand_structs``, ``sharded_call`` on a ``MeshSpec``,
``launch.mesh.host_device_mesh``'s degrade arithmetic against the
reference's own function, and the ``use_mesh`` / ``current_mesh``
contract.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import diagnostics as jdiag  # noqa: E402
from repro.kernels import partition as jpart  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch.diagnostics import ReproDegradeWarning, reset_degrade_warnings  # noqa: E402
from repro_torch.hopper import ops, partition  # noqa: E402,F401  (ops registers the impls)
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

MESH8 = {"data": 2, "model": 4}
MESH_2POD = {"pod": 2, "data": 2, "model": 4}
MESH_2X2X2 = {"pod": 2, "data": 2, "model": 2}
MESH_RING = {"data": 4, "model": 2}
DTYPES = {"f32": (torch.float32, jnp.float32), "i32": (torch.int32, jnp.int32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
OFFS3 = np.array([(-1, 0, 0), (0, 0, 0), (1, 0, 0)], np.int32)
OFFS_H2 = np.array([(-2, 0, 0), (0, 0, 0), (1, 0, 0)], np.int32)
OFFS_WIDE = np.array([(-5, 0, 0), (0, 0, 0)], np.int32)
OFFS_EQUIV = np.array([(-2, 0, 0), (0, 0, 0), (1, 1, 0), (2, 0, 1)], np.int32)


def _st(offs):
    return {"offsets": offs, "weights": np.ones((len(offs),), np.float32)}


def _f(*shape):
    return (shape, "f32")


def _i(*shape):
    return (shape, "i32")


QKV = (_f(2, 8, 32, 16), _f(2, 4, 32, 16), _f(2, 4, 32, 16))
RING_Q, RING_KV = _f(1, 8, 256, 16), _f(1, 4, 256, 16)
EQ_Q, EQ_KV, EQ_KV2 = _f(1, 8, 64, 16), _f(1, 2, 64, 16), _f(1, 10, 64, 16)
HOSTILE_KV = _f(1, 5, 64, 16)
RING_MASKS = [dict(causal=True), dict(causal=True, window=9), dict(causal=False),
              dict(causal=False, window=9)]

# (id, op, mesh, operands as (shape, dtype) or None, keywords)
CASES = [
    # test_gemm_two_level_plan_and_per_level_costs / _k_shard_then_m_shard
    ("gemm_2pod", "gemm", MESH_2POD, (_f(32, 64), _f(64, 16)), {}),
    ("gemm_k", "gemm", MESH8, (_f(32, 64), _f(64, 16)), {}),
    ("gemm_m", "gemm", MESH8, (_f(32, 61), _f(61, 16)), {}),
    ("gemm_none", "gemm", MESH8, (_f(30, 61), _f(61, 16)), {}),
    ("gemm_256", "gemm", MESH8, (_f(256, 256), _f(256, 256)), {}),
    ("gemm_256_2pod", "gemm", MESH_2POD, (_f(256, 256), _f(256, 256)), {}),
    ("gemm_trivial", "gemm", {"data": 1, "model": 1}, (_f(8, 8), _f(8, 8)), {}),
    ("gemm_roofline", "gemm", MESH8, (_f(1024, 4096), _f(4096, 1024)), {}),
    # the gemm rule's precision branch: the narrowed psum payload
    ("gemm_bf16", "gemm", MESH_2POD, (_f(32, 64), _f(64, 16)), {"precision": "bf16"}),
    ("gemm_fp8", "gemm", MESH8, (_f(32, 64), _f(64, 16)), {"precision": "fp8"}),
    ("gemm_fp32_policy", "gemm", MESH8, (_f(32, 64), _f(64, 16)), {"precision": "fp32"}),
    ("gemm_bf16_out", "gemm", MESH8, (_f(32, 64), _f(64, 32)),
     {"out_dtype": (torch.bfloat16, jnp.bfloat16)}),
    # test_fallback_ladder_drops_pod_level_before_replicating
    ("flash_ladder_kv4", "flash_attention", MESH_2POD, QKV, {}),
    ("flash_kv8", "flash_attention", MESH_2POD,
     (_f(2, 8, 32, 16), _f(2, 8, 32, 16), _f(2, 8, 32, 16)), {}),
    ("flash_hostile_2pod", "flash_attention", MESH_2POD,
     (_f(2, 20, 32, 16), _f(2, 5, 32, 16), _f(2, 5, 32, 16)), {}),
    ("flash_replicate", "flash_attention", MESH_2POD,
     (_f(1, 5, 33, 16), _f(1, 5, 33, 16), _f(1, 5, 33, 16)), {}),
    # test_stencil_two_level_distinguishes_pod_boundary_hop
    ("stencil_2pod", "stencil", MESH_2POD, (_f(32, 8, 8),), _st(OFFS3)),
    ("stencil_flat", "stencil", MESH8, (_f(32, 8, 8),), _st(OFFS3)),
    ("stencil_sync", "stencil", MESH8, (_f(32, 8, 8),), {**_st(OFFS3), "overlap": False}),
    # test_two_level_sparse_rules_divide_over_pod_times_model
    ("spmm_2pod", "spmm", MESH_2POD, (_f(64, 8), _i(64, 8), _f(32, 4)), {}),
    ("bsr_2pod", "bsr_spmm", MESH_2POD, (_f(8, 8, 128), _i(8), _i(8), _f(256, 16)),
     {"num_rows": 64}),
    ("spmm_ladder", "spmm", MESH_2POD, (_f(36, 8), _i(36, 8), _f(32, 4)), {}),
    # test_attention_rules_are_gqa_aware
    ("flash_gqa", "flash_attention", MESH8, QKV, {}),
    ("flash_hostile", "flash_attention", MESH8,
     (_f(2, 20, 32, 16), _f(2, 5, 32, 16), _f(2, 5, 32, 16)), {}),
    ("decode_gqa", "decode_attention", MESH8,
     (_f(2, 8, 16), _f(2, 4, 32, 16), _f(2, 4, 32, 16), _i(2)), {}),
    ("decode_hostile", "decode_attention", MESH8,
     (_f(2, 20, 16), _f(2, 5, 32, 16), _f(2, 5, 32, 16), _i(2)), {}),
    ("decode_replicate", "decode_attention", MESH8,
     (_f(3, 20, 16), _f(3, 5, 32, 16), _f(3, 5, 32, 16), _i(3)), {}),
    ("decode_paged_declines", "decode_attention", MESH8,
     (_f(2, 8, 16), _f(9, 4, 8, 16), _f(9, 4, 8, 16), _i(2)),
     {"block_table": (_i(2, 4),)}),
    # test_linear_attention_rule_head_divisibility
    ("linattn_ok", "linear_attention", MESH8, (_f(1, 8, 64, 8),) * 4, {}),
    ("linattn_bad", "linear_attention", MESH8, (_f(1, 6, 64, 8),) * 4, {}),
    ("linattn_u_s0", "linear_attention", MESH_2POD,
     (_f(2, 8, 64, 8),) * 4 + (_f(8, 8), _f(2, 8, 8, 8)), {}),
    # test_sparse_rules_row_and_tile_divisibility
    ("spmm_ok", "spmm", MESH8, (_f(64, 8), _i(64, 8), _f(32, 4)), {}),
    ("spmm_none", "spmm", MESH8, (_f(62, 8), _i(62, 8), _f(32, 4)), {}),
    ("bsr_ok", "bsr_spmm", MESH8, (_f(8, 8, 128), _i(8), _i(8), _f(256, 16)),
     {"num_rows": 64}),
    ("bsr_none", "bsr_spmm", MESH8, (_f(6, 8, 128), _i(6), _i(6), _f(256, 16)),
     {"num_rows": 64}),
    ("spmspm_ok", "spmspm", MESH8, (_f(32, 6), _i(32, 6), _f(64, 6), _i(64, 6)),
     {"contraction_dim": 64}),
    ("spmspm_none", "spmspm", MESH8, (_f(30, 6), _i(30, 6), _f(64, 6), _i(64, 6)),
     {"contraction_dim": 64}),
    # test_stencil_rule_halo_metadata
    ("stencil_h2", "stencil", MESH8, (_f(16, 8, 8),), _st(OFFS_H2)),
    ("stencil_wide", "stencil", MESH8, (_f(16, 8, 8),), _st(OFFS_WIDE)),
    ("stencil_x18", "stencil", MESH8, (_f(18, 8, 8),), _st(OFFS_H2)),
    ("stencil_no_halo", "stencil", MESH8, (_f(16, 8, 8),),
     _st(np.array([(0, 0, 0), (0, 1, 0)], np.int32))),
    # test_flash_ring_rule_resolution
    ("ring", "flash_attention", MESH8, (RING_Q, RING_KV, RING_KV), {}),
    ("ring_window_pruned", "flash_attention", {"data": 8, "model": 1},
     (RING_Q, RING_KV, RING_KV), {"window": 33}),
    ("ring_batch_preferred", "flash_attention", MESH8,
     (_f(2, 8, 256, 16), _f(2, 4, 256, 16), _f(2, 4, 256, 16)), {}),
    ("ring_q_offset_declines", "flash_attention", MESH8, (RING_Q, RING_KV, RING_KV),
     {"causal": True, "q_offset": 7}),
    ("ring_cross_attention", "flash_attention", MESH8,
     (_f(1, 8, 128, 16), RING_KV, RING_KV), {"causal": False}),
    ("ring_unbounded_q_offset", "flash_attention", MESH8, (RING_Q, RING_KV, RING_KV),
     {"causal": False, "q_offset": 7}),
    ("ring_lse", "flash_attention", MESH8, (RING_Q, RING_KV, RING_KV), {"return_lse": True}),
    ("ring_sync_contiguous", "flash_attention", MESH8, (RING_Q, RING_KV, RING_KV),
     {"overlap": False, "zigzag": False}),
    ("batch_lse", "flash_attention", MESH8, QKV, {"return_lse": True}),
    # the attention family on a {"model": 4} mesh and a size-1 data axis
    ("flash_model_only", "flash_attention", {"model": 4}, QKV, {}),
    ("flash_data1", "flash_attention", {"data": 1, "model": 4}, QKV, {}),
    ("gemm_pod_only", "gemm", {"pod": 2, "data": 2, "model": 1}, (_f(32, 64), _f(64, 16)), {}),
    ("gemm_no_model", "gemm", {"pod": 2, "x": 4}, (_f(32, 64), _f(64, 16)), {}),
    # the two-level plans of the 2x2x2 equivalence script, and its ladder
    ("eq3_gemm", "gemm", MESH_2X2X2, (_f(32, 64), _f(64, 32)), {}),
    ("eq3_flash", "flash_attention", MESH_2X2X2, QKV, {}),
    ("eq3_decode", "decode_attention", MESH_2X2X2,
     (_f(2, 8, 16), _f(2, 4, 32, 16), _f(2, 4, 32, 16), _i(2)), {}),
    ("eq3_linattn", "linear_attention", MESH_2X2X2, (_f(1, 4, 64, 8),) * 4, {}),
    ("eq3_spmm", "spmm", MESH_2X2X2, (_f(64, 3), _i(64, 3), _f(32, 8)), {}),
    ("eq3_bsr", "bsr_spmm", MESH_2X2X2, (_f(4, 8, 128), _i(4), _i(4), _f(256, 16)),
     {"num_rows": 16}),
    ("eq3_spmspm", "spmspm", MESH_2X2X2, (_f(32, 6), _i(32, 6), _f(64, 6), _i(64, 6)),
     {"contraction_dim": 64}),
    ("eq3_stencil", "stencil", MESH_2X2X2, (_f(16, 8, 8),), _st(OFFS_EQUIV)),
    ("eq3_ladder_flash", "flash_attention", MESH_2X2X2,
     (_f(2, 8, 32, 16), _f(2, 2, 32, 16), _f(2, 2, 32, 16)), {}),
    ("eq3_ladder_spmm", "spmm", MESH_2X2X2, (_f(38, 3), _i(38, 3), _f(32, 8)), {}),
    ("eq_fallback_flash", "flash_attention", MESH8, (_f(1, 5, 15, 8),) * 3, {}),
    ("eq_fallback_spmm", "spmm", MESH8, (_f(62, 3), _i(62, 3), _f(32, 8)), {}),
] + [
    # the 8-device ring script's plans: GQA and a TP-hostile head count
    (f"eq_ring_{tag}_w{kw.get('window', 0)}c{int(kw['causal'])}", "flash_attention",
     MESH_RING, (q, kv, kv), kw)
    for tag, q, kv in (("gqa", EQ_Q, EQ_KV), ("hostile", EQ_KV2, HOSTILE_KV))
    for kw in RING_MASKS
] + [
    (f"eq_halo_tp{tp}", "stencil", {"data": 8 // tp, "model": tp}, (_f(16, 8, 8),),
     _st(OFFS_EQUIV)) for tp in (2, 4, 8)
]


def _operand(spec, side):
    if spec is None:
        return None
    shape, dt = spec
    if side == 0:
        return torch.empty(shape, dtype=DTYPES[dt][0], device="meta")
    return jax.ShapeDtypeStruct(shape, DTYPES[dt][1])


def _kwargs(kw, side):
    out = {}
    for k, v in kw.items():
        if isinstance(v, tuple) and len(v) == 2 and not isinstance(v[0], tuple):
            v = v[side]  # a (torch, jax) dtype pair
        elif isinstance(v, tuple):
            v = _operand(v[0], side)
        out[k] = v
    return out


def _plans(op, mesh, args, kw):
    """(port plan, its warnings, reference plan, its warnings)."""
    out = []
    for side, (mod, spec, reset) in enumerate((
            (partition, partition.MeshSpec(dict(mesh)), reset_degrade_warnings),
            (jpart, jpart.MeshSpec(dict(mesh)), jdiag.reset_degrade_warnings))):
        reset()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            plan = mod.plan_for(op, spec, *(_operand(a, side) for a in args),
                                **_kwargs(kw, side))
        out += [plan, [str(w.message) for w in caught if issubclass(w.category, UserWarning)]]
    return out


def _spec(x):
    if isinstance(x, (jax.sharding.PartitionSpec, partition.PartitionSpec)):
        return ("P", tuple(x))
    return tuple(_spec(s) for s in x)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plan_matches_reference(case):
    _, op, mesh, args, kw = case
    got, got_warn, want, want_warn = _plans(op, mesh, args, kw)
    assert got_warn == want_warn
    assert (got is None) == (want is None)
    if want is None:
        return
    assert (got.op, got.levels, got.note) == (want.op, want.levels, want.note)
    assert (got.axis, got.n) == (want.axis, want.n)
    assert _spec(got.in_specs) == _spec(want.in_specs)
    assert _spec(got.out_specs) == _spec(want.out_specs)
    assert [(c.kind, c.axis, c.nbytes, c.n) for c in got.collectives] == \
        [(c.kind, c.axis, c.nbytes, c.n) for c in want.collectives]
    assert (got.overlappable, got.hops, got.pre is None, got.post is None) == \
        (want.overlappable, want.hops, want.pre is None, want.post is None)
    assert partition.plan_collective_bytes(got) == jpart.plan_collective_bytes(want)


def test_the_plans_the_reference_asserts():
    """A few of the reference suite's own claims, read off the port's plans."""
    plans = {c[0]: _plans(c[1], c[2], c[3], c[4])[0] for c in CASES}
    assert plans["gemm_2pod"].levels == (("pod", 2), ("model", 4))
    assert plans["gemm_bf16"].note.endswith("bfloat16 reduce")
    assert plans["flash_ladder_kv4"].levels == (("data", 2), ("model", 4))
    assert plans["spmm_ladder"].levels == (("model", 4),)
    assert plans["flash_replicate"] is None and plans["decode_paged_declines"] is None
    assert "1 kv hops" in plans["ring_window_pruned"].note
    assert "pod boundary hop" in plans["stencil_2pod"].note
    assert plans["stencil_flat"].overlappable and not plans["stencil_sync"].overlappable
    assert {c[0] for c in CASES if c[0].startswith("eq3_") and "ladder" not in c[0]} == {
        f"eq3_{t}" for t in ("gemm", "flash", "decode", "linattn", "spmm", "bsr", "spmspm",
                             "stencil")}
    for name in ("eq3_gemm", "eq3_spmm", "eq3_bsr", "eq3_spmspm", "eq3_stencil",
                 "eq3_linattn"):
        assert plans[name].levels == (("pod", 2), ("model", 2)), name
    assert plans["eq3_flash"].levels == (("pod", 2), ("data", 2), ("model", 2))


def test_ladder_warns_once_per_op_and_shape():
    reset_degrade_warnings()
    spec = partition.MeshSpec(MESH8)
    args = [torch.empty(s, dtype=torch.float32, device="meta") for s in ((30, 61), (61, 16))]
    with pytest.warns(ReproDegradeWarning, match="partition ladder exhausted for 'gemm'"):
        assert partition.plan_for("gemm", spec, *args) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert partition.plan_for("gemm", spec, *args) is None


VOCAB_MESHES = [MESH8, MESH_2POD, MESH_2X2X2, {"pod": 1, "data": 2, "model": 4},
                {"pod": 2, "data": 2, "model": 1}, {"data": 1, "model": 1},
                {"data": 1, "model": 4}, {"model": 4}, {"pod": 2, "x": 4}, {"data": 4},
                {"pod": 2, "data": 4}]


@pytest.mark.parametrize("mesh", VOCAB_MESHES, ids=lambda m: "x".join(f"{a}{s}" for a, s in
                                                                       m.items()))
def test_level_vocabularies_match_reference(mesh):
    got, want = partition.MeshSpec(dict(mesh)), jpart.MeshSpec(dict(mesh))
    assert partition.partition_axis(got) == jpart.partition_axis(want)
    assert partition.partition_levels(got) == jpart.partition_levels(want)
    assert partition.attention_levels(got) == jpart.attention_levels(want)


def test_registry_surface_matches_reference():
    assert partition.partitioned_ops() == jpart.partitioned_ops()
    assert partition.PLAN_KWARGS == jpart.PLAN_KWARGS
    assert partition.AXIS_VOCAB == jpart.AXIS_VOCAB
    kw = {"overlap": False, "zigzag": True, "bx": 4}
    assert partition.strip_plan_kwargs(kw) == jpart.strip_plan_kwargs(kw) == {"bx": 4}


@pytest.mark.parametrize("mesh", [MESH8, MESH_2POD], ids=["mesh8", "mesh_2pod"])
@pytest.mark.parametrize("case", ["gemm_256", "flash_gqa", "linattn_u_s0", "bsr_ok",
                                  "stencil_h2", "gemm_none"])
def test_local_operand_structs_match_reference(case, mesh):
    _, op, _, args, kw = next(c for c in CASES if c[0] == case)
    if op == "linear_attention":
        args = args[:4] + (None,) + args[5:]  # a hole: u absent, s0 present
    got, _, want, _ = _plans(op, mesh, args, kw)
    t_args = tuple(_operand(a, 0) for a in args)
    j_args = tuple(_operand(a, 1) for a in args)
    g = partition.local_operand_structs(got, partition.MeshSpec(dict(mesh)), t_args)
    w = jpart.local_operand_structs(want, jpart.MeshSpec(dict(mesh)), j_args)
    assert [(shape, str(dt).removeprefix("torch.")) for shape, dt in g] == \
        [(tuple(s.shape), jnp.dtype(s.dtype).name) for s in w]


def test_sharded_call_on_a_meshspec_raises():
    a = torch.zeros(32, 64)
    with pytest.raises(TypeError, match="needs a device mesh"):
        partition.sharded_call("gemm", partition.MeshSpec(MESH8), a, a.T)
    # a plan of None replicates, so a MeshSpec runs the plain call
    x = torch.arange(64.0).reshape(8, 8)
    got = partition.sharded_call("gemm", partition.MeshSpec({"data": 1, "model": 1}), x, x)
    assert torch.equal(got, x @ x)
    with pytest.raises(TypeError, match="DeviceMesh"):
        partition.sharded_call("gemm", "model", a, a.T)


# ---------------------------------------------------------------------------
# host_device_mesh and the kernel-mesh context
# ---------------------------------------------------------------------------


def _host(fn, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mesh = fn(**kw)
    return dict(mesh.shape), tuple(mesh.axis_names), [str(w.message) for w in caught]


@pytest.mark.parametrize("tp, pods", [(1, 1), (4, 1), (2, 2), (1, 2), (2, 1), (3, 5)])
def test_host_device_mesh_at_one_device_matches_reference(tp, pods):
    """The reference's cases at its one CPU device; the port's one CPU rank."""
    assert len(jax.devices()) == 1
    got = _host(tmesh.host_device_mesh, tp=tp, pods=pods, device="cpu")
    want = _host(jmesh.host_device_mesh, tp=tp, pods=pods)
    assert got[:2] == want[:2]
    assert [m.replace("ranks", "devices") for m in got[2]] == want[2]


class _EightDevices:
    """Stands in for ``jax`` inside ``repro.launch.mesh``: eight devices, and
    ``make_mesh`` returning its arguments, so the reference's own arithmetic
    runs at n = 8."""

    @staticmethod
    def devices():
        return list(range(8))

    @staticmethod
    def make_mesh(shape, axes):
        return dict(zip(axes, shape))


@pytest.mark.parametrize("tp", range(1, 10))
@pytest.mark.parametrize("pods", [1, 2, 3, 4, 8, 9])
def test_host_device_mesh_formula_at_eight_ranks(monkeypatch, tp, pods):
    monkeypatch.setattr(jmesh, "jax", _EightDevices)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = jmesh.host_device_mesh(tp=tp, pods=pods)
    want_warn = [str(w.message) for w in caught]
    shape, axes, got_warn = _host(tmesh.host_device_mesh, tp=tp, pods=pods, n=8, device="cpu")
    assert shape == want and axes == tuple(want)
    assert [m.replace("ranks", "devices") for m in got_warn] == want_warn


@pytest.mark.parametrize("tp, pods", [(0, 1), (1, 0)])
def test_host_device_mesh_rejects_invalid_factorisations(tp, pods):
    with pytest.raises(ValueError, match="not a valid mesh factorisation"):
        jmesh.host_device_mesh(tp=tp, pods=pods)
    with pytest.raises(ValueError, match="not a valid mesh factorisation"):
        tmesh.host_device_mesh(tp=tp, pods=pods, device="cpu")


def test_make_mesh_names_axes_in_order():
    mesh = tmesh.make_mesh((2, 1, 3), ("pod", "data", "model"), device="cpu")
    assert mesh.shape == {"pod": 2, "data": 1, "model": 3} and mesh.n == 6
    with pytest.raises(ValueError, match="sizes"):
        tmesh.make_mesh((2, 2), ("pod", "data", "model"), device="cpu")


def test_use_mesh_does_not_leak_into_model_mesh():
    """The reference's contract (``tests/test_partition.py``): use_mesh
    sets the kernel mesh and never ``current_mesh()``; nesting restores."""
    outer, inner = object(), object()
    for sh in (jsh, sharding):
        with sh.use_mesh(outer):
            assert sh.kernel_mesh() is outer and sh.current_mesh() is None
            with sh.use_mesh(inner) as m:
                assert m is inner and sh.kernel_mesh() is inner
            assert sh.kernel_mesh() is outer
        assert sh.kernel_mesh() is None and sh.current_mesh() is None
