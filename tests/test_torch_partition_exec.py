"""The port's sharded ops vs the JAX reference's unsharded ops, on the CPU.

The case lists of the reference's 8-device equivalence scripts
(``tests/test_partition.py`` ``_EQUIV`` and ``_EQUIV_3AX``) on the port's
``DeviceMesh({"data": 2, "model": 4}, device="cpu")`` and
``DeviceMesh({"pod": 2, "data": 2, "model": 2}, device="cpu")``: every op
through the port's ``cuda`` (its wrapper's plain version on CPU tensors),
``torch`` and ``ref`` impls, held to the reference's unsharded
``ops.*(impl="ref")`` (``xla`` for BSR) on the same numpy inputs at the
reference suite's 1e-4. Also: gemm keeps ``out_dtype=bf16``; the two
fallbacks (``q5``, ``ell62``) plan ``None``, warn and still agree; the
ladder's dropped-pod plans run; stencil halos at tp 2, 4 and 8; the
overlapped stencil is bitwise its synchronous schedule; the GCN with
``mesh=`` and under ``use_mesh`` against ``repro.models.gcn.forward``;
the gemm rule under ``precision="bf16"`` against the reference's per-slab
calls, to one bf16 rounding per level; and the mesh, ``ppermute`` and
``hierarchical_psum`` themselves.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import sparse as jsp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import partition as jpart  # noqa: E402
from repro.models import gcn as jgcn  # noqa: E402
from repro_torch.core import sparse as tsp  # noqa: E402
from repro_torch.diagnostics import ReproDegradeWarning, reset_degrade_warnings  # noqa: E402
from repro_torch.hopper import dispatch, ops, partition  # noqa: E402
from repro_torch.models import gcn  # noqa: E402
from repro_torch.parallel import collectives, sharding  # noqa: E402
from repro_torch.parallel.mesh import DeviceMesh, RingMesh  # noqa: E402

TOL = 1e-4  # the reference suite's
IMPLS = ("cuda", "torch", "ref")
MESHES = {"2x4": {"data": 2, "model": 4}, "2x2x2": {"pod": 2, "data": 2, "model": 2}}
T = torch.from_numpy


def _mesh(name):
    return DeviceMesh(MESHES[name], device="cpu")


def _inputs():
    """The reference scripts' operands, drawn in their order from seed 0."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    x = {}
    x["a"] = rng.standard_normal((32, 64)).astype(f32)
    x["b"] = rng.standard_normal((64, 32)).astype(f32)
    x["q"] = rng.standard_normal((2, 8, 32, 16)).astype(f32)
    x["kv"] = rng.standard_normal((2, 4, 32, 16)).astype(f32)
    x["qd"] = rng.standard_normal((2, 8, 16)).astype(f32)
    x["pos"] = np.asarray([5, 30], np.int32)
    x["r"] = rng.standard_normal((1, 4, 64, 8)).astype(f32)
    x["wl"] = (-rng.uniform(0.01, 1.0, (1, 4, 64, 8))).astype(f32)
    x["u"] = rng.standard_normal((4, 8)).astype(f32)
    x["ell"] = jsp.random_ell(rng, 64, 32, 0.1)
    x["dn"] = rng.standard_normal((32, 8)).astype(f32)
    bsr_dense = np.zeros((16, 256), f32)
    bsr_dense[::3, ::17] = 1.0
    x["bsr_dense"] = bsr_dense
    x["brhs"] = rng.standard_normal((256, 16)).astype(f32)
    x["sA"], x["sB"] = jsp.random_ell(rng, 32, 64, 0.1), jsp.random_ell(rng, 64, 64, 0.1)
    x["grid"] = rng.standard_normal((16, 8, 8)).astype(f32)
    # |dx| = 2 on 4-plane slabs: halo planes cross slab and pod boundaries
    x["offs"] = np.array([(-2, 0, 0), (0, 0, 0), (1, 1, 0), (2, 0, 1)], np.int32)
    x["w"] = np.array([0.2, 0.3, 0.4, 0.1], f32)
    x["q5"] = rng.standard_normal((1, 5, 15, 8)).astype(f32)
    x["ell62"] = jsp.random_ell(rng, 62, 32, 0.1)
    x["kv2"] = rng.standard_normal((2, 2, 32, 16)).astype(f32)
    x["ell38"] = jsp.random_ell(rng, 38, 32, 0.1)
    return x


X = _inputs()


def _ell(A):
    return tsp.EllMatrix(T(np.array(A.values)), T(np.array(A.cols)), A.shape)


def _j(name):
    return jnp.asarray(X[name])


# name -> (the port's call on a mesh and impl, the reference's unsharded call)
CASES = {
    "gemm": (lambda m, i: ops.gemm(T(X["a"]), T(X["b"]), mesh=m, impl=i, out_dtype=torch.float32),
             lambda: jops.gemm(_j("a"), _j("b"), impl="ref", out_dtype=jnp.float32)),
    "flash": (lambda m, i: ops.flash_attention(T(X["q"]), T(X["kv"]), T(X["kv"]), mesh=m, impl=i),
              lambda: jops.flash_attention(_j("q"), _j("kv"), _j("kv"), impl="ref")),
    "linattn_rwkv": (
        lambda m, i: ops.linear_attention(T(X["r"]), T(X["r"]), T(X["r"]), T(X["wl"]),
                                          T(X["u"]), mesh=m, impl=i),
        lambda: jops.linear_attention(_j("r"), _j("r"), _j("r"), _j("wl"), _j("u"), impl="ref")),
    "linattn_ssd": (
        lambda m, i: ops.linear_attention(T(X["r"]), T(X["r"]), T(X["r"]), T(X["wl"]),
                                          mesh=m, impl=i),
        lambda: jops.linear_attention(_j("r"), _j("r"), _j("r"), _j("wl"), impl="ref")),
    "spmm": (lambda m, i: ops.spmm(_ell(X["ell"]), T(X["dn"]), mesh=m, impl=i),
             lambda: jops.spmm(X["ell"], _j("dn"), impl="ref")),
    "bsr_spmm": (
        lambda m, i: ops.bsr_spmm(tsp.dense_to_bsr(X["bsr_dense"], bm=8, bk=128), T(X["brhs"]),
                                  mesh=m, impl=i),
        lambda: jops.bsr_spmm(jsp.dense_to_bsr(X["bsr_dense"], bm=8, bk=128), _j("brhs"),
                              impl="xla")),
    "spmspm": (lambda m, i: ops.spmspm(_ell(X["sA"]), _ell(X["sB"]), 64, mesh=m, impl=i),
               lambda: jops.spmspm(X["sA"], X["sB"], 64, impl="ref")),
    "stencil": (lambda m, i: ops.stencil(T(X["grid"]), X["offs"], X["w"], mesh=m, impl=i),
                lambda: jops.stencil(_j("grid"), X["offs"], X["w"], impl="ref")),
    "decode": (lambda m, i: ops.decode_attention(T(X["qd"]), T(X["kv"]), T(X["kv"]),
                                                 T(X["pos"]), mesh=m, impl=i),
               lambda: jops.decode_attention(_j("qd"), _j("kv"), _j("kv"), _j("pos"),
                                             impl="ref")),
}
_WANT: dict = {}


def _want(name):
    if name not in _WANT:
        _WANT[name] = CASES[name][1]()
    return _WANT[name]


def _check(got, want, tol=TOL):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.float().numpy()
        w = np.asarray(w, dtype=np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def _impls(name):
    op = {"flash": "flash_attention", "decode": "decode_attention"}.get(name, name)
    op = "linear_attention" if op.startswith("linattn") else op
    return [i for i in IMPLS if i in dispatch.implementations(op)]


EXEC = [(m, name, impl) for m in MESHES for name in CASES for impl in _impls(name)]


@pytest.mark.parametrize("mesh, name, impl", EXEC, ids=[f"{m}-{n}-{i}" for m, n, i in EXEC])
def test_sharded_op_matches_reference_unsharded(mesh, name, impl):
    reset_degrade_warnings()
    with warnings.catch_warnings():
        warnings.simplefilter("error", ReproDegradeWarning)  # every case shards
        got = CASES[name][0](_mesh(mesh), impl)
    _check(got, _want(name))


def test_every_case_runs_all_three_impls():
    """Every sharded case runs ``cuda``, ``torch`` and ``ref``: decode
    attention too, whose kernel (``hopper/decode_attention.py``) the
    reference lacks (its ``pallas`` impl is the ref form)."""
    assert _impls("decode") == ["cuda", "torch", "ref"]
    assert all(_impls(n) == list(IMPLS) for n in CASES)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gemm_keeps_a_narrow_out_dtype(mesh):
    got = ops.gemm(T(X["a"]), T(X["b"]), mesh=_mesh(mesh), impl="torch", out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _check(got.float(), _want("gemm"), tol=2e-2 * float(np.abs(np.asarray(_want("gemm"))).max()))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_overlapped_stencil_is_bitwise_the_sync_schedule(mesh, impl):
    m = _mesh(mesh)
    grid = T(X["grid"])
    plan = partition.plan_for("stencil", m, grid, offsets=X["offs"], weights=X["w"])
    assert plan.overlappable and plan.hops == 2
    sync = ops.stencil(grid, X["offs"], X["w"], mesh=m, impl=impl, overlap=False)
    ovl = ops.stencil(grid, X["offs"], X["w"], mesh=m, impl=impl, overlap=True)
    assert torch.equal(ovl, sync)


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_stencil_halo_at_every_slab_width(tp):
    m = DeviceMesh({"data": 8 // tp, "model": tp}, device="cpu")
    for overlap in (True, False):
        got = ops.stencil(T(X["grid"]), X["offs"], X["w"], mesh=m, impl="cuda", overlap=overlap)
        _check(got, _want("stencil"))


def test_fallbacks_plan_none_warn_and_agree():
    m = _mesh("2x4")
    q5, ell62 = T(X["q5"]), _ell(X["ell62"])
    reset_degrade_warnings()
    with pytest.warns(ReproDegradeWarning, match="'flash_attention'"):
        got = ops.flash_attention(q5, q5, q5, mesh=m, impl="torch")
    _check(got, jops.flash_attention(*(_j("q5"),) * 3, impl="ref"))
    with pytest.warns(ReproDegradeWarning, match="'spmm'"):
        got = ops.spmm(ell62, T(X["dn"]), mesh=m, impl="torch")
    _check(got, jops.spmm(X["ell62"], _j("dn"), impl="ref"))
    assert partition.plan_for("flash_attention", m, q5, q5, q5) is None
    assert partition.plan_for("spmm", m, ell62.values, ell62.cols, T(X["dn"])) is None


@pytest.mark.parametrize("impl", IMPLS)
def test_ladder_plans_run_on_the_three_axis_mesh(impl):
    m = _mesh("2x2x2")
    q, kv2, ell38 = T(X["q"]), T(X["kv2"]), _ell(X["ell38"])
    assert partition.plan_for("flash_attention", m, q, kv2, kv2).levels == \
        (("data", 2), ("model", 2))
    _check(ops.flash_attention(q, kv2, kv2, mesh=m, impl=impl),
           jops.flash_attention(_j("q"), _j("kv2"), _j("kv2"), impl="ref"))
    assert partition.plan_for("spmm", m, ell38.values, ell38.cols, T(X["dn"])).levels == \
        (("model", 2),)
    _check(ops.spmm(ell38, T(X["dn"]), mesh=m, impl=impl),
           jops.spmm(X["ell38"], _j("dn"), impl="ref"))


def _gcn_inputs():
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((64, 16)).astype(np.float32)
    adj = jsp.random_ell(rng, 64, 64, 0.05)
    params = jgcn.init_params(jax.random.PRNGKey(0), [16, 32, 8])
    want = jgcn.forward(params, adj, jnp.asarray(feats))
    return feats, adj, params, want


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gcn_sharded_matches_reference_forward(mesh):
    feats, adj, params, want = _gcn_inputs()
    m = _mesh(mesh)
    tparams = gcn.params_from_jax([np.asarray(w) for w in params], device="cpu")
    tadj, tfeats = _ell(adj), T(feats)
    _check(gcn.forward(tparams, tadj, tfeats, mesh=m), want)
    with sharding.use_mesh(m):
        assert sharding.kernel_mesh() is m and sharding.current_mesh() is None
        _check(gcn.forward(tparams, tadj, tfeats), want)
    assert sharding.kernel_mesh() is None  # context restored


def test_use_mesh_shards_every_op_inside(monkeypatch):
    m = _mesh("2x4")
    calls = []
    real = partition.sharded_call
    monkeypatch.setattr(partition, "sharded_call",
                        lambda op, mesh, *a, **k: calls.append((op, mesh)) or real(op, mesh, *a, **k))
    a, b = T(X["a"]), T(X["b"])
    with sharding.use_mesh(m):
        ops.gemm(a, b)
        ops.stencil(T(X["grid"]), X["offs"], X["w"])
    ops.gemm(a, b)
    assert calls == [("gemm", m), ("stencil", m)]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_gemm_bf16_policy_one_rounding_per_level(mesh, impl):
    """Each rank runs the scaled GEMM on its K-slab with a bf16 output, and
    the psum sums each group in fp32, rounded once to bf16. Expected: the
    reference's per-slab unsharded calls (bf16 partials) summed exactly;
    held to one bf16 rounding (2^-8 relative) of each level's group sums."""
    m = _mesh(mesh)
    a, b = T(X["a"]), T(X["b"])
    plan = partition.plan_for("gemm", m, a, b, precision="bf16")
    assert plan.note.endswith("bfloat16 reduce")
    got = ops.gemm(a, b, mesh=m, impl=impl, precision="bf16")
    assert got.dtype == torch.float32
    n, K = plan.n, X["a"].shape[1]
    c = K // n
    parts = [np.asarray(jops.gemm(_j("a")[:, s * c:(s + 1) * c], _j("b")[s * c:(s + 1) * c],
                                  precision="bf16", out_dtype=jnp.bfloat16, impl="ref"),
                        dtype=np.float64) for s in range(n)]
    want = np.sum(parts, axis=0)
    bound, sizes, sums = np.zeros_like(want), [s for _, s in plan.levels][::-1], parts
    for size in sizes:  # innermost level first; slabs are outer-major
        sums = [np.sum(sums[g * size:(g + 1) * size], axis=0) for g in range(len(sums) // size)]
        bound += 2.0 ** -8 * np.sum(np.abs(sums), axis=0)
    err = np.abs(got.double().numpy() - want)
    assert (err <= bound + 1e-6).all(), float((err - bound).max())


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------


def test_device_mesh_needs_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceMesh({"data": 2})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RingMesh(2)
    assert DeviceMesh({"data": 2}, device="cpu").devices == [torch.device("cpu")] * 2


def test_device_mesh_rank_arithmetic():
    m = DeviceMesh({"pod": 2, "data": 3, "model": 2}, device="cpu")
    assert m.n == 12 and m.axis_names == ("pod", "data", "model")
    assert m.coords(9) == {"pod": 1, "data": 1, "model": 1}
    assert all(m.rank(m.coords(r)) == r for r in range(m.n))
    assert m.group("data", 9) == [7, 9, 11] and m.group("pod", 3) == [3, 9]
    assert m.groups("model") == [[2 * i, 2 * i + 1] for i in range(6)]
    assert m.chunk(("pod", "model"), 9) == (3, 4) and m.chunk(None, 9) == (0, 1)
    assert isinstance(RingMesh(3, device="cpu"), DeviceMesh)
    assert RingMesh(3, device="cpu").shape == {"data": 3}


def test_shard_and_gather_by_spec_round_trip():
    m = DeviceMesh({"pod": 2, "data": 2, "model": 2}, device="cpu")
    x = torch.arange(8 * 6 * 4.0).reshape(8, 6, 4)
    spec = partition.P(("pod", "model"), "data", None)
    parts = m.shard_spec(x, spec)
    assert [tuple(p.shape) for p in parts] == [(2, 3, 4)] * 8
    assert len({p.data_ptr() for p in parts} | {x.data_ptr()}) == 9  # own allocations
    # rank (pod 1, data 0, model 1) holds slab 3 of dim 0, half 0 of dim 1
    assert torch.equal(parts[m.rank({"pod": 1, "data": 0, "model": 1})], x[6:8, 0:3])
    assert torch.equal(m.gather_spec(parts, spec), x)
    rows = m.shard(x, 0, "model")
    assert torch.equal(rows[m.rank({"pod": 1, "data": 1, "model": 0})], x[:4])
    assert torch.equal(m.gather(rows, 0, entry="model"), x)
    with pytest.raises(ValueError, match="split"):
        m.shard(x, 1, ("pod", "model"))  # 6 rows over 4 ranks


def test_ppermute_and_hierarchical_psum():
    m = DeviceMesh({"pod": 2, "model": 3}, device="cpu")
    parts = [torch.full((2,), float(r)) for r in range(m.n)]
    got = collectives.ppermute(parts, m, "model", [(i, (i + 1) % 3) for i in range(3)])
    assert [int(p[0]) for p in got] == [2, 0, 1, 5, 3, 4]
    got = collectives.ppermute(parts, m, "pod", [(0, 1)])
    assert [int(p[0]) for p in got] == [0, 0, 0, 0, 1, 2]  # rank 0-2 receive nothing: zeros
    vals = torch.randn(m.n, 5, dtype=torch.float32)
    sums = collectives.hierarchical_psum(list(vals.clone()), m, (("pod", 2), ("model", 3)))
    inner = [vals[3 * p] + vals[3 * p + 1] + vals[3 * p + 2] for p in range(2)]
    want = inner[0] + inner[1]  # model first, in increasing index, then pod
    assert all(torch.equal(s, want) for s in sums)
    assert len({s.data_ptr() for s in sums}) == m.n
    bf = [v.to(torch.bfloat16) for v in vals]
    sums = collectives.hierarchical_psum(bf, m, (("model", 3),))
    for p in range(2):
        one = (bf[3 * p].float() + bf[3 * p + 1].float() + bf[3 * p + 2].float()).bfloat16()
        assert all(torch.equal(sums[3 * p + i], one) for i in range(3))


def test_mesh_rows_twin_of_bench_mesh_on_cpu():
    """``launch.mesh_rows`` on a 2x4 CPU mesh: the reference bench's rows in
    its order, each plan's note the reference's on the same operands, the
    sharded outputs within 1e-4 of the single ones (the gemm's K-split sums
    256 products of unit normals in another order), and the overlap rows
    bitwise."""
    from benchmarks import bench_mesh

    from repro_torch.launch import mesh_rows

    rows = mesh_rows.run(mesh_rows.parse_mesh("2x4", device="cpu"), reps=1).json_rows
    jcases = bench_mesh._cases(np.random.default_rng(0))
    assert [r["name"] for r in rows] == [f"mesh_{c[0]}" for c in jcases] + [
        "mesh_overlap_flash_attention_long", "mesh_overlap_stencil"]
    spec = jpart.MeshSpec({"data": 2, "model": 4})
    for row, (_, op, _, args, kw) in zip(rows, jcases):
        want = jpart.plan_for(op, spec, *args, **kw)
        assert row["note"] == want.note.replace(",", ";") and row["mesh"] == "model4"
        assert row["max_err"] <= 1e-4, row
    assert [r["max_err"] for r in rows[-2:]] == [0.0, 0.0]
    assert [r["hops"] for r in rows[-2:]] == [2, 2]
