"""The port's sequence-parallel ring vs the JAX reference on the CPU.

``repro_torch.parallel`` (``RingMesh``, ``ring_schedule``, ``ring_scan``,
``online_softmax_merge``), ``hopper/partition.py`` (the flash rule's batch
split, contiguous and zigzag rings) and ``serving/ring_decode.py``, held to
``repro.parallel.collectives``, ``repro.kernels.partition`` and
``repro.serving.ring_decode`` on the same numpy inputs:

- the hop schedule equals the reference's event for event;
- the merge agrees with the reference's at 1e-6;
- ``ops.flash_attention(mesh=RingMesh(n, device="cpu"))`` agrees with the
  reference's unsharded ``flash_attention`` (the Pallas body in
  ``interpret`` mode and the ``xla`` form) at the reference suite's 1e-4,
  and its plan (note, hops) equals ``repro.kernels.partition.plan_for``'s
  on ``MeshSpec({"data": n})``;
- ring decode is bitwise the port's ``ring_decode_reference`` and within
  1e-5 of the reference's on the same pools.

On the CPU the ranks share no streams and every hop takes the plain
transport; the ring-hop kernel runs only on the card (its test here is
marked ``cuda`` and skips without one).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the card's machine has no JAX: only the `cuda`-marked tests run there
    import jax
    import jax.numpy as jnp
    from repro.core import precision as jprec
    from repro.kernels import flash_attention as jfa
    from repro.kernels import ops as jops
    from repro.kernels import partition as jpartition
    from repro.parallel import collectives as jcoll
    from repro.serving import ring_decode as jrd
except ImportError:
    jax = jnp = jprec = jfa = jops = jpartition = jcoll = jrd = None
from repro_torch.core import precision as prec  # noqa: E402
from repro_torch.diagnostics import ReproDegradeWarning, reset_degrade_warnings  # noqa: E402
from repro_torch.hopper import dispatch, ops, partition, ring_hop  # noqa: E402
from repro_torch.hopper import flash_attention as tfa  # noqa: E402
from repro_torch.launch import ring_attention  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.parallel.mesh import RingMesh  # noqa: E402
from repro_torch.serving import ring_decode as trd  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)  # the reference suite's attention tolerance


# ---------------------------------------------------------------------------
# schedule, scan, merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remote_copy", [False, True])
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("hops", range(1, 9))
def test_ring_schedule_matches_reference(hops, overlap, remote_copy):
    got = collectives.ring_schedule(hops, overlap=overlap, remote_copy=remote_copy)
    want = jcoll.ring_schedule(hops, overlap=overlap, remote_copy=remote_copy)
    assert [(e.kind, e.hop, e.src, e.dst) for e in got] == \
        [(e.kind, e.hop, e.src, e.dst) for e in want]


@pytest.mark.parametrize("overlap", [True, False])
def test_ring_scan_replays_the_schedule(monkeypatch, overlap):
    """ring_scan issues exactly ring_schedule's events (each applied to
    every rank in turn), and at hop t rank me folds the block that left rank
    (me - t) % n; the twin of tests/test_overlap.py's replay test."""
    n = 4
    log = []

    def fake_send(src, dst):
        log.append("send")
        return dst.copy_(src + 100)

    monkeypatch.setattr(collectives, "_hop_send", lambda mesh, remote: fake_send)
    mesh = RingMesh(n, device="cpu")
    folds = {me: [] for me in range(n)}

    def step(me, carry, block, t):
        log.append("fold")
        folds[me].append((t, int(block[0])))
        return carry

    collectives.ring_scan(step, [0] * n, [(torch.tensor(10 * me),) for me in range(n)], mesh,
                          overlap=overlap)
    for me in range(n):
        assert folds[me] == [(t, 10 * ((me - t) % n) + 100 * t) for t in range(n)]
    kinds = [e.kind for e in jcoll.ring_schedule(n, overlap=overlap)]
    assert log == [k for k in kinds for _ in range(n)]  # n-1 sends per rank


@pytest.mark.parametrize("shape", [(2, 4, 8, 16), (1, 2, 5, 8)])
def test_online_softmax_merge_matches_jax(rng, shape):
    o_acc, o = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    lse_acc, lse = (rng.standard_normal(shape[:-1]).astype(np.float32) * 3 for _ in range(2))
    lse_acc[..., 0] = collectives.NEG_LSE  # an empty accumulator row
    lse[..., 1] = collectives.NEG_LSE  # a fully masked partial row
    lse_acc[..., 2] = lse[..., 2] = collectives.NEG_LSE  # masked on both sides
    o_acc[..., 0, :] = 0.0
    got = collectives.online_softmax_merge(*map(torch.from_numpy, (o_acc, lse_acc, o, lse)))
    want = jcoll.online_softmax_merge(*map(jnp.asarray, (o_acc, lse_acc, o, lse)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    assert jcoll.NEG_LSE == collectives.NEG_LSE


MASKS = {"causal": dict(causal=True), "causal_window": dict(causal=True, window=5),
         "noncausal": dict(causal=False)}


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_half_split_merge_reconstructs_full_softmax(rng, mask):
    """tests/test_partition.py's half-split reconstruction, through the
    port's kernels' plain form and merge, against the reference's oracle."""
    kw = MASKS[mask]
    q = rng.standard_normal((1, 4, 32, 8)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, 32, 8)).astype(np.float32) for _ in range(2))
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), impl="ref", **kw)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o = torch.zeros(tq.shape)
    lse = torch.full(tq.shape[:-1], collectives.NEG_LSE)
    half = 16
    for j, off in ((0, 0), (1, -half)):
        o_t, lse_t = ops.flash_attention(tq, tk[:, :, j * half:(j + 1) * half],
                                         tv[:, :, j * half:(j + 1) * half],
                                         return_lse=True, q_offset=off, **kw)
        o, lse = collectives.online_softmax_merge(o, lse, o_t, lse_t)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=9),
                                dict(causal=False), dict(causal=False, window=9)],
                         ids=["causal", "causal_window", "noncausal", "noncausal_window"])
def test_per_shard_q_offset_simulation(rng, kw):
    """tests/test_partition.py's per-(rank, hop) simulation through the
    port: rank me's hop t runs at q_offset t*c on rank (me - t)'s KV chunk,
    wrapped hops of a bounded mask merge as no-ops."""
    d, c = 4, 16
    S = d * c
    q = rng.standard_normal((1, 4, S, 8)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, S, 8)).astype(np.float32) for _ in range(2))
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), impl="ref", **kw)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    bounded = kw.get("causal") or kw.get("window", 0)
    outs = []
    for me in range(d):
        q_l = tq[:, :, me * c:(me + 1) * c]
        o = torch.zeros(q_l.shape)
        lse = torch.full(q_l.shape[:-1], collectives.NEG_LSE)
        for t in range(d):
            src = (me - t) % d
            o_t, lse_t = ops.flash_attention(q_l, tk[:, :, src * c:(src + 1) * c],
                                             tv[:, :, src * c:(src + 1) * c],
                                             return_lse=True, q_offset=t * c, **kw)
            if bounded and t and me < t:
                continue
            o, lse = collectives.online_softmax_merge(o, lse, o_t, lse_t)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, dim=2).numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_zigzag_permutation_equals_reference(d):
    S = 16 * d
    np.testing.assert_array_equal(tfa.zigzag_indices(S, d), jfa.zigzag_indices(S, d))
    np.testing.assert_array_equal(tfa.zigzag_inverse(S, d), jfa.zigzag_inverse(S, d))


# ---------------------------------------------------------------------------
# the flash ring
# ---------------------------------------------------------------------------

# (B, H, K, S, D, causal, window, q_offset, return_lse, zigzag)
RING_CASES = {
    "zigzag_causal": (1, 4, 4, 32, 16, True, 0, 0, True, True),
    "contiguous_causal": (1, 4, 4, 32, 16, True, 0, 0, True, False),
    "zigzag_gqa": (1, 4, 2, 32, 16, True, 0, 0, False, True),
    "window_pruned": (1, 4, 2, 32, 16, True, 5, 0, True, True),
    "window_noncausal": (1, 2, 2, 32, 16, False, 5, 0, True, True),
    "noncausal_gqa": (1, 4, 2, 32, 16, False, 0, 0, True, True),
    "noncausal_q_offset": (1, 2, 2, 32, 16, False, 0, 7, True, True),
    "causal_q_offset_declines": (1, 2, 2, 32, 16, True, 0, 7, True, True),
    "batch_split": (4, 4, 2, 16, 16, True, 0, 0, True, True),
}
_JAX_FA: dict = {}


def _ring_inputs(case):
    B, H, K, S, D, causal, window, q_offset, return_lse, zigzag = RING_CASES[case]
    rng = np.random.default_rng(sorted(RING_CASES).index(case))
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, K, S, D)).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset, return_lse=return_lse)
    return (q, k, v), kw, zigzag


def _jax_fa(case):
    """The reference's unsharded flash attention on the case's inputs,
    Pallas body (interpret) and xla form; computed once per case."""
    if case not in _JAX_FA:
        (q, k, v), kw, _ = _ring_inputs(case)
        jargs = tuple(map(jnp.asarray, (q, k, v)))
        _JAX_FA[case] = [jops.flash_attention(*jargs, impl=impl, **kw)
                         for impl in ("interpret", "xla")]
    return _JAX_FA[case]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_flash_ring_matches_jax_unsharded(case, n):
    (q, k, v), kw, zigzag = _ring_inputs(case)
    mesh = RingMesh(n, device="cpu")
    reset_degrade_warnings()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), mesh=mesh, zigzag=zigzag,
                                  **kw)
    declined = [w for w in caught if issubclass(w.category, ReproDegradeWarning)]
    assert len(declined) == (case == "causal_q_offset_declines")
    got = got if kw["return_lse"] else (got,)
    for want in _jax_fa(case):
        want = want if kw["return_lse"] else (want,)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_flash_plan_matches_reference(case, n):
    (q, k, v), kw, zigzag = _ring_inputs(case)
    kw = {**kw, "zigzag": zigzag}
    reset_degrade_warnings()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = partition.flash_plan(RingMesh(n, device="cpu"),
                                   *map(torch.from_numpy, (q, k, v)), **kw)
        want = jpartition.plan_for(
            "flash_attention", jpartition.MeshSpec({"data": n}),
            *(jax.ShapeDtypeStruct(x.shape, jnp.float32) for x in (q, k, v)), **kw)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.note, got.hops, got.overlappable, got.pre is None) == \
            (want.note, want.hops, want.overlappable, want.pre is None)
        assert want.levels == (("data", n),)


@pytest.mark.parametrize("case", ["zigzag_causal", "contiguous_causal", "window_pruned"])
def test_remote_copy_on_cpu_warns_once_and_is_bitwise(case):
    (q, k, v), kw, zigzag = _ring_inputs(case)
    args = tuple(map(torch.from_numpy, (q, k, v)))
    mesh = RingMesh(4, device="cpu")
    plain = ops.flash_attention(*args, mesh=mesh, zigzag=zigzag, **kw)
    reset_degrade_warnings()
    dispatch.reset_launches()
    with pytest.warns(ReproDegradeWarning, match="remote_copy"):
        got = ops.flash_attention(*args, mesh=mesh, zigzag=zigzag, remote_copy=True, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error", ReproDegradeWarning)  # one-shot: no second warning
        again = ops.flash_attention(*args, mesh=mesh, zigzag=zigzag, remote_copy=True, **kw)
    for g, a, p in zip(got, again, plain):
        assert torch.equal(g, p) and torch.equal(a, p)
    assert not dispatch.LAUNCHES  # CPU tensors launch nothing


@pytest.mark.parametrize("overlap", [True, False])
def test_ring_overlap_and_sync_agree_bitwise(overlap):
    (q, k, v), kw, _ = _ring_inputs("zigzag_causal")
    args = tuple(map(torch.from_numpy, (q, k, v)))
    mesh = RingMesh(4, device="cpu")
    got = ops.flash_attention(*args, mesh=mesh, overlap=overlap, **kw)
    want = ops.flash_attention(*args, mesh=mesh, overlap=not overlap, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_ring_mesh_parts_are_own_allocations():
    x = torch.arange(48.0).reshape(2, 24)
    mesh = RingMesh(3, device="cpu")
    parts = mesh.shard(x, 1)
    assert [tuple(p.shape) for p in parts] == [(2, 8)] * 3
    assert len({p.data_ptr() for p in parts} | {x.data_ptr()}) == 4
    assert torch.equal(mesh.gather(parts, 1), x)
    reps = mesh.replicate(x)
    assert all(torch.equal(r, x) and r.data_ptr() != x.data_ptr() for r in reps)
    assert mesh.streams == [None] * 3
    with pytest.raises(ValueError, match="split"):
        mesh.shard(x, 0)


def test_flash_mesh_argument_errors():
    """mesh= takes a mesh object; every op, gemm included, now shards over
    a RingMesh (its one ``data`` axis is gemm's partition level)."""
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(TypeError, match="DeviceMesh"):
        ops.flash_attention(q, q, q, mesh="data")
    a = torch.arange(32.0).reshape(8, 4)
    got = ops.gemm(a, a.T, mesh=RingMesh(2, device="cpu"))
    assert torch.equal(got, ops.gemm(a, a.T))


def test_ring_hop_wrapper_on_cpu_takes_the_plain_version():
    src = torch.arange(37, dtype=torch.uint8)
    dst = torch.zeros_like(src)
    dispatch.reset_launches()
    assert ring_hop.ring_hop_cuda(src, dst) is dst
    assert torch.equal(dst, src)
    assert not dispatch.LAUNCHES


@pytest.mark.parametrize("nbytes", [1, 16, 4095, 16 << 10, 256 << 10, 4 << 20, 8 << 20, 64 << 20])
@pytest.mark.parametrize("same_card", [True, False])
def test_hop_plan_sizes_the_grid_to_the_block_and_the_card(nbytes, same_card):
    """The bulk kernel only on one card and from BULK_MIN_BYTES on, one CTA
    per chunk up to the cap; the words kernel one CTA per THREADS 16-byte
    words up to the cap, so each of its threads moves at most one word per
    pass below the cap; never more than CTAS_PER_SM CTAs an SM."""
    sms = 132
    bulk, grid = ring_hop.hop_plan(nbytes, sms, same_card)
    cap = sms * ring_hop.CTAS_PER_SM
    assert 1 <= grid <= cap
    assert bulk == (same_card and nbytes >= ring_hop.BULK_MIN_BYTES)
    per_cta = ring_hop.CHUNK if bulk else 16 * ring_hop.THREADS
    assert grid == min(-(-nbytes // per_cta), cap)
    # every byte has a CTA: the grid's first pass, or passes of the cap
    assert grid * per_cta >= nbytes or grid == cap


# ---------------------------------------------------------------------------
# ring decode
# ---------------------------------------------------------------------------


def _localize(kp, vp, tbl, n):
    """tests/test_paged_decode.py's re-homing of a global paged layout to
    the ring convention: rank r's local pool (slot 0 its null page) holds
    the pages behind table columns [r*nb_l, (r+1)*nb_l), which index it."""
    B, nb = tbl.shape
    nb_l = nb // n
    K, bs, D = kp.shape[1:]
    p_l = B * nb_l + 1
    k_out = np.zeros((n * p_l, K, bs, D), kp.dtype)
    v_out = np.zeros_like(k_out)
    t_out = np.zeros((B, nb), np.int32)
    for r in range(n):
        nxt = 1
        for b in range(B):
            for j in range(r * nb_l, (r + 1) * nb_l):
                k_out[r * p_l + nxt] = kp[tbl[b, j]]
                v_out[r * p_l + nxt] = vp[tbl[b, j]]
                t_out[b, j] = nxt
                nxt += 1
    return k_out, v_out, t_out


def _ring_pools(n, B=3, H=8, K=4, D=16, bs=8, nb=8):
    rng = np.random.default_rng(n)
    S = nb * bs
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, K, S, D)).astype(np.float32) for _ in range(2))
    pos = rng.integers(1, S, B).astype(np.int32)
    tbl = (rng.permutation(B * nb) + 1).reshape(B, nb).astype(np.int32)
    kp = np.zeros((B * nb + 1, K, bs, D), np.float32)
    vp = np.zeros_like(kp)
    for b in range(B):
        for j in range(nb):
            kp[tbl[b, j]] = k[b, :, j * bs:(j + 1) * bs]
            vp[tbl[b, j]] = v[b, :, j * bs:(j + 1) * bs]
    return q, pos, *_localize(kp, vp, tbl, n)


@pytest.mark.parametrize("pools", ["fp32", "fp8"])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_decode_bitwise_and_matches_jax(n, pools):
    q, pos, kl, vl, tl = _ring_pools(n)
    T = torch.from_numpy
    tk, tv, scales, jk, jv, jscales = T(kl), T(vl), {}, jnp.asarray(kl), jnp.asarray(vl), {}
    if pools == "fp8":
        tk, ks, tv, vs = prec.quantize_kv_cache(tk, tv, "fp8")
        jk, jks, jv, jvs = jprec.quantize_kv_cache(jk, jv, "fp8")
        scales, jscales = dict(k_scale=ks, v_scale=vs), dict(k_scale=jks, v_scale=jvs)
    mesh = RingMesh(n, device="cpu")
    args = (T(q), tk, tv, T(tl), T(pos))
    got = trd.ring_decode(*args, mesh, **scales)
    assert torch.equal(got, trd.ring_decode_reference(*args, n, **scales))
    assert torch.equal(got, trd.ring_decode(*args, mesh, overlap=False, **scales))
    want = jrd.ring_decode_reference(jnp.asarray(q), jk, jv, jnp.asarray(tl),
                                     jnp.asarray(pos), n, **jscales)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ring_decode_rejects_indivisible_tables():
    q, pos, kl, vl, tl = _ring_pools(2)
    T = torch.from_numpy
    with pytest.raises(ValueError, match="split over"):
        trd.ring_decode(T(q), T(kl), T(vl), T(tl[:, :7]), T(pos), RingMesh(2, device="cpu"))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def test_ring_attention_run_small_on_cpu():
    reset_degrade_warnings()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ReproDegradeWarning)  # remote_copy on the CPU
        out = ring_attention.run(device="cpu", cases=ring_attention.SMALL)
    cases = ring_attention.SMALL
    assert out["device"] == "cpu" and out["ranks"] == 4 and out["cards"] == 1
    assert [r["bytes"] for r in out["hops"]] == list(cases.hop_bytes)
    timed = 1 + cases.hop_iters  # a warm-up call, then the timed ones
    for r in out["hops"]:
        assert r["bitwise"] and r["calls"] == 1 + 3 * timed  # check, 2 cold turns, warm
        assert r["hop_ms"] == min(r["hop_turns_ms"]) and len(r["copy_turns_ms"]) == 2
    assert len(out["flash"]) == len(cases.flash)
    for row, case in zip(out["flash"], cases.flash):
        _, B, S, causal, window, zigzag = case
        spec = jax.ShapeDtypeStruct((B, cases.heads, S, cases.head_dim), jnp.float32)
        kv = jax.ShapeDtypeStruct((B, cases.kv_heads, S, cases.head_dim), jnp.float32)
        want = jpartition.plan_for("flash_attention", jpartition.MeshSpec({"data": 4}),
                                   spec, kv, kv, causal=causal, window=window, zigzag=zigzag)
        assert (row["note"], row["hops"]) == (want.note, want.hops)
        assert row["bitwise_overlap"] and row["bitwise_remote_copy"]
        assert row["max_abs_err"] <= 1e-4 * max(1.0, row["max_abs_full"])
        assert row["rel_err"] <= 1e-4
        timed = 1 + cases.iters
        assert row["calls"] == {"overlap": 1 + timed, "sync": 1 + timed, "copy": 1,
                                "full": 1 + timed}
        assert row["launches"] == {"overlap": {}, "sync": {}, "copy": {}}
        assert row["ring_ms"] is not None  # host clock, CPU
    assert [r["pools"] for r in out["decode"]] == ["float32", "fp8"]
    for row in out["decode"]:
        assert row["bitwise_reference"] and row["bitwise_overlap"]
        assert row["rel_err_contiguous"] <= 1e-5 and row["launches"] == {}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_ring_hop_bitwise_at_every_offset():
    """1 B to 64 MiB + 3 B, src and dst at every offset mod 16 (the words
    kernel's head, body and tail, its byte path for relatively misaligned
    pairs, and the bulk kernel from BULK_MIN_BYTES on): bitwise copy_."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ring-hop kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for nbytes in (1, 2, 15, 16, 17, 31, 4095, 65541, (1 << 20) + 7, (8 << 20) + 5, (64 << 20) + 3):
        src_buf = torch.randint(0, 256, (nbytes + 16,), dtype=torch.uint8, generator=gen, device="cuda")
        dst_buf = torch.empty(nbytes + 16, dtype=torch.uint8, device="cuda")
        for a in range(16):
            for b in range(16):
                src, dst = src_buf[a:a + nbytes], dst_buf[b:b + nbytes]
                dst.zero_()
                ring_hop.ring_hop_cuda(src, dst)
                assert torch.equal(dst, src), (nbytes, a, b)


@pytest.mark.cuda
def test_cuda_ring_hop_and_flash_ring_launch_counts():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ring-hop kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for nbytes, off in ((1, 0), (17, 3), (4099, 5), (1 << 20, 0)):
        buf = torch.randint(0, 256, (nbytes + off,), dtype=torch.uint8, generator=gen,
                            device="cuda")
        src = buf[off:]
        dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
        ring_hop.ring_hop_cuda(src, dst)
        torch.cuda.synchronize()
        assert torch.equal(dst, src)
    mesh = RingMesh(4)
    q, k, v = (torch.randn((1, 4, 256, 64), generator=gen, device="cuda") for _ in range(3))
    full = ops.flash_attention(q, k, v)
    dispatch.reset_launches()
    got = ops.flash_attention(q, k, v, mesh=mesh, remote_copy=True)
    torch.cuda.synchronize()
    assert dict(dispatch.LAUNCHES) == {"ring_hop": 24, "flash_attention": 28}
    np.testing.assert_allclose(got.cpu().numpy(), full.cpu().numpy(), **TOL)
