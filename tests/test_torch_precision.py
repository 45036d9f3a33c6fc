"""Port precision ladder vs the JAX reference on the CPU.

The same seeded numpy inputs go through ``repro.core.precision`` /
``repro.kernels.ops`` and their counterparts in ``repro_torch``:

- quantization (``quantize_blockwise``, ``dequantize_blockwise``,
  ``quantize_kv_cache``) is bitwise the reference's for all four policies,
  ragged and zero blocks included;
- the scaled ``gemm``, ``flash_attention`` and ``decode_attention`` of
  every port impl (``cuda`` runs its plain form on CPU tensors) agree with
  the reference's ``interpret`` (Pallas body) and ``xla`` impls at the
  reference suite's cross-impl bound (Frobenius rel 1e-4), and with the
  fp32 oracle at its tolerances;
- paged fp8 decode with pool scales is bitwise contiguous decode;
- ``precision=None`` is bitwise the legacy path;
- ``launch.precision_ladder`` at the bench's sizes draws the bench's
  operands and matches the reference ops on them.

The two Hopper kernels run only on the card: their test is marked
``cuda`` and skips without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import precision as jprec  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.serving.paged_cache import init_paged_cache as jinit_paged_cache  # noqa: E402
from repro_torch.core import precision as prec  # noqa: E402
from repro_torch.hopper import blocked, dispatch, ops  # noqa: E402
from repro_torch.hopper.flash_attention_scaled import flash_attention_scaled_kernel  # noqa: E402
from repro_torch.hopper.gemm_scaled import gemm_scaled_kernel  # noqa: E402
from repro_torch.launch import precision_ladder as pl  # noqa: E402
from repro_torch.serving.paged_cache import init_paged_cache  # noqa: E402

POLICIES = ("fp32", "bf16", "fp8", "fp8_e5m2")
CROSS_IMPL_REL = 1e-4  # tests/test_precision.py:125-126, 142-143
# against the fp32 oracle: the reference's _GEMM_TOL (tests/test_precision.py:108);
# its attention tolerances (:129) for bf16 and fp8, fp32 at the GEMM's, e5m2 at 0.2
ORACLE_TOL = {"fp32": 1e-5, "bf16": 0.02, "fp8": 0.1, "fp8_e5m2": 0.2}
PORT_IMPLS = ("cuda", "torch", "ref")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype != torch.float32 else x.numpy()
    return np.asarray(x, np.float32)


def _bytes(x):
    """Raw bytes of a torch or JAX array (fp8/bf16 compared bit for bit)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


def _rel(got, want):
    g, w = _np(got), _np(want)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


# ---------------------------------------------------------------------------
# policies and quantization
# ---------------------------------------------------------------------------


def test_resolve_policy_seam():
    assert prec.resolve(None) is None
    p = prec.resolve("fp8")
    assert p.compute_dtype == torch.float8_e4m3fn and p.scale_block == 128
    assert prec.resolve(p) is p
    assert prec.resolve("fp8_e5m2").compute_dtype == torch.float8_e5m2
    with pytest.raises(KeyError, match="known:"):
        prec.resolve("fp4")
    assert prec.supported_policies("gemm") == POLICIES
    assert prec.supported_policies("spmm") == ("fp32",)
    assert prec.SUPPORTED_OPS == jprec.SUPPORTED_OPS
    for name, p in prec.POLICIES.items():
        jp = jprec.POLICIES[name]
        assert p.scale_block == jp.scale_block
        assert str(p.compute_dtype).split(".")[-1] == jnp.dtype(jp.compute_dtype).name


# (shape, axis, block): ragged final blocks, a block past the axis, the
# policy's default block and a whole-axis block
QUANT_CASES = {
    "ragged_rows": ((5, 300), -1, 128),
    "ragged_cols_axis0": ((160, 7), 0, 64),
    "default_block": ((3, 4, 260), -1, None),
    "block_past_axis": ((6, 40), 1, 128),
    "kv_rows_3d": ((2, 3, 16), -1, 16),
}


def _quant_input(rng, shape):
    x = rng.standard_normal(shape) * 10.0 ** rng.integers(-6, 6, shape[:-1] + (1,))
    x = x.astype(np.float32)
    x.reshape(-1)[: x.size // 3] = 0  # whole zero blocks (scale 1.0)
    return x


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantize_blockwise_is_bitwise_the_reference(rng, pol, case):
    shape, axis, block = QUANT_CASES[case]
    x = _quant_input(rng, shape)
    jv, js = jprec.quantize_blockwise(jnp.asarray(x), pol, axis=axis, block=block)
    tv, ts = prec.quantize_blockwise(torch.from_numpy(x), pol, axis=axis, block=block)
    assert tv.dtype == prec.resolve(pol).compute_dtype and ts.dtype == torch.float32
    assert tuple(tv.shape) == jv.shape and tuple(ts.shape) == js.shape
    assert tv.is_contiguous() and ts.is_contiguous()
    assert _bytes(tv) == _bytes(jv)
    assert _bytes(ts) == _bytes(js)
    # the reconstruction, with the explicit block and (where unambiguous) without
    jd = jprec.dequantize_blockwise(jv, js, axis=axis, block=block)
    td = prec.dequantize_blockwise(tv, ts, axis=axis, block=block)
    assert _bytes(td) == _bytes(jd)
    jd = jprec.dequantize_blockwise(jv, js, axis=axis)
    td = prec.dequantize_blockwise(tv, ts, axis=axis)
    assert _bytes(td) == _bytes(jd)


def test_zero_blocks_take_unit_scales_and_roundtrip_exactly():
    x = torch.zeros((2, 256))
    vals, scales = prec.quantize_blockwise(x, "fp8", axis=-1, block=128)
    assert torch.equal(scales, torch.ones((2, 2)))
    assert torch.equal(prec.dequantize_blockwise(vals, scales, axis=-1, block=128), x)


@pytest.mark.parametrize("pol", POLICIES)
def test_quantize_kv_cache_is_bitwise_the_reference(rng, pol):
    k = rng.standard_normal((2, 4, 32, 16)).astype(np.float32)
    v = (rng.standard_normal((2, 4, 32, 16)) * 1e-3).astype(np.float32)
    k[0, 1, 3] = 0  # a zero row
    want = jprec.quantize_kv_cache(jnp.asarray(k), jnp.asarray(v), pol)
    got = prec.quantize_kv_cache(torch.from_numpy(k), torch.from_numpy(v), pol)
    assert tuple(got[1].shape) == (2, 4, 32, 1)
    for g, w in zip(got, want):
        assert _bytes(g) == _bytes(w)


@pytest.mark.parametrize("pol", POLICIES)
def test_expanding_gemm_matches_jax(rng, pol):
    a = rng.standard_normal((24, 40)).astype(np.float32)
    b = rng.standard_normal((40, 16)).astype(np.float32)
    want = jprec.expanding_gemm(jnp.asarray(a), jnp.asarray(b), pol, impl="ref")
    got = prec.expanding_gemm(torch.from_numpy(a), torch.from_numpy(b), pol, impl="ref")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# scaled ops vs the reference's impls and the fp32 oracle
# ---------------------------------------------------------------------------

# (M, K, N, bk): the reference suite's shape at bk 64, ragged K at the
# default bk 256, K past one default block
GEMM_CASES = {"bk64": (96, 160, 80, 64), "ragged_default_bk": (33, 70, 20, None),
              "two_blocks_default_bk": (40, 300, 24, None)}


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("case", sorted(GEMM_CASES))
def test_scaled_gemm_matches_jax(rng, pol, case):
    M, K, N, bk = GEMM_CASES[case]
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    want = {impl: jops.gemm(ja, jb, precision=pol, impl=impl, bk=bk)
            for impl in ("interpret", "xla")}
    oracle = jref.gemm_ref(ja, jb, jnp.float32)
    dispatch.reset_launches()
    for impl in PORT_IMPLS:
        got = ops.gemm(torch.from_numpy(a), torch.from_numpy(b), precision=pol, impl=impl, bk=bk)
        assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
        for w in want.values():
            assert _rel(got, w) < CROSS_IMPL_REL, impl
        assert _rel(got, oracle) < ORACLE_TOL[pol], impl
    assert not dispatch.LAUNCHES  # CPU tensors take the plain form


# (B, H, K, Sq, Sk, D, causal, window, q_offset)
FA_CASES = {
    "causal_gqa": (1, 4, 2, 64, 64, 32, True, 0, 0),
    "window_q_offset_ragged": (2, 2, 1, 20, 53, 16, True, 9, 33),
    "noncausal_ragged": (1, 2, 2, 33, 45, 16, False, 0, 0),
}


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_scaled_flash_attention_matches_jax(rng, pol, case):
    B, H, K, Sq, Sk, D, causal, window, q_offset = FA_CASES[case]
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, K, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, K, Sk, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset, return_lse=True)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = {"interpret": jops.flash_attention(jq, jk, jv, precision=pol, impl="interpret",
                                              bq=32, bk=16, **kw),
            "xla": jops.flash_attention(jq, jk, jv, precision=pol, impl="xla", **kw)}
    oracle = jref.mha_ref(jq, jk, jv, causal=causal, window=window, q_offset=q_offset)
    for impl in PORT_IMPLS:
        o, lse = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), precision=pol,
                                     impl=impl, **kw)
        assert o.dtype == torch.float32 and lse.dtype == torch.float32
        for wo, wl in want.values():
            assert _rel(o, wo) < CROSS_IMPL_REL, impl
            np.testing.assert_allclose(lse.numpy(), np.asarray(wl), rtol=1e-4, atol=1e-4)
        assert _rel(o, oracle) < ORACLE_TOL[pol], impl


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("window", [0, 7])
def test_scaled_decode_attention_matches_jax(rng, pol, window):
    q = rng.standard_normal((2, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, 4, 40, 16)).astype(np.float32)
    v = rng.standard_normal((2, 4, 40, 16)).astype(np.float32)
    pos = np.array([5, 37])
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos, jnp.int32))
    want = {impl: jops.decode_attention(*jargs, precision=pol, impl=impl, window=window, bs=16)
            for impl in ("xla", "ref")}
    oracle = jref.decode_attention_ref(*jargs, window=window)
    targs = (*map(torch.from_numpy, (q, k, v)), torch.from_numpy(pos))
    for impl in ("torch", "ref"):
        got = ops.decode_attention(*targs, precision=pol, impl=impl, window=window, bs=16)
        for w in want.values():
            assert _rel(got, w) < CROSS_IMPL_REL, impl
        assert _rel(got, oracle) < ORACLE_TOL[pol], impl


def _paged(rng, *, B=3, K=4, S=64, D=16, bs=16):
    """A contiguous cache and the same rows as a shuffled page pool."""
    k = rng.standard_normal((B, K, S, D)).astype(np.float32)
    v = rng.standard_normal((B, K, S, D)).astype(np.float32)
    nb = S // bs
    perm = rng.permutation(B * nb) + 1  # never the null page 0
    table = perm.reshape(B, nb).astype(np.int32)
    kp = np.zeros((B * nb + 1, K, bs, D), np.float32)
    vp = np.zeros_like(kp)
    for b in range(B):
        for j in range(nb):
            kp[table[b, j]] = k[b, :, j * bs:(j + 1) * bs]
            vp[table[b, j]] = v[b, :, j * bs:(j + 1) * bs]
    return k, v, kp, vp, table


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("impl", ["torch", "ref"])
def test_paged_decode_is_bitwise_contiguous_under_precision(rng, pol, impl):
    k, v, kp, vp, table = _paged(rng)
    q = torch.from_numpy(rng.standard_normal((3, 8, 16)).astype(np.float32))
    pos = torch.tensor([3, 40, 63])
    want = ops.decode_attention(q, torch.from_numpy(k), torch.from_numpy(v), pos,
                                precision=pol, impl=impl, bs=16)
    # quantize at use over the pool's pages
    got = ops.decode_attention(q, torch.from_numpy(kp), torch.from_numpy(vp), pos,
                               precision=pol, impl=impl, paged=True,
                               block_table=torch.from_numpy(table))
    assert torch.equal(got, want)
    # a pool already held narrow, with its per-row scales
    kq, ks, vq, vs = prec.quantize_kv_cache(torch.from_numpy(kp), torch.from_numpy(vp), pol)
    got = ops.decode_attention(q, kq, vq, pos, impl=impl, paged=True,
                               block_table=torch.from_numpy(table), k_scale=ks, v_scale=vs)
    assert torch.equal(got, want)


def test_paged_fp8_pool_decode_matches_jax(rng):
    k, v, kp, vp, table = _paged(rng)
    q = rng.standard_normal((3, 8, 16)).astype(np.float32)
    pos = np.array([3, 40, 63])
    jkq, jks, jvq, jvs = jprec.quantize_kv_cache(jnp.asarray(kp), jnp.asarray(vp), "fp8")
    want = jops.decode_attention(jnp.asarray(q), jkq, jvq, jnp.asarray(pos, jnp.int32),
                                 paged=True, block_table=jnp.asarray(table), k_scale=jks,
                                 v_scale=jvs, impl="xla")
    kq, ks, vq, vs = prec.quantize_kv_cache(torch.from_numpy(kp), torch.from_numpy(vp), "fp8")
    got = ops.decode_attention(torch.from_numpy(q), kq, vq, torch.from_numpy(pos), paged=True,
                               block_table=torch.from_numpy(table), k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_precision_none_is_the_legacy_path_bitwise(rng, impl):
    a = torch.from_numpy(rng.standard_normal((32, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    assert torch.equal(ops.gemm(a, b, impl=impl, precision=None), ops.gemm(a, b, impl=impl))
    q = torch.from_numpy(rng.standard_normal((1, 2, 20, 16)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 2, 20, 16)).astype(np.float32))
    for g, w in zip(ops.flash_attention(q, kv, kv, impl=impl, precision=None, return_lse=True),
                    ops.flash_attention(q, kv, kv, impl=impl, return_lse=True)):
        assert torch.equal(g, w)
    dimpl = "torch" if impl == "cuda" else impl
    pos = torch.tensor([19])
    assert torch.equal(ops.decode_attention(q[:, :, 0], kv, kv, pos, impl=dimpl, precision=None),
                       ops.decode_attention(q[:, :, 0], kv, kv, pos, impl=dimpl))
    # the fp32 *policy* runs the scaled machinery with unit scales
    assert _rel(ops.gemm(a, b, impl=impl, precision="fp32"), ops.gemm(a, b, impl=impl)) < 1e-5


def test_scaled_argument_checks(rng):
    a = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
    with pytest.raises(KeyError, match="known:"):
        ops.gemm(a, a.T, precision="fp4")
    with pytest.raises(NotImplementedError, match="accum_dtype"):
        ops.gemm(a, a.T, precision="fp8", accum_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="mesh"):
        ops.gemm(a, a.T, precision="fp8", mesh=object())
    q, kv = torch.zeros((1, 8, 16)), torch.zeros((1, 4, 16, 16))
    kq, ks, vq, vs = prec.quantize_kv_cache(kv, kv, "fp8")
    with pytest.raises(TypeError, match="k_scale"):
        ops.decode_attention(q, kq, vq, torch.tensor([3]), k_scale=ks, v_scale=vs)
    with pytest.raises(TypeError, match="mesh"):
        ops.decode_attention(q, kv, kv, torch.tensor([3]), precision="fp8", mesh=object())
    with pytest.raises(TypeError, match="mesh"):
        ops.flash_attention(kv, kv, kv, precision="fp8", mesh=object())


def test_kernel_wrappers_take_the_plain_form_on_cpu_only(rng):
    a = torch.from_numpy(rng.standard_normal((20, 70)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((70, 12)).astype(np.float32))
    aq, a_s = prec.quantize_blockwise(a, "fp8", axis=1, block=32)
    bq, b_s = prec.quantize_blockwise(b, "fp8", axis=0, block=32)
    dispatch.reset_launches()
    assert torch.equal(gemm_scaled_kernel(aq, bq, a_s, b_s, bk=32),
                       blocked.gemm_scaled_values_blocked(aq, bq, a_s, b_s, bk=32))
    q = torch.from_numpy(rng.standard_normal((1, 2, 20, 16)).astype(np.float32))
    quant = [prec.quantize_blockwise(q, "fp8_e5m2", axis=-1, block=16)] * 3
    args = [x for x, _ in quant] + [s for _, s in quant]
    assert torch.equal(flash_attention_scaled_kernel(*args, window=5),
                       blocked.flash_attention_scaled_values_blocked(*args, window=5))
    assert not dispatch.LAUNCHES
    meta = [x.to("meta") for x in (aq, bq, a_s, b_s)]
    with pytest.raises(ValueError, match="CUDA"):
        gemm_scaled_kernel(*meta, bk=32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_scaled_kernel(*(x.to("meta") for x in args))


# ---------------------------------------------------------------------------
# paged cache with fp8 pools
# ---------------------------------------------------------------------------


class _Cfg:
    num_layers, num_kv_heads, vocab_size = 2, 4, 128
    dtype = "float32"

    def resolved_head_dim(self):
        return 16


@pytest.mark.parametrize("pol", ["fp8", "fp8_e5m2", "bf16"])
def test_paged_cache_quantized_write_and_roundtrip(rng, pol):
    cache = init_paged_cache(_Cfg(), num_blocks=8, block_size=4, policy=pol, device="cpu")
    jcache = jinit_paged_cache(_Cfg(), num_blocks=8, block_size=4, policy=pol)
    assert cache.quantized and cache.num_blocks == 8
    assert tuple(cache.k_scale.shape) == jcache.k_scale.shape == (2, 8, 4, 4, 1)
    k_rows = rng.standard_normal((2, 3, 4, 4, 16)).astype(np.float32)
    v_rows = rng.standard_normal((2, 3, 4, 4, 16)).astype(np.float32)
    ids = [2, 5, 7]
    cache.write_prompt(ids, torch.from_numpy(k_rows), torch.from_numpy(v_rows))
    jcache = jcache.write_prompt(jnp.asarray(ids), jnp.asarray(k_rows), jnp.asarray(v_rows))
    for name in ("k_pool", "v_pool", "k_scale", "v_scale"):
        assert _bytes(getattr(cache, name)) == _bytes(getattr(jcache, name)), name
    payload = cache.gather_blocks(ids)
    assert set(payload) == {"k", "v", "k_scale", "v_scale"}
    before = {n: t.clone() for n, t in payload.items()}
    cache.k_pool.view(torch.uint8).zero_()  # later steps overwrite the freed pages
    cache.restore_blocks([1, 3, 6], payload)
    assert _bytes(cache.k_pool[:, [1, 3, 6]]) == _bytes(before["k"])
    assert torch.equal(cache.k_scale[:, [1, 3, 6]], before["k_scale"])


# ---------------------------------------------------------------------------
# the entry point vs bench_precision
# ---------------------------------------------------------------------------


def test_precision_ladder_matches_the_reference_bench():
    cases = pl.make_cases(pl.BENCH)
    # bench_precision.run's draws, in its order, from default_rng(0)
    rng = np.random.default_rng(0)
    m, k, n = pl.BENCH.gemm
    B, H, K, S, D = pl.BENCH.fa
    Bd, _, _, Sd, _ = pl.BENCH.decode
    shapes = [(m, k), (k, n), (B, H, S, D), (B, K, S, D), (B, K, S, D), (Bd, H, D),
              (Bd, K, Sd, D), (Bd, K, Sd, D)]
    drawn = [jnp.asarray(rng.standard_normal(s), jnp.float32) for s in shapes]
    ours = [x for c in cases for x in c.operands[:4] if x.dtype == torch.float32]
    assert len(ours) == len(drawn)
    for t, j in zip(ours, drawn):
        assert _bytes(t) == _bytes(j)
    a, b, q, kf, vf, qd, kc, vc = drawn
    pos = jnp.full((Bd,), Sd - 1, jnp.int32)
    jax_ops = {
        "gemm": (lambda pol: jops.gemm(a, b, precision=pol, impl="xla"), jref.gemm_ref(a, b, jnp.float32)),
        "flash_attention": (lambda pol: jops.flash_attention(q, kf, vf, causal=True, precision=pol,
                                                             impl="xla"),
                            jref.mha_ref(q, kf, vf, causal=True)),
        "decode_attention": (lambda pol: jops.decode_attention(qd, kc, vc, pos, precision=pol,
                                                               impl="xla"),
                             jref.decode_attention_ref(qd, kc, vc, pos)),
    }
    dispatch.reset_launches()
    rows = pl.run(device="cpu", cases=cases)
    assert not dispatch.LAUNCHES
    assert [(r.op, r.policy) for r in rows] == [(op, p) for op in jax_ops for p in pl.POLICY_NAMES]
    for r in rows:
        fn, oracle = jax_ops[r.op]
        want = fn(r.policy)
        assert _rel(r.out, want) < CROSS_IMPL_REL, (r.op, r.policy)
        # the bench's _err against its oracle
        diff = np.asarray(want, np.float32) - np.asarray(oracle, np.float32)
        bench_rel = float(np.linalg.norm(diff) / np.linalg.norm(np.asarray(oracle, np.float32)))
        assert r.rel_err == pytest.approx(bench_rel, rel=1e-2, abs=1e-6), (r.op, r.policy)
        assert r.max_err == pytest.approx(float(np.abs(diff).max()), rel=0.1, abs=1e-5)
        assert r.rel_err < ORACLE_TOL[r.policy]
        assert r.bound_ms > 0 and r.bound_by in ("bytes", "operations")
    for op in jax_ops:
        rel = {r.policy: r.rel_err for r in rows if r.op == op}
        assert rel["fp32"] < rel["bf16"] < rel["fp8"] <= rel["fp8_e5m2"], op


def test_precision_ladder_card_sizes_are_occamy_gptj_widths():
    from repro_torch.configs.base import get_config

    cfg = get_config("occamy-gptj")
    m, k, n = pl.CARD.gemm
    assert (k, n) == (cfg.d_model, cfg.d_ff)
    _, H, K, S, D = pl.CARD.fa
    assert (H, K, D) == (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim())
    assert pl.CARD.decode[1:] == (H, K, S, D)


def test_precision_ladder_raises_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pl.run()


@pytest.mark.cuda
def test_cuda_scaled_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((100, 300), generator=gen, device="cuda")
    b = torch.randn((300, 70), generator=gen, device="cuda")
    q = torch.randn((1, 4, 70, 64), generator=gen, device="cuda")
    kv = torch.randn((1, 2, 90, 64), generator=gen, device="cuda")
    for pol in POLICIES:
        aq, a_s = prec.quantize_blockwise(a, pol, axis=1, block=64)
        bq, b_s = prec.quantize_blockwise(b, pol, axis=0, block=64)
        got = gemm_scaled_kernel(aq, bq, a_s, b_s, bk=64)
        want = blocked.gemm_scaled_values_blocked(aq, bq, a_s, b_s, bk=64)
        assert _rel(got.cpu(), want.cpu()) < CROSS_IMPL_REL
        (qq, qs), (kq, ks) = (prec.quantize_blockwise(x, pol, axis=-1, block=64) for x in (q, kv))
        kw = dict(causal=True, window=30, q_offset=20)
        got = flash_attention_scaled_kernel(qq, kq, kq, qs, ks, ks, **kw)
        want = blocked.flash_attention_scaled_values_blocked(qq, kq, kq, qs, ks, ks, **kw)
        assert _rel(got.cpu(), want.cpu()) < CROSS_IMPL_REL


# ---------------------------------------------------------------------------
# what the reference's kernel paths refuse: a narrow accumulator under
# precision=, and the scaled attention's gradient through the Pallas body
# ---------------------------------------------------------------------------

# the narrow-accumulator oracles against each other: both round each
# fp32 sum once to the accumulator, then widen to fp32
NARROW_ACCUM_REF_TOL = 0.0
# the torch impl's scaled-attention gradient against the reference's xla
# form's: the cross-impl bound of the forward (Frobenius rel)
SCALED_FA_GRAD_REL = CROSS_IMPL_REL


@pytest.mark.parametrize("accum", ["bfloat16", "float16"])
def test_narrow_accumulator_scaled_gemm_is_refused_as_the_reference_refuses(rng, accum):
    a = rng.standard_normal((40, 300)).astype(np.float32)
    b = rng.standard_normal((300, 24)).astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    # the reference: its xla scan's carry and its Pallas body's store refuse
    with pytest.raises(TypeError, match="carry input and carry output must have equal types"):
        jops.gemm(ja, jb, precision="fp8", accum_dtype=getattr(jnp, accum), impl="xla", bk=64)
    with pytest.raises(ValueError, match="Invalid dtype for `swap`"):
        jops.gemm(ja, jb, precision="fp8", accum_dtype=getattr(jnp, accum), impl="interpret",
                  bk=64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for impl in ("cuda", "torch"):
        with pytest.raises(NotImplementedError, match="refuse a narrow accumulator too"):
            ops.gemm(ta, tb, precision="fp8", accum_dtype=getattr(torch, accum), impl=impl, bk=64)
    want = jops.gemm(ja, jb, precision="fp8", accum_dtype=getattr(jnp, accum), impl="ref", bk=64)
    got = ops.gemm(ta, tb, precision="fp8", accum_dtype=getattr(torch, accum), impl="ref", bk=64)
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=NARROW_ACCUM_REF_TOL)


@pytest.mark.parametrize("pol", ["bf16", "fp8"])
def test_scaled_flash_attention_gradient_is_the_reference_xla_forms(rng, pol):
    import jax

    B, H, K, S, D = 1, 4, 2, 64, 32
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, K, S, D)).astype(np.float32)
    v = rng.standard_normal((B, K, S, D)).astype(np.float32)
    do = rng.standard_normal((B, H, S, D)).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))

    def jloss(impl):
        return lambda q, k, v: jnp.sum(jops.flash_attention(q, k, v, precision=pol,
                                                            impl=impl) * do)

    want = jax.grad(jloss("xla"), argnums=(0, 1, 2))(jq, jk, jv)
    with pytest.raises(AssertionError):  # the reference's Pallas body has no gradient
        jax.grad(jloss("interpret"), argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, precision=pol, impl="torch")
    got = torch.autograd.grad((o * torch.from_numpy(do)).sum(), (tq, tk, tv))
    for g, w in zip(got, want):
        assert _rel(g, w) < SCALED_FA_GRAD_REL
    with pytest.raises(NotImplementedError, match="the reference's Pallas body has none"):
        ops.flash_attention(tq, tk, tv, precision=pol, impl="cuda")
