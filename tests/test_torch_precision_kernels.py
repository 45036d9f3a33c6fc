"""The precision ladder's two Hopper kernels: their route planners on the
CPU, and each route against its plain version on the card.

``hopper/gemm_scaled.py`` ``plan`` picks the scaled GEMM's kernel from
shapes and types alone (``wgmma`` for bf16 and fp8 where bk is a multiple
of a stage's k and the rows are 16-byte aligned, ``ffma`` for fp32, ``mma``
for bf16 and fp8 at every other shape), with its ring, promotion interval
and grid; ``hopper/flash_attention_scaled.py`` ``route`` names the scaled
FA's kernel for a value type. The CPU tests hold the plans to the kernels'
limits (shared memory, threads, the promotion interval dividing bk). The
``cuda``-marked tests hold every route to the plain version on the same
quantized operands at the ladder's cross-impl bound (Frobenius 1e-4,
``chip_smoke.py`` SCALED_REL_TOL) at edge shapes; they skip without a
card. Nothing here imports JAX: the card's machine runs this file whole.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import precision as prec  # noqa: E402
from repro_torch.hopper import blocked  # noqa: E402
from repro_torch.hopper import flash_attention_scaled as fs  # noqa: E402
from repro_torch.hopper import gemm_scaled as gs  # noqa: E402
from repro_torch.hopper.gemm import SMEM_PER_CTA  # noqa: E402
from repro_torch.launch import precision_ladder as pl  # noqa: E402

POLICIES = ("fp32", "bf16", "fp8", "fp8_e5m2")
NARROW = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)
REL = 1e-4  # chip_smoke.py SCALED_REL_TOL: the reference suite's cross-impl bound
SMS = 132


def _rel(got, want):
    diff = torch.linalg.vector_norm(got.float() - want.float())
    return float(diff / torch.linalg.vector_norm(want.float()).clamp_min(1e-30))


# (M, N, K, bk, dtype, aligned) -> route
ROUTE_CASES = [
    ((2048, 16384, 4096, 256, torch.float32, True), "ffma"),
    ((100, 130, 70, 64, torch.float32, False), "ffma"),
    ((5, 7, 3, 2, torch.float32, True), "ffma"),
    ((2048, 16384, 4096, 256, torch.bfloat16, True), "wgmma"),
    ((130, 144, 256, 64, torch.bfloat16, True), "wgmma"),
    ((200, 144, 512, 128, torch.bfloat16, True), "wgmma"),
    ((256, 384, 1024, 512, torch.bfloat16, True), "wgmma"),
    ((130, 144, 256, 48, torch.bfloat16, True), "mma"),       # bk not a multiple of 64
    ((130, 144, 256, 32, torch.bfloat16, True), "mma"),
    ((130, 144, 256, 64, torch.bfloat16, False), "mma"),      # rows not 16-byte aligned
    ((32, 144, 256, 64, torch.bfloat16, True), "mma"),        # M below 64
    ((130, 40, 256, 64, torch.bfloat16, True), "mma"),        # N below 64
    ((130, 144, 0, 64, torch.bfloat16, True), "mma"),         # K = 0
    ((2048, 16384, 4096, 256, torch.float8_e4m3fn, True), "wgmma"),
    ((2048, 16384, 4096, 256, torch.float8_e5m2, True), "wgmma"),
    ((192, 256, 304, 128, torch.float8_e4m3fn, True), "wgmma"),
    ((256, 384, 1024, 512, torch.float8_e5m2, True), "wgmma"),
    ((130, 144, 256, 64, torch.float8_e4m3fn, True), "mma"),  # bk not a multiple of 128
    ((130, 144, 256, 256, torch.float8_e5m2, False), "mma"),
    ((130, 136, 256, 256, torch.float8_e4m3fn, True), "mma"),  # N not a multiple of 16
]


@pytest.mark.parametrize("args,route", ROUTE_CASES, ids=lambda x: str(x))
def test_gemm_plan_route_by_dtype_bk_and_alignment(args, route):
    assert gs.plan(*args, SMS).route == route


@pytest.mark.parametrize("dtype", NARROW, ids=str)
@pytest.mark.parametrize("bk", [64, 128, 256, 384, 512, 1024])
def test_gemm_plan_promote_divides_bk(dtype, bk):
    p = gs.plan(2048, 4096, 4096, bk, dtype, True, SMS)
    if bk % gs.STAGE_K[dtype]:
        assert p.route == "mma" and p.promote == 0
        return
    assert p.route == "wgmma"
    assert bk % p.promote == 0
    assert p.promote == math.gcd(gs.PROMOTE[dtype], bk)
    # half a stage or a whole one, in wgmma k-steps of the type; bf16 also two
    steps = (2, 4, 8) if dtype == torch.bfloat16 else (2, 4)
    assert p.promote in [n * gs.K_STEP[dtype] for n in steps]


def test_promote_table_covers_the_wgmma_types():
    assert set(gs.PROMOTE) == set(NARROW)
    for dt, interval in gs.PROMOTE.items():
        stages = 2 if dt == torch.bfloat16 else 1
        assert (stages * gs.STAGE_K[dt]) % interval == 0 and interval % (2 * gs.K_STEP[dt]) == 0


SHAPES = [(2048, 16384, 4096, 256), (169343, 144, 144, 128), (5, 7, 3, 2), (100, 130, 70, 64),
          (257, 65, 300, 64), (1000, 2048, 1024, 256), (64, 96, 160, 256), (4096, 4096, 4096, 20)]


@pytest.mark.parametrize("M,N,K,bk", SHAPES)
def test_ffma_plan_fits_the_card(M, N, K, bk):
    p = gs.plan(M, N, K, bk, torch.float32, True, SMS)
    assert p.route == "ffma"
    assert p.smem == gs.ffma_smem_bytes(p.tm, p.wr, p.wc, p.stages) <= SMEM_PER_CTA
    assert 2 <= p.stages <= gs.F_MAX_STAGES
    assert p.tm in (2, 4) and 32 * p.wr * p.wc <= gs.F_MAX_THREADS
    tiles = math.ceil(M / (8 * p.tm * p.wr)) * math.ceil(N / (48 * p.wc))
    assert 1 <= p.grid <= min(tiles, SMS)
    assert p.vec == (bk % 4 == 0)


@pytest.mark.parametrize("M,N,K,bk", [s for s in SHAPES if s[3] % 128 == 0 and min(s[:2]) >= 64])
@pytest.mark.parametrize("dtype", NARROW, ids=str)
def test_wgmma_plan_fits_the_card(M, N, K, bk, dtype):
    p = gs.plan(M, N, K, bk, dtype, True, SMS)
    assert p.route == "wgmma"
    assert p.smem == gs.wgmma_smem_bytes(p.stages) <= SMEM_PER_CTA
    assert 2 <= p.stages <= gs.W_MAX_STAGES
    assert gs.wgmma_smem_bytes(p.stages + 1) > SMEM_PER_CTA or p.stages == gs.W_MAX_STAGES
    assert 1 <= p.grid <= min(math.ceil(M / 128) * math.ceil(N / 128), SMS)


@pytest.mark.parametrize("pol", POLICIES)
def test_ladder_card_shapes_take_the_fast_routes(pol):
    m, k, n = pl.CARD.gemm
    dt = prec.resolve(pol).compute_dtype
    p = gs.plan(m, n, k, 256, dt, True, SMS)  # resolve_blocks("gemm")'s bk, as the ladder takes it
    assert p.route == ("ffma" if pol == "fp32" else "wgmma")
    assert fs.route(dt) == ("ffma" if pol == "fp32" else "wgmma")
    assert p.grid == SMS  # the card shape fills every SM


def test_plan_args_carry_the_route_parameters():
    w = gs.plan(2048, 16384, 4096, 256, torch.float8_e4m3fn, True, SMS)
    assert w.args() == (w.stages, w.promote, w.grid, 0, 0, 0)
    f = gs.plan(2048, 16384, 4096, 256, torch.float32, True, SMS)
    assert f.args() == (f.tm, f.wr, f.wc, f.stages, 1, f.grid)
    assert gs.plan(100, 130, 70, 64, torch.bfloat16, False, SMS).args() == (0,) * 6
    assert set(gs.ROUTES) == {"mma", "wgmma", "ffma"}


def test_plan_refuses_a_type_without_a_route():
    with pytest.raises(TypeError, match="no route"):
        gs.plan(64, 64, 64, 64, torch.float16, True, SMS)
    with pytest.raises(TypeError, match="no route"):
        fs.route(torch.float16)


def test_rows16_reads_base_and_row_stride():
    x = torch.zeros((64, 32), dtype=torch.bfloat16)
    assert gs.rows16(x)
    assert not gs.rows16(x[:, 1:])                       # base off 16 bytes
    assert not gs.rows16(torch.zeros((64, 36), dtype=torch.bfloat16)[:, :32])  # 72-byte rows
    assert gs.rows16(torch.zeros((64, 48), dtype=torch.float8_e4m3fn))
    assert not gs.rows16(torch.zeros((64, 40), dtype=torch.float8_e4m3fn))


@pytest.mark.parametrize("pol", POLICIES)
def test_kernels_take_the_plain_forms_on_cpu(pol, rng):
    # CPU tensors never reach a planner's kernel: the wrappers run the plain forms
    a = torch.from_numpy(rng.standard_normal((40, 96)).astype("float32"))
    b = torch.from_numpy(rng.standard_normal((96, 24)).astype("float32"))
    aq, a_s = prec.quantize_blockwise(a, pol, axis=1, block=64)
    bq, b_s = prec.quantize_blockwise(b, pol, axis=0, block=64)
    got = gs.gemm_scaled_kernel(aq, bq, a_s, b_s, bk=64)
    assert torch.equal(got, blocked.gemm_scaled_values_blocked(aq, bq, a_s, b_s, bk=64))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")


# (label, M, K, N, bk): ragged M, N and K, a ragged last K-block, bk of 64,
# 128, 256 and 512, on both routes of the narrow types
GEMM_EDGE = [
    ("ragged M N K bk=64", 200, 320, 144, 64),
    ("ragged last K-block bk=128", 192, 304, 256, 128),
    ("bk=256 K < bk", 130, 160, 208, 256),
    ("bk=512", 256, 1024, 384, 512),
    ("unaligned rows bk=128", 129, 264, 130, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("pol", POLICIES)
def test_cuda_gemm_scaled_routes_match_plain(pol):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    routes = set()
    for label, M, K, N, bk in GEMM_EDGE:
        a = torch.randn((M, K), generator=gen, device="cuda")
        b = torch.randn((K, N), generator=gen, device="cuda")
        aq, a_s = prec.quantize_blockwise(a, pol, axis=1, block=bk)
        bq, b_s = prec.quantize_blockwise(b, pol, axis=0, block=bk)
        routes.add(gs.plan(M, N, K, bk, aq.dtype, gs.rows16(aq, bq), torch.cuda.get_device_properties(0)
                           .multi_processor_count).route)
        want = blocked.gemm_scaled_values_blocked(aq, bq, a_s, b_s, bk=bk)
        got32 = gs.gemm_scaled_kernel(aq, bq, a_s, b_s, bk=bk)
        assert _rel(got32, want) <= REL, label
        # bf16 output: one rounding of the same fp32 sum (the order is fixed)
        got = gs.gemm_scaled_kernel(aq, bq, a_s, b_s, bk=bk, out_dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, got32.to(torch.bfloat16)), label
        # strided scales: every other column of a buffer twice as wide
        a_t = torch.zeros((M, 2 * a_s.shape[1]), device="cuda")[:, ::2]
        b_t = torch.zeros((b_s.shape[0], 2 * N), device="cuda")[:, ::2]
        a_t.copy_(a_s)
        b_t.copy_(b_s)
        assert a_t.stride(1) == 2 and b_t.stride(1) == 2
        assert _rel(gs.gemm_scaled_kernel(aq, bq, a_t, b_t, bk=bk), want) <= REL, label
    assert routes == ({"ffma"} if pol == "fp32" else {"wgmma", "mma"})


@pytest.mark.cuda
def test_cuda_gemm_scaled_empty_k_is_zeros():
    _card()
    z = torch.empty((0,), device="cuda")
    a = torch.empty((8, 0), device="cuda", dtype=torch.bfloat16)
    b = torch.empty((0, 16), device="cuda", dtype=torch.bfloat16)
    got = gs.gemm_scaled_kernel(a, b, z.reshape(8, 0), z.reshape(0, 16), bk=64)
    assert torch.equal(got, torch.zeros((8, 16), device="cuda"))


# (label, B, H, K, Sq, Sk, D, causal, window, q_offset, return_lse)
FA_EDGE = [
    ("gqa causal lse D=64", 2, 8, 2, 100, 100, 64, True, 0, 0, True),
    ("window q_offset ragged Sk D=128", 1, 4, 2, 70, 150, 128, True, 40, 80, True),
    ("non-causal lse D=256", 1, 2, 1, 130, 77, 256, False, 0, 0, True),
    ("causal D=256 two warpgroups", 1, 16, 16, 1024, 1024, 256, True, 0, 0, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("pol", POLICIES)
def test_cuda_fa_scaled_routes_match_plain(pol):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    for label, B, H, K, Sq, Sk, D, causal, window, q_offset, lse in FA_EDGE:
        q = torch.randn((B, H, Sq, D), generator=gen, device="cuda")
        k = torch.randn((B, K, Sk, D), generator=gen, device="cuda")
        v = torch.randn((B, K, Sk, D), generator=gen, device="cuda")
        (qq, qs), (kq, ks), (vq, vs) = (prec.quantize_blockwise(x, pol, axis=-1, block=D) for x in (q, k, v))
        kw = dict(causal=causal, window=window, q_offset=q_offset, return_lse=lse)
        got = fs.flash_attention_scaled_kernel(qq, kq, vq, qs, ks, vs, **kw)
        want = blocked.flash_attention_scaled_values_blocked(qq, kq, vq, qs, ks, vs, **kw)
        if lse:
            assert torch.allclose(got[1], want[1], atol=1e-4, rtol=1e-4), label
            got, want = got[0], want[0]
        assert _rel(got, want) <= REL, label
