"""The plain GEMM's bf16 planner (``repro_torch.hopper.gemm.plan_bf16``)
on the CPU, device-free.

The planner picks the bf16 kernel of ``csrc/gemm.cu`` from shapes,
strides and alignment alone: ``wgmma`` (TMA-fed warpgroup MMA) where both
operands' rows start on 16 bytes and M and N are at least 64, ``mma``
everywhere else. These tests hold the route by shape, stride and
alignment, every candidate against the H100's limits (or pruned with its
reason), a plan override, the accepted ``bk`` set and the
``KernelStreams`` name by route. The kernels themselves run only on the
card (``chip_smoke.py`` phase 2).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.hopper import dispatch, gemm  # noqa: E402

SMS = 132
BF = torch.bfloat16
SMEM_PER_BLOCK, THREADS_PER_BLOCK, REGS_PER_SM = 232448, 1024, 65536


def _route(a, b, narrow=False):
    (M, K), N = a.shape, b.shape[1]
    return gemm.plan_bf16(M, N, K, gemm.rows16(a, b), SMS, narrow).route


def _z(*shape):
    return torch.zeros(shape, dtype=BF)


# (label, a, b, route): operands as the wrapper would get them
ROUTE_CASES = [
    ("square", lambda: (_z(256, 512), _z(512, 256)), "wgmma"),
    ("M and N of exactly 64", lambda: (_z(64, 64), _z(64, 64)), "wgmma"),
    ("K below 64", lambda: (_z(200, 40), _z(40, 136)), "wgmma"),
    ("ragged", lambda: (_z(257, 1000), _z(1000, 72)), "wgmma"),
    ("the GCN width", lambda: (_z(3327, 144), _z(144, 144)), "wgmma"),
    ("K = 0 in aligned rows", lambda: (_z(300, 64)[:, :0], _z(0, 200)), "wgmma"),
    ("M below 64", lambda: (_z(63, 512), _z(512, 256)), "mma"),
    ("N below 64", lambda: (_z(256, 512), _z(512, 56)), "mma"),
    ("unaligned K (140-byte rows)", lambda: (_z(100, 70), _z(70, 130)), "mma"),
    ("unaligned N (130-byte rows)", lambda: (_z(257, 1000), _z(1000, 65)), "mma"),
    ("slice, 2192-byte stride, base 16 bytes in", lambda: (_z(300, 1096)[:, 8:1008], _z(1000, 200)),
     "wgmma"),
    ("slice, 2200-byte stride TMA refuses", lambda: (_z(300, 1100)[:, :1000], _z(1000, 200)), "mma"),
    ("slice, base 2 bytes in", lambda: (_z(300, 1096)[:, 1:1001], _z(1000, 200)), "mma"),
    ("b a column slice, 2192-byte stride", lambda: (_z(300, 1000), _z(1000, 1096)[:, 8:208]),
     "wgmma"),
    ("b a column slice, base 2 bytes in", lambda: (_z(300, 1000), _z(1000, 1096)[:, 1:201]), "mma"),
]


@pytest.mark.parametrize("label,make,want", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
@pytest.mark.parametrize("narrow", [False, True], ids=["fp32-accum", "narrow-accum"])
def test_route_follows_shape_stride_and_alignment(label, make, want, narrow):
    a, b = make()
    assert _route(a, b, narrow) == want


def test_rows16_reads_base_and_row_stride():
    x = _z(64, 64)
    assert gemm.rows16(x)
    assert not gemm.rows16(x[:, 1:])                  # base 2 bytes in
    assert not gemm.rows16(_z(64, 36)[:, :32])        # 72-byte rows
    assert gemm.rows16(_z(64, 40)[:, 8:])             # 80-byte rows, base 16 bytes in
    assert gemm.rows16(torch.zeros((64, 4)))          # fp32: 16-byte rows


PLAN_SHAPES = [(4096, 4096, 4096), (3327, 144, 144), (169343, 144, 144), (64, 64, 64),
               (257, 72, 1000), (2048, 16384, 4096), (128, 128, 4096), (300, 200, 0)]


@pytest.mark.parametrize("M,N,K", PLAN_SHAPES)
@pytest.mark.parametrize("narrow", [False, True], ids=["fp32-accum", "narrow-accum"])
def test_every_candidate_fits_the_card_or_names_its_limit(M, N, K, narrow):
    cands = gemm.candidates_bf16(M, N, K, True, SMS, narrow)
    assert cands and any(c.feasible for c in cands)
    for c in cands:
        assert c.threads <= THREADS_PER_BLOCK and c.threads * c.regs <= REGS_PER_SM
        assert c.plan.route == "wgmma"
        assert c.smem == gemm.wgmma_smem_bytes(c.plan.bn, c.plan.stages) == c.plan.smem
        if c.feasible:
            assert c.smem <= SMEM_PER_BLOCK and 2 <= c.plan.stages <= gemm.W_MAX_STAGES
            tiles = -(-M // gemm.W_BM) * -(-N // c.plan.bn)
            assert c.plan.grid == min(tiles, SMS)
        else:
            assert c.why == "shared memory" and c.smem > SMEM_PER_BLOCK
    # a narrow accumulator's two partial tiles take the registers of a
    # 256-column tile: 128 columns only
    assert {c.plan.bn for c in cands} == ({128} if narrow else {128, 256})


def test_mma_route_is_one_fixed_candidate_within_the_card():
    [c] = gemm.candidates_bf16(100, 130, 70, False, SMS)
    assert c.plan == gemm.Bf16Plan("mma") and c.feasible
    assert c.smem <= 48 * 1024 and c.threads <= THREADS_PER_BLOCK
    assert c.threads * c.regs <= REGS_PER_SM
    assert gemm.Bf16Plan("mma").args() == (gemm.ROUTES["mma"],) + (0,) * 7


def test_a_smaller_budget_prunes_by_shared_memory():
    cands = gemm.candidates_bf16(4096, 4096, 4096, True, SMS, smem_budget=100_000)
    assert {c.why for c in cands if not c.feasible} == {"shared memory"}
    assert all(c.smem <= 100_000 for c in cands if c.feasible)
    assert gemm.wgmma_smem_bytes(256, 4) == 4 * (128 + 256) * 128 + 1024 + 64 == 197696
    assert gemm.wgmma_smem_bytes(128, 7) == 7 * 256 * 128 + 1024 + 112 <= SMEM_PER_BLOCK
    assert gemm.wgmma_smem_bytes(256, 5) > SMEM_PER_BLOCK


def test_model_takes_the_wide_tile_where_it_pads_nothing():
    big = gemm.plan_bf16(4096, 4096, 4096, True, SMS)
    assert (big.route, big.bn, big.grid) == ("wgmma", 256, SMS)
    assert big.args()[:4] == (gemm.ROUTES["wgmma"], 256, big.stages, SMS)
    gcn = gemm.plan_bf16(3327, 144, 144, True, SMS)  # 144 = 128 + 16: a 256-wide tile pads 112
    assert gcn.bn == 128
    narrow = gemm.plan_bf16(4096, 4096, 4096, True, SMS, True)
    assert narrow.bn == 128 and narrow.grid == SMS


def test_plan_override_is_honoured_and_keyed_apart_from_fp32():
    M, N, K = 512, 384, 1024
    args = ("bf16", M, N, K, True, SMS, False)
    override = gemm.Bf16Plan("wgmma", 128, 3, 7, gemm.wgmma_smem_bytes(128, 3))
    f32_pick = gemm.plan_f32(M, N, K, SMS, True)
    hits = dispatch.PLAN_HITS["gemm"]
    with dispatch.plan_override("gemm", args, override):
        assert gemm.plan_bf16(M, N, K, True, SMS) == override
        assert dispatch.PLAN_HITS["gemm"] == hits + 1
        assert gemm.plan_f32(M, N, K, SMS, True) == f32_pick  # the fp32 key is another
        assert gemm.plan_bf16(M, N, K, True, SMS, True) != override  # so is the narrow one
    assert gemm.plan_bf16(M, N, K, True, SMS) != override
    with dispatch.plan_override("gemm", (M, N, K, SMS, True), f32_pick._replace(stages=2)):
        assert gemm.plan_bf16(M, N, K, True, SMS) != override


def test_the_accepted_bk_set_does_not_shrink():
    """A bf16 ``bk`` is a multiple of 32 or covers K, as before the wgmma
    route: every k16 step pair of a 64-k stage is a fold point."""
    assert gemm.K_STEP[torch.bfloat16] <= 32
    assert gemm.K_STEP[torch.float32] == 16


@pytest.mark.parametrize("bk", [32, 64, 96, 256, 1000])
def test_cpu_wrapper_runs_the_per_block_plain_version(bk):
    from repro_torch.hopper import blocked

    gen = torch.Generator().manual_seed(bk)
    a = torch.randn((72, 1000), generator=gen).to(BF)
    b = torch.randn((1000, 80), generator=gen).to(BF)
    got = gemm.gemm_cuda(a, b, accum_dtype=torch.bfloat16, bk=bk, out_dtype=torch.float32)
    want = blocked.gemm_accum_blocked(a, b, bk=bk, accum_dtype=torch.bfloat16,
                                      out_dtype=torch.float32)
    assert torch.equal(got, want)


STREAM_CASES = [
    ((256, 512), (512, 256), torch.bfloat16, torch.float32, "gemm/wgmma"),
    ((256, 512), (512, 256), torch.bfloat16, torch.bfloat16, "gemm/wgmma+bfloat16-accum"),
    ((256, 512), (512, 256), torch.bfloat16, torch.float16, "gemm/wgmma+float16-accum"),
    ((48, 40), (40, 24), torch.bfloat16, torch.float32, "gemm/mma"),
    ((257, 1000), (1000, 65), torch.bfloat16, torch.bfloat16, "gemm/mma+bfloat16-accum"),
    ((100, 70), (70, 130), torch.bfloat16, torch.float32, "gemm/mma"),
    ((256, 512), (512, 256), torch.float32, torch.float32, "gemm/ffma"),
]


@pytest.mark.parametrize("a_shape,b_shape,dtype,accum,name", STREAM_CASES,
                         ids=[c[-1] + f"-{c[0][0]}x{c[1][1]}" for c in STREAM_CASES])
def test_kernel_streams_name_the_route(a_shape, b_shape, dtype, accum, name):
    s = dispatch.kernel_streams("gemm", ((a_shape, dtype), (b_shape, dtype)), accum_dtype=accum)
    assert s.name == name and s.accum == accum
