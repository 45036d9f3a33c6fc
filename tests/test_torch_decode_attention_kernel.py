"""The host parts of the split-KV decode-attention kernel's wrapper
(``hopper/decode_attention.py``), on the CPU: the kernel itself runs only
on the card (``chip_smoke.py``'s decode-kernel phase).

- ``check_args`` refuses every call the kernel does not take: dtypes, head
  dims, heads a kv head, row layouts, scales, indices, window; a tensor on
  a device other than the CPU or the card is refused before it.
- ``plan`` takes its split from shapes alone.
- ``live_pages`` counts what a brute-force walk over the plain form's mask
  counts: windows, offsets, null columns, idle slots at the scratch page,
  sequences whose last page is full.
- For CPU tensors the wrapper is the plain form, bitwise.
- ``ServingEngine._pages`` counts what the resolved impl walks.
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from repro_torch.core import precision as prec
from repro_torch.hopper import blocked, dispatch, ops
from repro_torch.hopper import decode_attention as da
from repro_torch.serving.engine import ServingEngine, StubModel

F8 = torch.float8_e4m3fn


def _args(B=2, H=4, K=2, D=64, S=32, dtype=torch.bfloat16, qdtype=None):
    q = torch.zeros(B, H, D, dtype=qdtype or dtype)
    k = torch.zeros(B, K, S, D, dtype=dtype)
    return q, k, k.clone(), torch.zeros(B, dtype=torch.int32)


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------


def test_the_calls_the_kernel_takes_pass():
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for D in da.HEAD_DIMS:
            da.check_args(*_args(D=D, dtype=dtype))
    q, k, v, pos = _args(dtype=F8, qdtype=torch.bfloat16)
    s = torch.ones(k.shape[:3] + (1,))
    da.check_args(q, k, v, pos, k_scale=s, v_scale=s.clone())
    da.check_args(q, k, v, pos.long(), block_table=torch.zeros(2, 3, dtype=torch.int64),
                  k_scale=s, v_scale=s, window=5)
    da.check_args(*_args(H=16, K=2))  # G at the kernel's largest


@pytest.mark.parametrize("qdtype", [torch.float64, torch.int32, F8])
def test_refuses_a_q_dtype(qdtype):
    q, k, v, pos = _args()
    with pytest.raises(TypeError, match="q"):
        da.check_args(q.to(qdtype), k, v, pos)


@pytest.mark.parametrize("kdtype", [torch.float64, torch.int8, torch.uint8])
def test_refuses_a_pool_dtype(kdtype):
    q, k, v, pos = _args()
    with pytest.raises(TypeError, match="k and v of one dtype"):
        da.check_args(q, k.to(kdtype), v.to(kdtype), pos)


def test_refuses_k_and_v_of_two_dtypes():
    q, k, v, pos = _args()
    with pytest.raises(TypeError, match="k and v of one dtype"):
        da.check_args(q, k, v.half(), pos)


@pytest.mark.parametrize("D", [16, 32, 96, 512])
def test_refuses_a_head_dim(D):
    with pytest.raises(ValueError, match="head dim"):
        da.check_args(*_args(D=D))


def test_refuses_shapes_that_do_not_fit():
    q, k, v, pos = _args()
    with pytest.raises(ValueError, match="do not fit"):
        da.check_args(q[:, :3], k, v, pos)  # H % K
    with pytest.raises(ValueError, match="do not fit"):
        da.check_args(q, k[..., :32], v[..., :32], pos)
    with pytest.raises(ValueError, match="4-d"):
        da.check_args(q, k[0], v[0], pos)
    with pytest.raises(ValueError, match="query heads a kv head"):
        da.check_args(*_args(H=32, K=2))


def test_refuses_row_layouts_it_cannot_copy():
    q, k, v, pos = _args(S=32)
    with pytest.raises(ValueError, match="contiguous rows"):  # D not unit-stride
        da.check_args(q, k.transpose(2, 3).contiguous().transpose(2, 3), v, pos)
    with pytest.raises(ValueError, match="contiguous rows"):  # rows not D apart
        da.check_args(q, k[:, :, ::2], v[:, :, ::2], pos)
    big = torch.zeros(2 * 2 * 32 * 64 + 1, dtype=torch.bfloat16)
    off = big[1:].view(2, 2, 32, 64)  # 2 bytes past a 16-byte start
    with pytest.raises(ValueError, match="16-byte"):
        da.check_args(q, off, v, pos)
    with pytest.raises(ValueError, match="unit-stride in D"):
        da.check_args(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, pos)


def test_refuses_scales_that_do_not_match():
    q, k, v, pos = _args(dtype=F8, qdtype=torch.bfloat16)
    s = torch.ones(k.shape[:3] + (1,))
    with pytest.raises(TypeError, match="need k_scale"):
        da.check_args(q, k, v, pos)
    with pytest.raises(ValueError, match="go together"):
        da.check_args(q, k, v, pos, k_scale=s)
    with pytest.raises(ValueError, match="k_scale must be float32"):
        da.check_args(q, k, v, pos, k_scale=s[:, :, :16], v_scale=s)
    with pytest.raises(ValueError, match="v_scale must be float32"):
        da.check_args(q, k, v, pos, k_scale=s, v_scale=s.double())


def test_refuses_indices_and_window():
    q, k, v, pos = _args()
    with pytest.raises(ValueError, match="position"):
        da.check_args(q, k, v, pos.float())
    with pytest.raises(ValueError, match="position"):
        da.check_args(q, k, v, pos[:1])
    with pytest.raises(ValueError, match="block_table"):
        da.check_args(q, k, v, pos, block_table=torch.zeros(2, 3))
    with pytest.raises(ValueError, match="block_table"):
        da.check_args(q, k, v, pos, block_table=torch.zeros(3, 2, dtype=torch.int32).T)
    with pytest.raises(ValueError, match="window"):
        da.check_args(q, k, v, pos, window=-1)


def test_refuses_a_device_that_is_neither_cpu_nor_the_card():
    q, k, v, pos = (x.to("meta") for x in _args())
    with pytest.raises(ValueError, match="one CUDA device"):
        da.decode_attention_cuda(q, k, v, pos)


# ---------------------------------------------------------------------------
# the split planner
# ---------------------------------------------------------------------------


def test_plan_at_the_callers_shapes():
    assert da.plan(64, 16, 128, 16) == (2, 8)  # the serving cell: 256-row splits
    assert da.plan(4, 16, 512, 2) == (1, 2)  # contiguous generate at 528 rows
    assert da.plan(4, 16, 16, 33) == (8, 5)  # pages of 16 rows: halved once to fill the grid
    assert da.plan(1, 1, 512, 4) == (1, 4)


@pytest.mark.parametrize("B,K,bs,nb", [(64, 16, 128, 16), (1, 1, 16, 2048), (8, 8, 16, 40),
                                        (2, 4, 100, 7), (3, 5, 1000, 1), (128, 32, 16, 128)])
def test_plan_covers_the_table_and_depends_on_shapes_only(B, K, bs, nb):
    pps, nsplit = da.plan(B, K, bs, nb)
    assert (pps, nsplit) == da.plan(B, K, bs, nb)
    assert pps >= 1 and pps * bs <= max(bs, da.SPLIT_ROWS)
    assert (nsplit - 1) * pps < nb <= nsplit * pps
    if pps > 1:  # halved only while the grid falls short
        assert B * K * nsplit >= da.MIN_CTAS
    if pps < max(1, da.SPLIT_ROWS // bs):
        assert B * K * -(-nb // (2 * pps)) < da.MIN_CTAS


# ---------------------------------------------------------------------------
# the live pages, against a brute-force walk over the plain form's mask
# ---------------------------------------------------------------------------


def _brute(pos, *, bs, nb, window=0, pos_offset=0):
    out = []
    for p in pos:
        idx = pos_offset + np.arange(nb * bs)
        mask = (idx <= p)
        if window:
            mask &= idx > p - window
        out.append(len({r // bs for r in np.nonzero(mask)[0]}))
    return np.array(out)


@pytest.mark.parametrize("bs,nb,window,pos_offset", [(16, 8, 0, 0), (16, 8, 20, 0), (128, 16, 0, 0),
                                                      (16, 8, 0, 64), (16, 8, 37, 48), (5, 7, 3, 0),
                                                      (16, 8, 1, 0), (16, 8, 500, 0)])
def test_live_pages_match_a_brute_force_walk(bs, nb, window, pos_offset):
    rng = np.random.default_rng(bs * nb + window + pos_offset)
    S = nb * bs
    pos = np.concatenate([rng.integers(0, S + pos_offset + 10, 40),
                          [0, bs - 1, bs, 2 * bs - 1, S - 1, S, S + 5,  # full last pages
                           pos_offset, pos_offset + bs - 1, max(pos_offset - 1, 0)]])
    got = da.live_pages(pos, bs=bs, nb=nb, window=window, pos_offset=pos_offset)
    np.testing.assert_array_equal(got, _brute(pos, bs=bs, nb=nb, window=window,
                                              pos_offset=pos_offset))


def test_an_idle_slot_walks_its_scratch_page_and_null_columns_are_not_walked():
    # idle slots sit at position 0 with a table of null pages; a live
    # sequence's null columns lie past its position
    pos = np.array([0, 0, 130, 255, 256])
    np.testing.assert_array_equal(da.live_pages(pos, bs=128, nb=16), [1, 1, 2, 2, 3])


# ---------------------------------------------------------------------------
# CPU tensors: the plain form, bitwise
# ---------------------------------------------------------------------------


def _rand(gen, *shape):
    return torch.randn(shape, generator=gen)


@pytest.mark.parametrize("layout", ["contiguous", "paged", "paged-fp8", "contiguous-precision"])
def test_cpu_tensors_take_the_plain_form_bitwise(layout):
    gen = torch.Generator().manual_seed(7)
    B, H, K, D, bs, nb = 3, 8, 2, 64, 16, 5
    q = _rand(gen, B, H, D)
    pos = torch.tensor([0, 40, 79])
    kw = dict(window=30, pos_offset=0, return_lse=True)
    if layout.startswith("paged"):
        P = B * nb + 1
        k, v = _rand(gen, P, K, bs, D), _rand(gen, P, K, bs, D)
        kw["block_table"] = torch.randperm(P - 1, generator=gen)[: B * nb].reshape(B, nb).int() + 1
        if layout == "paged-fp8":
            k, ks, v, vs = prec.quantize_kv_cache(k, v, "fp8")
            kw.update(k_scale=ks, v_scale=vs)
    else:
        k, v = _rand(gen, B, K, nb * bs - 3, D), _rand(gen, B, K, nb * bs - 3, D)
        kw["bs"] = bs
        if layout == "contiguous-precision":
            kw["precision"] = prec.resolve("fp8")
    dispatch.reset_launches()
    got = da.decode_attention_cuda(q, k, v, pos, **kw)
    want = blocked.decode_attention_blocked(q, k, v, pos, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert dispatch.LAUNCHES["decode_attention"] == 0
    # the op's auto impl is this wrapper, and on the CPU the plain form
    assert dispatch.resolve_impl("decode_attention") == "cuda"
    paged = "block_table" in kw
    via_op = ops.decode_attention(q, k, v, pos, paged=paged, **{
        n: x for n, x in kw.items() if not (n == "precision" or (n == "bs" and paged))},
        **({"precision": "fp8"} if "precision" in kw else {}))
    assert all(torch.equal(g, w) for g, w in zip(via_op, want))


# ---------------------------------------------------------------------------
# the engine's page counters follow the resolved impl
# ---------------------------------------------------------------------------


class _Model(StubModel):
    def __init__(self, device, window=0):
        super().__init__()
        self.device = torch.device(device)
        self.cfg = types.SimpleNamespace(num_layers=3, sliding_window=window)


def _engine(device, window=0):
    return ServingEngine(_Model(device, window), num_blocks=40, block_size=16, max_slots=4,
                         max_blocks_per_seq=6)


def test_engine_page_counters_under_each_impl():
    positions = np.array([0, 17, 0, 80])
    active = np.array([False, True, False, True])
    tables = np.zeros((4, 6), np.int32)
    live = (2 + 6) * 3  # the active slots' pages, 3 layers
    whole = 4 * 6 * 3
    kernel = (1 + 2 + 1 + 6) * 3  # live pages, an idle slot's scratch page included
    for impl in ("torch", "ref"):
        with dispatch.default_impl(impl):
            assert _engine("cuda")._pages(positions, active, tables) == {
                "pages_live": live, "pages_walked": whole}
    for impl in (None, "cuda"):
        with dispatch.default_impl(impl):
            assert _engine("cuda")._pages(positions, active, tables) == {
                "pages_live": live, "pages_walked": kernel}
            # on the CPU the wrapper runs the plain form, which walks the table
            assert _engine("cpu")._pages(positions, active, tables) == {
                "pages_live": live, "pages_walked": whole}
    windowed = (1 + 2 + 1 + 3) * 3  # rows 61-80 of the last slot lie on pages 3-5
    assert _engine("cuda", window=20)._pages(positions, active, tables)["pages_walked"] == windowed
