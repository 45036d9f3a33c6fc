"""Port attention ops vs the JAX reference on the CPU.

The same numpy inputs (seeded) go through ``repro.kernels.ops`` and
``repro_torch.hopper.ops``. Flash attention is held to the Pallas body
itself (``impl="interpret"``) and the ``ref`` oracle; decode attention to
the ``xla`` blocked form and the ``ref`` oracle; all at the reference
suite's ``rtol=atol=1e-4``. Paged decode equals contiguous decode bitwise
inside the port. The Hopper kernel itself runs only on the card: its test
here is marked ``cuda`` and skips without one.
"""
import itertools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the card's machine has no JAX: only the `cuda`-marked tests run there
    import jax.numpy as jnp
    from repro.kernels import ops as jops
except ImportError:
    jnp = jops = None
from repro_torch.hopper import build, dispatch, ops  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)

# (B, H, K, Sq, Sk, D, causal, window, q_offset)
FA_CASES = {
    "causal": (2, 4, 4, 40, 40, 16, True, 0, 0),
    "noncausal_ragged": (1, 2, 2, 33, 45, 16, False, 0, 0),
    "gqa_causal": (1, 4, 2, 32, 32, 32, True, 0, 0),
    "window_noncausal": (1, 2, 2, 48, 48, 16, False, 7, 0),
    "window_causal_gqa": (2, 4, 1, 24, 24, 16, True, 5, 0),
    "q_offset_ragged_sk": (1, 2, 1, 20, 53, 16, True, 0, 33),
    "q_offset_window": (1, 2, 2, 16, 64, 16, True, 10, 48),
}


def _qkv(rng, B, H, K, Sq, Sk, D):
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, K, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, K, Sk, D)).astype(np.float32)
    return q, k, v


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_flash_attention_matches_jax(rng, case):
    B, H, K, Sq, Sk, D, causal, window, q_offset = FA_CASES[case]
    q, k, v = _qkv(rng, B, H, K, Sq, Sk, D)
    kw = dict(causal=causal, window=window, q_offset=q_offset, return_lse=True)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_pallas = jops.flash_attention(jq, jk, jv, impl="interpret", bq=32, bk=16, **kw)
    want_ref = jops.flash_attention(jq, jk, jv, impl="ref", **kw)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for impl, blocks in ((None, {}), ("torch", {"bk": 16}), ("ref", {})):
        got = ops.flash_attention(tq, tk, tv, impl=impl, **blocks, **kw)
        for want in (want_pallas, want_ref):
            for g, w in zip(got, want):
                np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_flash_attention_strided_views_and_default_blocks(rng):
    # the transformer passes (B, S, H, D) -> (B, H, S, D) views
    q, k, v = (rng.standard_normal((2, 37, 4, 16)).astype(np.float32) for _ in range(3))
    got = ops.flash_attention(*(torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)))
    want = jops.flash_attention(*(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
                                impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_tensors_take_the_plain_version_without_launching(rng):
    q, k, v = map(torch.from_numpy, _qkv(rng, 1, 2, 2, 24, 24, 16))
    dispatch.reset_launches()
    assert dispatch.resolve_impl("flash_attention") == "cuda"
    got = ops.flash_attention(q, k, v)  # auto: the kernel wrapper
    want = ops.flash_attention(q, k, v, impl="torch")
    assert torch.equal(got, want)
    assert dispatch.LAUNCHES["flash_attention"] == 0


def test_kernel_wrapper_raises_off_cpu_and_cuda(rng):
    q = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, q, q, impl="cuda")


# (B, H, K, S, bs, window, pos_offset)
DECODE_CASES = {
    "plain": (3, 4, 4, 32, 8, 0, 0),
    "gqa_window": (3, 4, 2, 32, 8, 5, 0),
    "pos_offset": (2, 2, 1, 24, 8, 0, 16),
}


def _decode_inputs(rng, B, H, K, S, D=16):
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, K, S, D)).astype(np.float32)
    v = rng.standard_normal((B, K, S, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_attention_contiguous_matches_jax(rng, case):
    B, H, K, S, bs, window, pos_offset = DECODE_CASES[case]
    q, k, v = _decode_inputs(rng, B, H, K, S)
    pos = (rng.integers(0, S, B) + pos_offset).astype(np.int32)
    kw = dict(window=window, pos_offset=pos_offset, return_lse=True)
    jargs = (*map(jnp.asarray, (q, k, v)), jnp.asarray(pos))
    targs = (*map(torch.from_numpy, (q, k, v)), torch.from_numpy(pos))
    for jimpl in ("xla", "ref"):
        want = jops.decode_attention(*jargs, impl=jimpl, bs=bs, **kw)
        for impl in (None, "ref"):
            got = ops.decode_attention(*targs, impl=impl, bs=bs, **kw)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_attention_paged_matches_jax_and_contiguous_bitwise(rng, case):
    B, H, K, S, bs, window, pos_offset = DECODE_CASES[case]
    D, nb = 16, S // bs
    P = B * nb + 3
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, K, bs, D)).astype(np.float32)
    vp = rng.standard_normal((P, K, bs, D)).astype(np.float32)
    table = rng.permutation(np.arange(1, P))[: B * nb].reshape(B, nb).astype(np.int32)
    pos = (rng.integers(0, S, B) + pos_offset).astype(np.int32)
    kw = dict(window=window, pos_offset=pos_offset, return_lse=True)

    tq, tkp, tvp = map(torch.from_numpy, (q, kp, vp))
    tt, tpos = torch.from_numpy(table), torch.from_numpy(pos)
    got = ops.decode_attention(tq, tkp, tvp, tpos, paged=True, block_table=tt, **kw)
    for jimpl in ("xla", "ref"):
        want = jops.decode_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pos),
            paged=True, block_table=jnp.asarray(table), impl=jimpl, **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

    # the same pages laid out contiguously, streamed at the same partition
    kc = tkp[tt.long()].transpose(1, 2).reshape(B, K, S, D)
    vc = tvp[tt.long()].transpose(1, 2).reshape(B, K, S, D)
    contig = ops.decode_attention(tq, kc, vc, tpos, bs=bs, **kw)
    for g, c in zip(got, contig):
        assert torch.equal(g, c)


def test_decode_attention_argument_checks(rng):
    q, k, v = map(torch.from_numpy, _decode_inputs(rng, 2, 2, 2, 16))
    pos = torch.tensor([3, 5])
    table = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(TypeError, match="requires block_table"):
        ops.decode_attention(q, k, v, pos, paged=True)
    with pytest.raises(TypeError, match="requires paged=True"):
        ops.decode_attention(q, k, v, pos, block_table=table)
    with pytest.raises(ValueError, match="pools must be"):
        ops.decode_attention(q, k[..., 0], v[..., 0], pos, paged=True, block_table=table)
    out = ops.decode_attention(q, k, v, pos, precision="fp8")  # the precision slice runs
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    with pytest.raises(TypeError, match="mesh"):
        ops.decode_attention(q, k, v, pos, precision="fp8", mesh=object())
    with pytest.raises(TypeError, match="mesh"):
        ops.flash_attention(q[:, :, None], k, v, mesh=object())
    with pytest.raises(TypeError, match="disagree"):
        ops.flash_attention(q[:, :, None], k, v, bk=8, block_k=16)


def test_dispatch_resolution_and_block_overrides(monkeypatch):
    assert dispatch.resolve_impl("flash_attention") == "cuda"
    assert dispatch.resolve_impl("decode_attention") == "cuda"
    assert dispatch.resolve_impl("decode_attention", "ref") == "ref"
    with dispatch.default_impl("torch"):
        assert dispatch.resolve_impl("flash_attention") == "torch"
    assert dispatch.resolve_impl("flash_attention") == "cuda"
    with pytest.raises(ValueError, match="unknown impl"):
        dispatch.resolve_impl("flash_attention", "pallas")
    # every op of the port has a kernel now; an op without one raises
    monkeypatch.setitem(dispatch._REGISTRY, "plain_only", {"torch": lambda: None})
    with pytest.raises(NotImplementedError, match="no 'cuda'"):
        dispatch.kernel_call("plain_only", impl="cuda")
    assert dispatch.resolve_blocks("flash_attention") == {"bq": 128, "bk": 128}
    with dispatch.block_override("flash_attention", bk=32):
        assert dispatch.resolve_blocks("flash_attention")["bk"] == 32
        assert dispatch.resolve_blocks("flash_attention", bk=8)["bk"] == 8
    assert dispatch.resolve_blocks("flash_attention")["bk"] == 128
    with pytest.raises(ValueError, match="no block parameters"):
        dispatch.resolve_blocks("decode_attention", bk=4)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        q = torch.randn((1, 4, 70, 64), generator=gen, device="cuda").to(dtype)
        k = torch.randn((1, 2, 90, 64), generator=gen, device="cuda").to(dtype)
        v = torch.randn((1, 2, 90, 64), generator=gen, device="cuda").to(dtype)
        kw = dict(causal=True, window=30, q_offset=20, return_lse=True)
        got = ops.flash_attention(q, k, v, impl="cuda", **kw)
        want = ops.flash_attention(q, k, v, impl="torch", **kw)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


def test_port_imports_no_jax_and_no_reference_package():
    """Every module of the port imports with ``jax`` and ``repro`` (and all
    their submodules) blocked; ``repro_torch`` itself must stay importable."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        BLOCKED = ("jax", "repro")

        class Block:
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                    raise ImportError(f"blocked import {name}")
                return None

        sys.meta_path.insert(0, Block())
        import repro_torch
        names = ["repro_torch"] + [
            m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
        ]
        for n in names + ["chip_smoke"]:
            importlib.import_module(n)
        leaked = sorted(m for m in sys.modules
                        if any(m == b or m.startswith(b + ".") for b in BLOCKED))
        assert not leaked, leaked
        print(len(names))
    """)
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root / "src"), str(root)]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 14


def test_library_hash_covers_the_included_headers(tmp_path, monkeypatch):
    """A library's file name hashes its source and the ``csrc/`` headers it
    includes (directly or through each other), so an edited header builds
    every library that includes it anew and leaves the others alone."""
    for name in ("flash_attention.cu", "gemm.cu", "spmm.cu", "wgmma.cuh", "tma.cuh"):
        (tmp_path / name).write_bytes((build.CSRC_DIR / name).read_bytes())
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "wgmma.cuh"\n')
    (tmp_path / "flash_attention.cu").write_text(
        '#include "outer.cuh"\n' + (tmp_path / "flash_attention.cu").read_text())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    assert build.local_includes(tmp_path / "flash_attention.cu") == [
        tmp_path / "outer.cuh", tmp_path / "wgmma.cuh"]
    assert build.local_includes(tmp_path / "gemm.cu") == [
        tmp_path / "tma.cuh", tmp_path / "wgmma.cuh"]
    assert build.local_includes(tmp_path / "spmm.cu") == []
    fa, gemm = build.library_path("flash_attention"), build.library_path("gemm")
    spmm = build.library_path("spmm")
    (tmp_path / "tma.cuh").write_text((tmp_path / "tma.cuh").read_text() + "// edited\n")
    assert build.library_path("gemm") != gemm
    assert build.library_path("flash_attention") == fa
    gemm = build.library_path("gemm")
    (tmp_path / "wgmma.cuh").write_text((tmp_path / "wgmma.cuh").read_text() + "// edited\n")
    assert build.library_path("flash_attention") != fa
    assert build.library_path("gemm") != gemm
    assert build.library_path("spmm") == spmm


@pytest.mark.cuda
def test_cuda_bf16_kernel_every_head_dim():
    """The bf16 (wgmma) kernel against its plain version at every head dim
    it takes, with GQA, a window, q_offset, ragged Sk and lse, on
    contiguous tensors, on (B, S, H, D) -> (B, H, S, D) views and on the
    second half of each along S (the zigzag ring's halves); bf16 o within
    one bf16 step, lse within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    # (2, 8, 2, 600, 777): more 64-row tiles than an H100 has SMs, so two
    # warpgroups a CTA
    for (B, H, K, Sq, Sk), D, layout in itertools.product(
            ((2, 8, 2, 100, 170), (2, 8, 2, 600, 777)), (16, 32, 64, 128, 256),
            ("contiguous", "view", "half")):
        def make(heads, S):
            n = 2 * S if layout == "half" else S
            x = torch.randn((B, n, heads, D), generator=gen, device="cuda").bfloat16()
            x = x.transpose(1, 2) if layout != "contiguous" else x.transpose(1, 2).contiguous()
            return x[:, :, S:] if layout == "half" else x

        q, k, v = make(H, Sq), make(K, Sk), make(K, Sk)
        for kw in (dict(causal=True, window=37, q_offset=70), dict(causal=False, window=0, q_offset=0),
                   dict(causal=True, window=0, q_offset=Sk - Sq)):
            got = ops.flash_attention(q, k, v, impl="cuda", return_lse=True, **kw)
            want = ops.flash_attention(q, k, v, impl="torch", return_lse=True, **kw)
            torch.testing.assert_close(got[0].float(), want[0].float(), rtol=1e-2, atol=1e-2)
            torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
