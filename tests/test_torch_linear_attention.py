"""Port's chunked linear attention vs the JAX reference on the CPU.

The same numpy inputs go through ``repro.kernels.ops.linear_attention``
(``interpret``, the Pallas body ``_la_kernel`` itself; ``xla``; ``ref``)
and ``repro_torch.hopper.ops.linear_attention`` (``torch``, the plain
form; ``ref``, the per-token oracle; ``cuda``, the kernel wrapper, which
runs the plain form for CPU tensors). Tolerance: the reference suite's
``rtol = atol = 1e-4`` (tests/test_kernels.py test_linear_attention),
chunk 16, with s0, both read-outs. The kernel itself runs only on a card:
the ``cuda``-marked test here skips without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the card's machine has no JAX: only the `cuda`-marked tests run there
    import jax.numpy as jnp
    from repro.kernels import ops as jops
except ImportError:
    jnp = jops = None
from repro_torch.hopper import blocked, dispatch, ops  # noqa: E402
from repro_torch.hopper.linear_attention import linear_attention_cuda  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
CASES = [(40, 8, 12), (64, 16, 16), (33, 8, 8)]
JAX_IMPLS = ("interpret", "xla", "ref")
PORT_IMPLS = ("torch", "ref", "cuda")


def _inputs(rng, mode, t, n, m, *, B=2, H=3):
    r = rng.standard_normal((B, H, t, n)).astype(np.float32)
    k = rng.standard_normal((B, H, t, n)).astype(np.float32)
    v = rng.standard_normal((B, H, t, m)).astype(np.float32)
    wl = (-rng.uniform(0.001, 2.0, (B, H, t, n))).astype(np.float32)
    u = None if mode == "ssd" else rng.standard_normal((H, n)).astype(np.float32)
    s0 = rng.standard_normal((B, H, n, m)).astype(np.float32)
    return r, k, v, wl, u, s0


def _jax(*xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


def _torch(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32), **(tol or TOL))


@pytest.mark.parametrize("impl", PORT_IMPLS)
@pytest.mark.parametrize("t,n,m", CASES)
@pytest.mark.parametrize("mode", ["rwkv", "ssd"])
def test_linear_attention_matches_reference(rng, mode, t, n, m, impl):
    xs = _inputs(rng, mode, t, n, m)
    o, s = ops.linear_attention(*_torch(*xs), impl=impl, chunk=16)
    assert o.dtype == torch.float32 and s.dtype == torch.float32
    for jimpl in JAX_IMPLS:
        jo, js = jops.linear_attention(*_jax(*xs), impl=jimpl, chunk=16)
        _close(o, jo)
        _close(s, js)


@pytest.mark.parametrize("chunk", [1, 7, 32, 34])
def test_chunk_sizes_agree_with_oracle(rng, chunk):
    """Any chunk the overflow guard admits gives the oracle's answer; a
    ragged last chunk acts as zero padding."""
    xs = _torch(*_inputs(rng, "rwkv", 45, 8, 8))
    o_ref, s_ref = ops.linear_attention(*xs, impl="ref")
    o, s = ops.linear_attention(*xs, impl="torch", chunk=chunk)
    torch.testing.assert_close(o, o_ref, **TOL)
    torch.testing.assert_close(s, s_ref, **TOL)


def test_step_matches_scan_and_reference(rng):
    r, k, v, wl, u, _ = _inputs(rng, "rwkv", 5, 8, 8)
    o_ref, s_ref = ops.linear_attention(*_torch(r, k, v, wl, u), impl="ref")
    S = torch.zeros((2, 3, 8, 8))
    jS = jnp.zeros((2, 3, 8, 8))
    for t in range(5):
        xt = [x[:, :, t] for x in (r, k, v, wl)]
        o_t, S = ops.linear_attention_step(*_torch(*xt), torch.from_numpy(u), S)
        jo_t, jS = jops.linear_attention_step(*_jax(*xt), jnp.asarray(u), jS)
        torch.testing.assert_close(o_t, o_ref[:, :, t], **TOL)
        _close(o_t, jo_t)
    torch.testing.assert_close(S, s_ref, **TOL)
    _close(S, jS)


def test_ssd_step_matches_scan(rng):
    r, k, v, wl, _, s0 = _inputs(rng, "ssd", 6, 8, 4)
    o_ref, s_ref = ops.linear_attention(*_torch(r, k, v, wl, None, s0), impl="ref")
    S = torch.from_numpy(s0)
    for t in range(6):
        o_t, S = ops.linear_attention_step(*_torch(*(x[:, :, t] for x in (r, k, v, wl))), None, S)
        torch.testing.assert_close(o_t, o_ref[:, :, t], **TOL)
    torch.testing.assert_close(S, s_ref, **TOL)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_chunk_overflow_guard(rng, impl):
    r = torch.from_numpy(rng.standard_normal((1, 1, 64, 4)).astype(np.float32))
    wl = torch.zeros((1, 1, 64, 4))
    with pytest.raises(ValueError, match="overflows fp32"):
        ops.linear_attention(r, r, r, wl, impl=impl, chunk=64)
    with dispatch.block_override("linear_attention", chunk=64):
        with pytest.raises(ValueError, match="overflows fp32"):
            ops.linear_attention(r, r, r, wl, impl=impl)
    ops.linear_attention(r, r, r, wl, impl=impl, chunk=34)  # the largest admitted
    # ref runs the exact scan: chunk is irrelevant, so no guard
    o, _ = ops.linear_attention(r, r, r, wl, impl="ref", chunk=64)
    assert bool(torch.isfinite(o).all())


def test_guard_message_matches_reference(rng):
    r = rng.standard_normal((1, 1, 8, 4)).astype(np.float32)
    wl = np.zeros_like(r)
    with pytest.raises(ValueError) as mine:
        ops.linear_attention(*_torch(r, r, r, wl), impl="torch", chunk=40)
    with pytest.raises(ValueError) as theirs:
        jops.linear_attention(*_jax(r, r, r, wl), impl="xla", chunk=40)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_decay_floor_applied_before_dispatch(rng, impl):
    """w_log below W_LOG_FLOOR acts as the floor, in every impl, as the
    reference clamps it (the step too)."""
    r, k, v, wl, u, s0 = _inputs(rng, "rwkv", 40, 8, 8)
    wl = (wl * 4.0 - 1.0).astype(np.float32)  # most steps below -2.5
    assert (wl < ops.W_LOG_FLOOR).mean() > 0.5
    got = ops.linear_attention(*_torch(r, k, v, wl, u, s0), impl=impl, chunk=16)
    clamped = np.maximum(wl, ops.W_LOG_FLOOR)
    want = ops.linear_attention(*_torch(r, k, v, clamped, u, s0), impl="ref")
    jwant = jops.linear_attention(*_jax(r, k, v, wl, u, s0), impl="xla", chunk=16)
    for g, w, jw in zip(got, want, jwant):
        torch.testing.assert_close(g, w, **TOL)
        _close(g, jw)
    o1, S1 = ops.linear_attention_step(*_torch(*(x[:, :, 0] for x in (r, k, v, wl))),
                                       torch.from_numpy(u), torch.from_numpy(s0))
    o2, S2 = ops.linear_attention_step(*_torch(*(x[:, :, 0] for x in (r, k, v, clamped))),
                                       torch.from_numpy(u), torch.from_numpy(s0))
    assert torch.equal(o1, o2) and torch.equal(S1, S2)


@pytest.mark.parametrize("mode", ["rwkv", "ssd"])
def test_bf16_inputs_match_reference(rng, mode):
    """bf16 r/k/v (fp32 w, u, s0), as the full-width models pass them: o in
    bf16 within a few bf16 steps of the reference's (both round an fp32
    result of another summation order), S_final fp32 at 1e-4."""
    r, k, v, wl, u, s0 = _inputs(rng, mode, 40, 8, 12)
    bf = [torch.from_numpy(x).bfloat16() for x in (r, k, v)]
    jbf = [jnp.asarray(x, jnp.bfloat16) for x in (r, k, v)]
    o, s = ops.linear_attention(*bf, *_torch(wl, u, s0), impl="torch", chunk=16)
    jo, js = jops.linear_attention(*jbf, *_jax(wl, u, s0), impl="xla", chunk=16)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    _close(o, np.asarray(jo.astype(jnp.float32)), rtol=2e-2, atol=2e-2)
    _close(s, js)


def test_broadcast_and_transposed_inputs(rng):
    """The models' argument forms: hymba's head-broadcast r/k and
    N-broadcast w (stride-0 views), rwkv6's (B, S, H, N) -> (B, H, S, N)
    transposes. Each gives what its dense copy gives, and the reference's
    answer on the broadcast arrays; the floor keeps w broadcast."""
    B, nh, T, N, M = 2, 5, 37, 4, 8
    C = rng.standard_normal((B, T, N)).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    dt = rng.uniform(0.01, 3.0, (B, T, nh)).astype(np.float32)
    v = rng.standard_normal((B, T, nh, M)).astype(np.float32)
    tC, tB, tdt, tv = _torch(C, Bm, dt, v)
    r = tC[:, None].expand(B, nh, T, N)
    k = tB[:, None].expand(B, nh, T, N)
    w = (-tdt).transpose(1, 2)[..., None].expand(B, nh, T, N)
    vt = tv.transpose(1, 2)
    assert r.stride(1) == 0 and w.stride(3) == 0 and not vt.is_contiguous()
    floored = ops._floor_decay(w)
    assert floored.stride(3) == 0 and float(floored.min()) >= ops.W_LOG_FLOOR
    dense = [x.contiguous() for x in (r, k, vt, w)]
    jargs = [jnp.broadcast_to(jnp.asarray(C)[:, None], (B, nh, T, N)),
             jnp.broadcast_to(jnp.asarray(Bm)[:, None], (B, nh, T, N)),
             jnp.asarray(v).transpose(0, 2, 1, 3),
             jnp.broadcast_to(-jnp.asarray(dt).transpose(0, 2, 1)[..., None], (B, nh, T, N))]
    jo, js = jops.linear_attention(*jargs, impl="xla", chunk=16)
    for impl in PORT_IMPLS:
        got = ops.linear_attention(r, k, vt, w, impl=impl, chunk=16)
        want = ops.linear_attention(*dense, impl=impl, chunk=16)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        _close(got[0], jo)
        _close(got[1], js)


def test_cpu_tensors_run_the_plain_form_and_count_no_launch(rng):
    xs = _torch(*_inputs(rng, "ssd", 33, 8, 8))
    dispatch.reset_launches()
    assert dispatch.resolve_impl("linear_attention") == "cuda"
    got = ops.linear_attention(*xs)  # auto: the kernel wrapper
    want = blocked.linear_attention_blocked(*xs[:4], None, xs[5])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert dispatch.LAUNCHES["linear_attention"] == 0
    assert dispatch.implementations("linear_attention") == ["cuda", "ref", "torch"]
    assert dispatch.resolve_blocks("linear_attention") == {"chunk": 32}


def test_kernel_wrapper_raises_off_cpu_and_cuda():
    x = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        linear_attention_cuda(x, x, x, x)
    with pytest.raises(NotImplementedError, match="mesh"):
        ops.linear_attention(x, x, x, x, mesh=object())


def test_empty_sequence_returns_the_incoming_state(rng):
    r = torch.zeros((1, 2, 0, 4))
    v = torch.zeros((1, 2, 0, 3))
    s0 = torch.from_numpy(rng.standard_normal((1, 2, 4, 3)).astype(np.float32))
    for impl in PORT_IMPLS:
        o, s = ops.linear_attention(r, r, v, r, None, s0, impl=impl)
        assert o.shape == (1, 2, 0, 3)
        assert torch.equal(s, s0)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for u_given in (True, False):
        r, k = (torch.randn((2, 3, 45, 16), generator=gen, device="cuda") for _ in range(2))
        v = torch.randn((2, 3, 45, 24), generator=gen, device="cuda")
        w = -2.0 * torch.rand((2, 3, 45, 16), generator=gen, device="cuda")
        u = torch.randn((3, 16), generator=gen, device="cuda") if u_given else None
        s0 = torch.randn((2, 3, 16, 24), generator=gen, device="cuda")
        for chunk in (16, 32):
            got = ops.linear_attention(r, k, v, w, u, s0, impl="cuda", chunk=chunk)
            want = ops.linear_attention(r, k, v, w, u, s0, impl="torch", chunk=chunk)
            for g, x in zip(got, want):
                torch.testing.assert_close(g, x, **TOL)


@pytest.mark.cuda
def test_cuda_kernel_near_zero_outputs_against_fp64():
    """rwkv6's read-out at its card shape's head width (N = M = 64, chunk
    32, Finch decays -exp(w0 + noise)), one (b, head) over two chunks, from
    fp32 inputs against the fp64 per-token oracle: over the slice the
    kernel lies no further from it than twice the plain form; at every
    entry, and so at the near-zero ones where terms of ~1-10 cancel, its
    error stays within 4 fp32 roundings (2^-22) of the sum of the terms'
    magnitudes (the same recurrence on |r|, |k|, |v|, |u|): a near-zero
    output's error is the fp32 rounding of its terms, whatever the order
    they are summed in."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    rng = np.random.default_rng(33)
    T, N = 64, 64
    r, k, v = (torch.from_numpy(rng.standard_normal((1, 1, T, N)).astype(np.float32)).cuda()
               for _ in range(3))
    w0 = np.linspace(-5.0, -0.5, N)
    w = torch.from_numpy(-np.exp(w0 + 0.5 * rng.standard_normal((1, 1, T, N)))
                         .astype(np.float32)).cuda()
    u = torch.from_numpy((0.5 * rng.standard_normal((1, N))).astype(np.float32)).cuda()
    oracle, _ = ops.linear_attention(*(x.double() for x in (r, k, v, w, u)), impl="ref")
    scale, _ = ops.linear_attention(*(x.double().abs() for x in (r, k, v)), w.double(),
                                    u.double().abs(), impl="ref")
    err = {impl: (ops.linear_attention(r, k, v, w, u, impl=impl)[0].double() - oracle).abs()
           for impl in ("cuda", "torch")}
    assert float(err["cuda"].max()) <= 2 * float(err["torch"].max()) + 1e-6, (
        float(err["cuda"].max()), float(err["torch"].max()))
    ratio = err["cuda"] / scale
    assert float(ratio.max()) <= 2.0 ** -22, float(ratio.max())


# ---------------------------------------------------------------------------
# The kernel's edge shapes on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_kernel_edge_shapes():
    """The kernel against its plain version: T of 0, 1, 33 and 2047;
    chunks of 1, 16 and 34; N of 16, 64 and 128 (a thread's staging batch
    of 1 and of 8 values); M of 24, 64 and 80 (a last 64-column block
    narrower than 64); s0; both read-outs; bf16 with the models' broadcast
    (hymba) and transposed (rwkv6) views and a view one element in."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = [(0, 16, 24, 32), (1, 16, 24, 32), (33, 64, 64, 16), (2047, 64, 80, 32),
              (45, 128, 80, 34), (40, 16, 24, 1), (70, 128, 64, 16)]
    for ssd in (False, True):
        for T, N, M, chunk in shapes:
            r, k = (torch.randn((2, 3, T, N), generator=gen, device="cuda") for _ in range(2))
            v = torch.randn((2, 3, T, M), generator=gen, device="cuda")
            w = -(0.001 + 1.999 * torch.rand((2, 3, T, N), generator=gen, device="cuda"))
            u = None if ssd else torch.randn((3, N), generator=gen, device="cuda")
            s0 = torch.randn((2, 3, N, M), generator=gen, device="cuda")
            got = linear_attention_cuda(r, k, v, w, u, s0, chunk=chunk)
            want = ops.linear_attention(r, k, v, w, u, s0, impl="torch", chunk=chunk)
            for g, x in zip(got, want):
                torch.testing.assert_close(g, x, **TOL)
        B, H, T, N, M = 2, 5, 77, 16, 64
        big = torch.randn((B, T, H, N + 1), generator=gen, device="cuda").bfloat16()
        forms = {
            "broadcast": (torch.randn((B, T, N), generator=gen, device="cuda").bfloat16()[:, None]
                          .expand(B, H, T, N), -torch.rand((B, T, H), generator=gen, device="cuda")
                          .transpose(1, 2)[..., None].expand(B, H, T, N)),
            "transposed": (big[..., :N].transpose(1, 2), None),
            "offset": (big[..., 1:].transpose(1, 2), None),
        }
        for name, (x, w) in forms.items():
            if w is None:
                w = -(0.001 + 1.999 * torch.rand((B, H, T, N), generator=gen, device="cuda"))
            v = torch.randn((B, T, H, M), generator=gen, device="cuda").bfloat16().transpose(1, 2)
            u = None if ssd else torch.randn((H, N), generator=gen, device="cuda")
            got = linear_attention_cuda(x, x, v, w, u)
            want = ops.linear_attention(x, x, v, w, u, impl="torch")
            step = float(2.0 ** (torch.floor(torch.log2(want[0].float().abs().max())) - 7))
            assert float((got[0].float() - want[0].float()).abs().max()) <= step, (ssd, name)
            torch.testing.assert_close(got[1], want[1], **TOL)
