"""Port dense transformer vs the JAX reference on the CPU.

``repro.models.transformer.init_params`` draws the weights; every leaf
goes through numpy to ``repro_torch.models.transformer.params_from_jax``
(norm weights and biases re-drawn from a seeded numpy stream so they are
not trivial), and the same tokens, pools and tables go to both sides.
``forward``, ``prefill_step`` and ``decode_step_paged`` must agree at the
reference suite's ``rtol=atol=1e-4`` for ``occamy-gptj`` REDUCED (fp32)
and two variants made with ``.replace(...)`` on both sides.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving.paged_cache import PagedKVCache as JaxPagedKVCache  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serving.paged_cache import PagedKVCache  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
VARIANTS = {
    "gptj": {},
    "gqa_qknorm": dict(num_kv_heads=2, qk_norm=True),
    "serial_swiglu_bias": dict(num_kv_heads=2, parallel_block=False,
                               activation="swiglu", qkv_bias=True),
}


def _np_params(cfg, seed=0):
    tree = jax.tree.map(np.asarray, jtr.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for name, leaf in list(tree["layers"].items()):
        if name.endswith("norm") or name in ("bq", "bk", "bv"):
            tree["layers"][name] = (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    tree["final_norm"] = (1.0 + 0.1 * rng.standard_normal(tree["final_norm"].shape)).astype(np.float32)
    return tree


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def model(request):
    kw = VARIANTS[request.param]
    jcfg = jax_get_config("occamy-gptj", reduced=True).replace(**kw)
    tcfg = get_config("occamy-gptj", reduced=True).replace(**kw)
    np_params = _np_params(jcfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = ttr.params_from_jax(np_params, device="cpu")
    return jcfg, tcfg, jp, tp


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_init_params_shapes_match_reference(model):
    jcfg, tcfg, jp, _ = model
    mine = ttr.init_params(tcfg, seed=1, device="cpu")
    ref = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), jp)
    got = {
        k: ({n: (tuple(x.shape), str(x.dtype).removeprefix("torch.")) for n, x in v.items()}
            if isinstance(v, dict) else (tuple(v.shape), str(v.dtype).removeprefix("torch.")))
        for k, v in mine.items()
    }
    assert got == ref


def test_forward_logits_match_reference(model, rng):
    jcfg, tcfg, jp, tp = model
    tokens = rng.integers(0, tcfg.vocab_size, (2, 13))
    want, _ = jtr.forward(jp, jcfg, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got, _ = ttr.forward(tp, tcfg, {"tokens": torch.from_numpy(tokens)})
    _close(got, want)


def test_prefill_step_matches_reference(model, rng):
    jcfg, tcfg, jp, tp = model
    tokens = rng.integers(0, tcfg.vocab_size, (2, 11))
    want, wcache = jtr.prefill_step(jp, jcfg, {"tokens": jnp.asarray(tokens, jnp.int32)}, 16)
    got, gcache = ttr.prefill_step(tp, tcfg, {"tokens": torch.from_numpy(tokens)}, 16)
    assert got.dtype == torch.float32 and tuple(gcache["k"].shape) == wcache["k"].shape
    _close(got, want)
    _close(gcache["k"], wcache["k"])
    _close(gcache["v"], wcache["v"])


def test_decode_step_paged_matches_reference(model, rng):
    jcfg, tcfg, jp, tp = model
    nl, K, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.resolved_head_dim()
    B, bs, nb, P = 3, 4, 3, 12
    kp = rng.standard_normal((nl, P, K, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((nl, P, K, bs, hd)).astype(np.float32)
    table = rng.permutation(np.arange(1, P))[: B * nb].reshape(B, nb).astype(np.int32)
    table[2] = 0  # an inactive slot: every entry on the scratch page
    pos = np.array([5, 11, 0], np.int32)
    tok = rng.integers(0, tcfg.vocab_size, B).astype(np.int32)

    jcache = JaxPagedKVCache(jnp.asarray(kp), jnp.asarray(vp), None, None, bs)
    want, wcache = jtr.decode_step_paged(
        jp, jcfg, jcache,
        {"token": jnp.asarray(tok), "position": jnp.asarray(pos), "block_table": jnp.asarray(table)})
    cache = PagedKVCache(torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()), bs)
    got, cache = ttr.decode_step_paged(
        tp, tcfg, cache,
        {"token": torch.from_numpy(tok), "position": torch.from_numpy(pos),
         "block_table": torch.from_numpy(table)})
    assert got.dtype == torch.float32
    _close(got[:2], want[:2])  # the inactive row's output is dropped by the engine
    live = np.unique(table[:2])
    _close(cache.k_pool[:, live], wcache.k_pool[:, live])
    _close(cache.v_pool[:, live], wcache.v_pool[:, live])


def test_layer_numerics_match_reference(rng):
    assert TL.padded_vocab(50400) == JL.padded_vocab(50400) == 50432
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    pos = np.arange(5) + 7
    cos, sin = TL.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    jcos, jsin = JL.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    _close(cos, jcos)
    _close(TL.apply_rope(torch.from_numpy(x), cos, sin),
           JL.apply_rope(jnp.asarray(x), jcos, jsin))
    for name in ("gelu", "swiglu", "relu_sq"):
        _close(TL.activation_fn(name)(torch.from_numpy(x)),
               JL.activation_fn(name)(jnp.asarray(x)))


def test_init_params_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.init_params(get_config("occamy-gptj", reduced=True))
