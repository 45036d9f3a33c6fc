"""granite-4.0-h-small, the port's granite_hybrid family, on the CPU at its
REDUCED size in fp32 (four layers, attention at index 1, four experts of
which two a token, a shared expert).

- The configuration against the catalog's published keys, which the
  benchmark's configuration file carries at its top level.
- ``ops.ssd_scan`` and ``ops.ssd_step`` against a per-token scan at decays
  down to -200 a token, where ``linear_attention``'s floor would change
  the result.
- ``moe.moe_mlp_dropless`` when every token picks one expert (all of them
  the same one, which a capacity would cut).
- The port's forward and prefill against ``portbench/reference/
  granite-4.0-h-small.py``, and that reference against ``transformers``'
  ``GraniteMoeHybridForCausalLM`` with the same weights.
- Through ``ServingEngine.with_model``: greedy tokens equal to the
  reference's argmax; a prompt padded to its bucket leaves the state of the
  unpadded prompt; a forced preemption carries the state to the host and
  back; the ``mamba.*`` and ``engine.state`` spans and the state counters
  exist only under a profiler.
"""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import manifest as mf  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, GraniteHybridConfig, get_config  # noqa: E402
from repro_torch.hopper import ops  # noqa: E402
from repro_torch.models import granite_hybrid as G  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serving.engine import PagedModel, Request, ServingEngine  # noqa: E402

ARCH = "granite-4.0-h-small"
CFG = get_config(ARCH, reduced=True)
REF = mf.reference(ARCH)
CONF = mf.load_json(mf.BENCH / "configs" / f"{ARCH}.json")


def model_dict(cfg):
    m = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    m["layer_types"] = list(m["layer_types"])
    return m


MODEL = model_dict(CFG)


@pytest.fixture(scope="module")
def params():
    return REF.make_params(MODEL, 7, "cpu")


def tokens(shape, seed=1):
    return torch.randint(0, CFG.vocab_size, shape, generator=torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------


def test_config_is_the_published_one():
    full = get_config(ARCH)
    assert ARCH not in ARCH_IDS  # the reference package has no Granite
    assert full.layer_types == tuple(CONF["layer_types"])
    assert full.layers_of("attention") == [5, 15, 25, 35]
    pairs = {"hidden_size": full.d_model, "num_hidden_layers": full.num_layers,
             "num_attention_heads": full.num_heads, "num_key_value_heads": full.num_kv_heads,
             "intermediate_size": full.d_ff, "shared_intermediate_size": full.shared_d_ff,
             "num_local_experts": full.num_experts, "num_experts_per_tok": full.experts_per_token,
             "mamba_d_state": full.ssm_state, "mamba_d_head": full.ssm_head_dim,
             "mamba_n_heads": full.ssm_heads, "mamba_d_conv": full.conv_kernel,
             "mamba_n_groups": full.ssm_groups, "vocab_size": full.vocab_size,
             "embedding_multiplier": full.embedding_multiplier,
             "residual_multiplier": full.residual_multiplier,
             "logits_scaling": full.logits_scaling,
             "attention_multiplier": full.attention_multiplier,
             "rms_norm_eps": full.norm_eps, "tie_word_embeddings": full.tie_embeddings}
    for key, value in pairs.items():
        assert CONF[key] == value, key
    assert full.resolved_d_inner() == CONF["mamba_expand"] * CONF["hidden_size"]
    assert full.nope and CONF["position_embedding_type"] == "nope"
    assert GraniteHybridConfig(**CONF["model"]) == full
    assert CONF["reduced"] == []


def test_parameter_count():
    full = get_config(ARCH)
    assert full.num_params() == pytest.approx(32.2e9, rel=0.01)
    assert full.num_active_params() == pytest.approx(8.80e9, rel=0.01)
    shapes = registry.param_shapes(full)
    n = sum(t.numel() for group in shapes.values()
            for t in (group.values() if isinstance(group, dict) else [group]))
    assert n == full.num_params()


def test_config_rejects_a_wrong_layer_list():
    with pytest.raises(ValueError, match="layer_types"):
        CFG.replace(layer_types=("mamba",) * 3)


# ---------------------------------------------------------------------------
# the exact SSD scan
# ---------------------------------------------------------------------------


def per_token(x, dt, A, B, C, D, s0):
    nh, G = x.shape[2], B.shape[2]
    g = torch.arange(nh) // (nh // G)
    st, ys = s0.clone().double(), []
    for t in range(x.shape[1]):
        st = (st * torch.exp(dt[:, t] * A).double()[..., None, None]
              + (x[:, t] * dt[:, t, :, None]).double()[..., None] * B[:, t][:, g].double()[:, :, None])
        ys.append(torch.einsum("bhpn,bhn->bhp", st, C[:, t][:, g].double()) + D[:, None] * x[:, t])
    return torch.stack(ys, 1), st


def scan_inputs(S, nh=8, P=4, G=2, N=5, deepest=200.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, S, nh, P, generator=g)
    dt = torch.rand(2, S, nh, generator=g) * 2
    dt[:, 0, -1] = 2.0
    A = -torch.linspace(0.01, deepest / 2, nh)  # dt A reaches -deepest a token
    B, C = torch.randn(2, S, G, N, generator=g), torch.randn(2, S, G, N, generator=g)
    D = torch.randn(nh, generator=g)
    s0 = torch.randn(2, nh, P, N, generator=g)
    return x, dt, A, B, C, D, s0


@pytest.mark.parametrize("S,chunk", [(1, 16), (37, 16), (200, 64), (129, 128)])
def test_ssd_scan_is_the_per_token_scan(S, chunk, monkeypatch):
    monkeypatch.setattr(ops, "SSD_CHUNK", chunk)
    x, dt, A, B, C, D, s0 = scan_inputs(S)
    assert float((dt * A).min()) < -150
    y, final = ops.ssd_scan(x, dt, A, B, C, D, s0)
    want_y, want_s = per_token(x, dt, A, B, C, D, s0)
    torch.testing.assert_close(y.double(), want_y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(final.double(), want_s, rtol=1e-5, atol=1e-5)


def test_ssd_step_advances_the_state_in_place():
    x, dt, A, B, C, D, s0 = scan_inputs(23)
    state = s0.clone()
    ys = [ops.ssd_step(x[:, t], dt[:, t], A, B[:, t], C[:, t], D, state) for t in range(23)]
    want_y, want_s = per_token(x, dt, A, B, C, D, s0)
    torch.testing.assert_close(torch.stack(ys, 1).double(), want_y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(state.double(), want_s, rtol=1e-5, atol=1e-5)


def test_zero_dt_leaves_the_state(monkeypatch):
    monkeypatch.setattr(ops, "SSD_CHUNK", 16)
    x, dt, A, B, C, D, s0 = scan_inputs(30)
    dt[:, 20:] = 0
    _, full = ops.ssd_scan(x, dt, A, B, C, D, s0)
    _, head = ops.ssd_scan(x[:, :20], dt[:, :20], A, B[:, :20], C[:, :20], D, s0)
    torch.testing.assert_close(full, head, rtol=1e-6, atol=1e-6)


def test_the_linear_attention_floor_would_change_these_results():
    """The same scan through ``linear_attention_step``, whose per-token
    floor (``W_LOG_FLOOR``) clamps the decays below -2.5: it departs from
    the exact scan, which ``ssd_scan`` keeps."""
    x, dt, A, B, C, D, s0 = scan_inputs(12, G=1)
    nh = x.shape[2]
    S = s0.transpose(-1, -2).clone()  # (B, nh, N, P): linear attention's layout
    ys = []
    for t in range(12):
        k = B[:, t, 0][:, None].expand(-1, nh, -1)
        r = C[:, t, 0][:, None].expand(-1, nh, -1)
        w = (dt[:, t] * A)[..., None].expand_as(k)
        o, S = ops.linear_attention_step(r, k, x[:, t] * dt[:, t, :, None], w, None, S)
        ys.append(o + D[:, None] * x[:, t])
    want, _ = per_token(x, dt, A, B, C, D, s0)
    assert float((torch.stack(ys, 1).double() - want).abs().max()) > 0.1


# ---------------------------------------------------------------------------
# dropless MoE
# ---------------------------------------------------------------------------


def one_expert_layer(expert: int, seed=3):
    cfg = CFG.replace(experts_per_token=1)
    g = torch.Generator().manual_seed(seed)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {n: torch.randn(shape, generator=g) / math.sqrt(shape[-2])
         for n, shape in (("moe_wg", (E, d, f)), ("moe_wi", (E, d, f)), ("moe_wo", (E, f, d)))}
    p["router"] = torch.zeros(d, E)
    p["router"][:, expert] = 1.0
    return cfg, p


@pytest.mark.parametrize("expert", [0, 3])
def test_dropless_moe_keeps_every_token_on_one_expert(expert):
    cfg, p = one_expert_layer(expert)
    x = torch.rand(2, 40, cfg.d_model) + 0.1  # every token routes to ``expert``
    got = M.moe_mlp_dropless(p, x, cfg)
    e = expert
    want = torch.matmul(torch.nn.functional.silu(x @ p["moe_wg"][e]) * (x @ p["moe_wi"][e]),
                        p["moe_wo"][e])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # a capacity-bound dispatch drops most of them
    dropped, _ = M.moe_mlp(p, x, cfg)
    assert float((dropped - want).abs().max()) > 0.1


def test_dropless_moe_is_the_plain_loop(params):
    p = {n: t[0] for n, t in params["layers"].items()}
    x = torch.randn(3, 17, CFG.d_model, generator=torch.Generator().manual_seed(2))
    got = M.moe_mlp_dropless(p, x, CFG).float() + M.shared_expert(p, x, "swiglu").float()
    w = {n: t.float() for n, t in p.items()}
    torch.testing.assert_close(got, REF._moe(w, MODEL, x, "fp32"), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the model against its references
# ---------------------------------------------------------------------------


def rel(a, b):
    return float((a - b).norm() / b.norm())


def test_forward_and_prefill_match_the_reference(params):
    t = tokens((2, 150))
    with torch.no_grad():
        got, aux = G.forward(params, CFG, {"tokens": t})
        last, kv, st = G.prefill_step(params, CFG, {"tokens": t}, lengths=[150, 101])
    want = REF.forward(params, MODEL, t)
    assert aux == 0.0 and got.shape == want.shape and rel(got, want) < 1e-5
    torch.testing.assert_close(last, torch.stack([want[0, 149], want[1, 100]]),
                               rtol=1e-5, atol=1e-7)
    assert kv["k"].shape == (1, 2, CFG.num_kv_heads, 150, CFG.head_dim)
    assert st["ssm"].shape == (3, 2, CFG.ssm_heads, CFG.ssm_head_dim, CFG.ssm_state)
    assert st["conv"].shape == (3, 2, CFG.conv_dim, CFG.conv_kernel - 1)
    low = REF.forward(params, MODEL, t, precision="fp8")
    assert rel(low, want) > 100 * max(rel(got, want), 1e-7)


def test_reference_matches_transformers(params):
    tf = pytest.importorskip("transformers")
    m = MODEL
    conf = tf.GraniteMoeHybridConfig(
        vocab_size=m["vocab_size"], hidden_size=m["d_model"], intermediate_size=m["d_ff"],
        shared_intermediate_size=m["shared_d_ff"], num_hidden_layers=m["num_layers"],
        num_attention_heads=m["num_heads"], num_key_value_heads=m["num_kv_heads"],
        layer_types=m["layer_types"], mamba_n_heads=CFG.ssm_heads, mamba_d_head=m["ssm_head_dim"],
        mamba_d_state=m["ssm_state"], mamba_n_groups=m["ssm_groups"], mamba_d_conv=m["conv_kernel"],
        mamba_expand=m["d_inner"] // m["d_model"], mamba_chunk_size=32,
        num_local_experts=m["num_experts"], num_experts_per_tok=m["experts_per_token"],
        embedding_multiplier=m["embedding_multiplier"], logits_scaling=m["logits_scaling"],
        residual_multiplier=m["residual_multiplier"],
        attention_multiplier=m["attention_multiplier"], position_embedding_type="nope",
        tie_word_embeddings=True, rms_norm_eps=m["norm_eps"], hidden_act="silu",
        attn_implementation="eager")
    hf = tf.GraniteMoeHybridForCausalLM(conf).eval()
    T = lambda x: x.float().transpose(-1, -2)  # noqa: E731  (ours (in, out); torch's (out, in))
    with torch.no_grad():
        hf.model.embed_tokens.weight.copy_(params["embed"])
        hf.model.norm.weight.copy_(params["final_norm"])
        nm = na = 0
        for i, layer in enumerate(hf.model.layers):
            p = {n: v[i] for n, v in params["layers"].items()}
            layer.input_layernorm.weight.copy_(p["attn_norm"])
            layer.post_attention_layernorm.weight.copy_(p["mlp_norm"])
            moe = layer.block_sparse_moe
            moe.router.layer.weight.copy_(T(p["router"]))
            moe.input_linear.weight.copy_(torch.cat([T(p["moe_wg"]), T(p["moe_wi"])], dim=1))
            moe.output_linear.weight.copy_(T(p["moe_wo"]))
            layer.shared_mlp.input_linear.weight.copy_(torch.cat([T(p["sh_wg"]), T(p["sh_wi"])]))
            layer.shared_mlp.output_linear.weight.copy_(T(p["sh_wo"]))
            if layer.mamba is not None:
                w = {n: v[nm] for n, v in params["mamba"].items()}
                nm += 1
                mb = layer.mamba
                mb.in_proj.weight.copy_(T(w["in_proj"]))
                mb.conv1d.weight.copy_(w["conv_w"][:, None])
                mb.conv1d.bias.copy_(w["conv_b"])
                for name in ("dt_bias", "A_log", "D"):
                    getattr(mb, name).copy_(w[name])
                mb.norm.weight.copy_(w["norm"])
                mb.out_proj.weight.copy_(T(w["out_proj"]))
            else:
                w = {n: v[na] for n, v in params["attn"].items()}
                na += 1
                for proj, name in (("q_proj", "wq"), ("k_proj", "wk"), ("v_proj", "wv"),
                                   ("o_proj", "wo")):
                    getattr(layer.self_attn, proj).weight.copy_(T(w[name]))
        hf.tie_weights()
        t = tokens((2, 70), seed=4)
        want = hf(input_ids=t).logits.float()
    got = REF.forward(params, MODEL, t)[..., : m["vocab_size"]]
    assert rel(got, want) < 1e-5, rel(got, want)


# ---------------------------------------------------------------------------
# through the paged engine
# ---------------------------------------------------------------------------

GEOMETRY = dict(num_blocks=40, block_size=8, max_slots=3, max_blocks_per_seq=8)
PROMPTS = {0: tuple(range(5, 25)), 1: tuple(range(300, 313)), 2: tuple(range(40, 51))}


def engine(params, **geometry):
    return ServingEngine.with_model(CFG, params, device="cpu", **{**GEOMETRY, **geometry})


def serve(eng, new=(9, 12, 7)):
    for rid, prompt in PROMPTS.items():
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=new[rid]))
    with torch.no_grad():
        return eng.run()


def test_served_tokens_are_the_references_argmax(params):
    eng = engine(params)
    out = serve(eng)
    assert eng.leaked_blocks() == 0
    for rid, prompt in PROMPTS.items():
        seq = torch.tensor([*prompt, *out[rid][:-1]])[None]
        logits = REF.forward(params, MODEL, seq, start=len(prompt) - 1)[0, :, : CFG.vocab_size]
        assert logits.argmax(-1).tolist() == list(out[rid]), rid


def test_kv_pages_for_attention_layers_only(params):
    model = engine(params).model
    assert model.cache.k_pool.shape[0] == 1 and model.attention_windows == (0,)
    assert model.state["ssm"].shape == (3, 3, CFG.ssm_heads, CFG.ssm_head_dim, CFG.ssm_state)
    with pytest.raises(NotImplementedError, match="granite_hybrid"):
        PagedModel(CFG.replace(family="ssm"), params, device="cpu", **GEOMETRY)


def test_bucket_padding_leaves_the_unpadded_state(params):
    """Two prompts of one 16-token bucket (11 and 13 tokens): each slot's
    state after the engine's padded prefill is that of the prompt alone."""
    eng = engine(params)
    model = eng.model
    for rid, n in ((0, 11), (1, 13)):
        eng.submit(Request(rid=rid, prompt=tokens((n,), seed=rid).tolist(), max_new_tokens=3))
    with torch.no_grad():
        admitted = eng.scheduler.admit(0)
        firsts = [model.prefill(seq, seq.blocks) for seq in admitted]
        for seq, first in zip(admitted, firsts):
            t = torch.tensor(seq.req.prompt)[None]
            last, _, st = G.prefill_step(params, CFG, {"tokens": t})
            assert first == int(last[0, : CFG.vocab_size].argmax())
            for name in ("ssm", "conv"):
                # the chunks of 11 or 13 tokens and of the 16-token bucket
                # round differently in fp32; nothing else differs
                torch.testing.assert_close(model.state[name][:, seq.slot], st[name][:, 0],
                                           rtol=1e-4, atol=1e-5)


def test_preemption_round_trips_the_state(params):
    roomy = serve(engine(params))
    tight = engine(params, num_blocks=6)
    assert serve(tight) == roomy
    assert sum(s.preemptions for s in tight.scheduler.finished.values()) > 0
    # save, clear, restore into another slot: the state comes back bitwise
    model = engine(params).model
    for pool in model.state.values():
        pool.normal_()
    seq = type("Seq", (), {"rid": 5, "slot": 1})()
    saved = model.save_blocks(seq, [2, 3])
    want = {n: pool[:, 1].clone() for n, pool in model.state.items()}
    seq.slot = 2
    for pool in model.state.values():
        pool[:, 2].zero_()
    model.restore_blocks(seq, [4, 5], saved)
    for n, pool in model.state.items():
        assert torch.equal(pool[:, 2], want[n])


def test_spans_and_counters_only_while_live(params):
    tracing.take()
    serve(engine(params))
    assert tracing.take() == []
    eng = engine(params)
    with profile(activities=[ProfilerActivity.CPU]):
        out = serve(eng)
    recs = tracing.take()
    names = [r.name for r in recs]
    decodes = [r for r in recs if r.name == "engine.decode"]
    steps = len(decodes)
    assert steps and names.count("mamba.step") == 3 * steps
    assert names.count("mamba.scan") == 3 * names.count("engine.prefill") == 9
    writes = [r for r in recs if r.name == "engine.state"]
    assert len(writes) == 3 and {r.attrs["op"] for r in writes} == {"write"}
    assert {r.attrs["layer"] for r in recs if r.name == "mamba.step"} == {0, 2, 3}
    for r in decodes:
        assert r.attrs["state_rows"] == 3 and 1 <= r.attrs["state_live"] <= 3
        assert r.attrs["pages_live"] <= r.attrs["pages_walked"]
    assert out == serve(engine(params))


def test_page_counters_count_attention_layers_only(params):
    eng = engine(params)
    positions = np.array([17, 3, 0])
    active = np.array([True, True, False])
    tables = np.zeros((3, 8), np.int32)
    c = eng._pages(positions, active, tables)
    assert c["pages_live"] == (3 + 1) * 1  # one attention layer
    assert c["pages_walked"] == tables.size  # the plain form on the CPU
    assert (c["state_live"], c["state_rows"]) == (2, 3)


# ---------------------------------------------------------------------------
# the benchmark's closed-form counts
# ---------------------------------------------------------------------------


def test_benchmark_counts_agree_with_the_config():
    from portbench.lib import counts_granite as cg

    full, m = get_config(ARCH), CONF["model"]
    vocab = m["vocab_size"] * m["d_model"]
    small = 2 * m["num_layers"] + 1  # the norms' vectors
    assert cg.token_matmul_params(m) + vocab == pytest.approx(
        full.num_active_params() - small * m["d_model"], rel=2e-3)
    # a decode step of 32 sequences reads nearly every expert, all the state
    contexts = [7590] * 32
    assert cg.experts_hit(m, 32) == pytest.approx(71.4, abs=0.1)
    assert cg.state_bytes(m) == 36 * (128 * 64 * 128 * 4 + 8448 * 3 * 2)
    assert 75e9 < cg.decode_bytes(m, contexts) < 82e9
    assert cg.prefill_flops(m, 7590) == pytest.approx(1.304e14, rel=0.01)
