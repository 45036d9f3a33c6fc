"""Each plain reference computes the port's function: on the CPU, at the
port's REDUCED sizes in fp32, it matches the port's own forward to
rounding, and its control (the precision below) does not."""
import torch

from portbench.lib import manifest as mf


def test_gptj_reference_matches_the_port_on_reduced():
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer

    cfg = get_config("occamy-gptj", reduced=True)
    model = {k: getattr(cfg, k) for k in (
        "name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
        "d_ff", "vocab_size", "activation", "parallel_block", "rope_theta", "norm_eps", "dtype")}
    ref = mf.reference("occamy-gptj")
    params = ref.make_params(model, 7, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 48), generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        port = transformer.forward(params, cfg, {"tokens": tokens})[0]
    want = ref.forward(params, model, tokens)
    rel = float((port - want).norm() / want.norm())
    assert port.shape == want.shape and rel < 1e-5, rel
    low = ref.forward(params, model, tokens, precision="fp8")
    assert float((low - want).norm() / want.norm()) > 100 * max(rel, 1e-7)


def test_gptj_reference_matches_the_port_in_serving():
    """The paged engine's greedy tokens are the reference's argmax of the
    prompt and the tokens served before them (fp32, REDUCED)."""
    from repro_torch.configs.base import get_config
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_config("occamy-gptj", reduced=True)
    model = {"num_layers": cfg.num_layers, "d_model": cfg.d_model, "num_heads": cfg.num_heads,
             "num_kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
             "vocab_size": cfg.vocab_size, "activation": cfg.activation, "rope_theta": cfg.rope_theta,
             "norm_eps": cfg.norm_eps, "dtype": cfg.dtype}
    ref = mf.reference("occamy-gptj")
    params = ref.make_params(model, 11, "cpu")
    eng = ServingEngine.with_model(cfg, params, num_blocks=17, block_size=8, max_slots=2,
                                   max_blocks_per_seq=8, device="cpu")
    prompt = tuple(range(5, 25))
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=12))
    with torch.no_grad():
        served = eng.run()[0]
    seq = torch.tensor([*prompt, *served[:-1]])[None]
    logits = ref.forward(params, model, seq)[0, len(prompt) - 1:, :cfg.vocab_size]
    assert list(logits.argmax(-1)) == list(served)


def test_gcn_reference_matches_the_port():
    from conftest import TINY_GRAPH
    from repro_torch.core.sparse import EllMatrix
    from repro_torch.models import gcn

    ref = mf.reference("gcn-uniform")
    vals, cols = ref.make_graph(TINY_GRAPH, 5, "cpu")
    w = ref.make_weights(TINY_GRAPH, 5, "cpu")
    x = ref.make_features(TINY_GRAPH, 5, "cpu", 1)[0]
    n = TINY_GRAPH["nodes"]
    port = gcn.forward(w, EllMatrix(vals, cols, (n, n)), x)
    want = ref.forward(w, vals, cols, x, rows=128)
    assert float((port - want).abs().max() / want.pow(2).mean().sqrt()) < 1e-5
