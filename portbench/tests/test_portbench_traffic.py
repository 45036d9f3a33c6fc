"""Each generator repeats for a seed: the same seed gives the same inputs
and weights, another seed other tokens but the same lengths."""
import numpy as np
import pytest
import torch

from portbench.lib import manifest as mf
from portbench.lib import traffic as tf

BIG = 2**31 + 12345  # seeds may run past 32 bits


def test_request_lengths_fixed_and_in_range():
    mix = mf.traffic("azure-conv64")
    a, b = tf.request_lengths(mix), tf.request_lengths(mix)
    assert a == b and len(a) == mix["requests"]
    p = np.array([x for x, _ in a])
    o = np.array([y for _, y in a])
    assert p.min() >= mix["prompt_tokens"][0] and p.max() <= mix["prompt_tokens"][1]
    assert o.min() >= mix["output_tokens"][0] and o.max() <= mix["output_tokens"][1]
    # log-uniform means 1049 and 173 tokens, medians the trace's 1020 and 129
    assert abs(p.mean() - 1049) < 5 and abs(o.mean() - 173) < 3
    assert abs(np.median(p) - 1020) < 5 and abs(np.median(o) - 129) < 3
    need = -(-(p + o) // mix["block_size"])
    assert need.max() <= mix["max_blocks_per_seq"]


def test_pool_holds_the_mix_without_preemption():
    """The mix's closed loop on the port's scheduler (its host-only
    ``StubModel``) for two cycles of its requests: the pool is what the
    mix holds at its peak, and one page fewer preempts."""
    from repro_torch.serving.engine import Request, ServingEngine, StubModel

    mix = mf.traffic("azure-conv64")
    lengths = tf.request_lengths(mix)

    def peak_and_preemptions(num_blocks):
        eng = ServingEngine(StubModel(), num_blocks=num_blocks, block_size=mix["block_size"],
                            max_slots=mix["slots"], max_blocks_per_seq=mix["max_blocks_per_seq"])
        alloc, sent, live, peak = eng.scheduler.allocator, [0], set(), 0

        def submit():
            p, o = lengths[sent[0] % len(lengths)]
            eng.submit(Request(rid=sent[0], prompt=(1,) * p, max_new_tokens=o,
                               arrival=eng.step_count))
            live.add(sent[0])
            sent[0] += 1

        for _ in range(mix["clients"]):
            submit()
        while sent[0] < 4 * mix["requests"]:
            eng.step()
            peak = max(peak, num_blocks - 1 - alloc.available())
            for rid in [r for r in live if r in eng.completed]:
                live.discard(rid)
                submit()
        return peak, sum(s.preemptions for s in eng.scheduler.finished.values())

    assert peak_and_preemptions(mix["num_blocks"]) == (mix["num_blocks"] - 1, 0)
    assert peak_and_preemptions(mix["num_blocks"] - 1)[1] > 0


def test_request_tokens_repeat_for_a_seed():
    mix = mf.traffic("azure-conv64")
    a = tf.request_tokens(mix, BIG, 50400)
    assert a == tf.request_tokens(mix, BIG, 50400)
    other = tf.request_tokens(mix, BIG + 1, 50400)
    assert [len(x) for x in a] == [len(x) for x in other] and a != other
    assert [len(x) for x in a] == [p for p, _ in tf.request_lengths(mix)]
    assert max(max(x) for x in a) < 50400


def _same(a, b):
    if isinstance(a, dict):
        return all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def test_weights_repeat_for_a_seed():
    from conftest import TINY_LM
    ref = mf.reference("occamy-gptj")
    a = ref.make_params(TINY_LM, BIG, "cpu")
    assert _same(a, ref.make_params(TINY_LM, BIG, "cpu"))
    assert not torch.equal(a["layers"]["wq"], ref.make_params(TINY_LM, BIG + 1, "cpu")["layers"]["wq"])
    assert a["layers"]["wq"].dtype == torch.bfloat16
    assert a["layers"]["wq"].shape == (2, 64, 64) and a["lm_head"].shape == (64, 512)


@pytest.mark.parametrize("maker", ["make_graph", "make_weights"])
def test_graph_repeats_for_a_seed(maker):
    from conftest import TINY_GRAPH
    ref = mf.reference("gcn-uniform")
    a = getattr(ref, maker)(TINY_GRAPH, BIG, "cpu")
    assert _same(a, getattr(ref, maker)(TINY_GRAPH, BIG, "cpu"))
    assert not _same(a, getattr(ref, maker)(TINY_GRAPH, BIG + 1, "cpu"))


def test_graph_shape():
    from conftest import TINY_GRAPH
    vals, cols = mf.reference("gcn-uniform").make_graph(TINY_GRAPH, 3, "cpu")
    n = TINY_GRAPH["nodes"]
    assert cols.dtype == torch.int32 and cols.shape == (n, TINY_GRAPH["ell_slots"])
    assert torch.equal(cols[:, 0], torch.arange(n, dtype=torch.int32))
    assert int(cols.min()) >= 0 and int(cols.max()) < n
    assert torch.allclose(vals.sum(1), torch.ones(n))


def test_uniform_graph_keeps_ogbn_arxivs_sizes():
    conf = mf.load_json(mf.BENCH / "configs" / "gcn-uniform.json")
    g, pub = conf["model"], conf["published"]
    assert g["ell_slots"] == round(g["mean_degree"]) + 1  # self loop + 14
    assert g["nodes"] == pub["ogbn_arxiv_nodes"]
    assert g["feature_dims"] == [pub["ogbn_arxiv_node_features"]] + [pub["gcn_features"]] * 2
