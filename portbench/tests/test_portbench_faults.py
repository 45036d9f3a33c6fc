"""A whole run but the look for a card, on the CPU at a test's size, with
the timed path broken underneath: ``correct`` has to come out false for
each fault the cell can have (an answer altered where it is produced, half
of the batch left out, a step that leaves its state unchanged), and true
with nothing broken. One chip, so no exchange between chips to leave out."""
import time

import pytest
import torch
from conftest import tiny_cell

from portbench.lib import harness


def run(drive, seed=2**31 + 7, seconds=1.0):
    return harness.run_cell(tiny_cell(drive), seed=seed, seconds=seconds, trace=False,
                            device=torch.device("cpu"), t0=time.perf_counter())


@pytest.mark.parametrize("drive", ["prefill", "graph", "serve"])
def test_sound_run_is_correct(drive):
    r = run(drive)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


def test_prefill_answer_altered(monkeypatch):
    from repro_torch.models import transformer

    forward = transformer.forward

    def altered(*a, **k):
        logits, aux = forward(*a, **k)
        logits = logits.clone()
        logits[:, 5] = logits[:, 5].roll(1, -1)  # one position's answer, every prompt
        return logits, aux

    monkeypatch.setattr(transformer, "forward", altered)
    assert not run("prefill")["correct"]


def test_prefill_half_batch_left_out(monkeypatch):
    from repro_torch.models import transformer

    forward = transformer.forward

    def half(params, cfg, batch, **k):
        tokens = batch["tokens"]
        logits, aux = forward(params, cfg, {"tokens": tokens[: len(tokens) // 2]}, **k)
        return torch.cat([logits, torch.zeros_like(logits)]), aux

    monkeypatch.setattr(transformer, "forward", half)
    assert not run("prefill")["correct"]


def test_graph_answer_altered(monkeypatch):
    from repro_torch.models import gcn

    forward = gcn.forward

    def altered(*a, **k):
        out = forward(*a, **k).clone()
        out[7, 3] += 0.01
        return out

    monkeypatch.setattr(gcn, "forward", altered)
    assert not run("graph")["correct"]


def test_graph_half_rows_left_out(monkeypatch):
    from repro_torch.hopper import ops

    spmm = ops.spmm

    def half(adj, h, **k):
        out = spmm(adj, h, **k)
        out[len(out) // 2:] = 0
        return out

    monkeypatch.setattr(ops, "spmm", half)
    assert not run("graph")["correct"]


def test_serve_token_altered(monkeypatch):
    from repro_torch.serving.engine import PagedModel

    decode = PagedModel.decode

    def altered(self, *a):
        out = decode(self, *a)
        out[0] = (out[0] + 1) % self.vocab
        return out

    monkeypatch.setattr(PagedModel, "decode", altered)
    assert not run("serve")["correct"]


def test_serve_step_leaves_the_cache_unchanged(monkeypatch):
    from repro_torch.models import transformer

    attend = transformer.attention_decode_paged

    def unchanged(p, cfg, x, cos, sin, k_pool, v_pool, *a, **k):
        return attend(p, cfg, x, cos, sin, k_pool.clone(), v_pool.clone(), *a, **k)

    monkeypatch.setattr(transformer, "attention_decode_paged", unchanged)
    assert not run("serve")["correct"]


def test_serve_blocks_leaked(monkeypatch):
    from repro_torch.serving.scheduler import BlockAllocator

    release = BlockAllocator.release

    def leaky(self, rid, blocks):
        release(self, rid, blocks[:-1])

    monkeypatch.setattr(BlockAllocator, "release", leaky)
    r = run("serve")
    assert not r["correct"] and r["checks"]["leaked_blocks"]["value"] > 0
