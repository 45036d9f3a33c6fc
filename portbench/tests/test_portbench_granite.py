"""granite.serve-long's parts on the CPU: its mix's lengths and pool, the
weights repeating for a seed, and a program without the granite_hybrid
family failing before a weight is drawn."""
import time

import numpy as np
import pytest
import torch

from portbench.lib import harness
from portbench.lib import manifest as mf
from portbench.lib import traffic as tf

BIG = 2**31 + 12345


def test_mix_has_mooncakes_means_and_fits_its_table():
    mix = mf.traffic("mooncake-long32")
    lengths = tf.request_lengths(mix)
    p = np.array([a for a, _ in lengths])
    o = np.array([b for _, b in lengths])
    assert abs(p.mean() - 7590) < 5 and abs(o.mean() - 182) < 2
    assert p.min() >= 2700 and p.max() <= 16384 and o.min() >= 38 and o.max() <= 512
    assert (-(-(p + o) // mix["block_size"])).max() <= mix["max_blocks_per_seq"]


def test_pool_holds_the_mix_without_preemption():
    """Four cycles of the mix's closed loop on the port's scheduler (its
    host-only ``StubModel``): the pool is the most pages held at once."""
    from repro_torch.serving.engine import Request, ServingEngine, StubModel

    mix = mf.traffic("mooncake-long32")
    lengths = tf.request_lengths(mix)
    eng = ServingEngine(StubModel(), num_blocks=mix["num_blocks"], block_size=mix["block_size"],
                        max_slots=mix["slots"], max_blocks_per_seq=mix["max_blocks_per_seq"])
    alloc, sent, live, peak = eng.scheduler.allocator, [0], set(), 0

    def submit():
        a, b = lengths[sent[0] % len(lengths)]
        eng.submit(Request(rid=sent[0], prompt=(1,) * a, max_new_tokens=b, arrival=eng.step_count))
        live.add(sent[0])
        sent[0] += 1

    for _ in range(mix["clients"]):
        submit()
    while sent[0] < 4 * mix["requests"]:
        eng.step()
        peak = max(peak, mix["num_blocks"] - 1 - alloc.available())
        for rid in [r for r in live if r in eng.completed]:
            live.discard(rid)
            submit()
    assert peak == mix["num_blocks"] - 1
    assert sum(s.preemptions for s in eng.scheduler.finished.values()) == 0


def test_weights_repeat_for_a_seed():
    ref = mf.reference("granite-4.0-h-small")
    tiny = dict(mf.load_json(mf.BENCH / "configs" / "granite-4.0-h-small.json")["model"],
                num_layers=3, layer_types=["mamba", "attention", "mamba"], d_model=32,
                num_heads=2, num_kv_heads=1, head_dim=16, d_ff=8, shared_d_ff=16,
                num_experts=4, experts_per_token=2, d_inner=64, ssm_head_dim=16, ssm_state=8,
                vocab_size=256)
    a, b = ref.make_params(tiny, BIG, "cpu"), ref.make_params(tiny, BIG, "cpu")
    flat = lambda p: [t for g in p.values() for t in (g.values() if isinstance(g, dict) else [g])]  # noqa: E731
    assert all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))
    assert not torch.equal(a["embed"], ref.make_params(tiny, BIG + 1, "cpu")["embed"])
    assert a["mamba"]["in_proj"].shape == (2, 32, 64 + 64 + 16 + 4)
    assert a["attn"]["wq"].shape == (1, 32, 32) and a["layers"]["moe_wo"].shape == (3, 4, 8, 32)


def test_a_program_without_the_family_fails_before_drawing_weights(monkeypatch):
    import repro_torch.configs.base as base

    monkeypatch.delattr(base, "GraniteHybridConfig")
    cell = mf.cell(mf.load_manifest(), "granite.serve-long")
    drawn = []
    ref = mf.reference(cell.config_name)
    monkeypatch.setattr(ref, "make_params", lambda *a: drawn.append(a))
    t0 = time.perf_counter()
    with pytest.raises(ImportError):
        harness.run_cell(cell, seed=BIG, seconds=1, trace=False, device=torch.device("cpu"), t0=t0)
    assert not drawn and time.perf_counter() - t0 < 30


TINY = {"num_layers": 3, "layer_types": ["mamba", "attention", "mamba"], "d_model": 32,
        "num_heads": 2, "num_kv_heads": 1, "head_dim": 16, "d_ff": 8, "shared_d_ff": 16,
        "num_experts": 4, "experts_per_token": 2, "d_inner": 64, "ssm_head_dim": 16,
        "ssm_state": 8, "vocab_size": 256, "dtype": "float32"}
# three clients on three slots, so that a sample of three slots covers them all
TINY_MIX = {"drive": "serve_granite", "clients": 3, "slots": 3, "block_size": 8,
            "num_blocks": 25, "max_blocks_per_seq": 8, "requests": 32, "length_seed": 0,
            "prompt_tokens": [8, 40], "output_tokens": [4, 16], "check_tokens": 20,
            "trace_seconds": 0.3}


def tiny_cell(mix=TINY_MIX):
    """The cell with its configuration's widths and its mix's sizes cut to
    a CPU test's, in fp32; limits and metrics as committed."""
    real = mf.cell(mf.load_manifest(), "granite.serve-long")
    model = dict(real.config["model"], **TINY)
    return mf.Cell("tiny.granite", 1, real.config_name, dict(real.config, model=model),
                   "tiny-granite", mix, real.end_to_end, real.per_layer)


def tiny_steps(steps, seed=BIG, mix=TINY_MIX):
    """The drive's set-up, then ``steps`` engine steps as its window (a
    count, not a time, so that a loaded CPU retires as many requests),
    then its comparison: -> ({check name: Check}, requests retired)."""
    cell = tiny_cell(mix)
    run = harness.Run(cell=cell, seed=seed, device=torch.device("cpu"),
                      ref=mf.reference(cell.config_name), drive=mf.drive("serve_granite"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny ops: threads would only contend with other test processes
    try:
        with torch.no_grad():
            run.drive.setup(run)
            start = time.perf_counter()
            for _ in range(steps):
                run.drive.SERVE.step(run)
            run.window = {"start": start, "stop": time.perf_counter()}
            run.drive.release(run)
            checks, attempted, _ = run.drive.check(run)
    finally:
        torch.set_num_threads(threads)
    return {c.name: c for c in checks}, attempted


def test_picks_cover_several_slots():
    drive = mf.drive("serve_granite")
    served = {0: [1] * 400, 1: [1] * 5, 2: [1] * 5, 3: [1] * 5, 4: [1] * 5}
    slots = {0: 0, 1: 0, 2: 0, 3: 1, 4: 2}
    chosen = drive.picks({"served": served, "slots": slots}, BIG, 300)
    assert chosen[0] == 0 and len(chosen) == drive.MIN_PICKS
    assert {slots[r] for r in chosen} == {0, 1, 2}
    assert drive.picks({"served": {}, "slots": {}}, BIG, 300) == []


def test_a_fault_at_few_positions_fails_the_share_not_the_mean():
    """One served token in 16 no better than a random one: the mean stays
    under its limit, the share of gaps above the threshold does not."""
    drive = mf.drive("serve_granite")
    cfg = mf.load_json(mf.BENCH / "configs" / "granite-4.0-h-small.json")
    run = harness.Run(cell=mf.cell(mf.load_manifest(), "granite.serve-long"), seed=BIG,
                      device=torch.device("cpu"), ref=None, drive=drive, state={"leaked": 0})
    g = torch.full((300,), 0.001)
    ok = {c.name: c.ok for c in drive.verdict(run, g, 3)}
    assert all(ok.values())
    g[::16] = 0.02  # 19 positions of 300
    ok = {c.name: c.ok for c in drive.verdict(run, g, 3)}
    assert float(g.mean()) < cfg["limits"]["token_gap_mean"]
    assert ok["token_gap_mean"] and not ok["token_gap_share"]


def test_tiny_run_is_correct():
    checks, retired = tiny_steps(60)
    assert all(c.ok for c in checks.values()), checks
    assert retired > 0 and checks["leaked_blocks"].value == 0


@pytest.mark.parametrize("seed", [BIG, BIG + 1])
def test_a_fault_confined_to_one_slot_is_not_correct(monkeypatch, seed):
    """Every token that one slot of three decodes is altered: the sample
    covers every slot, so the run is not correct."""
    from repro_torch.serving.engine import PagedModel

    decode = PagedModel.decode

    def altered(self, *a):
        out = decode(self, *a)
        out[2] = (out[2] + 1) % self.vocab
        return out

    monkeypatch.setattr(PagedModel, "decode", altered)
    checks, _ = tiny_steps(60, seed, mix=dict(TINY_MIX, output_tokens=[6, 10]))
    assert not checks["token_gap_share"].ok, checks
