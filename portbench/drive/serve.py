"""Closed loop of ``clients`` clients against the port's paged serving
engine (``serving/engine.py`` ``ServingEngine.with_model``, driven step by
step through ``ServingEngine.step``): each client has one request
outstanding and sends the next of the mix's requests
(``lib/traffic.py``) as soon as its last one retires. EOS is off, so every
request runs to its output length.

Set-up warms a prefill at every prompt bucket the mix can send and fills
every slot; the window then runs whole engine steps. The benchmark's spans
wrap ``ServingEngine.step`` and the engine's ``PagedModel.prefill`` and
``PagedModel.decode`` (each ends in a copy to the host), by attributes of
the engine's instances: the program is not edited.

The comparison takes the longest request that retired in the window and
others drawn from the seed until ``check_tokens`` served tokens are
covered; the reference runs once over each prompt with its served tokens,
and the number compared is the widest gap by which a served token's logit
lies below the reference's best at that position. Blocks leaked by the
scheduler are compared with 0.
"""
from __future__ import annotations

import random
import time

import torch

from portbench.lib import counts
from portbench.lib import traffic as tf
from portbench.lib.harness import Check


def setup(run):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Request, ServingEngine

    m, t = run.model, run.cell.traffic
    cfg = ModelConfig(**m)
    params = run.ref.make_params(m, run.seed, run.device)
    st = run.state
    st.update(params=params, Request=Request, lengths=tf.request_lengths(t),
              prompts=tf.request_tokens(t, run.seed, m["vocab_size"]), next=0,
              submitted={}, first={}, retired={}, inflight=set(), prefilled=[],
              prompt_tokens=[], contexts=[], pages=[])
    bs = t["block_size"]
    for sb in sorted({bs * -(-p // bs) for p, _ in st["lengths"]}):
        transformer.prefill_step(params, cfg, {"tokens": torch.zeros(
            (1, sb), dtype=torch.long, device=run.device)}, max_len=sb)
    eng = ServingEngine.with_model(
        cfg, params, num_blocks=t["num_blocks"], block_size=bs, max_slots=t["slots"],
        max_blocks_per_seq=t["max_blocks_per_seq"], device=run.device, eos_id=None)
    st["engine"] = eng
    model = eng.model
    prefill, decode = model.prefill, model.decode

    def spanned_prefill(seq, block_ids):
        with run.spans("prefill"):
            token = prefill(seq, block_ids)
        st["prefilled"].append(seq.rid)
        st["prompt_tokens"].append(len(seq.req.prompt))
        return token

    def spanned_decode(tokens, positions, tables, active):
        with run.spans("decode"):
            out = decode(tokens, positions, tables, active)
        st["contexts"].append(positions[active] + 1)
        return out

    model.prefill, model.decode = spanned_prefill, spanned_decode
    for _ in range(t["clients"]):
        submit(st)
    step(run)


def submit(st):
    i = st["next"]
    st["next"] += 1
    p, o = st["lengths"][i % len(st["lengths"])]
    eng = st["engine"]
    eng.submit(st["Request"](rid=i, prompt=st["prompts"][i % len(st["prompts"])],
                             max_new_tokens=o, arrival=eng.step_count))
    st["submitted"][i] = time.perf_counter()
    st["inflight"].add(i)


def step(run):
    """One engine step, then each retired request's client sends its next."""
    st = run.state
    eng = st["engine"]
    st["prefilled"] = []
    with run.spans("step"):
        produced = eng.step()
    now = time.perf_counter()
    st["pages"].append(eng.scheduler.allocator.num_blocks - 1 - eng.scheduler.allocator.available())
    for rid in st["prefilled"]:
        st["first"][rid] = now
    done = [rid for rid in st["inflight"] if rid in eng.completed]
    for rid in done:
        st["inflight"].discard(rid)
        st["retired"][rid] = now
        submit(st)
    return produced + len(st["prefilled"])


def loop(run, seconds, keep):
    st, m = run.state, run.model
    n_pref, n_dec, n_steps = len(st["prompt_tokens"]), len(st["contexts"]), len(st["pages"])
    start = time.perf_counter()
    end = start + seconds
    steps = tokens = 0
    while time.perf_counter() < end:
        tokens += step(run)
        steps += 1
    stop = time.perf_counter()
    prompts = st["prompt_tokens"][n_pref:]
    decodes = st["contexts"][n_dec:]
    pages = st["pages"][n_steps:]
    flops = (sum(counts.projection_flops(m, p) + counts.attention_flops(m, counts.causal_pairs(p))
                 for p in prompts)
             + sum(counts.decode_flops(m, c) for c in decodes))
    return {"seconds": stop - start, "start": start, "stop": stop, "steps": steps,
            "tokens": tokens, "prefills": len(prompts), "decodes": len(decodes),
            "flops": flops, "kv_pages": sum(pages) / len(pages) if pages else None,
            "decode_bytes": sum(counts.decode_bytes(m, c) for c in decodes)}


def end_to_end(run, w):
    return {"serve_tok_s": w["tokens"] / w["seconds"]}


def release(run):
    st = run.state
    eng = st.pop("engine")
    st["leaked"] = eng.leaked_blocks()
    st["served"] = {rid: eng.completed[rid] for rid, at in st["retired"].items()
                    if run.window["start"] <= at <= run.window["stop"]}
    del eng


def _gaps(ref_logits, tokens):
    """Reference best minus the reference's logit of each token."""
    picked = ref_logits.gather(-1, tokens[:, None])[:, 0]
    return ref_logits.max(-1).values - picked


def check(run, control=None):
    """The sampled requests' served tokens in the fp32 reference; with
    ``control="fp8"`` the reference at float8 takes the program's place:
    the tokens it puts first, in the same positions, are judged instead."""
    st, m = run.state, run.model
    served = st["served"]
    V = m["vocab_size"]
    picks = []
    if served:
        picks = [max(sorted(served), key=lambda r: len(served[r]))]
        rest = sorted(set(served) - set(picks))
        random.Random(run.seed).shuffle(rest)
        while rest and sum(len(served[r]) for r in picks) < run.cell.traffic["check_tokens"]:
            picks.append(rest.pop())
    worst = 0.0
    for rid in picks:
        prompt, gen = st["prompts"][rid % len(st["prompts"])], served[rid]
        seq = torch.tensor([*prompt, *gen[:-1]], device=run.device)[None]
        ref = run.ref.forward(st["params"], m, seq)[0, len(prompt) - 1:, :V]
        if control is None:
            tokens = torch.tensor(gen, device=run.device)
        else:
            low = run.ref.forward(st["params"], m, seq, precision=control)[0, len(prompt) - 1:, :V]
            tokens = low.argmax(-1)
        worst = max(worst, float(_gaps(ref, tokens).max()))
    checks = [Check("token_gap", worst, run.limits["token_gap"]),
              Check("no_request_retired", float(not picks), 0),
              Check("leaked_blocks", st["leaked"], 0)]
    return checks, len(served), 0
