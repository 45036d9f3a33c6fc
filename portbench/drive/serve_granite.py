"""Closed loop of ``clients`` clients against the port's paged serving
engine serving granite-4.0-h-small (``ServingEngine.with_model``, the
entry ``serve.py`` drives; the engine keeps KV pages for the attention
layers and a per-slot state pool for the Mamba layers). The loop, the
spans ``step``, ``prefill`` and ``decode`` and the state's keys are
``serve.py``'s, whose functions this drive calls; what differs is the
model and its counts (``lib/counts_granite.py``).

Set-up resolves the family before it draws a weight, so a program without
it fails within seconds; it warms the smallest, the middle and the
largest prompt bucket (the eager program compiles nothing, so a few
buckets warm the library calls), then fills every slot.

The comparison samples the longest request retired in the window, then
others in an order drawn from the seed, those of a slot not yet sampled
first, until at least ``MIN_PICKS`` requests and ``check_tokens`` served
tokens are covered, so that the state pool's slots are judged and not only
the longest request's. Each served token is judged by the gap between the
reference's best logit and its logit of that token, and two numbers are
compared: the mean gap over the sampled tokens, which a lower precision
moves at every token, and the share of sampled tokens whose gap exceeds
the configuration's ``token_gap_threshold``, which a fault confined to a
few positions moves where the mean dilutes it. The widest gap is not
compared: under bf16 the program's top-10 of 72 experts differ from the
fp32 reference's in most layers at every position, and the tail of that
divergence reaches single gaps as wide as the fp8 control's. The reference
runs after the engine has released its pools, one request at a time, and
returns the logits of the served positions only.
"""
from __future__ import annotations

import random
import time

import torch

from portbench.lib import counts_granite as cg
from portbench.lib import manifest as mf
from portbench.lib import traffic as tf
from portbench.lib.harness import Check

SERVE = mf.drive("serve")
MIN_PICKS = 3  # sampled requests at the least, whatever their lengths


def setup(run):
    from repro_torch.configs.base import GraniteHybridConfig
    from repro_torch.models import granite_hybrid
    from repro_torch.serving.engine import Request, ServingEngine

    m, t = run.model, run.cell.traffic
    cfg = GraniteHybridConfig(**m)
    params = run.ref.make_params(m, run.seed, run.device)
    st = run.state
    st.update(params=params, Request=Request, lengths=tf.request_lengths(t),
              prompts=tf.request_tokens(t, run.seed, m["vocab_size"]), next=0,
              submitted={}, first={}, retired={}, inflight=set(), prefilled=[],
              prompt_tokens=[], contexts=[], pages=[], slots={})
    bs = t["block_size"]
    buckets = sorted({bs * -(-p // bs) for p, _ in st["lengths"]})
    for sb in (buckets[0], buckets[len(buckets) // 2], buckets[-1]):
        granite_hybrid.prefill_step(params, cfg, {"tokens": torch.zeros(
            (1, sb), dtype=torch.long, device=run.device)})
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
        st["slots"][seq.rid] = seq.slot
        st["prompt_tokens"].append(len(seq.req.prompt))
        return token

    def spanned_decode(tokens, positions, tables, active):
        with run.spans("decode"):
            out = decode(tokens, positions, tables, active)
        st["contexts"].append(positions[active] + 1)
        return out

    model.prefill, model.decode = spanned_prefill, spanned_decode
    for _ in range(t["clients"]):
        SERVE.submit(st)
    SERVE.step(run)


def loop(run, seconds, keep):
    st, m = run.state, run.model
    n_pref, n_dec, n_steps = len(st["prompt_tokens"]), len(st["contexts"]), len(st["pages"])
    start = time.perf_counter()
    end = start + seconds
    steps = tokens = 0
    while time.perf_counter() < end:
        tokens += SERVE.step(run)
        steps += 1
    stop = time.perf_counter()
    prompts = st["prompt_tokens"][n_pref:]
    decodes = st["contexts"][n_dec:]
    pages = st["pages"][n_steps:]
    flops = (sum(cg.prefill_flops(m, p) for p in prompts)
             + sum(cg.decode_flops(m, c) for c in decodes))
    return {"seconds": stop - start, "start": start, "stop": stop, "steps": steps,
            "tokens": tokens, "prefills": len(prompts), "decodes": len(decodes),
            "flops": flops, "kv_pages": sum(pages) / len(pages) if pages else None,
            "decode_bytes": sum(cg.decode_bytes(m, c) for c in decodes)}


end_to_end = SERVE.end_to_end
release = SERVE.release


def picks(st, seed, check_tokens):
    """The requests whose served tokens are judged: the longest retired
    in the window, then the others in an order drawn from ``seed``, the
    first of each slot not yet sampled ahead of the rest, until at least
    ``MIN_PICKS`` requests and ``check_tokens`` tokens are covered."""
    served, slots = st["served"], st["slots"]
    if not served:
        return []
    chosen = [max(sorted(served), key=lambda r: len(served[r]))]
    rest = sorted(set(served) - set(chosen))
    random.Random(seed).shuffle(rest)
    seen = {slots[chosen[0]]}
    fresh = [r for r in rest if slots[r] not in seen and not seen.add(slots[r])]
    queue = fresh + [r for r in rest if r not in fresh]
    while queue and (len(chosen) < MIN_PICKS
                     or sum(len(served[r]) for r in chosen) < check_tokens):
        chosen.append(queue.pop(0))
    return chosen


def gaps(run, rid, control=None):
    """Each served token's gap in the fp32 reference's logits, on the host;
    with ``control`` the tokens that the reference in that precision puts
    first, in the same positions."""
    st, m = run.state, run.model
    V = m["vocab_size"]
    prompt, gen = st["prompts"][rid % len(st["prompts"])], st["served"][rid]
    seq = torch.tensor([*prompt, *gen[:-1]], device=run.device)[None]
    start = len(prompt) - 1
    ref = run.ref.forward(st["params"], m, seq, start=start)[0, :, :V]
    if control is None:
        tokens = torch.tensor(gen, device=run.device)
    else:
        low = run.ref.forward(st["params"], m, seq, precision=control, start=start)
        tokens = low[0, :, :V].argmax(-1)
    return SERVE._gaps(ref, tokens).float().cpu()


def verdict(run, g, n_picks):
    """The checks of the sampled tokens' gaps ``g``."""
    lim = run.limits
    mean = float(g.mean()) if len(g) else 0.0
    share = float((g > run.cell.config["token_gap_threshold"]).float().mean()) if len(g) else 0.0
    return [Check("token_gap_mean", mean, lim["token_gap_mean"]),
            Check("token_gap_share", share, lim["token_gap_share"]),
            Check("no_request_retired", float(not n_picks), 0),
            Check("leaked_blocks", run.state["leaked"], 0)]


def check(run, control=None):
    """The sampled requests' served tokens in the fp32 reference; with
    ``control="fp8"`` the reference at float8 takes the program's place:
    the tokens it puts first, in the same positions, are judged instead."""
    st = run.state
    chosen = picks(st, run.seed, run.cell.traffic["check_tokens"])
    g = torch.cat([gaps(run, rid, control) for rid in chosen]) if chosen else torch.zeros(0)
    return verdict(run, g, len(chosen)), len(st["served"]), 0
