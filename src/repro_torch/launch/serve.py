"""Batched greedy generation (port of ``repro.launch.serve``): prefill a
batch of prompts, then decode from the contiguous cache.

The transformer families (dense, moe, vlm) prefill the prompt in one pass
(``transformer.prefill_step``, attention through the FA kernel; the vlm's
patch embeddings ``extra_batch["patches"]`` go first, so decoding starts
at ``S0 + num_patches``) and decode through ``registry.decode_step`` at
positions ``S0 + i``; the recurrent families (ssm, hybrid) and the audio
family feed the prompt through ``registry.decode_step`` token by token,
the audio family after ``multimodal.build_cross_cache`` has run the
encoder once over ``extra_batch["frames"]``. On the card (full width,
random weights from seed 0):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch occamy-gptj

``--reduced`` takes the family's REDUCED config; ``--device cpu`` runs on
the CPU (the default is ``cuda``, which raises without a card).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.models import multimodal, registry, transformer

ONE_PASS = ("dense", "moe", "vlm")  # prefilled by transformer.prefill_step
RECURRENT = ("ssm", "hybrid", "audio")  # prompt fed through decode_step


def _check_family(cfg, families=RECURRENT):
    if cfg.family not in families:
        raise NotImplementedError(
            f"this runs the families {families}, got {cfg.family!r}"
        )


def _positions(B, t, device):
    return torch.full((B,), t, dtype=torch.int32, device=device)


@torch.no_grad()
def scan_prefill(params, cfg, cache, tokens):
    """Prompt prefill for the recurrent-cache families (ssm, hybrid,
    audio): ``registry.decode_step`` over the prompt, one token at a time.
    tokens (B, S0). Returns (last-token logits (B, V_pad) fp32, cache after
    the full prompt)."""
    _check_family(cfg)
    B, S0 = tokens.shape
    logits = None
    for t in range(S0):
        logits, cache = registry.decode_step(
            params, cfg, cache, {"token": tokens[:, t], "position": _positions(B, t, tokens.device)})
    return logits, cache


@torch.no_grad()
def generate(cfg, params, tokens, gen_len: int, max_len: int,
             extra_batch: dict | None = None):
    """tokens (B, S0) prompt on the params' device; returns (B, S0 + gen_len),
    greedy. ``max_len`` sizes the cache (at least S0 + gen_len - 1, plus
    num_patches for the vlm). ``extra_batch`` carries the vlm's
    ``patches`` (B, num_patches, d) or the audio family's ``frames``
    (B, encoder_seq, d)."""
    _check_family(cfg, ONE_PASS + RECURRENT)
    B, S0 = tokens.shape
    if cfg.family in ONE_PASS:
        batch = {"tokens": tokens}
        if cfg.family == "vlm" and extra_batch:
            batch["patches"] = extra_batch["patches"]
        logits, cache = transformer.prefill_step(params, cfg, batch, max_len)
        logits = logits[:, -1]
        pos0 = S0 + (cfg.num_patches if cfg.family == "vlm" else 0)
    else:
        cache = registry.init_cache(cfg, B, max_len, device=tokens.device)
        if cfg.family == "audio" and extra_batch:
            cache["cross_k"], cache["cross_v"] = multimodal.build_cross_cache(
                params, cfg, extra_batch["frames"])
        logits, cache = scan_prefill(params, cfg, cache, tokens)
        pos0 = S0
    last = logits[:, : cfg.vocab_size].argmax(-1)
    out = [last]
    for i in range(gen_len - 1):
        logits, cache = registry.decode_step(
            params, cfg, cache, {"token": last, "position": _positions(B, pos0 + i, tokens.device)})
        last = logits[:, : cfg.vocab_size].argmax(-1)
        out.append(last)
    return torch.cat([tokens, torch.stack(out, 1).to(tokens.dtype)], dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="occamy-gptj")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    device = resolve_device(args.device)
    params = registry.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))).to(device)
    extra, dtype = None, getattr(torch, cfg.dtype)
    if cfg.family == "vlm":
        extra = {"patches": torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.num_patches, cfg.d_model)).astype(np.float32)).to(device, dtype)}
    if cfg.family == "audio":
        extra = {"frames": torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).to(device, dtype)}
    max_len = args.prompt_len + args.gen + (cfg.num_patches or 0) + 1
    t0 = time.perf_counter()
    out = generate(cfg, params, tokens, args.gen, max_len, extra)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    how = "prefilled in one pass" if cfg.family in ONE_PASS else "fed token by token"
    print(f"{cfg.name} on {where}: generated {tuple(out.shape)} in {dt:.2f} s = "
          f"{args.batch * args.gen / dt:.1f} new tok/s (prompt {how})")
    print("sample:", out[0, -args.gen:].tolist())


if __name__ == "__main__":
    main()
