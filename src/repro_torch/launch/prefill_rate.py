"""Prefill token rate of GPT-J (port of ``benchmarks/bench_gptj.py``, the
paper's Fig. 12): non-autoregressive (= prefill) forward of a cut
occamy-gptj at sequence lengths 128-1024, attention through the FA-2
kernel on the card.

    PYTHONPATH=src python -m repro_torch.launch.prefill_rate [--device cpu] [--json PATH]

The config is the reference's cut (occamy-gptj REDUCED with 4 layers,
d_model 256, 4 heads of 64, d_ff 1024, vocab 8192; fp32), the rows its
names (``fig12_gptj_prefill_s{S}``); the weights are the port's seeded
draw and the tokens a numpy ``Generator`` of seed 0.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.bench_rows import Rows, timeit
from repro_torch.models import registry

CFG = get_config("occamy-gptj", reduced=True).replace(
    num_layers=4, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
    d_ff=1024, vocab_size=8192,
)
SEQS = (128, 256, 512, 1024)


@torch.no_grad()
def run(rows: Rows, *, device=None, seqs=SEQS):
    device = resolve_device(device)
    params = registry.init_params(CFG, seed=0, device=device)
    rng = np.random.default_rng(0)

    def fwd(batch):
        return registry.forward(params, CFG, batch)[0]

    for seq in seqs:
        tokens = torch.from_numpy(
            rng.integers(0, CFG.vocab_size, (1, seq)).astype(np.int32)).to(device)
        t = timeit(fwd, {"tokens": tokens}, device=device)
        rows.row(f"fig12_gptj_prefill_s{seq}", t, f"{seq / t:.1f} tok/s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = Rows(device)
    run(rows, device=device)
    if args.json:
        rows.emit_json(args.json)


if __name__ == "__main__":
    main()
