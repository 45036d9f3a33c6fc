"""Roofline terms at the card's constants (port of
``repro.launch.roofline``).

  compute    = FLOPs per device / PEAK_FLOPS (or a policy's peak)
  memory     = bytes per device / HBM_BW
  collective = collective bytes per device / LINK_BW
  d2d        = a partition plan's collectives priced per mesh level by
               ``topology.collective_seconds`` (the Fig. 13 D2D term)

``PEAK_FLOPS``, ``HBM_BW`` and ``LINK_BW`` are ``core.topology``'s (one
home for the card's constants): the bf16 tensor-core peak, HBM3 and one
NVLink direction. The d2d term is analytic, from the port's partition
plans (``hopper/partition.py``), so a plan prices from shapes alone, on a
``DeviceMesh`` or a device-free ``MeshSpec``.

Left out: the reference's ``collective_bytes`` and its ``_DTYPE_BYTES``
table, which parse XLA's post-SPMD HLO text; the port compiles no HLO, so
there is nothing for them to read.
"""
from __future__ import annotations

from repro_torch.core import topology

PEAK_FLOPS = topology.PEAK_FLOPS_BF16
HBM_BW = topology.HBM_BW
LINK_BW = topology.NVLINK_BW


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   d2d_s: float = 0.0,
                   peak_flops: float | None = None) -> dict:
    """The roofline time terms. ``d2d_s`` (a plan's collective time from
    ``op_collective_seconds`` / ``plan_collective_seconds``) joins the
    dominance comparison, so a D2D-bound sharded op reports as such.
    ``peak_flops`` replaces the bf16 peak: pass
    ``core.precision.peak_flops(policy)`` to price a cell at the rate its
    compute dtype runs at."""
    t_comp = flops / (peak_flops or PEAK_FLOPS)
    t_mem = hbm_bytes / HBM_BW
    t_coll = coll_bytes / LINK_BW
    terms = {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll}
    if d2d_s:
        terms["d2d_s"] = d2d_s
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms["dominant"] = dom
    terms["roofline_fraction"] = t_comp / bound if bound > 0 else 0.0
    return terms


def bound_ms(flops: float, nbytes: float, peak_flops: float | None = None) -> tuple:
    """The least time one device could take for a call, ``(ms, by)``: the
    larger of ``roofline_terms``' compute and memory terms, in ms, and
    ``"operations"`` or ``"bytes"`` for the term that bounds it."""
    terms = roofline_terms(flops, nbytes, 0.0, peak_flops=peak_flops)
    by = "operations" if terms["compute_s"] >= terms["memory_s"] else "bytes"
    return max(terms["compute_s"], terms["memory_s"]) * 1e3, by


def overlapped_seconds(compute_s: float, d2d_s: float, hops: int) -> float:
    """Pipeline time of an overlappable plan: ``hops`` compute stages with
    the ``hops - 1`` transfers double-buffered behind them.

        u = compute_s / hops            (per-stage compute)
        v = d2d_s / (hops - 1)          (per-stage transfer)
        total = u + (hops - 1) * max(u, v)

    Never more than ``compute_s + d2d_s``, and less whenever both terms are
    positive and ``hops > 1``; a compute-bound plan pays no D2D at all.
    The serial sum for ``hops <= 1`` or no transfer."""
    if hops <= 1 or d2d_s <= 0:
        return compute_s + max(d2d_s, 0.0)
    u = compute_s / hops
    v = d2d_s / (hops - 1)
    return u + (hops - 1) * max(u, v)


def overlapped_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                     d2d_s: float, hops: int,
                     peak_flops: float | None = None) -> dict:
    """``roofline_terms`` under the overlapped schedule: the stage time is
    ``max(compute_s, memory_s)``, pipelined over ``hops`` stages against
    ``d2d_s`` of transfer, and only the exposed remainder of the transfer
    joins the dominance comparison (dropped when compute hides it all).
    Adds ``serial_s``, ``overlapped_s`` and ``d2d_exposed_s``."""
    t_comp = flops / (peak_flops or PEAK_FLOPS)
    t_mem = hbm_bytes / HBM_BW
    base = max(t_comp, t_mem)
    total = overlapped_seconds(base, d2d_s, hops)
    exposed = max(total - base, 0.0)
    terms = roofline_terms(flops, hbm_bytes, coll_bytes, d2d_s=exposed,
                           peak_flops=peak_flops)
    terms["serial_s"] = base + d2d_s
    terms["overlapped_s"] = total
    terms["d2d_exposed_s"] = exposed
    return terms


def plan_collective_seconds_by_level(plan) -> dict:
    """One partition plan's collectives priced per mesh level,
    ``{axis: seconds}``: each at its level's link rate and participant
    count (``CollectiveCost.n``; 0 falls back to the plan's shard count).
    Empty for replication (``None``)."""
    if plan is None:
        return {}
    out: dict[str, float] = {}
    for c in plan.collectives:
        n = c.n or plan.n
        out[c.axis] = out.get(c.axis, 0.0) + topology.collective_seconds(
            c.kind, c.nbytes, c.axis, n
        )
    return out


def plan_collective_seconds(plan) -> float:
    """A plan's collective time: its per-level prices summed (the single
    ``d2d_s`` roofline term)."""
    return sum(plan_collective_seconds_by_level(plan).values())


def op_collective_seconds(op: str, mesh, *args, **kwargs) -> float:
    """The D2D term of one op call: ``op``'s PartitionRule resolved against
    ``mesh`` (a ``DeviceMesh`` or a ``MeshSpec``) and priced; 0.0 when the
    call replicates."""
    from repro_torch.hopper import partition

    return plan_collective_seconds(partition.plan_for(op, mesh, *args, **kwargs))


def min_bytes_per_device(cfg, shape, n_dev: int, tp: int = 16) -> float:
    """Analytic lower bound on HBM traffic per device per step, the floor
    the memory term is judged against.

    train:   params read twice (forward + remat backward) + gradient write
             (bf16) + optimizer m/v read and write (fp32) + parameter
             write + saved layer activations (write + read) + logits.
    prefill: params read once (TP-sharded) + activations + logits.
    decode:  params read once + the KV / state cache read.
    """
    p = cfg.num_params()
    bf2 = 2
    B, S = shape.global_batch, shape.seq_len
    d, L_ = cfg.d_model, cfg.num_layers
    if shape.kind == "train":
        param_traffic = p * (2 * bf2 + 2 * bf2 + bf2 + bf2) + p * 4 * 4
        acts = 2 * L_ * B * S * d * bf2
        logits = 2 * B * S * cfg.vocab_size * bf2
        return (param_traffic + acts + logits) / n_dev
    tp_eff = n_dev if cfg.weights_2d_tp else tp
    if shape.kind == "prefill":
        acts = L_ * B * S * d * bf2
        logits = B * S * cfg.vocab_size * bf2
        return p * bf2 / tp_eff + (acts + logits) / n_dev
    hd = cfg.resolved_head_dim()
    cache = 2 * L_ * B * cfg.num_kv_heads * S * hd * bf2 if not cfg.attention_free else 0
    if cfg.family in ("ssm", "hybrid"):
        nh = (cfg.resolved_d_inner() // max(cfg.ssm_head_dim, 1) if cfg.family == "hybrid"
              else cfg.d_model // hd)
        cache += L_ * B * nh * cfg.ssm_state * max(cfg.ssm_head_dim, hd) * 4
        if cfg.family == "hybrid":
            cache += 2 * L_ * B * cfg.num_kv_heads * S * hd * bf2
    return p * bf2 / tp_eff + cache / n_dev


def model_flops(cfg, shape) -> float:
    """6 N D (train) or 2 N D (inference), N the active parameters."""
    n = cfg.num_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
