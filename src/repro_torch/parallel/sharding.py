"""Divisibility-aware sharding rules (port of ``repro.parallel.sharding``).

The reference maps a model's logical intent (``constrain(x, "residual")``)
to a ``PartitionSpec`` for whatever mesh is active, and lowers the whole
step through GSPMD. The port keeps the rules, spec for spec, and runs
them single-controller over a ``parallel.mesh.DeviceMesh``:

  - ``param_specs`` / ``batch_specs`` / ``cache_specs`` give each leaf its
    ``hopper.partition.PartitionSpec``; every rule checks divisibility and
    degrades to replication instead of failing (20/25 heads, vocab 51866).
  - ``named(mesh, specs)`` pairs each spec with its mesh
    (``NamedSharding``, whose ``shard_shape`` is the reference's), and
    ``place_`` / ``gather_`` move a state tree to per-rank parts
    (``Placed``: one allocation a rank, ``DeviceMesh.shard_spec``) and
    back: the counterpart of ``jax.device_put(x, NamedSharding)``.
  - ``activation_sharding(specs)`` makes ``specs`` (from
    ``default_activation_specs``) the active dict: ``current_mesh()``
    returns its ``__mesh__``, which turns on the model's explicit regions
    (``moe_mlp``'s per-data-rank dispatch, ``ssm._shift``'s halo).
    ``constrain(x, kind)`` returns ``x``: ``with_sharding_constraint`` is
    a layout hint with no effect on values, and between the explicit
    regions the port holds global tensors.
  - ``use_mesh(mesh)`` adds only the kernel key to the active dict, so
    every ``ops.*`` call inside partitions over ``mesh``
    (``hopper/partition.py``) and ``current_mesh()`` stays as it was.

The helpers take any object with ``.shape`` (``{axis: size}``) and
``.axis_names``: a ``DeviceMesh``, or a shape-only stand-in.
"""
from __future__ import annotations

import dataclasses
import math
from contextlib import contextmanager

from repro_torch.hopper.partition import PartitionSpec

# ---------------------------------------------------------------------------
# activation-sharding intent hooks (used inside model code)
# ---------------------------------------------------------------------------

_ACTIVE: dict | None = None


def P(*entries) -> PartitionSpec:
    """A ``PartitionSpec`` with one-axis tuples written as the axis name,
    as ``jax.sharding.PartitionSpec`` normalises them."""
    return PartitionSpec(*(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                           for e in entries))


def constrain(x, kind: str):
    """``x`` itself: the layout hint ``kind`` of the active dict has no
    effect on values (the reference skips a spec longer than ``x``'s
    rank). Under the dry run's count (``launch.step_count``, an active
    ``__count__``) the hint seeds ``x``'s split."""
    counter = _ACTIVE.get("__count__") if _ACTIVE else None
    if counter is not None:
        counter.constrain(x, _ACTIVE.get(kind))
    return x


def current_mesh():
    """The mesh the model runs for (``None`` outside
    ``activation_sharding``)."""
    if _ACTIVE is None:
        return None
    return _ACTIVE.get("__mesh__")


@contextmanager
def activation_sharding(specs: dict):
    """Make ``specs`` the whole active dict (an outer ``use_mesh``'s kernel
    mesh is gone inside); the previous dict comes back on exit."""
    global _ACTIVE
    old, _ACTIVE = _ACTIVE, specs
    try:
        yield
    finally:
        _ACTIVE = old


@contextmanager
def use_mesh(mesh):
    """Partition every ``ops.*`` call inside over ``mesh``: a copy of the
    active dict with only the kernel key added, so ``current_mesh()``
    (which re-routes model internals) stays as it was."""
    specs = dict(_ACTIVE or {})
    specs["__kernel_mesh__"] = mesh
    with activation_sharding(specs):
        yield mesh


def kernel_mesh():
    """The mesh ``ops.*`` partitions over (``None`` outside ``use_mesh``)."""
    if _ACTIVE is None:
        return None
    return _ACTIVE.get("__kernel_mesh__")


def default_activation_specs(cfg, mesh, kind: str) -> dict:
    """Residual stream sequence-sharded over ``model`` (Megatron-SP style)
    when training with ``seq_shard_activations``; logits vocab-sharded over
    ``model``; the MoE buffers batch over the data axes, expert hidden over
    ``model``; with ``explicit_attn_sharding``, q heads over ``model``
    where they divide (else q's sequence) and k/v heads where they divide
    (else replicated). ``__mesh__`` is ``mesh``."""
    dp = dp_axes(mesh)
    specs = {}
    if kind == "train" and cfg.seq_shard_activations:
        specs["residual"] = NamedSharding(mesh, P(dp, "model", None))
    else:
        specs["residual"] = NamedSharding(mesh, P(dp, None, None))
    specs["logits"] = NamedSharding(mesh, P(dp, None, "model"))
    specs["moe_dispatch"] = NamedSharding(mesh, P(dp, None, None, None))
    specs["moe_tokens"] = NamedSharding(mesh, P(dp, None, None))
    specs["moe_hidden"] = NamedSharding(mesh, P(dp, None, None, "model"))
    if getattr(cfg, "explicit_attn_sharding", False):
        tp_n = axis_size(mesh, "model")
        q_ok = cfg.num_heads % tp_n == 0
        kv_ok = cfg.num_kv_heads % tp_n == 0
        specs["attn_q"] = NamedSharding(
            mesh, P(dp, None, "model", None) if q_ok else P(dp, "model", None, None))
        specs["attn_kv"] = NamedSharding(
            mesh, P(dp, None, "model", None) if kv_ok else P(dp, None, None, None))
    specs["__mesh__"] = mesh
    return specs


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------


def dp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(math.prod(mesh.shape[a] for a in axes))


def _fits(dim: int, axes, mesh) -> bool:
    return dim % axis_size(mesh, axes) == 0


def pick(mesh, dim: int, *candidates):
    """First candidate axis (or axis tuple) that divides ``dim``, else None."""
    for c in candidates:
        if c is not None and _fits(dim, c, mesh):
            return c
    return None


# ---------------------------------------------------------------------------
# parameter sharding rules
# ---------------------------------------------------------------------------

# leaf name -> logical role of each trailing dim; leading stacked-layer dims
# are detected by rank and stay unsharded. Roles: "d_in"/"d_out" (the
# embedding dim), "heads_q"/"heads_kv" (H*hd or K*hd flat), "ff", "vocab",
# "expert", "rwkv_heads", "ssm_inner", "ssm_heads", "none".
_PARAM_ROLES = {
    "embed": ("vocab", "d_out"),
    "lm_head": ("d_in", "vocab"),
    "wq": ("d_in", "heads_q"),
    "wk": ("d_in", "heads_kv"),
    "wv": ("d_in", "heads_kv"),
    "wo": ("heads_q", "d_out"),
    "bq": ("heads_q",),
    "bk": ("heads_kv",),
    "bv": ("heads_kv",),
    "wi": ("d_in", "ff"),
    "wg": ("d_in", "ff"),
    "wo_mlp": ("ff", "d_out"),
    # whisper cross-attention
    "cwq": ("d_in", "heads_q"),
    "cwk": ("d_in", "heads_kv"),
    "cwv": ("d_in", "heads_kv"),
    "cwo": ("heads_q", "d_out"),
    "cbq": ("heads_q",),
    "cbk": ("heads_kv",),
    "cbv": ("heads_kv",),
    "frontend_proj": ("d_in", "d_out"),
    "router": ("d_in", "none"),
    "moe_wi": ("expert", "d_in", "ff"),
    "moe_wg": ("expert", "d_in", "ff"),
    "moe_wo": ("expert", "ff", "d_out"),
    # rwkv6 time-mix / channel-mix
    "wr_t": ("d_in", "rwkv_heads"),
    "wk_t": ("d_in", "rwkv_heads"),
    "wv_t": ("d_in", "rwkv_heads"),
    "wg_t": ("d_in", "rwkv_heads"),
    "wo_t": ("rwkv_heads", "d_out"),
    "w_lora_a": ("d_in", "none"),
    "w_lora_b": ("none", "rwkv_heads"),
    "wk_c": ("d_in", "ff"),
    "wv_c": ("ff", "d_out"),
    "wr_c": ("d_in", "d_out"),
    # hybrid (mamba/SSD path)
    "ssm_in": ("d_in", "ssm_inner"),
    "ssm_out": ("ssm_inner", "d_out"),
    "ssm_bc": ("d_in", "none"),
    "ssm_dt": ("d_in", "ssm_heads"),
}


def _role_spec(role: str, dim: int, cfg, mesh, mode: str):
    """One logical role -> a mesh axis (or axis tuple, or None)."""
    tp = "model"
    dp = dp_axes(mesh)
    hd = cfg.resolved_head_dim()
    fsdp_ok = (mode == "train" and cfg.fsdp) or (mode == "serve" and cfg.weights_2d_tp)
    fsdp = dp if fsdp_ok else None

    if role == "none":
        return None
    if role == "vocab":
        return pick(mesh, dim, tp)
    if role in ("d_in", "d_out"):
        return pick(mesh, dim, fsdp)
    if role == "ff":
        return pick(mesh, dim, tp)
    if role == "expert":
        return None  # experts TP'd on ff; the EP variant: collectives.ep_expert_ffn
    if role in ("heads_q", "heads_kv"):
        nh = dim // hd
        return tp if nh % axis_size(mesh, tp) == 0 else pick(mesh, dim, fsdp)
    if role == "rwkv_heads":
        nh = dim // max(cfg.resolved_head_dim(), 1)
        return tp if nh % axis_size(mesh, tp) == 0 else pick(mesh, dim, fsdp)
    if role == "ssm_inner":
        nh = dim // max(cfg.ssm_head_dim, 1)
        return tp if nh % axis_size(mesh, tp) == 0 else pick(mesh, dim, fsdp)
    if role == "ssm_heads":
        return pick(mesh, dim, tp)
    raise ValueError(role)


def _map_with_name(fn, tree, name=""):
    """``fn(leaf name, leaf)`` over a tree of dicts; a leaf's name is its
    last dict key (the reference's ``_leaf_name``)."""
    if isinstance(tree, dict):
        return {k: _map_with_name(fn, v, str(k)) for k, v in tree.items()}
    return fn(name, tree)


def _dedupe(axes):
    """A mesh axis may appear only once per spec: later uses become None."""
    seen: set = set()
    final = []
    for a in axes:
        names = (a,) if isinstance(a, str) else tuple(a or ())
        if any(n in seen for n in names):
            final.append(None)
        else:
            seen.update(names)
            final.append(a)
    return P(*final)


def param_specs(cfg, params_tree, mesh, mode: str = "train"):
    """A tree of ``PartitionSpec`` matching ``params_tree`` (tensors, meta
    tensors or anything with ``.shape``)."""

    def one(name, leaf):
        shape = tuple(leaf.shape)
        roles = _PARAM_ROLES.get(name)
        if roles is None:
            return P()  # norms, scalars, unknown leaves: replicate
        lead = len(shape) - len(roles)
        return _dedupe([None] * lead + [_role_spec(r, shape[lead + i], cfg, mesh, mode)
                                        for i, r in enumerate(roles)])

    return _map_with_name(one, params_tree)


def param_shardings(cfg, params_tree, mesh, mode: str = "train"):
    return named(mesh, param_specs(cfg, params_tree, mesh, mode))


# ---------------------------------------------------------------------------
# batch / cache sharding
# ---------------------------------------------------------------------------


def batch_specs(cfg, batch_tree, mesh):
    """The leading batch dim over the data axes where it divides (else the
    innermost data axis, else replicated)."""
    dp = dp_axes(mesh)

    def one(_, leaf):
        if not tuple(leaf.shape):
            return P()
        axes = pick(mesh, leaf.shape[0], dp, dp[-1:])
        return P(*([axes] + [None] * (len(leaf.shape) - 1)))

    return _map_with_name(one, batch_tree)


def cache_specs(cfg, cache_tree, mesh):
    """KV caches (L, B, K, S, hd): B over the data axes where it divides
    and S over ``model`` (flash-decode style), else S over (data, model),
    ``model`` or data; SSM states (L, B, H, N, M): B over data, H over
    ``model``; other (L, B, ...) states: B over data."""
    dp = dp_axes(mesh)
    tp = "model"

    def one(name, leaf):
        shape = tuple(leaf.shape)
        if name in ("k", "v", "cross_k", "cross_v") and len(shape) == 5:
            _, B, _, S, _ = shape
            b_ax = pick(mesh, B, dp, dp[-1:])
            if b_ax is None:
                s_ax = pick(mesh, S, (dp[-1], tp), tp, dp[-1:])
            else:
                s_ax = pick(mesh, S, tp)
            return P(None, b_ax, None, s_ax, None)
        if name == "ssm_state" and len(shape) == 5:
            _, B, H, _, _ = shape
            return P(None, pick(mesh, B, dp, dp[-1:]), pick(mesh, H, tp), None, None)
        if len(shape) >= 2:  # token-shift states etc.: (L, B, ...)
            b_ax = pick(mesh, shape[1], dp, dp[-1:])
            return P(*([None, b_ax] + [None] * (len(shape) - 2)))
        return P()

    return _map_with_name(one, cache_tree)


# ---------------------------------------------------------------------------
# placement: a spec on a mesh, and per-rank parts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: PartitionSpec

    def shard_shape(self, shape) -> tuple:
        """The shape of one rank's part of a ``shape`` leaf; raises where a
        dim does not split, as the reference's does."""
        out = list(shape)
        for dim, entry in enumerate(self.spec):
            n = axis_size(self.mesh, entry)
            if out[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not split over "
                                 f"{n} ranks ({entry!r})")
            out[dim] //= n
        return tuple(out)


def named(mesh, spec_tree):
    """Each spec of ``spec_tree`` as a ``NamedSharding`` on ``mesh``."""
    return _map_with_name(lambda _, s: NamedSharding(mesh, s), spec_tree)


class Placed:
    """One leaf placed on a ``DeviceMesh``: ``parts[r]`` is rank ``r``'s
    part under ``sharding.spec``, its own allocation on rank ``r``'s device
    (replicas too: every rank holds one, as ``device_put`` places them)."""

    __slots__ = ("parts", "sharding", "shape", "dtype")

    def __init__(self, parts, sharding, shape):
        self.parts, self.sharding = list(parts), sharding
        self.shape, self.dtype = tuple(shape), parts[0].dtype

    @classmethod
    def of(cls, x, sharding):
        return cls(sharding.mesh.shard_spec(x, sharding.spec), sharding, x.shape)

    @property
    def owners(self) -> list:
        """The ranks that hold each distinct part once: index 0 on every
        axis the spec leaves out."""
        mesh = self.sharding.mesh
        used = {a for e in self.sharding.spec for a in mesh._entry(e)}
        return [r for r in range(mesh.n)
                if all(i == 0 for a, i in mesh.coords(r).items() if a not in used)]

    def gather(self, device=None):
        """The global tensor on the caller's stream (``gather_spec``)."""
        return self.sharding.mesh.gather_spec(self.parts, self.sharding.spec, device)

    def __repr__(self):
        return (f"Placed({self.dtype}{list(self.shape)}, spec={tuple(self.sharding.spec)}, "
                f"part={list(self.parts[0].shape)})")


def place_(tree: dict, shardings: dict) -> dict:
    """Replace every tensor leaf of the dict tree ``tree`` by its ``Placed``
    parts under the matching ``NamedSharding`` of ``shardings``, in place
    and one leaf at a time (the global tensor is freed as its parts are
    made, unless the caller holds it). Returns ``tree``."""
    for k in list(tree):
        if isinstance(tree[k], dict):
            place_(tree[k], shardings[k])
        else:
            tree[k] = Placed.of(tree[k], shardings[k])
    return tree


def gather_(tree: dict, device=None) -> dict:
    """The inverse of ``place_``: every ``Placed`` leaf replaced by its
    global tensor, in place, one leaf at a time. Returns ``tree``."""
    for k in list(tree):
        if isinstance(tree[k], dict):
            gather_(tree[k], device)
        elif isinstance(tree[k], Placed):
            tree[k] = tree[k].gather(device)
    return tree


def gap(x, want) -> float:
    """How far ``x`` (a ``Placed`` leaf, or a tensor) lies from the global
    tensor ``want`` (on any device): every rank's part, replicas included,
    against the slab of ``want`` that its spec gives that rank, as
    ``sqrt(sum_r |x_r - want_r|^2 / sum_r |want_r|^2)`` (Frobenius norms in
    fp32 on each part's device; the absolute gap where ``want`` is all
    zero). A tensor is one part."""
    import torch

    if isinstance(x, Placed):
        mesh, spec = x.sharding.mesh, x.sharding.spec
        pairs = [(mesh.collect(p, r, p.device), mesh.local(want, spec, r))
                 for r, p in enumerate(x.parts)]
    else:
        pairs = [(x, want)]
    num = den = 0.0
    for a, b in pairs:
        b = b.to(a.device).float()
        num += float(torch.linalg.vector_norm(a.float() - b)) ** 2
        den += float(torch.linalg.vector_norm(b)) ** 2
    return math.sqrt(num / den if den else num)
