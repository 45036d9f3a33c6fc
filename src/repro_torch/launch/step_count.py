"""A shape-only count of one step, per device, on a mesh: the port's
counterpart of the XLA-compiling half of ``repro.launch.dryrun``
(``_build_and_lower`` and what ``lower_cell`` reads from the compiled
module: ``memory_analysis()``, ``cost_analysis()`` and the collectives of
the HLO text).

The reference lowers each cell through GSPMD and reads XLA's analyses.
The port compiles nothing, so it runs the step itself, at the cell's
global shapes, on the ``meta`` device, through its own entry points
(``registry.param_shapes`` / ``input_specs`` / ``cache_spec``,
``train_loop.train_state_struct`` / ``make_train_step`` /
``make_prefill_step`` / ``make_decode_step``, remat and microbatches as
the config sets them), under ``StepCount``, a ``TorchDispatchMode`` that
sees every aten op of the forward, the remat recomputation and the
autograd backward:

- **Seeds.** Every tensor carries the mesh axes each of its dims is split
  over. Parameters, optimizer moments, the batch and the caches take their
  leaf's spec (``sharding.param_specs`` / ``batch_specs`` /
  ``cache_specs``); an activation takes its kind's spec at each
  ``sharding.constrain(x, kind)`` call site, which hands the tensor to the
  counter (``default_activation_specs``, without ``__mesh__``: the
  model's explicit per-rank regions are the same work as the global ops
  they split).
- **Propagation.** Each op's operands agree on one split per dim label
  (the largest operand's split first, an axis used once); an operand whose
  split disagrees is all-gathered over the axes it loses (an FSDP weight
  split on ``d_in`` meeting a batch split over the same data axes; a
  sequence-split activation meeting a head-split weight), and one whose
  dims the op splits further is sliced locally, for free. A contraction or
  a sum over a split dim leaves partial sums on its axes, which the next
  consumer settles as a reduce-scatter (where it splits a dim over that
  axis) or an all-reduce, at the byte width of the op that made them;
  views, casts, adds of partial sums and products with one partial factor
  carry them on. Under ``train`` each parameter gradient is settled
  against its parameter's spec (``make_train_step(grads_hook=)``).
- **Per-device FLOPs and bytes.** An op's global FLOPs (``2 M K N`` for
  the aten matmul family, as ``torch.utils.flop_counter`` counts them; one
  per element for elementwise arithmetic and reductions, as XLA counts
  them; transcendentals apart, as XLA keeps them) divided by the splits of
  its iteration space: its output's and its contracted dims'. Bytes are
  each non-view op's operands (stride-0 dims once) and results at their
  local shapes: the eager program reads and writes every one of them.
- **Kernel ops** (``flash_attention``, ``decode_attention``,
  ``linear_attention`` and the rest) are counted at the one seam every op
  passes, ``hopper.dispatch.kernel_call``, by formula at their operands'
  local shapes (``kernel_formula``), and not run: a ``meta`` result of the
  right shape comes back. Under grad they sit in an autograd Function: the
  flash-attention backward runs the port's own plain FA-2 backward
  (``hopper.grads.flash_attention_bwd``) under the counter, op by op; the
  scan's, the plain chunked form recomputed and differentiated, by
  formula.
- **Memory.** ``argument_size_in_bytes`` is exact, the shard shapes of the
  arguments (``NamedSharding.shard_shape``); the train state is donated
  (AdamW updates it in place), so it aliases its output, as the decode
  cache does. ``temp_size_in_bytes`` is the peak of live local bytes the
  step allocates (and the gathers it holds for one op), less what survives
  it as output. ``total_per_device`` is the reference's sum.

No extrapolation is needed: a ``meta`` run costs per op, not per byte, so
a full-depth cell counts in seconds, and the reference's ``_cost_point``,
``_layer_extrapolate`` and ``_costs_chunked_seq`` (small unrolled lowers
fitted to depth and sequence length, because XLA counts a loop body once)
have no counterpart. Dividing a global count by the device count would
hide the work that every rank repeats (a norm over a residual that is not
split over ``model``), which is what ``useful_flops_ratio`` shows; this
count keeps it.

Importing this module touches no device.
"""
from __future__ import annotations

import contextlib
import math
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")
# bytes moved per byte of the buffer (roofline.collective_bytes' factors):
# a ring all-reduce moves the buffer twice, the others once
_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
           "all-to-all": 1.0, "collective-permute": 1.0}

# elementwise work of the online softmax per (q, k) score the attention
# forms compute (mask select, running max, subtract, masked select, row sum)
ATTN_SCORE_FLOPS = 5
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "mv", "addmv"}
_VIEWS = {"view", "_unsafe_view", "reshape", "_reshape_alias", "alias", "detach",
          "lift_fresh", "expand", "t", "transpose", "permute", "unsqueeze",
          "squeeze", "select", "slice", "split", "split_with_sizes", "unbind",
          "chunk", "narrow", "as_strided", "view_as", "expand_as", "movedim",
          "unflatten", "flatten", "_unsafe_split", "diagonal", "alias_copy"}
_FACTORIES = {"empty", "zeros", "ones", "full", "arange", "linspace", "scalar_tensor",
              "empty_strided", "new_zeros", "new_empty", "new_ones", "new_full",
              "new_empty_strided", "eye", "randn", "rand", "randint", "tensor"}
_LIKE = {"zeros_like", "empty_like", "ones_like", "full_like", "rand_like", "randn_like"}
_COPIES = {"clone", "_to_copy", "contiguous", "to", "_copy", "lift_fresh_copy"}
# no arithmetic: data movement, comparisons of masks, selects of indices
_ZERO_FLOP = {"copy_", "fill_", "zero_", "constant_pad_nd", "repeat", "flip", "roll",
              "where", "masked_fill", "masked_fill_", "index_select", "bitwise_and",
              "bitwise_or", "bitwise_not", "logical_and", "logical_or", "logical_not",
              "lt", "le", "gt", "ge", "eq", "ne", "clamp_min", "clamp_max",
              "clamp", "one_hot"}
# aten op -> (flops, transcendentals) per output element
_PER_ELEM = {
    "exp": (0, 1), "log": (0, 1), "tanh": (0, 1), "sigmoid": (0, 1), "rsqrt": (0, 1),
    "sqrt": (0, 1), "sin": (0, 1), "cos": (0, 1), "erf": (0, 1), "log1p": (0, 1),
    "expm1": (0, 1), "exp2": (0, 1), "reciprocal": (1, 0),
    "silu": (1, 1), "gelu": (7, 1), "softplus": (2, 2), "relu": (1, 0),
    "silu_backward": (4, 1), "gelu_backward": (12, 1), "sigmoid_backward": (2, 0),
    "tanh_backward": (2, 0), "softplus_backward": (3, 1), "threshold_backward": (1, 0),
    "pow": (1, 0), "square": (1, 0),
}
# combined by addition: partial sums pass through these
_LINEAR_ADD = {"add", "add_", "sub", "sub_", "cat", "stack"}
_LINEAR_ONE = {"mul", "mul_", "div", "div_"}
_CARRY = {"neg", "clone", "_to_copy", "contiguous", "constant_pad_nd"}
_REDUCE_SUM = {"sum", "mean", "nansum"}
_REDUCE_OTHER = {"amax", "amin", "max", "min", "argmax", "argmin", "logsumexp", "any",
                 "all", "prod", "norm", "linalg_vector_norm", "var", "std", "var_mean"}
_ALONG = {"cumsum", "cumprod", "sort", "argsort", "topk", "searchsorted", "logcumsumexp"}
_SOFTMAX = {"_softmax": (4, 1), "_log_softmax": (4, 1),
            "_softmax_backward_data": (3, 0), "_log_softmax_backward_data": (3, 1)}


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_of(pspec, ndim: int) -> tuple:
    """A ``PartitionSpec`` as a tuple of axis tuples, one per dim."""
    entries = [_axes(e) for e in tuple(pspec)]
    return tuple(entries + [()] * (ndim - len(entries)))[:ndim]


def _spec(t) -> tuple:
    s = getattr(t, "_dr_spec", None)
    return s if s is not None and len(s) == t.dim() else ((),) * t.dim()


def _part(t):
    return getattr(t, "_dr_part", None)


def _sub(t) -> dict:
    return getattr(t, "_dr_sub", None) or {}


def _tag(t, spec, part=None, sub=None):
    """Record on ``t`` its split (``spec``: axes per dim), its pending
    partial sums (``part``: (axes, byte width) or None) and, for a dim that
    a reshape merged, the (size, axes) segments it was merged from
    (``sub``), so that the reshape back gives each part its own axes."""
    t._dr_spec = tuple(tuple(a) for a in spec)
    t._dr_part = part
    t._dr_sub = {d: v for d, v in (sub or {}).items() if d < t.dim() and v}
    return t


def _unique_numel(t) -> int:
    """Elements a kernel reads of ``t``: stride-0 (broadcast) dims once."""
    n = 1
    for size, st in zip(t.shape, t.stride()):
        if st != 0:
            n *= size
    return n


def _tensors(tree) -> list:
    """The tensors among nested lists, tuples and dicts (aten's arguments)."""
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _dims_arg(dims, ndim):
    if dims is None or (isinstance(dims, (list, tuple)) and len(dims) == 0):
        return list(range(ndim))
    if isinstance(dims, int):
        dims = [dims]
    return sorted(d % max(ndim, 1) for d in dims)


class StepCount(TorchDispatchMode):
    """The counter (see the module docstring). Enter it around one step;
    read ``result()``. ``mesh`` is ``{axis: size}``."""

    def __init__(self, mesh: dict):
        super().__init__()
        self.mesh = dict(mesh)
        self.flops = 0.0
        self.transcendentals = 0.0
        self.matmul_flops = 0.0   # the aten matmul family, as FlopCounterMode counts it
        self.kernel_flops: dict[str, float] = {}
        self.hbm = 0.0
        self.coll = dict.fromkeys(COLL_KINDS, 0.0)
        self.coll_counts = dict.fromkeys(COLL_KINDS, 0)
        self.live = 0
        self.peak = 0
        self._quiet = 0
        self._layouts: dict = {}  # shape -> split of the last gather's source

    # -- mesh arithmetic ---------------------------------------------------

    def fac(self, axes) -> int:
        return math.prod(self.mesh.get(a, 1) for a in axes)

    def split(self, spec) -> int:
        return math.prod(self.fac(a) for a in spec)

    def local_numel(self, t, spec=None) -> float:
        return t.numel() / self.split(_spec(t) if spec is None else spec)

    def local_bytes(self, t, spec=None) -> float:
        return self.local_numel(t, spec) * t.element_size()

    def _read_bytes(self, t, spec=None) -> float:
        return _unique_numel(t) * t.element_size() / self.split(
            _spec(t) if spec is None else spec)

    # -- records -----------------------------------------------------------

    def collective(self, kind: str, nbytes: float):
        if nbytes <= 0:
            return
        self.coll[kind] += _FACTOR[kind] * nbytes
        self.coll_counts[kind] += 1

    def _alloc(self, t):
        """Count ``t``'s storage as live (local bytes) until it is freed."""
        st = t.untyped_storage()
        if getattr(st, "_dr_seen", False):
            return
        nbytes = int(st.nbytes() / self.split(_spec(t)))
        st._dr_seen = True
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, nbytes)

    def _free(self, nbytes):
        self.live -= nbytes

    def seed(self, t, pspec):
        """Tag ``t`` (an argument of the step) with ``pspec``'s split."""
        _tag(t, spec_of(pspec, t.dim()))
        t.untyped_storage()._dr_seen = True  # an argument: not a temp
        return t

    # -- resharding --------------------------------------------------------

    def _fit(self, t, want):
        """``want`` without the axes that do not divide ``t``'s dims."""
        out = []
        for size, axes in zip(t.shape, want):
            keep = []
            for a in axes:
                if size % (self.fac(keep) * self.mesh.get(a, 1)) == 0:
                    keep.append(a)
            out.append(tuple(keep))
        return tuple(out)

    def reshard(self, t, want):
        """Bring operand ``t`` to the split ``want``: partial sums settled
        (a reduce-scatter onto the axes ``want`` splits, an all-reduce over
        the rest), dims split over axes ``want`` leaves out all-gathered
        (once per tensor, target and pass), dims ``want`` splits further
        sliced for free."""
        want = self._fit(t, want)
        if getattr(t, "_dr_free", False):
            self._settle_free(t, want)
            return
        part = _part(t)
        if part is not None:
            paxes, width = part
            used = {a for ax in want for a in ax}
            rs = tuple(a for a in paxes if a in used)
            ar = tuple(a for a in paxes if a not in used)
            if rs:
                self.collective("reduce-scatter", t.numel() / self.split(want)
                                * self.fac(rs) * width)
            if ar:
                self.collective("all-reduce", t.numel() / self.split(want) * width)
            _tag(t, want)  # settled once: later consumers see the result
            return
        have = _spec(t)
        kept = tuple(tuple(a for a in h if a in w) for h, w in zip(have, want))
        if kept != have:
            key = (want, torch._C._current_graph_task_id())
            done = getattr(t, "_dr_gathered", None)
            if done is None:
                done = t._dr_gathered = set()
            if key not in done:
                done.add(key)
                gathered = t.numel() / self.split(kept) * t.element_size()
                self.collective("all-gather", gathered)
                self.peak = max(self.peak, self.live + int(gathered))

    def _settle_free(self, t, want):
        """A factory's tensor (or a view of one) laid out at its first use:
        ``want``, at no cost; its base takes the same split where it has
        the same rank (else stays whole) and is counted live from here."""
        base = getattr(t, "_dr_base", None)
        _tag(t, want, None, _sub(t))
        t._dr_free = False
        if base is not None and getattr(base, "_dr_free", False):
            bspec = want if base.dim() == t.dim() else ((),) * base.dim()
            _tag(base, self._fit(base, bspec))
            base._dr_free = False
            self._alloc(base)
        elif base is None:
            self._alloc(t)

    def _resolve(self, operands, sizes, fixed=None, first=None):
        """One split per label over ``operands`` ((tensor, labels) pairs;
        a label ``None`` is a broadcast dim): the largest operand's split
        first (``first`` before all), an axis used once, and ``fixed``
        labels pinned. Each operand is resharded to the result. Returns
        ``{label: axes}``."""
        assign = dict(fixed or {})
        src = {}
        used = {a for ax in assign.values() for a in ax}
        order = sorted(range(len(operands)),
                       key=lambda i: (i != first, -operands[i][0].numel()))
        for i in order:
            t, labels = operands[i]
            if getattr(t, "_dr_free", False):
                continue  # takes the others' split
            for lab, ax in zip(labels, _spec(t)):
                if lab is None or lab in assign or not ax:
                    continue
                if set(ax) & used or sizes[lab] % self.fac(ax):
                    continue
                assign[lab] = ax
                src[lab] = _sub(t).get(labels.index(lab))
                used |= set(ax)
        self._src = src
        for t, labels in operands:
            self.reshard(t, tuple(() if lab is None else assign.get(lab, ())
                                  for lab in labels))
        return assign

    def subs(self, labels) -> dict:
        """The merge segments of the result's dims (``labels`` per dim),
        from the operand that gave each label its split."""
        src = getattr(self, "_src", {})
        return {d: src.get(lab) for d, lab in enumerate(labels) if src.get(lab)}

    def constrain(self, x, named):
        """``sharding.constrain(x, kind)`` with the kind's
        ``NamedSharding`` (None: no such kind active): ``x`` brought to
        that split and tagged with it; a spec longer than ``x``'s rank is
        skipped, as the reference skips it."""
        if named is None or not isinstance(x, torch.Tensor) or len(tuple(named.spec)) > x.dim():
            return
        want = self._fit(x, spec_of(named.spec, x.dim()))
        self.reshard(x, want)
        _tag(x, want)

    # -- dispatch ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._quiet:
            return func(*args, **kwargs)
        name = func._overloadpacket.__name__
        ins = _tensors((args, kwargs))
        parts = [_part(t) for t in ins]
        # a consumer other than these settles the partial sums it reads
        carry = None
        if any(p is not None for p in parts):
            carry = self._carry(name, ins, parts)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if name.endswith("_") and len(ins) == 1 and getattr(ins[0], "_dr_free", False):
            return out  # fill_ / zero_ of a tensor not laid out yet
        if not outs:
            for t in ins:
                if _part(t) is not None:
                    self.reshard(t, _spec(t))
            return out
        if name in _VIEWS:
            self._view(name, args, ins, outs)
        elif name in _FACTORIES:
            for o in outs:  # laid out by its first use (``_settle_free``)
                _tag(o, ((),) * o.dim())
                o._dr_free = o.numel() > 1
                if not o._dr_free:
                    self._fresh(o)
        elif name in _LIKE:
            _tag(outs[0], _spec(ins[0]), None, _sub(ins[0]))
            self._fresh(outs[0])
        elif name in _MATMUL:
            self._matmul(name, args, outs[0])
        elif name in _REDUCE_SUM or name in _REDUCE_OTHER:
            self._reduce(name, args, kwargs, ins, outs)
        elif name in _SOFTMAX:
            self._softmax(name, args, ins, outs)
        elif name in _ALONG:
            self._along(name, args, kwargs, ins, outs)
        elif name in ("index", "_unsafe_index"):
            self._index(args, outs[0])
        elif name in ("index_put", "index_put_", "_index_put_impl_", "_unsafe_index_put"):
            self._index_put(name, args, kwargs, outs[0])
        elif name in ("gather", "scatter", "scatter_", "scatter_add", "scatter_add_",
                      "scatter_reduce", "scatter_reduce_", "take_along_dim"):
            self._gather_scatter(name, args, outs[0])
        elif name in ("cat", "stack"):
            self._cat(name, args, kwargs, outs[0], carry)
        else:
            self._elementwise(name, ins, outs, carry)
        return out

    def _fresh(self, o):
        if not o.is_meta:
            return
        self._alloc(o)

    def _count(self, flops, transc, nbytes, matmul=False):
        self.flops += flops
        self.transcendentals += transc
        self.hbm += nbytes
        if matmul:
            self.matmul_flops += flops

    def _carry(self, name, ins, parts):
        """The partial sums this op carries to its result (``(axes,
        width)``), or None: then every partial operand is settled by the
        op's own resolution."""
        live = [p for p in parts if p is not None]
        if name in _VIEWS or name in _CARRY:
            return live[0]
        if name in _LINEAR_ADD:
            big = [t for t in ins if t.numel() > 1]
            if big and all(_part(t) == live[0] for t in big):
                return live[0]
        if name in _LINEAR_ONE and len(live) == 1 and (
                name.startswith("mul") or _part(ins[0]) is not None):
            return live[0]
        if name in _REDUCE_SUM and len(live) == 1:
            return live[0]
        return None

    # views ----------------------------------------------------------------

    def _view(self, name, args, ins, outs):
        src = ins[0]
        part = _part(src)
        free = getattr(src, "_dr_free", False)
        for o in outs:
            spec, sub = self._view_spec(name, args, src, o)
            _tag(o, spec, part, sub)
            if free:
                o._dr_free = True
                o._dr_base = getattr(src, "_dr_base", None) or src

    def _view_spec(self, name, args, src, o):
        """(split, merge segments) of the view ``o`` of ``src``."""
        sp, sub, nd = _spec(src), _sub(src), src.dim()
        if name in ("detach", "alias", "lift_fresh", "alias_copy", "view_as") \
                and o.shape == src.shape:
            return sp, sub
        if name in ("t", "transpose", "permute"):
            if nd < 2:
                return sp, sub
            if name == "permute":
                perm = [d % nd for d in args[1]]
            else:
                d0, d1 = (0, 1) if name == "t" else (args[1] % nd, args[2] % nd)
                perm = list(range(nd))
                perm[d0], perm[d1] = perm[d1], perm[d0]
            return tuple(sp[d] for d in perm), {i: sub[d] for i, d in enumerate(perm) if d in sub}
        if name in ("expand", "expand_as"):
            lead = o.dim() - nd
            keep = [src.shape[i] == o.shape[lead + i] for i in range(nd)]
            return (tuple([()] * lead + [a if k else () for a, k in zip(sp, keep)]),
                    {lead + d: v for d, v in sub.items() if keep[d]})
        if name in ("select", "unbind"):
            d = (args[1] if len(args) > 1 else 0) % nd
            return sp[:d] + sp[d + 1:], {i - (i > d): v for i, v in sub.items() if i != d}
        if name in ("slice", "narrow", "split", "split_with_sizes", "chunk", "_unsafe_split") \
                and o.dim() == nd:
            d = (args[1] if len(args) > 1 and isinstance(args[1], int) else 0) % max(nd, 1)
            if name in ("split", "split_with_sizes", "chunk", "_unsafe_split"):
                d = (args[2] if len(args) > 2 else 0) % max(nd, 1)
            s = list(sp)
            if o.shape[d] != src.shape[d]:
                sub = {i: v for i, v in sub.items() if i != d}
                if o.shape[d] % self.fac(s[d]):
                    s[d] = ()
            return tuple(s), sub
        if name == "as_strided" and o.shape == src.shape:
            return sp, sub
        return self._reshape(src.shape, sp, o.shape, sub)

    def _reshape(self, in_shape, sp, out_shape, sub=None):
        """(split, merge segments) of a reshape: dims grouped by equal
        products; a group's (size, axes) segments (a merged dim's own
        segments expanded) handed to its output dims in order, each output
        dim taking the segments whose sizes make up its size (and keeping
        them when it merges several); where the sizes do not line up, the
        group's axes go to its output dims from the outermost while they
        divide."""
        sub = sub or {}
        in_shape, out_shape = list(in_shape), list(out_shape)
        out, out_sub = [()] * len(out_shape), {}
        i = j = 0
        ni, no = len(in_shape), len(out_shape)
        while i < ni and j < no:
            gi, gj = [i], [j]
            pi, pj = in_shape[i], out_shape[j]
            while pi != pj:
                if pi < pj and i + 1 < ni:
                    i += 1
                    pi *= in_shape[i]
                    gi.append(i)
                elif j + 1 < no:
                    j += 1
                    pj *= out_shape[j]
                    gj.append(j)
                else:
                    break
            segs = [sg for d in gi for sg in (sub.get(d) or ((in_shape[d], sp[d]),))
                    if sg[0] != 1 or sg[1]]
            placed = self._place_segments(segs, [out_shape[d] for d in gj])
            if placed is None:
                axes = [a for sg in segs for a in sg[1]]
                for d in gj:
                    take = []
                    while axes and out_shape[d] % (self.fac(take) * self.mesh.get(axes[0], 1)) == 0:
                        take.append(axes.pop(0))
                    out[d] = tuple(take)
            else:
                for d, taken in zip(gj, placed):
                    out[d] = tuple(a for sg in taken for a in sg[1])
                    if len(taken) > 1 and out[d]:
                        out_sub[d] = tuple(taken)
            i += 1
            j += 1
        return tuple(out), out_sub

    @staticmethod
    def _place_segments(segs, sizes):
        """``segs`` handed out in order to dims of ``sizes``, each dim the
        run of segments whose sizes multiply to its own; None where a
        segment straddles two dims."""
        out, k = [], 0
        for size in sizes:
            taken, prod = [], 1
            while prod < size and k < len(segs):
                taken.append(segs[k])
                prod *= segs[k][0]
                k += 1
            if prod != size:
                return None
            out.append(taken)
        return out if k == len(segs) else None

    # arithmetic -------------------------------------------------------------

    def _elementwise(self, name, ins, outs, carry, per=None):
        o = outs[0]
        nd = o.dim()
        first = 0 if name.endswith("_") else None
        operands = []
        for t in ins:
            if t.dim() > nd:
                continue
            off = nd - t.dim()
            operands.append((t, [off + d if t.shape[d] == o.shape[off + d] and t.shape[d] > 1
                                 else None for d in range(t.dim())]))
        sizes = dict(enumerate(o.shape))
        if carry is not None:  # the result keeps the partial sums: resolve on splits alone
            saved = [(t, _part(t)) for t, _ in operands]
            for t, _ in saved:
                t._dr_part = None
            assign = self._resolve(operands, sizes, first=first)
            for t, p in saved:
                t._dr_part = p
        else:
            assign = self._resolve(operands, sizes, first=first)
        spec = tuple(assign.get(d, ()) for d in range(nd))
        sub = self.subs(range(nd))
        if name.endswith("_") and ins and ins[0] is o:
            spec, sub = _spec(o), _sub(o)
        for x in outs:
            _tag(x, spec if x.dim() == nd else ((),) * x.dim(), carry, sub)
            if not (name.endswith("_") and ins and x is ins[0]):
                self._fresh(x)
        if name in _ZERO_FLOP or name in _COPIES or name in _CARRY and name != "neg":
            f, tr = 0, 0
        else:
            f, tr = per or _PER_ELEM.get(name.rstrip("_"), (1, 0))
        n = o.numel() / self.split(spec)
        nbytes = sum(self._read_bytes(t) for t in ins) + sum(self.local_bytes(x) for x in outs)
        self._count(f * n, tr * n, nbytes)

    def _matmul(self, name, args, o):
        if name in ("addmm", "baddbmm", "addbmm", "addmv"):
            bias, a, b = args[0], args[1], args[2]
        else:
            bias, a, b = None, args[0], args[1]
        if name == "dot":
            la, lb, lo = ["k"], ["k"], []
        elif name == "mv":
            la, lb, lo = ["m", "k"], ["k"], ["m"]
        elif a.dim() == 3:
            la, lb, lo = ["b", "m", "k"], ["b", "k", "n"], ["b", "m", "n"]
        else:
            la, lb, lo = ["m", "k"], ["k", "n"], ["m", "n"]
        sizes = dict(zip(la, a.shape))
        sizes.update(zip(lb, b.shape))
        operands = [(a, la), (b, lb)]
        if isinstance(bias, torch.Tensor):
            off = len(lo) - bias.dim()
            operands.append((bias, [lo[off + d] if bias.shape[d] > 1 else None
                                    for d in range(bias.dim())]))
        assign = self._resolve(operands, sizes)
        spec = tuple(assign.get(lab, ()) for lab in lo)
        kax = assign.get("k", ())
        _tag(o, spec, (kax, o.element_size()) if kax else None, self.subs(lo))
        self._fresh(o)
        flops = 2.0 * math.prod(sizes.values()) / self.fac(
            [x for v in assign.values() for x in v])
        nbytes = sum(self._read_bytes(t) for t, _ in operands) + self.local_bytes(o)
        self._count(flops, 0, nbytes, matmul=True)

    def _reduce(self, name, args, kwargs, ins, outs):
        x = args[0]
        nd = x.dim()
        dims = kwargs.get("dim", args[1] if len(args) > 1 and not isinstance(
            args[1], torch.dtype) else None)
        if name in ("max", "min") and len(args) == 1 and "dim" not in kwargs:
            dims = None
        if name in ("var_mean", "var", "std") and isinstance(dims, bool):
            dims = None
        red = _dims_arg(dims, nd)
        labels = [("r", d) if d in red else d for d in range(nd)]
        carry = _part(x) if name in _REDUCE_SUM else None
        if carry is not None:
            x._dr_part = None
        assign = self._resolve([(x, labels)], dict(zip(labels, x.shape)))
        if carry is not None:
            x._dr_part = carry
        raxes = tuple(a for d in red for a in assign.get(("r", d), ()))
        kept = [assign.get(d, ()) for d in range(nd) if d not in red]
        for o in outs:
            spec = kept if o.dim() == len(kept) else [
                assign.get(d, ()) if d not in red else () for d in range(nd)]
            spec = tuple(spec)[:o.dim()] + ((),) * max(0, o.dim() - len(spec))
            part = carry
            if raxes and name in _REDUCE_SUM:
                part = ((carry[0] if carry else ()) + raxes, o.element_size())
            _tag(o, spec, part)
            self._fresh(o)
            if raxes and name not in _REDUCE_SUM:
                self.collective("all-reduce", self.local_bytes(o))
        n = self.local_numel(x)
        self._count(n * (3 if name == "logsumexp" else 1), n if name == "logsumexp" else 0,
                    self._read_bytes(x) + sum(self.local_bytes(o) for o in outs))

    def _softmax(self, name, args, ins, outs):
        x = ins[-1] if "backward" in name else ins[0]
        dim = args[1] if "backward" not in name else args[2]
        dim %= x.dim()
        o = outs[0]
        assign = self._resolve([(t, list(range(t.dim()))) for t in ins if t.dim() == o.dim()],
                               dict(enumerate(o.shape)))
        spec = tuple(assign.get(d, ()) for d in range(o.dim()))
        _tag(o, spec)
        self._fresh(o)
        if spec[dim]:  # the row max and sum over a split dim
            rows = self.local_numel(o) / max(o.shape[dim] / self.fac(spec[dim]), 1)
            self.collective("all-reduce", rows * 4)
            self.collective("all-reduce", rows * 4)
        f, tr = _SOFTMAX[name]
        n = self.local_numel(o)
        self._count(f * n, tr * n, sum(self._read_bytes(t) for t in ins) + self.local_bytes(o))

    def _along(self, name, args, kwargs, ins, outs):
        """Scans and sorts along one dim: that dim gathered first."""
        x = ins[-1] if name == "searchsorted" else ins[0]
        if name == "searchsorted":
            dim = x.dim() - 1
        elif name == "topk":
            dim = kwargs.get("dim", args[2] if len(args) > 2 else -1)
        else:
            dim = kwargs.get("dim", args[1] if len(args) > 1 and isinstance(args[1], int) else -1)
        dim %= max(x.dim(), 1)
        operands = [(t, [d if not (t is x and d == dim) else ("along", d)
                         for d in range(t.dim())]) for t in ins if t.dim() == x.dim()]
        assign = self._resolve(operands, {**dict(enumerate(x.shape)), ("along", dim): 1},
                               fixed={("along", dim): ()})
        for o in outs:
            _tag(o, tuple(assign.get(d, ()) if o.shape[d] == x.shape[d] else ()
                          for d in range(o.dim())) if o.dim() == x.dim() else ((),) * o.dim())
            self._fresh(o)
        n = self.local_numel(outs[0])
        f = 1 if name in ("cumsum", "cumprod", "logcumsumexp") else 0
        self._count(f * n, 0, sum(self._read_bytes(t) for t in ins)
                    + sum(self.local_bytes(o) for o in outs))

    def _index(self, args, o):
        """``self[idx...]``: the result's index dims take the indices'
        split, its other dims the source's; a split source dim that the
        indices do not split on the same axes leaves partial sums (a masked
        gather on each rank, summed)."""
        src, idx = args[0], list(args[1])
        pos = [d for d, t in enumerate(idx) if t is not None]
        idxs = [t for t in idx if t is not None]
        bshape = torch.broadcast_shapes(*[t.shape for t in idxs])
        nb = len(bshape)
        ops = [(t, [nb - t.dim() + d if t.shape[d] > 1 else None for d in range(t.dim())])
               for t in idxs]
        assign = self._resolve(ops, dict(enumerate(bshape))) if ops else {}
        bspec = [assign.get(d, ()) for d in range(nb)]
        sp = _spec(src)
        self._layouts[tuple(src.shape)] = sp
        rest = [sp[d] for d in range(src.dim()) if d not in pos]
        consecutive = pos == list(range(pos[0], pos[0] + len(pos)))
        if consecutive:
            spec = rest[:pos[0]] + bspec + rest[pos[0]:]
        else:
            spec = bspec + rest
        used = {a for ax in bspec for a in ax}
        lost = tuple(a for d in pos for a in sp[d] if a not in used)
        used |= {a for ax in rest for a in ax}
        spec = tuple(tuple(a for a in ax) for ax in spec)
        if len(spec) != o.dim():
            spec = ((),) * o.dim()
        _tag(o, spec, (lost, o.element_size()) if lost else None)
        self._fresh(o)
        nbytes = 2 * self.local_bytes(o) + sum(self._read_bytes(t) for t in idxs)
        self._count(0, 0, nbytes)

    def _index_put(self, name, args, kwargs, o):
        src, idx, values = args[0], list(args[1]), args[2]
        accumulate = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
        idxs = [t for t in idx if t is not None]
        if getattr(src, "_dr_free", False):  # an index's backward: its source's layout
            self._settle_free(src, self._layouts.get(tuple(src.shape), ((),) * src.dim()))
        sp = _spec(src)
        part = None
        if accumulate:
            have = {a for ax in sp for a in ax}
            vaxes = tuple(a for ax in _spec(values) for a in ax if a not in have)
            part = (vaxes, o.element_size()) if vaxes else None
        if _part(values) is not None:
            self.reshard(values, _spec(values))
        if o is not src:
            _tag(o, sp, part)
            self._fresh(o)
        elif part is not None:
            o._dr_part = part
        n = self.local_numel(values)
        self._count(n if accumulate else 0, 0,
                    2 * self._read_bytes(values) + sum(self._read_bytes(t) for t in idxs))

    def _gather_scatter(self, name, args, o):
        src, dim, index = args[0], args[1] % max(args[0].dim(), 1), args[2]
        if name.startswith("scatter"):
            upd = args[3] if len(args) > 3 and isinstance(args[3], torch.Tensor) else None
            for t in (index, upd):
                if t is not None and _part(t) is not None:
                    self.reshard(t, _spec(t))
            if getattr(src, "_dr_free", False):
                # a gather's backward scatters into its source's layout
                want = self._layouts.get(tuple(src.shape)) or tuple(
                    ax if d != dim and index.shape[d] == src.shape[d] else ()
                    for d, ax in enumerate(_spec(index)))
                self._settle_free(src, want)
            spec = _spec(src)
            if o is not src:
                _tag(o, spec)
                self._fresh(o)
            n = self.local_numel(index)
            self._count(n if "add" in name or "reduce" in name else 0, 0,
                        2 * self.local_bytes(index) + self._read_bytes(index))
            return
        sp = _spec(src)
        self._layouts[tuple(src.shape)] = sp
        ispec = list(_spec(index))
        lost = tuple(a for a in sp[dim] if a not in {x for ax in ispec for x in ax})
        _tag(o, tuple(ispec), (lost, o.element_size()) if lost else None)
        self._fresh(o)
        self._count(0, 0, 2 * self.local_bytes(o) + self._read_bytes(index))

    def _cat(self, name, args, kwargs, o, carry):
        ts = list(args[0])
        dim = kwargs.get("dim", args[1] if len(args) > 1 else 0)
        nd = ts[0].dim()
        dim %= (nd + 1 if name == "stack" else max(nd, 1))
        operands = [(t, [d if (name == "stack" or d != dim) else None for d in range(nd)])
                    for t in ts]
        sizes = dict(enumerate(ts[0].shape))
        saved = [(t, _part(t)) for t in ts]
        if carry is not None:
            for t in ts:
                t._dr_part = None
        fixed = {} if name == "stack" else {dim: ()}
        # the joined dim is whole on every rank: each part gathered on it
        for t, labels in operands:
            if name != "stack":
                labels[dim] = dim
        assign = self._resolve(operands, sizes, fixed=fixed)
        if carry is not None:
            for t, p in saved:
                t._dr_part = p
        spec = [assign.get(d, ()) for d in range(nd)]
        if name == "stack":
            spec.insert(dim, ())
        _tag(o, tuple(spec), carry)
        self._fresh(o)
        self._count(0, 0, sum(self._read_bytes(t) for t in ts) + self.local_bytes(o))

    # -- the kernel seam -----------------------------------------------------

    def kernel(self, op, *args, impl=None, **kwargs):
        """``dispatch.kernel_call`` while counting: ``op`` counted by
        formula at its operands' local shapes, a ``meta`` result of the
        right shape returned; under grad through ``_Counted``."""
        del impl
        if torch.is_grad_enabled() and any(
                isinstance(a, torch.Tensor) and a.requires_grad for a in args):
            return _Counted.apply(self, op, kwargs, *args)
        return self.kernel_forward(op, args, kwargs)

    def kernel_forward(self, op, args, kwargs):
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        for t in ins:
            if _part(t) is not None:
                self.reshard(t, _spec(t))
        with self.quiet():
            outs, split, flops, transc, mm = kernel_formula(self, op, args, kwargs)
        for o, spec in outs:
            _tag(o, spec[0], spec[1])
            self._alloc(o)
        nbytes = sum(self._read_bytes(t) for t in ins) + sum(
            self.local_bytes(o) for o, _ in outs)
        self.kernel_flops[op] = self.kernel_flops.get(op, 0.0) + (flops + mm) / split
        self._count((flops + mm) / split, transc / split, nbytes)
        res = [o for o, _ in outs]
        return res[0] if len(res) == 1 else tuple(res)

    @contextlib.contextmanager
    def quiet(self):
        """Ops inside pass through uncounted (a formula's own ``meta``
        results)."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def result(self) -> dict:
        return {"flops": self.flops, "transcendentals": self.transcendentals,
                "matmul_flops": self.matmul_flops, "kernel_flops": dict(self.kernel_flops),
                "hbm_bytes": self.hbm, "coll_bytes": sum(self.coll.values()),
                "coll_by_kind": dict(self.coll), "coll_counts": dict(self.coll_counts)}


# ---------------------------------------------------------------------------
# kernel formulas
# ---------------------------------------------------------------------------


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def attention_pairs(Sq, Sk, *, causal, window, q_offset, bq, bk) -> int:
    """(q, k) pairs in the ``bq`` x ``bk`` blocks a causal or windowed
    query block reaches (every block without a mask): the blocks the
    reference's unrolled form and the kernel visit."""
    bq, bk = max(1, min(bq, Sq)), max(1, min(bk, Sk))
    if not (causal or window):
        return Sq * Sk
    pairs = 0
    for q0 in range(0, Sq, bq):
        q_lo, q_hi = q_offset + q0, q_offset + min(q0 + bq, Sq) - 1
        rows = min(q0 + bq, Sq) - q0
        for k0 in range(0, Sk, bk):
            k_hi = min(k0 + bk, Sk) - 1
            if k0 > q_hi or (window and k_hi <= q_lo - window):
                continue
            pairs += rows * (k_hi - k0 + 1)
    return pairs


def _attn_assign(counter, q, kv, labels_q, labels_kv, fixed, first=0):
    ops = [(q, labels_q)] + [(t, labels_kv) for t in kv]
    sizes = dict(zip(labels_kv, kv[0].shape)) if kv else {}
    sizes.update(zip(labels_q, q.shape))
    return counter._resolve(ops, sizes, fixed=fixed, first=first)


def kernel_formula(counter, op, args, kwargs):
    """(outputs [(meta tensor, (spec, partial))], split of the iteration
    space, flops, transcendentals, product flops) of one kernel op call:
    the formulas of ``launch.op_cases`` at any shape, with the attention
    forms' causal block skipping and the scan's chunked products."""
    from repro_torch.hopper.dispatch import resolve_blocks

    f32 = torch.float32
    if op == "flash_attention":
        q, k, v = args[:3]
        B, H, Sq, D = q.shape
        Sk = k.shape[2]
        a = _attn_assign(counter, q, (k, v), ["b", "h", "sq", "d"], ["b", "h", "sk", "d"],
                         {"d": (), "sk": ()})
        blocks = resolve_blocks("flash_attention", bq=kwargs.get("bq"), bk=kwargs.get("bk"))
        pairs = B * H * attention_pairs(Sq, Sk, causal=kwargs.get("causal", True),
                                        window=kwargs.get("window", 0),
                                        q_offset=kwargs.get("q_offset", 0),
                                        bq=blocks["bq"], bk=blocks["bk"])
        spec = (a.get("b", ()), a.get("h", ()), a.get("sq", ()), ())
        odt = f32 if kwargs.get("precision") is not None else q.dtype
        outs = [(_meta(q.shape, odt), (spec, None))]
        if kwargs.get("return_lse"):
            outs.append((_meta((B, H, Sq), f32), (spec[:3], None)))
        split = counter.fac([x for v in (spec[0], spec[1], spec[2]) for x in v])
        return outs, split, pairs * ATTN_SCORE_FLOPS, pairs, pairs * 4 * D
    if op == "decode_attention":
        q, k, v, _position = args[:4]
        B, H, D = q.shape
        paged = kwargs.get("block_table") is not None
        S = (kwargs["block_table"].shape[1] * k.shape[2]) if paged else k.shape[2]
        if paged:
            a = _attn_assign(counter, q, (), ["b", "h", "d"], [], {"d": ()})
        else:
            # the cache keeps its split (batch over the data axes, the
            # sequence over ``model``: flash-decode); q comes to it
            a = _attn_assign(counter, q, (k, v), ["b", "h", "d"], ["b", "hk", "s", "d"],
                             {"d": (), "hk": ()}, first=1)
        spec = (a.get("b", ()), a.get("h", ()), ())
        sax = a.get("s", ())
        outs = [(_meta(q.shape, q.dtype), (spec, (sax, q.element_size()) if sax else None))]
        if kwargs.get("return_lse"):
            outs.append((_meta((B, H), f32), (spec[:2], None)))
        pairs = B * H * S
        split = counter.fac([x for v in (spec[0], spec[1], sax) for x in v])
        if not paged:  # the plain form streams a contiguous copy of the cache
            counter.hbm += 2 * (counter._read_bytes(k) + counter._read_bytes(v))
        return outs, split, pairs * ATTN_SCORE_FLOPS, pairs, pairs * 4 * D
    if op == "linear_attention":
        r, k, v, w = args[:4]
        u = args[4] if len(args) > 4 else None
        B, H, T, N = r.shape
        M = v.shape[-1]
        C = kwargs.get("chunk") or resolve_blocks("linear_attention")["chunk"]
        a = _attn_assign(counter, v, (r, k, w), ["b", "h", "t", "m"], ["b", "h", "t", "n"],
                         {"t": (), "m": (), "n": ()})
        spec = (a.get("b", ()), a.get("h", ()), (), ())
        outs = [(_meta(v.shape, v.dtype), (spec, None)),
                (_meta((B, H, N, M), f32), (spec, None))]
        Tp = -(-T // C) * C
        mm = B * H * Tp * (4 * N * M + 2 * C * (N + M))
        ew = B * H * Tp * (8 * N + C + 3 * M) + B * H * (Tp // C) * 2 * N * M
        if u is not None:
            ew += B * H * Tp * (3 * N + 2 * M)
        transc = B * H * Tp * 3 * N
        split = counter.fac([x for v in spec for x in v])
        return outs, split, ew, transc, mm
    if op == "gemm":
        a_, b_ = args[:2]
        M, K = a_.shape
        N = b_.shape[1]
        asg = counter._resolve([(a_, ["m", "k"]), (b_, ["k", "n"])],
                               {"m": M, "k": K, "n": N}, fixed={"k": ()})
        spec = (asg.get("m", ()), asg.get("n", ()))
        odt = kwargs.get("out_dtype") or (f32 if kwargs.get("precision") is not None
                                          else a_.dtype)
        split = counter.fac([x for v in spec for x in v])
        return [(_meta((M, N), odt), (spec, None))], split, 0, 0, 2 * M * K * N
    if op == "spmm":
        values, _cols, dense = args[:3]
        R, L = values.shape
        F = dense.shape[1]
        return [(_meta((R, F), dense.dtype), (((), ()), None))], 1, 0, 0, 2 * R * L * F
    if op == "bsr_spmm":
        tv, _tr, _tc, dense = args[:4]
        T, bm, bk = tv.shape
        F = dense.shape[1]
        rows = kwargs.get("num_rows", args[4] if len(args) > 4 else None)
        return ([(_meta((rows, F), f32), (((), ()), None))], 1, 0, 0, 2 * T * bm * bk * F)
    if op == "spmspm":
        av, _ac, bv = args[:3]
        R, L = av.shape
        C = bv.shape[0]
        return [(_meta((R, C), f32), (((), ()), None))], 1, 0, 0, 2 * R * C * L
    if op == "stencil":
        grid = args[0]
        P = len(kwargs["offsets"])
        return ([(_meta(grid.shape, grid.dtype), (((),) * grid.dim(), None))], 1,
                2 * P * grid.numel(), 0, 0)
    raise NotImplementedError(f"step_count: no formula for kernel op {op!r}")


def fa_backward(counter, q, k, v, o, kw):
    """The port's plain FA-2 backward (``hopper.grads.flash_attention_bwd``)
    by formula, walked block by block at a rank's local batch and heads as
    that function walks it (its key block from ``grads._key_block``, the
    query rows each block's mask reaches): five products of 2 D per score
    (S recomputed, dV, dP, dQ, dK; exactly the matmul FLOPs it issues),
    the probability's and dS's elementwise work, the score blocks written
    and read about a dozen times, and its fp32 accumulators live. Returns
    (dq, dk, dv), ``meta`` and split as q, k, v."""
    from repro_torch.hopper.grads import _key_block

    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    sq, sk = _spec(q), _spec(k)
    Bl, Hl = B // counter.fac(sq[0]), H // counter.fac(sq[1])
    causal, window = kw.get("causal", True), kw.get("window", 0)
    q_offset = kw.get("q_offset", 0)
    bk = _key_block(Bl, Hl, Sq, Sk)
    rows_x_keys = 0
    for start in range(0, Sk, bk):
        stop = min(start + bk, Sk)
        if (causal or window) and start > q_offset + Sq - 1:
            break
        if window and stop - 1 <= q_offset - window:
            continue
        r0 = min(max(start - q_offset, 0), Sq) if (causal or window) else 0
        r1 = min(max(stop - 1 + window - q_offset, 0), Sq) if window else Sq
        rows_x_keys += max(r1 - r0, 0) * (stop - start)
    scores = Bl * Hl * rows_x_keys / counter.fac(sq[2])
    mm = 10.0 * D * scores
    rowsd = Bl * Hl * Sq * D / counter.fac(sq[2])
    counter._count(mm + 4 * scores + 3 * rowsd, scores, 12 * 4 * scores + 4 * (
        sum(counter._read_bytes(t) for t in (q, k, v, o)) + 4 * rowsd), matmul=False)
    counter.matmul_flops += mm
    counter.kernel_flops["flash_attention_bwd"] = (
        counter.kernel_flops.get("flash_attention_bwd", 0.0) + mm)
    # fp32 dq/dk/dv and three score blocks live while it runs
    blk = Bl * Hl * Sq * bk * 4 / counter.fac(sq[2])
    acc = 4 * (rowsd + 2 * Bl * k.shape[1] // max(counter.fac(sk[1]), 1) * Sk * D)
    counter.peak = max(counter.peak, counter.live + int(acc + 3 * blk))
    out = []
    for t in (q, k, v):
        with counter.quiet():
            g = torch.empty(t.shape, dtype=t.dtype, device="meta")
        _tag(g, _spec(t))
        counter._alloc(g)
        out.append(g)
    return out


class _Counted(torch.autograd.Function):
    """A kernel op under grad: the forward counted by formula, the
    backward as the port computes it (the plain FA-2 backward run under
    the counter; the scan's by formula: the plain chunked form recomputed
    and differentiated, three times its forward's work)."""

    @staticmethod
    def forward(ctx, counter, op, kw, *args):
        ctx.counter, ctx.op, ctx.kw = counter, op, dict(kw)
        fkw = dict(kw, return_lse=True) if op == "flash_attention" else kw
        res = counter.kernel_forward(op, args, fkw)
        res = res if isinstance(res, tuple) else (res,)
        ctx.n_in = len(args)
        ctx.save_for_backward(*[a if isinstance(a, torch.Tensor) else None for a in args],
                              *res)
        if op == "flash_attention":
            ctx.mark_non_differentiable(res[1])
            return res[0] if not kw.get("return_lse") else res
        return res

    @staticmethod
    def backward(ctx, *grads):
        counter, op = ctx.counter, ctx.op
        saved = ctx.saved_tensors
        ins, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        if op == "flash_attention":
            q, k, v = ins[:3]
            for t in (grads[0],):
                if _part(t) is not None:
                    counter.reshard(t, _spec(t))
            return (None, None, None, *fa_backward(counter, q, k, v, outs[0], ctx.kw)) + (
                None,) * (ctx.n_in - 3)
        if op == "linear_attention":
            with counter.quiet():
                _, split, flops, transc, mm = kernel_formula(
                    counter, op, ins, ctx.kw)
            counter._count(3 * (flops + mm) / split, 3 * transc / split,
                           3 * sum(counter._read_bytes(t) for t in ins + outs
                                   if t is not None), matmul=False)
            counter.matmul_flops += 3 * mm / split
            out = []
            for t, need in zip(ins, ctx.needs_input_grad[3:]):
                if t is None or not need:
                    out.append(None)
                    continue
                with counter.quiet():
                    g = torch.empty(t.shape, dtype=t.dtype, device="meta")
                _tag(g, _spec(t))
                counter._alloc(g)
                out.append(g)
            return (None, None, None, *out)
        raise NotImplementedError(f"step_count: no backward for kernel op {op!r}")


# ---------------------------------------------------------------------------
# one step of a cell
# ---------------------------------------------------------------------------


def _meta_tree(specs):
    """{name: (shape, dtype)} -> {name: meta tensor}."""
    return {n: _meta(s, dt) for n, (s, dt) in specs.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _zip_leaves(tree, specs):
    if isinstance(tree, dict):
        for k in tree:
            yield from _zip_leaves(tree[k], specs[k])
    else:
        yield tree, specs


def _shard_bytes(mesh, tree, specs) -> int:
    from repro_torch.parallel.sharding import NamedSharding

    total = 0
    for t, s in _zip_leaves(tree, specs):
        total += math.prod(NamedSharding(mesh, s).shard_shape(t.shape)) * t.element_size()
    return total


def step_arguments(cfg, shape, mesh) -> dict:
    """The step's arguments as ``meta`` trees with their specs, as the
    reference's ``_build_and_lower`` passes them (``train``: the state and
    the batch; ``prefill``: the parameters and the batch; ``decode``: the
    parameters, the cache and the batch), and their bytes on one device:
    ``{"trees": [(tree, specs), ...], "argument_bytes", "alias_bytes"}``
    (the donated state or cache). Allocates nothing."""
    from repro_torch.models import registry
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime import train_loop

    mode = "train" if shape.kind == "train" else "serve"
    batch = _meta_tree(registry.input_specs(cfg, shape))
    trees = [(batch, sh.batch_specs(cfg, batch, mesh))]
    if shape.kind == "train":
        state = train_loop.train_state_struct(cfg)
        pspecs = sh.param_specs(cfg, state["params"], mesh, mode)
        trees.insert(0, (state, {"params": pspecs,
                                 "opt": {"m": pspecs, "v": pspecs, "step": sh.P()}}))
    else:
        params = registry.param_shapes(cfg)
        trees.insert(0, (params, sh.param_specs(cfg, params, mesh, mode)))
        if shape.kind == "decode":
            cache = _meta_tree(registry.cache_spec(cfg, shape.global_batch, shape.seq_len))
            trees.insert(1, (cache, sh.cache_specs(cfg, cache, mesh)))
    sizes = [_shard_bytes(mesh, t, s) for t, s in trees]
    donated = {"train": 0, "decode": 1}.get(shape.kind)
    return {"trees": trees, "argument_bytes": sum(sizes),
            "alias_bytes": sizes[donated] if donated is not None else 0}


def count_step(cfg, shape, mesh) -> dict:
    """Count one step of ``cfg`` at ``shape`` (a ``configs.base.ShapeSpec``)
    on ``mesh`` (a ``hopper.partition.MeshSpec`` or anything with
    ``.shape``/``.axis_names``): the step ``_build_and_lower`` lowers in the
    reference (``train``: the AdamW train step on the donated state;
    ``prefill``: the forward; ``decode``: one decode step on the donated
    cache), per device. Returns ``{"memory": {...}, "flops",
    "transcendentals", "matmul_flops", "kernel_flops", "hbm_bytes",
    "coll_bytes", "coll_by_kind", "coll_counts", "count_s"}``."""
    from repro_torch.hopper import dispatch
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime import train_loop

    t0 = time.time()
    counter = StepCount(mesh.shape)
    act = {k: v for k, v in sh.default_activation_specs(cfg, mesh, shape.kind).items()
           if k != "__mesh__"}
    act["__count__"] = counter
    args = step_arguments(cfg, shape, mesh)
    for tree, specs in args["trees"]:
        for t, s in _zip_leaves(tree, specs):
            counter.seed(t, s)
    trees = [t for t, _ in args["trees"]]
    if shape.kind == "train":
        state, batch = trees
        pspecs = args["trees"][0][1]["params"]
        for t in _leaves(state):
            t.requires_grad_(False)

        def settle(grads):
            for g, s in _zip_leaves(grads, pspecs):
                counter.reshard(g, spec_of(s, g.dim()))
                _tag(g, counter._fit(g, spec_of(s, g.dim())))

        step = train_loop.make_train_step(cfg, grads_hook=settle)
    elif shape.kind == "prefill":
        step = train_loop.make_prefill_step(cfg)
    else:
        step = train_loop.make_decode_step(cfg)
    with sh.activation_sharding(act), dispatch.counting(counter.kernel), counter:
        out = step(*trees)
    # what the step returns beyond the donated buffers stays live
    for t in _tensors(out):
        if _part(t) is not None:
            counter.reshard(t, _spec(t))
    if shape.kind == "prefill":
        extra = counter.local_bytes(out)
    elif shape.kind == "decode":
        extra = counter.local_bytes(out[0])
    else:
        extra = sum(counter.local_bytes(t) for t in _tensors(out[1]))
    alias = args["alias_bytes"]
    memory = {"argument_size_in_bytes": int(args["argument_bytes"]),
              "output_size_in_bytes": int(alias + extra),
              "temp_size_in_bytes": int(max(counter.peak - int(extra), 0)),
              "alias_size_in_bytes": int(alias)}
    memory["total_per_device"] = (memory["argument_size_in_bytes"]
                                  + memory["output_size_in_bytes"]
                                  + memory["temp_size_in_bytes"]
                                  - memory["alias_size_in_bytes"])
    res = counter.result()
    res["memory"] = memory
    res["count_s"] = time.time() - t0
    return res
