"""Static checker of the port's substrate invariants and schedule hazards
(the port of the reference's ``analysis`` package).

Three tiers behind one rule registry (``base.register_rule``):

  - **AST rules** (``ast_rules``): parse ``src/repro_torch`` and enforce
    the syntactic invariants the kernel layer depends on — one module
    opens the kernels' libraries, block geometry and run-time plans come
    from ``hopper/dispatch.py``, no environment reads in ``hopper/``,
    collective axis names from the partition vocabulary, the documented
    surfaces' contract, explicit warning categories.
  - **Plan rules** (``plan_rules``): check *resolved artifacts* — ring
    schedules for double-buffer aliasing and wait ordering, the kernels'
    run-time plans against a CTA's shared memory, threads and registers
    (the H100's constants on the CPU, the card's own with
    ``--device cuda``), the kernels' ``KernelStreams`` for a widened
    accumulator, partition plans on the production meshes, the serving
    scheduler's block ledger.
  - **Model rules** (``model_rules`` over the ``explore`` engine):
    exhaustively explore bounded state spaces — every scheduler action
    interleaving, every legal landing order of the ring schedules — and
    the dtype/scale dataflow of every suite kernel. Explorations run under
    an explicit ``--budget``; exhaustion is its own exit code (3).

Drive it as ``python -m repro_torch.analysis`` (see ``cli``). This
``__init__`` pulls only the stdlib-based registry; the plan and model
tiers import torch inside each rule, so ``--list`` and usage errors
import no torch.
"""
from repro_torch.analysis.base import (  # noqa: F401
    Context,
    Finding,
    Rule,
    default_root,
    register_rule,
    registered_rules,
    run_rules,
)
