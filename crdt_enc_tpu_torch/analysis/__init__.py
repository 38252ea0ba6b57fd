"""crdt_enc_tpu_torch.analysis — the project-invariant static-analysis engine.

One AST parse pass over ``crdt_enc_tpu_torch/``, a plugin rule registry
encoding the invariants this codebase has been burned by (FFI contracts,
silent native and CUDA fallbacks, thread discipline, span registry, H2D
accounting, key-material taint, the ``_mut`` epoch law, the event loop's
and the simulator's contracts), inline pragmas plus a committed baseline
(``baseline.toml`` beside this file) for deliberate exceptions, and a CLI
(``python -m crdt_enc_tpu_torch.tools.analyze``).  The span and counter
registry SPN001 reads is ``observability.md`` beside this file.

It imports the standard library only: no ``torch``, nothing that a
machine without the numeric stack would lack.
"""

from .baseline import Baseline
from .engine import (
    SEV_ERROR,
    SEV_WARNING,
    Finding,
    ModuleInfo,
    Project,
    all_rules,
    run,
    rule,
    unsuppressed_errors,
)

__all__ = [
    "Baseline",
    "Finding",
    "ModuleInfo",
    "Project",
    "SEV_ERROR",
    "SEV_WARNING",
    "all_rules",
    "rule",
    "run",
    "unsuppressed_errors",
]
