"""Dense OR-Set ops of the port: host↔tensor conversion (``columnar``),
the fold and merge (``orset``), and their CUDA kernels
(``orset_fold_cuda``, ``orset_merge_cuda``, built by ``cuda_build``)."""

from .columnar import (
    KIND_ADD,
    KIND_RM,
    OrsetColumns,
    Vocab,
    orset_ops_to_columns,
    orset_planes_to_state,
    orset_scan_vocab,
    orset_state_to_planes,
    pad_orset_rows,
)
from .orset import (
    merge_rule,
    orset_apply_batch_planes,
    orset_fold,
    orset_merge,
    orset_merge_many,
)

__all__ = [
    "KIND_ADD",
    "KIND_RM",
    "OrsetColumns",
    "Vocab",
    "merge_rule",
    "orset_apply_batch_planes",
    "orset_fold",
    "orset_merge",
    "orset_merge_many",
    "orset_ops_to_columns",
    "orset_planes_to_state",
    "orset_scan_vocab",
    "orset_state_to_planes",
    "pad_orset_rows",
]
