"""Dense ops of the port: host↔tensor conversion and the sparse host fold
(``columnar``), the OR-Set fold and merge (``orset``), the
counter folds (``counters``), the LWW-map fold (``lww``), and their CUDA
kernels (``orset_fold_cuda``, ``orset_merge_cuda``, ``lww_fold_cuda``,
built by ``cuda_build``)."""

from .columnar import (
    KIND_ADD,
    KIND_RM,
    CounterColumns,
    LwwColumns,
    OrsetColumns,
    Vocab,
    counter_ops_to_columns,
    dense_to_vclock,
    lww_ops_to_columns,
    orset_apply_coo,
    orset_fold_sparse_host,
    orset_ops_to_columns,
    orset_planes_to_state,
    orset_scan_vocab,
    orset_state_to_planes,
    pad_orset_rows,
    vclock_to_dense,
)
from .counters import gcounter_fold, pncounter_fold, vclock_merge
from .lww import (
    lww_fold,
    lww_fold_into,
    lww_table_merge,
    lww_table_wins,
    ts_split,
)
from .orset import (
    merge_rule,
    orset_apply_batch_planes,
    orset_fold,
    orset_merge,
    orset_merge_many,
    orset_retire,
)

__all__ = [
    "KIND_ADD",
    "KIND_RM",
    "CounterColumns",
    "LwwColumns",
    "OrsetColumns",
    "Vocab",
    "counter_ops_to_columns",
    "dense_to_vclock",
    "gcounter_fold",
    "lww_fold",
    "lww_fold_into",
    "lww_ops_to_columns",
    "lww_table_merge",
    "lww_table_wins",
    "merge_rule",
    "orset_apply_batch_planes",
    "orset_apply_coo",
    "orset_fold",
    "orset_fold_sparse_host",
    "orset_merge",
    "orset_merge_many",
    "orset_ops_to_columns",
    "orset_planes_to_state",
    "orset_retire",
    "orset_scan_vocab",
    "orset_state_to_planes",
    "pad_orset_rows",
    "pncounter_fold",
    "ts_split",
    "vclock_merge",
    "vclock_to_dense",
]
