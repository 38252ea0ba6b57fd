from .accel import TorchAccelerator
from .distributed import (
    global_op_batch,
    initialize,
    make_multihost_mesh,
    replicate,
)
from .mesh import (
    Mesh,
    gcounter_fold_sharded,
    lww_fold_sharded,
    make_mesh,
    orset_fold_sharded,
    orset_merge_sharded,
    pad_rows_for_mesh,
    pncounter_fold_sharded,
)

__all__ = [
    "Mesh",
    "TorchAccelerator",
    "gcounter_fold_sharded",
    "global_op_batch",
    "initialize",
    "lww_fold_sharded",
    "make_mesh",
    "make_multihost_mesh",
    "orset_fold_sharded",
    "orset_merge_sharded",
    "pad_rows_for_mesh",
    "pncounter_fold_sharded",
    "replicate",
]
