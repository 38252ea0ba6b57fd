"""The registry under its historical name.

The span/counter registry lives in :mod:`crdt_enc_tpu_torch.obs.record`.
This module replaces itself in ``sys.modules`` with that module, so
``from crdt_enc_tpu_torch.utils import trace`` and ``from
crdt_enc_tpu_torch.obs import record`` name one module object and one
registry (a re-export would fork the module-level state, such as the
event-log switch).
"""

import sys

from ..obs import record as _record

sys.modules[__name__] = _record
