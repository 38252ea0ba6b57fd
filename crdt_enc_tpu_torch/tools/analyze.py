"""``python -m crdt_enc_tpu_torch.tools.analyze`` — static-analysis CLI.

Thin entry point over :mod:`crdt_enc_tpu_torch.analysis.cli`, which lints
the port's own tree (``crdt_enc_tpu_torch/``) against its baseline
(``crdt_enc_tpu_torch/analysis/baseline.toml``) and its span and counter
registry (``crdt_enc_tpu_torch/analysis/observability.md``).
"""

from __future__ import annotations

from ..analysis.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
