"""Replication observability: the port's copy of the parts of
``crdt_enc_tpu/obs`` its delta seal needs."""
