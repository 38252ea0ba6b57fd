"""The port's benchmark tools, twins of the JAX package's ``benchmarks/``:
``suite`` (the five BASELINE configs), ``compaction_e2e`` (the real
encrypted compaction in child processes), ``streaming_phases`` (config
5's phase budget) and ``pin_baselines`` (the host-loop pins).  Each runs
as ``python3 -m crdt_enc_tpu_torch.benchmarks.<name>``."""
