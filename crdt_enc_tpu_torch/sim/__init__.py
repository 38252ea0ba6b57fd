"""Adversarial convergence simulator: the port's copy of
``crdt_enc_tpu/sim``.

Machine-checks the protocol invariants — convergence, oracle equality,
warm≡cold reopen, replication monotonicity, fsck cleanliness — under
hostile, deterministic, seeded schedules of replica activity over a
fault-injecting storage layer.  Even replicas, the oracle and fsck run
on the host reference; odd replicas and the service and daemon steps
fold on the runner's device (the card unless the caller asks for the
CPU).  Failures shrink to minimal replayable fixtures in the JAX
package's format (``tests/data/sim/``), so a schedule from either
package replays in the other.

Front doors: :func:`generate` a schedule, :func:`run_schedule` it,
:func:`shrink` a failure; ``python -m crdt_enc_tpu_torch.tools.sim`` is
the CLI over the same calls.
"""

from .check import InvariantViolation, Violation
from .coverage import CoFireMatrix
from .faults import FaultConfig, FaultyStorage, SimCrash
from .population import (
    PopulationReport,
    PopulationSubstrate,
    run_budget,
    run_population,
    verify_serial_equality,
)
from .runner import DeterministicCryptor, SimResult, SimRunner, run_schedule
from .schedule import STEP_KINDS, Schedule, Step, generate
from .shrink import shrink, to_fixture

__all__ = [
    "CoFireMatrix",
    "FaultConfig",
    "FaultyStorage",
    "InvariantViolation",
    "DeterministicCryptor",
    "PopulationReport",
    "PopulationSubstrate",
    "STEP_KINDS",
    "Schedule",
    "SimCrash",
    "SimResult",
    "SimRunner",
    "Step",
    "Violation",
    "generate",
    "run_budget",
    "run_population",
    "run_schedule",
    "shrink",
    "to_fixture",
    "verify_serial_equality",
]
