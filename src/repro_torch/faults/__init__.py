"""Fault tolerance for the federated round engine.  Counterpart of
``src/repro/faults/``.

``plan.FaultPlan`` injects seeded dropouts, straggler delays and
Byzantine payload corruption into any framework x backend x schedule;
``guard`` holds the upload-seam checks (the finite check and the norm
screen) by which core/round_program.run_program quarantines offenders.
"""
from repro_torch.faults.plan import FaultPlan  # noqa: F401
