"""Round-level crash recovery for the federated driver.  Counterpart of
``src/repro/checkpoint/federated.py``, field for field.

``save_run`` snapshots everything mutable in a
core/round_program.run_program run after round ``rnd``: the program's
state (the global LoRA tree; KD's client adapters, server state and
global knowledge; Split's halves and server optimizer), the schedule's
in-flight jobs with their payloads and its generators, the secure-agg
session (cohorts and fixed-point vectors, bit exact), the ledger with
its hops, the metric history, the per-client cost, the DP release
counts and the streamed rounds' masking-cohort ids.  ``restore_run``
rebuilds all of it and returns the round to resume from, so a run killed
and resumed from its last checkpoint ends bit for bit as the run that
was not interrupted.  The port's ``RoundMetrics.seconds`` (wall time,
which no resumed run repeats) is saved and restored with the rest.

What follows from ``FedConfig.seed`` is not stored: fault plans, dropout
generators, DP noise, batch orders and secure-agg pair masks are pure
functions of (seed, round, client), so the resumed rounds draw them
again.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import metrics as M
from repro_torch.core.async_agg import _Job


def save_run(mgr: CheckpointManager, ctx, program, schedule, rnd: int,
             rollovers: int) -> str:
    """Snapshot the run after round ``rnd`` (a resume continues at
    ``rnd + 1``)."""
    state = {
        "round": int(rnd) + 1,
        "rollovers": int(rollovers),
        "program": program.state_dict(ctx),
        "jobs": [{"client": int(j.client), "start": int(j.start),
                  "arrival": int(j.arrival), "payload": j.payload}
                 for j in schedule.jobs()],
        # numpy generator states: dicts of strings and (large) Python
        # ints, which JSON carries exactly
        "sched_rngs": schedule.rng_state(),
        "secagg": ctx.secagg.state_dict(),
        "ledger": {
            "default_hop": ctx.ledger.default_hop,
            "events": [[int(e.round), int(e.client), e.name, e.direction,
                        int(e.bytes), e.hop] for e in ctx.ledger.events],
        },
        "history": [[int(m.round), float(m.accuracy), float(m.loss),
                     float(m.comm_bytes_per_client), float(m.client_flops),
                     float(m.epsilon), float(m.seconds)]
                    for m in ctx.history],
        "cost": [float(c.flops) for c in ctx.cost],
        "releases": [int(r) for r in ctx.releases],
        "cohort_ids": {f"{r}:{c}": int(v)
                       for (r, c), v in ctx._cohort_ids.items()},
    }
    return mgr.save_state(rnd + 1, state,
                          metadata={"framework": ctx.fed.framework,
                                    "rounds": int(ctx.fed.rounds)})


def restore_run(directory: str, ctx, program, schedule,
                step: Optional[int] = None) -> Tuple[int, int]:
    """Load the latest (or the ``step``-th) snapshot of ``directory`` into
    a newly built run -> (round to start from, rollovers)."""
    st, _ = CheckpointManager(directory).restore_state(step, ctx.device)
    program.load_state_dict(ctx, st["program"])
    schedule.load_jobs([_Job(int(j["client"]), int(j["start"]),
                             int(j["arrival"]), j["payload"])
                        for j in st["jobs"]])
    if st["sched_rngs"] is not None:
        schedule.load_rng_state(st["sched_rngs"])
    ctx.secagg.load_state_dict(st["secagg"])
    ctx.ledger.default_hop = st["ledger"]["default_hop"]
    ctx.ledger.events = [M.CommEvent(r, c, name, d, b, hop)
                         for r, c, name, d, b, hop
                         in st["ledger"]["events"]]
    ctx.history[:] = [M.RoundMetrics(r, acc, loss, cb, fl, epsilon=eps,
                                     seconds=sec)
                      for r, acc, loss, cb, fl, eps, sec in st["history"]]
    for c, fl in zip(ctx.cost, st["cost"]):
        c.flops = fl
    ctx.releases[:] = [int(r) for r in st["releases"]]
    ctx._cohort_ids = {}
    for key, v in st["cohort_ids"].items():
        r, c = key.split(":")
        ctx._cohort_ids[(int(r), int(c))] = int(v)
    return int(st["round"]), int(st["rollovers"])
