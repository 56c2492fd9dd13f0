"""The federated round pipeline for the port's first slice:

    broadcast -> local_update -> upload -> aggregate -> evaluate

Counterpart of the parts of ``src/repro/core/round_program.py`` the
paper's SSV case study runs: ``RoundContext``, the ``SyncSchedule``, the
``SequentialExecutor`` (a Python loop over clients, one train step per
batch), the ``FedLLMProgram`` stage-spec and ``run_program`` without the
privacy and fault middleware.  Ledger bytes are derived from payload
shapes, so they equal the reference's exactly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import FedConfig, ModelConfig
from repro_torch.core import metrics as M
from repro_torch.core.fedavg import evaluate, fedavg, make_fns, to_device
from repro_torch.data.loader import epoch_batches
from repro_torch.peft import lora as lora_lib


@dataclasses.dataclass
class FedResult:
    history: List[M.RoundMetrics]
    ledger: M.CommLedger
    final_lora: Dict
    client_flops: List[float]

    @property
    def final_accuracy(self) -> float:
        return self.history[-1].accuracy if self.history else 0.0


class RoundContext:
    """Run-wide state shared by the stages: config, data, the train and
    eval steps, the ledger and the per-client cost model."""

    def __init__(self, model, base, cfg: ModelConfig, fed: FedConfig,
                 targets, public, clients_data: List[Dict], test, task,
                 batch_size, eval_batch, verbose, device):
        self.model, self.base, self.cfg, self.fed = model, base, cfg, fed
        self.targets, self.public, self.test = targets, public, test
        self.clients_data = list(clients_data)
        self.task, self.device, self.verbose = task, device, verbose
        self.batch_size, self.eval_batch = batch_size, eval_batch
        self.n_clients = len(self.clients_data)
        self.fns = make_fns(model, fed, task)
        self.ledger = M.CommLedger()
        self.history: List[M.RoundMetrics] = []
        self.cost = [M.ClientCost() for _ in range(self.n_clients)]
        self.data_w = [len(d["tokens"]) for d in self.clients_data]
        self.total_w = float(sum(self.data_w))


@dataclasses.dataclass
class _Job:
    """One in-flight client update."""
    client: int
    start: int          # round the client pulled the global and trained
    arrival: int        # round the update lands on the server
    payload: object


class SyncSchedule:
    """The paper-literal parameter-server round: every client starts a job
    each round and its upload arrives the same round."""

    def __init__(self, fed: FedConfig, n_clients: int):
        self.n = n_clients
        self._pending: List[_Job] = []

    def starters(self, rnd: int) -> List[int]:
        return list(range(self.n))

    def submit(self, rnd: int, ci: int, payload):
        self._pending.append(_Job(ci, rnd, rnd, payload))

    def pop_arrivals(self, rnd: int) -> List[_Job]:
        out = sorted((j for j in self._pending if j.arrival == rnd),
                     key=lambda j: j.client)
        self._pending = [j for j in self._pending if j.arrival != rnd]
        return out


def local_generator(fed: FedConfig, rnd: int, ci: int) -> torch.Generator:
    """The LoRA-dropout stream of one (round, client) job.  The seed formula
    is the reference's (core/rng.local_rng); the draws are torch's own."""
    return torch.Generator().manual_seed(fed.seed * 1013 + rnd * 131 + ci)


class SequentialExecutor:
    """Python loop over clients, one train step per batch — the
    paper-literal reference and the numerical ground truth."""

    def __init__(self, ctx: RoundContext):
        self.ctx = ctx

    def _local_finetune(self, program, ci, lt, opt, rnd):
        """One client's epochs of train steps; returns (lt, opt, n_tok)."""
        ctx, fed, fns = self.ctx, self.ctx.fed, self.ctx.fns
        gen = local_generator(fed, rnd, ci)
        n_tok = 0
        for ep in range(fed.local_epochs):
            for batch in epoch_batches(
                    ctx.clients_data[ci], ctx.batch_size,
                    seed=fed.seed * program.epoch_seed_mult + rnd + ep):
                lt, opt, _ = fns["train_step"](
                    ctx.base, lt, opt, to_device(batch, ctx.device), gen)
                n_tok += batch["tokens"].size
        return lt, opt, n_tok

    def train(self, program, jobs, rnd):
        """jobs: [(ci, lt)] -> [(new_lt, n_tok)] in job order."""
        out = []
        for ci, lt in jobs:
            lt, _, n_tok = self._local_finetune(
                program, ci, lt, self.ctx.fns["opt_init"](lt), rnd)
            out.append((lt, n_tok))
        return out


def staleness_weight(staleness: int, decay: float) -> float:
    """Polynomial staleness decay (FedAsync): ``(1 + s)^-decay``."""
    return float((1.0 + staleness) ** (-decay))


def stale_weighted_avg(global_tree, arrivals, total_weight: float, fed):
    """Staleness-weighted FedAvg of arrived trees, ``arrivals`` being
    ``(client, tree, staleness, data_weight)``.  Clients that delivered
    nothing anchor their data weight on the current global tree; when every
    client arrives fresh this is plain data-weighted FedAvg."""
    trees = [t for _, t, _, _ in arrivals]
    ws = [w * staleness_weight(s, fed.staleness_decay)
          for _, _, s, w in arrivals]
    absent = total_weight - sum(w for _, _, _, w in arrivals)
    if absent > 0:
        trees = [global_tree] + trees
        ws = [absent] + ws
    return fedavg(trees, ws)


class FedLLMProgram:
    """FedLLMs (paper SSII.A): a1 broadcast global LoRA params, a2 local
    PEFT fine-tuning, a3 upload the tuned params, a4 FedAvg."""

    epoch_seed_mult = 997

    def __init__(self, ctx: RoundContext, lora=None):
        if lora is None:
            gen = torch.Generator().manual_seed(ctx.fed.seed + 1)
            lora = lora_lib.init_lora(gen, ctx.base, ctx.targets,
                                      ctx.fed.lora_rank, ctx.fed.lora_alpha)
        self.global_lt = lora

    def broadcast(self, ctx, cohort, rnd):
        jobs = []
        for ci in cohort:
            ctx.ledger.record(rnd, ci, "lora_params", M.DOWN,
                              M.tree_bytes(self.global_lt))
            jobs.append((ci, self.global_lt))
        return jobs

    def local_update(self, ctx, ex, jobs, rnd):
        outs = ex.train(self, jobs, rnd)
        for (ci, _), (new_lt, n_tok) in zip(jobs, outs):
            ctx.cost[ci].add_train(ctx.cfg, n_tok, lora_lib.n_params(new_lt))
        return [(ci, new_lt) for (ci, _), (new_lt, _) in zip(jobs, outs)]

    def upload(self, ctx, outs, rnd):
        return outs

    def record_arrival(self, ctx, job, rnd):
        ctx.ledger.record(rnd, job.client, "lora_params", M.UP,
                          M.tree_bytes(job.payload))

    def aggregate(self, ctx, ex, kept, arrived, rnd):
        if kept:
            self.global_lt = stale_weighted_avg(self.global_lt, kept,
                                                ctx.total_w, ctx.fed)

    def evaluate(self, ctx):
        return evaluate(ctx.fns, ctx.base, self.global_lt, ctx.test,
                        ctx.eval_batch, ctx.device)

    def final_state(self, ctx):
        return self.global_lt


def run_program(model, base, cfg: ModelConfig, fed: FedConfig, targets,
                public: Dict, clients_data: List[Dict], test: Dict,
                task: str, batch_size: int, eval_batch: int, verbose: bool,
                device, lora=None) -> FedResult:
    """Run ``fed.rounds`` FedLLM rounds with sequential clients and sync
    aggregation.  ``lora`` (optional) is the initial global LoRA tree."""
    ctx = RoundContext(model, base, cfg, fed, targets, public, clients_data,
                       test, task, batch_size, eval_batch, verbose, device)
    program = FedLLMProgram(ctx, lora)
    ex = SequentialExecutor(ctx)
    schedule = SyncSchedule(fed, ctx.n_clients)
    for rnd in range(fed.rounds):
        t0 = time.perf_counter()
        starters = schedule.starters(rnd)
        jobs = program.broadcast(ctx, starters, rnd)
        outs = program.local_update(ctx, ex, jobs, rnd)
        for ci, payload in program.upload(ctx, outs, rnd):
            schedule.submit(rnd, ci, payload)
        kept, arrived = [], []
        for j in schedule.pop_arrivals(rnd):
            arrived.append(j)
            program.record_arrival(ctx, j, rnd)
            s = rnd - j.start
            if s <= fed.max_staleness:
                kept.append((j.client, j.payload, s, ctx.data_w[j.client]))
        program.aggregate(ctx, ex, kept, arrived, rnd)
        acc, loss = program.evaluate(ctx)
        ctx.history.append(M.RoundMetrics(
            rnd, acc, loss, ctx.ledger.mean_client_bytes_per_round(),
            float(np.mean([c.flops for c in ctx.cost])) if ctx.cost else 0.0,
            seconds=time.perf_counter() - t0))
        if verbose:
            print(f"[{fed.framework}/sequential] round {rnd}: "
                  f"acc={acc:.4f} loss={loss:.4f}")
    return FedResult(ctx.history, ctx.ledger, program.final_state(ctx),
                     [c.flops for c in ctx.cost])
