"""The federated round pipeline:

    broadcast -> local_update -> upload -> aggregate -> evaluate

Counterpart of the parts of ``src/repro/core/round_program.py`` that run
FedLLM, KD-FedLLM and Split-FedLLM: ``RoundContext`` (with each client's
LoRA rank, core/heterogeneous.normalize_ranks), the ``AsyncSchedule``
(core/async_agg.py; a sync round is its case with every delay 0), the
``SequentialExecutor`` (a Python loop over clients, one train step per
batch), the ``SpmdExecutor`` (the round's clients stacked on a leading
axis, one stacked program per rank bucket: core/fed_spmd.py), the
``FedLLMProgram``, ``KDProgram`` and ``SplitProgram`` stage-specs (a
client below the global rank gets the global tree truncated to its rank,
and its upload is harmonized by ``FedConfig.hetero_agg``) and
``run_program`` with the privacy middleware (upload noise,
secure-aggregation masking around aggregation, the RDP accountant),
which is the same under either executor and aggregation, and without the
fault middleware.  Ledger bytes are derived from payload shapes, so they
equal the reference's exactly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import FedConfig, ModelConfig
from repro_torch.core import fed_spmd
from repro_torch.core.async_agg import (ParticipationSchedule, _Job,
                                        _pop_arrivals, stale_weighted_avg,
                                        staleness_weight)
from repro_torch.core.heterogeneous import normalize_ranks
from repro_torch.core import kd as kd_mod
from repro_torch.core import metrics as M
from repro_torch.core import split as split_mod
from repro_torch import tree as tree_lib
from repro_torch.core.fedavg import evaluate, make_fns, to_device
from repro_torch.data.loader import epoch_batches
from repro_torch.peft import lora as lora_lib
from repro_torch.privacy import dp as dp_mod
from repro_torch.privacy.accountant import GaussianAccountant
from repro_torch.privacy.secure_agg import SecureAggSession


@dataclasses.dataclass
class FedResult:
    history: List[M.RoundMetrics]
    ledger: M.CommLedger
    final_lora: Dict
    client_flops: List[float]

    @property
    def final_accuracy(self) -> float:
        return self.history[-1].accuracy if self.history else 0.0


# --------------------------------------------------------------------------- #
# Privacy accounting (RDP accountant wiring)
# --------------------------------------------------------------------------- #
def make_accountant(fed: FedConfig, sample_rate: float = 1.0):
    """RDP accountant for the run, or None when DP is off.  ``sample_rate``
    is the per-step subsampling rate q (``sample_rate`` below); a
    clipping-only run (dp_clip > 0, noise 0) gets an accountant whose
    epsilon is ``inf``: the mechanism runs but gives no (eps, delta)
    guarantee, and 0.0 would claim the strongest one."""
    if not fed.privacy.dp_enabled:
        return None
    return GaussianAccountant(fed.privacy.dp_noise_multiplier,
                              fed.privacy.dp_delta, sample_rate=sample_rate)


def round_epsilon(acct, releases: int) -> float:
    """eps at the configured dp_delta after ``releases`` noisy uploads per
    client; 0.0 when DP is off (no claim), inf when clipping runs without
    noise."""
    return acct.epsilon(releases) if acct is not None else 0.0


def sample_rate(clients_data: List[Dict], batch_size: int) -> float:
    """Worst-case (largest) per-step subsampling rate over clients:
    q_i = batch_size / |client i's data|, clamped to 1."""
    return max(min(1.0, batch_size / max(len(d["tokens"]), 1))
               for d in clients_data)


class RoundContext:
    """Run-wide state shared by the stages: config, data, the train and
    eval steps, the ledger, the per-client cost model and the privacy
    middleware (accountant, secure-agg session, per-client release
    counts)."""

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
        self.acct = make_accountant(fed, sample_rate(self.clients_data,
                                                     batch_size))
        self.secagg = SecureAggSession(fed)
        self.releases = [0] * self.n_clients   # noisy uploads per client
        self.ranks = normalize_ranks(fed.client_ranks, self.n_clients,
                                     fed.lora_rank)

    def secagg_start(self, rnd: int, ci: int) -> int:
        """The secure-agg cohort key of client ``ci``'s job started in
        ``rnd``: the start round (per-chunk ids come with the
        cohort-streaming executor)."""
        return rnd


class AsyncSchedule:
    """FedAsync-style participation: a free client starts a job (pulls
    the current global, trains now) and its upload is in flight for a
    seeded delay a job (core/async_agg.ParticipationSchedule, seeded with
    ``fed.seed + 17`` as the reference's).  Under ``aggregation="sync"``
    every delay is 0: every client starts a job each round and its upload
    arrives the same round, the paper-literal parameter-server round."""

    def __init__(self, fed: FedConfig, n_clients: int):
        self.n = n_clients
        self.sched = ParticipationSchedule(
            n_clients, fed.seed + 17,
            fed.max_staleness if fed.aggregation == "async" else 0)
        self.in_flight: Dict[int, _Job] = {}

    def starters(self, rnd: int) -> List[int]:
        return [ci for ci in range(self.n) if ci not in self.in_flight]

    def submit(self, rnd: int, ci: int, payload):
        self.in_flight[ci] = _Job(ci, rnd, rnd + self.sched.next_delay(ci),
                                  payload)

    def pop_arrivals(self, rnd: int) -> List[_Job]:
        return _pop_arrivals(self.in_flight, rnd)


def local_generator(fed: FedConfig, rnd: int, ci: int) -> torch.Generator:
    """The LoRA-dropout stream of one (round, client) job.  The seed formula
    is the reference's (core/rng.local_rng); the draws are torch's own."""
    return torch.Generator().manual_seed(fed.seed * 1013 + rnd * 131 + ci)


class SequentialExecutor:
    """Python loop over clients, one train step per batch — the
    paper-literal reference and the numerical ground truth."""

    backend = "sequential"

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

    def kd_train_and_logits(self, program, cis, rnd):
        """KD b1 + b2: each client fine-tunes its own LoRA, keeping its
        optimizer state across rounds, then forms its public-set logits.
        Returns [(logits, n_tok)] in client order."""
        ctx = self.ctx
        out = []
        for ci in cis:
            lt, opt, n_tok = self._local_finetune(
                program, ci, program.lts[ci], program.opts[ci], rnd)
            program.lts[ci], program.opts[ci] = lt, opt
            out.append((kd_mod.client_logits(ctx.fns, ctx.base, lt,
                                             ctx.public, ctx.eval_batch,
                                             ctx.device), n_tok))
        return out

    def kd_distill(self, program, cis, glob, rnd):
        """KD b8: each client distills the global knowledge ``glob``."""
        ctx, fed = self.ctx, self.ctx.fed
        for ci in cis:
            program.lts[ci], program.opts[ci], _ = kd_mod.distill(
                ctx.fns, ctx.base, program.lts[ci], program.opts[ci],
                ctx.public, glob, fed.kd_epochs, ctx.eval_batch, ctx.device,
                seed=fed.seed + 31 * rnd + ci)

    def split_train(self, program, jobs, rnd):
        """Split c1-c5: jobs [(ci, c_init)] -> [(c_lt, n_tok, n_steps,
        batch shape)].  Each client's half starts from fresh Adam state
        every round and makes one pass over its data; the server half and
        its Adam state thread through the clients in visit order across
        the whole run.  One LoRA-dropout generator per job serves both
        halves of every step."""
        ctx, fed = self.ctx, self.ctx.fed
        sfns = program.sfns
        out = []
        for ci, c_init in jobs:
            c_lt, c_opt = c_init, sfns["opt_init"](c_init)
            gen = local_generator(fed, rnd, ci)
            n_tok, n_steps, shape = 0, 0, None
            for batch in epoch_batches(
                    ctx.clients_data[ci], ctx.batch_size,
                    seed=fed.seed * program.epoch_seed_mult + rnd):
                noise = dp_mod.noise_generator(fed, rnd, ci, n_steps) \
                    if fed.privacy.dp_enabled else None
                c_lt, program.s_lt, c_opt, program.s_opt, _ = \
                    sfns["split_step"](
                        program.base_c, program.base_s, c_lt, program.s_lt,
                        c_opt, program.s_opt, to_device(batch, ctx.device),
                        gen, noise)
                n_tok += batch["tokens"].size
                n_steps += 1
                shape = batch["tokens"].shape
            out.append((c_lt, n_tok, n_steps, shape))
        return out


class SpmdExecutor:
    """The ready set stacked on a leading client axis, one stacked program
    per rank bucket (core/fed_spmd.py): each step trains every client of
    the bucket on its own batch in one forward and backward, the LoRA
    projections as client-axis passes.  Each client draws its dropout
    masks from the generator the sequential executor gives it, in the
    same order, so the two executors see the same masks."""

    backend = "spmd"

    def __init__(self, ctx: RoundContext):
        self.ctx = ctx
        self._local_update = fed_spmd.make_local_update(
            ctx.model, ctx.fed, ctx.task, ctx.fns)

    def _gens(self, rnd, cis):
        return [local_generator(self.ctx.fed, rnd, ci) for ci in cis]

    def _local_finetune(self, program, cis, slt, sopt, rnd):
        """Every client of ``cis`` fine-tunes its stacked LoRA over its
        epochs of padded, masked batches; returns (slt, sopt, n_tok)."""
        ctx, fed = self.ctx, self.ctx.fed
        seeds = [fed.seed * program.epoch_seed_mult + rnd + ep
                 for ep in range(fed.local_epochs)]
        batches, valid, n_tok = fed_spmd.stack_client_batches(
            [ctx.clients_data[ci] for ci in cis], ctx.batch_size, seeds)
        slt, sopt, _ = self._local_update(ctx.base, slt, sopt, batches,
                                          valid, self._gens(rnd, cis),
                                          ctx.device)
        return slt, sopt, n_tok

    # -- FedLLM a2 ------------------------------------------------------ #
    def train(self, program, jobs, rnd):
        """jobs: [(ci, lt)] -> [(new_lt, n_tok)] in job order."""
        ctx = self.ctx
        by_ci = dict(jobs)
        results = {}
        for _, cis in fed_spmd.rank_buckets(ctx.ranks, list(by_ci)):
            slt = fed_spmd.stack_trees([by_ci[ci] for ci in cis])
            sopt = fed_spmd.stack_for_clients(
                ctx.fns["opt_init"](by_ci[cis[0]]), len(cis))
            slt, _, n_tok = self._local_finetune(program, cis, slt, sopt,
                                                 rnd)
            for k, (ci, t) in enumerate(zip(cis,
                                            fed_spmd.unstack_tree(slt))):
                results[ci] = (t, n_tok[k])
        return [results[ci] for ci, _ in jobs]

    # -- KD b1 + b2 ----------------------------------------------------- #
    def kd_train_and_logits(self, program, cis, rnd):
        """KD b1 + b2 over stacked clients; [(logits, n_tok)] in client
        order."""
        ctx = self.ctx
        lts, opts = program.lts, program.opts
        results = {}
        for _, bcis in fed_spmd.rank_buckets(ctx.ranks, cis):
            sl, so, n_tok = self._local_finetune(
                program, bcis, fed_spmd.stack_trees([lts[ci] for ci in bcis]),
                fed_spmd.stack_trees([opts[ci] for ci in bcis]), rnd)
            logits = _batched_public_logits(ctx, sl)
            for k, (ci, lt, opt) in enumerate(zip(
                    bcis, fed_spmd.unstack_tree(sl),
                    fed_spmd.unstack_tree(so))):
                lts[ci], opts[ci] = lt, opt
                results[ci] = (logits[k], n_tok[k])
        return [results[ci] for ci in cis]

    # -- KD b8 ---------------------------------------------------------- #
    def kd_distill(self, program, cis, glob, rnd):
        ctx = self.ctx
        lts, opts = program.lts, program.opts
        for _, bcis in fed_spmd.rank_buckets(ctx.ranks, cis):
            sl = fed_spmd.stack_trees([lts[ci] for ci in bcis])
            so = fed_spmd.stack_trees([opts[ci] for ci in bcis])
            sl, so = _batched_distill(ctx, sl, so, glob, rnd, bcis)
            for ci, lt, opt in zip(bcis, fed_spmd.unstack_tree(sl),
                                   fed_spmd.unstack_tree(so)):
                lts[ci], opts[ci] = lt, opt

    # -- Split c1-c5 ---------------------------------------------------- #
    def split_train(self, program, jobs, rnd):
        """Split's shared server half threads client after client (the
        reference's scan over the client axis), so with uniform ranks the
        stacked program is the sequential executor's: the same
        ``split_step`` on the same batches, in the same order.  A client
        with no full batch raises, as the stacked programs do."""
        fed_spmd.require_full_batch(
            [self.ctx.clients_data[ci] for ci, _ in jobs],
            self.ctx.batch_size)
        return SequentialExecutor.split_train(self, program, jobs, rnd)


def _batched_public_logits(ctx, stacked_lt):
    """b2 for every stacked client at once: the same batch order and
    original-row-order scatter as kd.client_logits, giving (C, N, D) with
    row i holding public sample i's logits."""
    C = tree_lib.leaves(stacked_lt)[0].shape[0]
    outs = [ctx.fns["logits_fn_clients"](
                ctx.base, stacked_lt,
                fed_spmd.repeat_batch(batch, C, ctx.device))
            for batch in epoch_batches(ctx.public, ctx.eval_batch, seed=0,
                                       drop_remainder=False)]
    stacked = torch.cat(outs, dim=1)
    perm = torch.as_tensor(kd_mod._epoch_perm(len(ctx.public["tokens"]), 0),
                           device=stacked.device)
    out = torch.zeros_like(stacked)
    out[:, perm] = stacked
    return out


def _batched_distill(ctx, stacked_lt, stacked_opt, teacher, rnd,
                     client_ids):
    """b8 for every client of a stack at once: kd.distill's batches and
    teacher rows, each client's dropout generator seeded as the
    sequential executor's (seed + 31·rnd + ci)."""
    fed = ctx.fed
    gens = [torch.Generator().manual_seed(fed.seed + 31 * rnd + ci)
            for ci in client_ids]
    C, n = len(client_ids), len(ctx.public["tokens"])
    for ep in range(fed.kd_epochs):
        perm = torch.as_tensor(kd_mod._epoch_perm(n, ep),
                               device=teacher.device)
        start = 0
        for batch in epoch_batches(ctx.public, ctx.eval_batch, seed=ep,
                                   drop_remainder=False):
            b = len(batch["tokens"])
            t = teacher[perm[start:start + b]]
            start += b
            stacked_lt, stacked_opt, _ = ctx.fns["kd_step_clients"](
                ctx.base, stacked_lt, stacked_opt,
                fed_spmd.repeat_batch(batch, C, ctx.device), t, gens)
    return stacked_lt, stacked_opt


EXECUTORS = {"sequential": SequentialExecutor, "spmd": SpmdExecutor}


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
            lt = lora_lib.maybe_truncate_rank(self.global_lt, ctx.ranks[ci],
                                              ctx.fed.lora_rank)
            ctx.ledger.record(rnd, ci, "lora_params", M.DOWN,
                              M.tree_bytes(lt))
            jobs.append((ci, lt))
        return jobs

    def local_update(self, ctx, ex, jobs, rnd):
        outs = ex.train(self, jobs, rnd)
        for (ci, _), (new_lt, n_tok) in zip(jobs, outs):
            ctx.cost[ci].add_train(ctx.cfg, n_tok, lora_lib.n_params(new_lt))
        return [(ci, new_lt) for (ci, _), (new_lt, _) in zip(jobs, outs)]

    def upload(self, ctx, outs, rnd):
        payloads = []
        for ci, lt in outs:
            lt = dp_mod.privatize_tree(lt, dp_mod.noise_generator(ctx.fed,
                                                                  rnd, ci),
                                       ctx.fed.privacy.noise_std)
            ctx.secagg.collect(ctx.secagg_start(rnd, ci), ci, lt)
            ctx.releases[ci] += 1
            payloads.append((ci, lt))
        return payloads

    def record_arrival(self, ctx, job, rnd):
        ctx.ledger.record(rnd, job.client, "lora_params", M.UP,
                          M.tree_bytes(job.payload))
        if ctx.fed.privacy.dp_enabled:
            ctx.ledger.record(rnd, job.client, "dp_meta", M.UP,
                              M.DP_META_BYTES)

    def aggregate(self, ctx, ex, kept, arrived, rnd):
        if kept:
            self.global_lt = stale_weighted_avg(self.global_lt, kept,
                                              ctx.total_w, ctx.fed,
                                              ctx.ranks)

    def evaluate(self, ctx):
        return evaluate(ctx.fns, ctx.base, self.global_lt, ctx.test,
                        ctx.eval_batch, ctx.device)

    def final_state(self, ctx):
        return self.global_lt


class KDProgram:
    """KD-FedLLMs (paper SSII.B): params never cross the wire.  Clients
    upload public-set logits (b3), the server fuses knowledge (b4),
    distills (b5), and re-broadcasts global knowledge (b6-b8).  Every
    client keeps its own LoRA tree, at its own rank, and Adam state across
    rounds."""

    epoch_seed_mult = 991

    def __init__(self, ctx: RoundContext, lora=None):
        fed = ctx.fed
        if lora is None:
            gen = torch.Generator().manual_seed(fed.seed + 2)

            def draw(rank):
                return lora_lib.init_lora(gen, ctx.base, ctx.targets, rank,
                                          fed.lora_alpha)
            lora = {"clients": [draw(r) for r in ctx.ranks],
                    "server": draw(fed.lora_rank)}
        if len(lora["clients"]) != ctx.n_clients:
            raise ValueError(f"lora['clients'] holds {len(lora['clients'])} "
                             f"trees for {ctx.n_clients} clients")
        opt_init = ctx.fns["opt_init"]
        self.lts = list(lora["clients"])
        self.opts = [opt_init(lt) for lt in self.lts]
        self.server_lt = lora["server"]
        self.server_opt = opt_init(self.server_lt)
        self.n_lora = [lora_lib.n_params(lt) for lt in self.lts]
        self.glob = None            # latest global knowledge (b6)
        self.pub_tok = ctx.public["tokens"].size

    def broadcast(self, ctx, cohort, rnd):
        return list(cohort)         # no param download in KD

    def local_update(self, ctx, ex, jobs, rnd):
        outs = ex.kd_train_and_logits(self, jobs, rnd)
        for ci, (_, n_tok) in zip(jobs, outs):
            ctx.cost[ci].add_train(ctx.cfg, n_tok, self.n_lora[ci])
            ctx.cost[ci].add_fwd(ctx.cfg, self.pub_tok)
        return [(ci, logits) for ci, (logits, _) in zip(jobs, outs)]

    def upload(self, ctx, outs, rnd):
        payloads = []
        for ci, logits in outs:
            logits = dp_mod.privatize_logits(
                logits, dp_mod.noise_generator(ctx.fed, rnd, ci), ctx.fed)
            lg, wire = kd_mod.compress_for_wire(logits, ctx.fed)
            ctx.secagg.collect(ctx.secagg_start(rnd, ci), ci, lg)
            ctx.releases[ci] += 1
            payloads.append((ci, (lg, wire)))
        return payloads

    def record_arrival(self, ctx, job, rnd):
        ctx.ledger.record(rnd, job.client, "logits", M.UP, job.payload[1])
        if ctx.fed.privacy.dp_enabled:
            ctx.ledger.record(rnd, job.client, "dp_meta", M.UP,
                              M.DP_META_BYTES)

    def aggregate(self, ctx, ex, kept, arrived, rnd):
        fed = ctx.fed
        if kept:
            ws = [w * staleness_weight(s, fed.staleness_decay)
                  for _, _, s, w in kept]
            teacher = kd_mod.aggregate_knowledge(
                [p[0] for _, p, _, _ in kept], ws)
            self.server_lt, self.server_opt, _ = kd_mod.distill(
                ctx.fns, ctx.base, self.server_lt, self.server_opt,
                ctx.public, teacher, fed.kd_epochs, ctx.eval_batch,
                ctx.device, seed=fed.seed + rnd)
            self.glob = kd_mod.client_logits(ctx.fns, ctx.base,
                                             self.server_lt, ctx.public,
                                             ctx.eval_batch, ctx.device)
        # b6-b8: delivering clients re-sync against the latest knowledge
        if arrived and self.glob is not None:
            glob_wire = kd_mod.logit_wire_bytes(self.glob.shape, fed)
            cis = [j.client for j in arrived]
            for ci in cis:
                ctx.ledger.record(rnd, ci, "logits", M.DOWN, glob_wire)
                ctx.cost[ci].add_train(ctx.cfg, self.pub_tok * fed.kd_epochs,
                                       self.n_lora[ci])
            ex.kd_distill(self, cis, self.glob, rnd)

    def evaluate(self, ctx):
        return evaluate(ctx.fns, ctx.base, self.server_lt, ctx.test,
                        ctx.eval_batch, ctx.device)

    def final_state(self, ctx):
        return self.server_lt


class SplitProgram:
    """Split-FedLLMs (paper SSII.C): c1-c5 split training (activations
    up, gradients down, the server half in the loop) plus the cc1-cc4
    FedAvg of the *client-side* adapters.  ``lora`` is a full-model tree,
    split at L here."""

    epoch_seed_mult = 983

    def __init__(self, ctx: RoundContext, lora=None):
        fed = ctx.fed
        self.sfns = split_mod.make_split_fns(ctx.model, fed, ctx.task)
        L = self.sfns["n_client_groups"]
        n_client = self.sfns["n_client_layers"]
        if lora is None:
            gen = torch.Generator().manual_seed(fed.seed + 3)
            lora = lora_lib.init_lora(gen, ctx.base, ctx.targets,
                                      fed.lora_rank, fed.lora_alpha)
        self.c_global, self.s_lt = split_mod.split_lora(lora, n_client)
        self.base_c, self.base_s = split_mod.split_base(ctx.base, n_client)
        self.s_opt = self.sfns["opt_init"](self.s_lt)
        # the client's share of the model's FLOPs counts pattern groups,
        # not layers, as the reference's does: L / G (on the hybrid 2/8
        # at split_layer 2, where the client holds 6 of 26 layers)
        self.frac_client = L / max(self.sfns["n_groups"], 1)
        self.label_bytes = ctx.batch_size * 4 \
            if "labels" in ctx.clients_data[0] else 0
        self.joined = lora

    def broadcast(self, ctx, cohort, rnd):
        jobs = []
        for ci in cohort:
            c_init = lora_lib.maybe_truncate_rank(
                self.c_global, ctx.ranks[ci], ctx.fed.lora_rank)
            ctx.ledger.record(rnd, ci, "lora_params", M.DOWN,
                              M.tree_bytes(c_init))                    # cc3
            jobs.append((ci, c_init))
        return jobs

    def local_update(self, ctx, ex, jobs, rnd):
        outs = ex.split_train(self, jobs, rnd)
        dp = ctx.fed.privacy.dp_enabled
        res = []
        for (ci, _), (c_lt, n_tok, n_steps, shape) in zip(jobs, outs):
            if n_steps:          # a sub-batch-size client trains 0 steps
                up, down = self.sfns["wire_bytes_per_batch"](shape)
                for _ in range(n_steps):
                    ctx.ledger.record(rnd, ci, "activations", M.UP,
                                      up + self.label_bytes)           # c2
                    ctx.ledger.record(rnd, ci, "act_grads", M.DOWN,
                                      down)                            # c4
                    if dp:
                        ctx.ledger.record(rnd, ci, "dp_meta", M.UP,
                                          M.DP_META_BYTES)
            ctx.releases[ci] += n_steps     # per-client c2 noise events
            ctx.cost[ci].add_train(ctx.cfg, n_tok, lora_lib.n_params(c_lt),
                                   frac_layers=self.frac_client)
            res.append((ci, c_lt))
        return res

    def upload(self, ctx, outs, rnd):
        # the c2 activation noise is Split's DP mechanism (inside the
        # step); the cc1 adapter upload is masked but not noised
        for ci, c_lt in outs:
            ctx.secagg.collect(ctx.secagg_start(rnd, ci), ci, c_lt)
        return outs

    def record_arrival(self, ctx, job, rnd):
        ctx.ledger.record(rnd, job.client, "lora_params", M.UP,
                          M.tree_bytes(job.payload))                   # cc1

    def aggregate(self, ctx, ex, kept, arrived, rnd):
        if kept:                                                       # cc2
            self.c_global = stale_weighted_avg(self.c_global, kept,
                                             ctx.total_w, ctx.fed,
                                             ctx.ranks)
        self.joined = split_mod.join_lora(self.c_global, self.s_lt)

    def evaluate(self, ctx):
        return evaluate(ctx.fns, ctx.base, self.joined, ctx.test,
                        ctx.eval_batch, ctx.device)

    def final_state(self, ctx):
        return self.joined


PROGRAMS = {"fedllm": FedLLMProgram, "kd": KDProgram,
            "split": SplitProgram}


def run_program(model, base, cfg: ModelConfig, fed: FedConfig, targets,
                public: Dict, clients_data: List[Dict], test: Dict,
                task: str, batch_size: int, eval_batch: int, verbose: bool,
                device, lora=None) -> FedResult:
    """Run ``fed.rounds`` rounds of ``fed.framework`` under
    ``fed.aggregation``'s schedule, the clients' local work run by
    ``fed.backend``'s executor.  ``lora`` (optional) is the initial LoRA state: the global
    tree for FedLLM, ``{"server": tree, "clients": [tree, ...]}`` for KD,
    the full-model tree (split at L) for Split."""
    ctx = RoundContext(model, base, cfg, fed, targets, public, clients_data,
                       test, task, batch_size, eval_batch, verbose, device)
    program = PROGRAMS[fed.framework](ctx, lora)
    ex = EXECUTORS[fed.backend](ctx)
    schedule = AsyncSchedule(fed, ctx.n_clients)
    tag = f"{fed.framework}/{ex.backend}" + \
        ("/async" if fed.aggregation == "async" else "")
    for rnd in range(fed.rounds):
        t0 = time.perf_counter()
        # the clients starting this round form its secure-agg cohort
        starters = schedule.starters(rnd)
        ctx.secagg.begin_cohort(ctx.ledger, rnd, starters)
        jobs = program.broadcast(ctx, starters, rnd)
        outs = program.local_update(ctx, ex, jobs, rnd)
        for ci, payload in program.upload(ctx, outs, rnd):
            schedule.submit(rnd, ci, payload)
        kept, delivered, arrived = [], [], []
        for j in schedule.pop_arrivals(rnd):
            arrived.append(j)
            program.record_arrival(ctx, j, rnd)
            s = rnd - j.start
            if s <= fed.max_staleness:
                kept.append((j.client, j.payload, s, ctx.data_w[j.client]))
                delivered.append((j.start, j.client))
            else:
                ctx.secagg.discard(j.start, j.client)
        ctx.secagg.deliver(ctx.ledger, rnd, delivered)
        program.aggregate(ctx, ex, kept, arrived, rnd)
        acc, loss = program.evaluate(ctx)
        ctx.history.append(M.RoundMetrics(
            rnd, acc, loss, ctx.ledger.mean_client_bytes_per_round(),
            float(np.mean([c.flops for c in ctx.cost])) if ctx.cost else 0.0,
            epsilon=round_epsilon(ctx.acct, max(ctx.releases, default=0)),
            seconds=time.perf_counter() - t0))
        if verbose:
            print(f"[{tag}] round {rnd}: acc={acc:.4f} loss={loss:.4f}"
                  + (f" arrived={len(arrived)}"
                     if fed.aggregation == "async" else ""))
    return FedResult(ctx.history, ctx.ledger, program.final_state(ctx),
                     [c.flops for c in ctx.cost])
