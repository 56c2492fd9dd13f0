"""The federated round pipeline:

    broadcast -> local_update -> upload -> aggregate -> evaluate

Counterpart of the parts of ``src/repro/core/round_program.py`` that run
FedLLM, KD-FedLLM and Split-FedLLM: ``RoundContext`` (with each client's
LoRA rank, core/heterogeneous.normalize_ranks), the ``SyncSchedule``
(every client starts a job each round, its upload arriving that round
or, as a straggler, later) and the ``AsyncSchedule``
(core/async_agg.ParticipationSchedule's seeded delays), the
``SequentialExecutor`` (a Python loop over clients, one train step per
batch), the ``SpmdExecutor`` (the round's ready set stacked on a
leading axis, one stacked program per rank bucket: core/fed_spmd.py), the
``CohortStreamingExecutor`` (``backend="cohort"``: the ready set streamed
through the spmd executor ``FedConfig.cohort_size`` clients at a time,
the partial aggregates folded between chunks, each chunk its own
secure-aggregation cohort, clients drawn from a lazy
data/population.ClientPopulation, and under ``FedConfig.n_edges > 1``
the ledger split into a client->edge and an edge->server hop), the
``FedLLMProgram``, ``KDProgram`` and ``SplitProgram`` stage-specs (a
client below the global rank gets the global tree truncated to its rank,
and its upload is harmonized by ``FedConfig.hetero_agg``) and
``run_program`` with its middleware, the same under every executor and
aggregation: privacy (upload noise, secure-aggregation masking around
aggregation, the RDP accountant), fault tolerance (faults/: seeded
dropout, straggler delay and Byzantine corruption at the upload seam;
the finite check and the norm screen over each round's arrivals, which
quarantine offenders; the quorum rollover), the robust combines of
``FedConfig.robust_agg`` in each program's aggregate stage, and
checkpoint and resume (checkpoint/federated.py).  Ledger bytes are
derived from payload shapes, so they equal the reference's exactly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.checkpoint import federated as fed_ckpt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import FedConfig, ModelConfig
from repro_torch.core import fed_spmd
from repro_torch.core.async_agg import (ParticipationSchedule, _Job,
                                        _pop_arrivals, combine_arrivals,
                                        staleness_weight)
from repro_torch.core.heterogeneous import normalize_ranks
from repro_torch.core import kd as kd_mod
from repro_torch.core import metrics as M
from repro_torch.core import rng as rng_mod
from repro_torch.core import split as split_mod
from repro_torch import tree as tree_lib
from repro_torch.core.fedavg import evaluate, make_fns, to_device
from repro_torch.core.rng import local_generator
from repro_torch.data import population as population_mod
from repro_torch.data.loader import epoch_batches
from repro_torch.faults import guard as fault_guard
from repro_torch.faults.plan import FaultPlan
from repro_torch.peft import lora as lora_lib
from repro_torch.privacy import dp as dp_mod
from repro_torch.privacy.accountant import GaussianAccountant
from repro_torch.privacy.secure_agg import SecureAggSession
from repro_torch.runtime import compute_dtype


@dataclasses.dataclass
class FedResult:
    history: List[M.RoundMetrics]
    ledger: M.CommLedger
    final_lora: Dict
    client_flops: List[float]
    # rounds that missed the participation quorum and rolled over with
    # the global state unchanged (0 without a quorum)
    rollovers: int = 0

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


class RoundContext:
    """Run-wide state shared by the stages: config, data, the train and
    eval steps, the ledger, the per-client cost model and the privacy
    middleware (accountant, secure-agg session, per-client release
    counts).  ``clients_data`` is a ClientPopulation (a list of shards is
    wrapped in one): a lazy population builds a client's shard only when
    a stage reads ``clients_data[ci]``."""

    def __init__(self, model, base, cfg: ModelConfig, fed: FedConfig,
                 targets, public, clients_data, test, task, batch_size,
                 eval_batch, verbose, device):
        self.model, self.base, self.cfg, self.fed = model, base, cfg, fed
        self.targets, self.public, self.test = targets, public, test
        self.clients_data = population_mod.as_population(clients_data)
        self.task, self.device, self.verbose = task, device, verbose
        self.batch_size, self.eval_batch = batch_size, eval_batch
        self.n_clients = len(self.clients_data)
        self.fns = make_fns(model, fed, task)
        self.ledger = M.CommLedger()
        self.history: List[M.RoundMetrics] = []
        self.cost = [M.ClientCost() for _ in range(self.n_clients)]
        # each client's sample count from the population, no shard built
        self.data_w = self.clients_data.data_weights()
        self.total_w = float(sum(self.data_w))
        # the worst-case (largest) per-step subsampling rate over clients,
        # q_i = batch_size / |client i's data| clamped to 1, from the weights
        self.acct = make_accountant(
            fed, max(min(1.0, batch_size / max(w, 1)) for w in self.data_w))
        self.secagg = SecureAggSession(fed)
        self.releases = [0] * self.n_clients   # noisy uploads per client
        self.ranks = normalize_ranks(fed.client_ranks, self.n_clients,
                                     fed.lora_rank)
        # (rnd, ci) -> the secure-agg masking cohort of a streamed chunk
        # (run_program's streaming branch); empty under the flat engines
        self._cohort_ids: Dict[tuple, int] = {}

    def secagg_start(self, rnd: int, ci: int) -> int:
        """The secure-agg cohort key of client ``ci``'s job started in
        ``rnd``: its chunk's cohort id under cohort streaming, the start
        round everywhere else."""
        return self._cohort_ids.get((rnd, ci), rnd)


class SyncSchedule:
    """The paper-literal parameter-server round: every client starts a job
    each round and its upload arrives the same round.  The jobs in flight
    are a list, so a straggler's late job and its next one can both be in
    flight."""

    def __init__(self, fed: FedConfig, n_clients: int):
        self.n = n_clients
        self._pending: List[_Job] = []

    def starters(self, rnd: int) -> List[int]:
        return list(range(self.n))

    def submit(self, rnd: int, ci: int, payload, extra_delay: int = 0):
        """``extra_delay``: a fault-injected straggler's lag; the upload
        arrives that many rounds late and is weighted by its staleness
        like any async arrival."""
        self._pending.append(_Job(ci, rnd, rnd + extra_delay, payload))

    def pop_arrivals(self, rnd: int) -> List[_Job]:
        out = sorted((j for j in self._pending if j.arrival == rnd),
                     key=lambda j: j.client)
        self._pending = [j for j in self._pending if j.arrival != rnd]
        return out

    # -- checkpoint/resume (checkpoint/federated.py) --------------------- #
    def jobs(self) -> List[_Job]:
        return list(self._pending)

    def load_jobs(self, jobs):
        self._pending = list(jobs)

    def rng_state(self):
        return None

    def load_rng_state(self, state):
        pass


class AsyncSchedule:
    """FedAsync-style participation: a free client starts a job (pulls
    the current global, trains now) and its upload is in flight for a
    seeded delay a job (core/async_agg.ParticipationSchedule, seeded with
    ``fed.seed + 17`` as the reference's); ``max_staleness`` 0 makes
    every delay 0 and the run the sync one."""

    def __init__(self, fed: FedConfig, n_clients: int):
        self.n = n_clients
        self.sched = ParticipationSchedule(n_clients, fed.seed + 17,
                                           fed.max_staleness)
        self.in_flight: Dict[int, _Job] = {}

    def starters(self, rnd: int) -> List[int]:
        return [ci for ci in range(self.n) if ci not in self.in_flight]

    def submit(self, rnd: int, ci: int, payload, extra_delay: int = 0):
        self.in_flight[ci] = _Job(
            ci, rnd, rnd + self.sched.next_delay(ci) + extra_delay, payload)

    def pop_arrivals(self, rnd: int) -> List[_Job]:
        return _pop_arrivals(self.in_flight, rnd)

    # -- checkpoint/resume (checkpoint/federated.py) --------------------- #
    def jobs(self) -> List[_Job]:
        return [self.in_flight[ci] for ci in sorted(self.in_flight)]

    def load_jobs(self, jobs):
        self.in_flight = {j.client: j for j in jobs}

    def rng_state(self):
        return self.sched.state()

    def load_rng_state(self, state):
        self.sched.load_state(state)


def make_schedule(fed: FedConfig, n_clients: int):
    return (SyncSchedule if fed.aggregation == "sync"
            else AsyncSchedule)(fed, n_clients)


class SequentialExecutor:
    """Python loop over clients, one train step per batch — the
    paper-literal reference and the numerical ground truth."""

    backend = "sequential"
    streaming = False

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
    streaming = False

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
                    fed_spmd.unstack_tree(so, len(bcis)))):
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
                                   fed_spmd.unstack_tree(so, len(bcis))):
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


class CohortStreamingExecutor(SpmdExecutor):
    """``backend="cohort"``: the per-chunk work is the spmd executor's;
    run_program streams the round's ready set through it
    ``FedConfig.cohort_size`` clients at a time and folds the partial
    aggregates between chunks (the programs' ``agg_fold``), so peak
    memory is one cohort's."""

    backend = "cohort"
    streaming = True


# -- streaming partial-aggregate folds -------------------------------------- #
def _fold_zeros(tree):
    """A zero accumulator like ``tree``: fp32 (fp64 for fp64 leaves)."""
    return tree_lib.map_(
        lambda x: torch.zeros(x.shape, dtype=compute_dtype(x.dtype),
                              device=x.device), tree)


@torch.no_grad()
def _fold_add(acc, tree, w: float):
    """acc + w·tree leaf by leaf in the accumulator's precision, ``w``
    rounded to it: two roundings, the product's and the sum's (the
    reference's ``a + w * x``; no fused multiply-add)."""
    first = tree_lib.leaves(acc)[:1]
    if not first:
        return acc
    wt = first[0].new_tensor(w)
    return tree_lib.map_(lambda a, x: a + wt * x.to(a.dtype), acc, tree)


def _cohort_chunks(seq, size: int):
    """A client-id or job sequence in cohorts of ``size`` (<= 0: one
    chunk)."""
    seq = list(seq)
    if size <= 0 or size >= len(seq):
        return [seq] if seq else []
    return [seq[i:i + size] for i in range(0, len(seq), size)]


def _cohort_uid(rnd: int, idx: int) -> int:
    """The masking-cohort id of chunk ``idx`` of round ``rnd``: it keys the
    secure-agg cohorts and seeds their pairwise masks, unique over a run
    (a round's chunks stay far below the stride)."""
    return rnd * 1_000_003 + idx


def _stream_fold_params(ctx, state, kept, global_tree):
    """FedLLM's a4 and Split's cc2 under streaming: one chunk of arrivals
    into the running staleness-weighted sum of parameters.  zeropad
    harmonization is linear leaf by leaf, so it streams in one
    accumulator; svd's re-factorization and the robust combines' order
    statistics are not, so under them the round's arrivals are kept
    instead (O(arrivals this round))."""
    fed = ctx.fed
    if not kept:
        return state
    if fed.robust_agg != "mean" or (
            fed.hetero_agg == "svd" and any(r != fed.lora_rank
                                            for r in ctx.ranks)):
        if state is None:
            state = ("buf", [])
        state[1].extend(kept)
        return state
    if state is None:
        state = ("sum", _fold_zeros(global_tree), 0.0, 0.0)
    _, acc, w_sum, raw = state
    for ci, tree, s, w in kept:
        if ctx.ranks[ci] != fed.lora_rank:
            tree = lora_lib.pad_rank(tree, fed.lora_rank)
        ws = w * staleness_weight(s, fed.staleness_decay)
        acc = _fold_add(acc, tree, ws)
        w_sum += ws
        raw += w
    return ("sum", acc, w_sum, raw)


@torch.no_grad()
def _finalize_param_fold(ctx, state, global_tree):
    """Closes a ``_stream_fold_params`` round: the data weight of the
    clients that delivered nothing anchors the current global (the convex
    combination ``stale_weighted_avg`` forms), then the sum is divided by
    the total weight, rounded to the accumulator's precision.  Returns
    the new global tree, ``global_tree`` itself when nothing was kept."""
    if state is None:
        return global_tree
    if state[0] == "buf":
        return combine_arrivals(global_tree, state[1], ctx.total_w,
                                ctx.fed, ctx.ranks)
    _, acc, w_sum, raw = state
    absent = ctx.total_w - raw
    if absent > 0:
        acc = _fold_add(acc, global_tree, absent)
        w_sum += absent
    return tree_lib.map_(lambda a, g: (a / a.new_tensor(w_sum)).to(g.dtype),
                         acc, global_tree)


class _LazyClientState:
    """List-like per-client state built on first touch by ``factory(ci)``:
    under cohort streaming over a lazy population only the clients that
    take part are ever built (KD keeps each client's adapter after its
    cohort: the one per-client state the port holds)."""

    def __init__(self, n: int, factory):
        self._n = int(n)
        self._factory = factory
        self._vals: Dict[int, object] = {}

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, ci):
        if ci not in self._vals:
            self._vals[ci] = self._factory(ci)
        return self._vals[ci]

    def __setitem__(self, ci, val):
        self._vals[ci] = val


EXECUTORS = {"sequential": SequentialExecutor, "spmd": SpmdExecutor,
             "cohort": CohortStreamingExecutor}


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

    def payload_bytes(self, ctx, payload) -> int:
        return M.tree_bytes(payload)

    def payload_arrays(self, payload):
        return tree_lib.leaves(payload)

    def aggregate(self, ctx, ex, kept, arrived, rnd):
        if kept:
            self.global_lt = combine_arrivals(self.global_lt, kept,
                                              ctx.total_w, ctx.fed,
                                              ctx.ranks)

    # -- streaming a4 (cohort executor): fold chunks, finalize once ---- #
    def agg_init(self, ctx):
        return None

    def agg_fold(self, ctx, ex, state, kept, rnd):
        return _stream_fold_params(ctx, state, kept, self.global_lt)

    def agg_finalize(self, ctx, ex, state, arrived, rnd):
        self.global_lt = _finalize_param_fold(ctx, state, self.global_lt)

    def edge_payload_bytes(self, ctx) -> int:
        return M.tree_bytes(self.global_lt)

    def evaluate(self, ctx):
        return evaluate(ctx.fns, ctx.base, self.global_lt, ctx.test,
                        ctx.eval_batch, ctx.device)

    def final_state(self, ctx):
        return self.global_lt

    # -- checkpoint/resume (checkpoint/federated.py) --------------------- #
    def state_dict(self, ctx):
        return {"global_lt": self.global_lt}

    def load_state_dict(self, ctx, st):
        self.global_lt = st["global_lt"]

    @staticmethod
    def spmd_round(model, fed: FedConfig, task: str = "classification",
                   n_edges: int = 1):
        """The whole-round program of the launch layer: the stacked local
        update, then the client-axis FedAvg (the two-hop
        ``fed_spmd.hierarchical_client_mean`` when ``n_edges > 1``)."""
        return fed_spmd.make_spmd_round(model, fed, task, n_edges=n_edges)


class KDProgram:
    """KD-FedLLMs (paper SSII.B): params never cross the wire.  Clients
    upload public-set logits (b3), the server fuses knowledge (b4),
    distills (b5), and re-broadcasts global knowledge (b6-b8).  Every
    client keeps its own LoRA tree, at its own rank, and Adam state across
    rounds, each built when the client first takes part.

    Without ``lora`` the trees are drawn from ``fed.seed + 2``: over a
    list of shards (an EagerPopulation) the clients' trees one after
    another from one generator, then the server's; over a lazy population
    the server's from that generator and client ``ci``'s from a generator
    of its own, seeded with the words of core/rng.fold_chain(fed.seed + 2,
    ci), so that building one client builds no other."""

    epoch_seed_mult = 991

    def __init__(self, ctx: RoundContext, lora=None):
        fed = ctx.fed
        if lora is None:
            gen = torch.Generator().manual_seed(fed.seed + 2)

            def draw(g, rank):
                return lora_lib.init_lora(g, ctx.base, ctx.targets, rank,
                                          fed.lora_alpha)
            if isinstance(ctx.clients_data, population_mod.EagerPopulation):
                lora = {"clients": [draw(gen, r) for r in ctx.ranks]}
                lora["server"] = draw(gen, fed.lora_rank)
                clients = lora["clients"].__getitem__
            else:
                lora = {"server": draw(gen, fed.lora_rank)}

                def clients(ci):
                    hi, lo = rng_mod.fold_chain(fed.seed + 2, ci)
                    return draw(torch.Generator().manual_seed(hi << 32 | lo),
                                ctx.ranks[ci])
        else:
            if len(lora["clients"]) != ctx.n_clients:
                raise ValueError(
                    f"lora['clients'] holds {len(lora['clients'])} trees "
                    f"for {ctx.n_clients} clients")
            clients = list(lora["clients"]).__getitem__
        opt_init = ctx.fns["opt_init"]
        self.lts = _LazyClientState(ctx.n_clients, clients)
        self.opts = _LazyClientState(ctx.n_clients,
                                     lambda ci: opt_init(self.lts[ci]))
        self.server_lt = lora["server"]
        self.server_opt = opt_init(self.server_lt)
        self.n_lora = _LazyClientState(
            ctx.n_clients, lambda ci: lora_lib.n_params(self.lts[ci]))
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

    def payload_bytes(self, ctx, payload) -> int:
        return payload[1]

    def payload_arrays(self, payload):
        return [payload[0]]

    @staticmethod
    def _robust_teacher(ctx, kept):
        """b4 under a robust combine: order statistics over the stacked
        client logits instead of the weighted mean."""
        fed = ctx.fed
        stacked = torch.stack([p[0].float() for _, p, _, _ in kept])
        ws = [w * staleness_weight(s, fed.staleness_decay)
              for _, _, s, w in kept]
        return fed_spmd.robust_client_combine(
            stacked, torch.tensor(ws, dtype=torch.float32,
                                  device=stacked.device),
            fed.robust_agg, fed.trim_frac, fed.clip_norm)

    def aggregate(self, ctx, ex, kept, arrived, rnd):
        fed = ctx.fed
        if kept:
            if fed.robust_agg != "mean":
                teacher = self._robust_teacher(ctx, kept)
            else:
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

    # -- streaming b4-b8 (cohort executor) ----------------------------- #
    def agg_init(self, ctx):
        return None

    def agg_fold(self, ctx, ex, state, kept, rnd):
        """One chunk of arrivals' logits into the running b4 teacher sum
        (the weighted mean is linear, so it streams exactly).  A robust
        combine is not linear, so under one the round's arrivals are kept
        instead (O(arrivals this round), as svd's harmonization)."""
        if not kept:
            return state
        if ctx.fed.robust_agg != "mean":
            if state is None:
                state = ("buf", [])
            state[1].extend(kept)
            return state
        acc, w_sum = state if state is not None else (None, 0.0)
        for _, p, s, w in kept:
            ws = w * staleness_weight(s, ctx.fed.staleness_decay)
            acc = _fold_add(acc if acc is not None else _fold_zeros(p[0]),
                            p[0], ws)
            w_sum += ws
        return acc, w_sum

    def agg_finalize(self, ctx, ex, state, arrived, rnd):
        """b5: the server distills the normalized teacher; then b6-b8
        streamed over the arrived clients in cohort-sized chunks (one
        stacked distillation a chunk)."""
        fed = ctx.fed
        if state is not None and isinstance(state[0], str):   # robust buffer
            state = (self._robust_teacher(ctx, state[1]), 1.0)
        if state is not None and state[1] > 0:
            acc, w_sum = state
            with torch.no_grad():
                teacher = (acc / acc.new_tensor(w_sum)).float()
            self.server_lt, self.server_opt, _ = kd_mod.distill(
                ctx.fns, ctx.base, self.server_lt, self.server_opt,
                ctx.public, teacher, fed.kd_epochs, ctx.eval_batch,
                ctx.device, seed=fed.seed + rnd)
            self.glob = kd_mod.client_logits(ctx.fns, ctx.base,
                                             self.server_lt, ctx.public,
                                             ctx.eval_batch, ctx.device)
        if arrived and self.glob is not None:
            glob_wire = kd_mod.logit_wire_bytes(self.glob.shape, fed)
            for chunk in _cohort_chunks(arrived, fed.cohort_size):
                for ci in chunk:
                    ctx.ledger.record(rnd, ci, "logits", M.DOWN, glob_wire)
                    ctx.cost[ci].add_train(ctx.cfg,
                                           self.pub_tok * fed.kd_epochs,
                                           self.n_lora[ci])
                ex.kd_distill(self, chunk, self.glob, rnd)

    def edge_payload_bytes(self, ctx) -> int:
        if self.glob is None:
            return 0
        return kd_mod.logit_wire_bytes(self.glob.shape, ctx.fed)

    def evaluate(self, ctx):
        return evaluate(ctx.fns, ctx.base, self.server_lt, ctx.test,
                        ctx.eval_batch, ctx.device)

    def final_state(self, ctx):
        return self.server_lt

    # -- checkpoint/resume (checkpoint/federated.py) --------------------- #
    def state_dict(self, ctx):
        """Only the clients built so far are saved: the others are built
        on resume as they would have been."""
        return {"lts": dict(self.lts._vals), "opts": dict(self.opts._vals),
                "server_lt": self.server_lt, "server_opt": self.server_opt,
                "glob": self.glob}

    def load_state_dict(self, ctx, st):
        self.lts._vals = dict(st["lts"])
        self.opts._vals = dict(st["opts"])
        self.server_lt = st["server_lt"]
        self.server_opt = st["server_opt"]
        self.glob = st["glob"]

    @staticmethod
    def spmd_round(model, fed: FedConfig, task: str = "classification"):
        """The whole-round program of the launch layer: returns
        kd_round_core(base, slt, sopt, server_lt, server_opt, batches,
        gens, valid, weights, public_batch, client_gens, server_gen[,
        noise_gens]) -> (slt, sopt, server_lt, server_opt): the stacked
        b1 local update, b2 every client's logits on ``public_batch``
        (with the b3 mechanism under DP), b4 the client-axis knowledge
        reduction (``kd.aggregate_knowledge_batched``, or the robust
        combine), b5 the server's distillation step, b6 its logits and
        b8 every client's distillation step against them.  ``gens``
        draws each client's b1 dropout masks, ``client_gens`` its b8
        ones, ``server_gen`` the server's; under DP noise
        ``noise_gens`` holds one b3 generator a client."""
        fns = make_fns(model, fed, task)
        local_update = fed_spmd.make_local_update(model, fed, task, fns)
        noised = fed.privacy.noise_std > 0.0

        def kd_round_core(base, slt, sopt, server_lt, server_opt, batches,
                          gens, valid, weights, public_batch, client_gens,
                          server_gen, noise_gens=None):
            device = tree_lib.leaves(slt)[0].device
            C = tree_lib.leaves(slt)[0].shape[0]
            slt, sopt, _ = local_update(base, slt, sopt, batches, valid,
                                        gens, device)
            pub = fed_spmd.batches_on(public_batch, device)
            pub_c = {k: torch.cat([v] * C) for k, v in pub.items()}
            logits = fns["logits_fn_clients"](base, slt, pub_c)  # (C, Bp, D)
            if fed.privacy.dp_enabled:
                logits = torch.stack([
                    dp_mod.privatize_rows(lg, noise_gens[c] if noised
                                          else None, fed)
                    for c, lg in enumerate(logits)])
            weights = torch.as_tensor(weights, dtype=torch.float32)
            if fed.robust_agg != "mean":
                teacher = fed_spmd.robust_client_combine(
                    logits.to(compute_dtype(logits.dtype)), weights,
                    fed.robust_agg, fed.trim_frac, fed.clip_norm)
            else:
                teacher = kd_mod.aggregate_knowledge_batched(logits, weights)
            server_lt, server_opt, _ = fns["kd_step"](
                base, server_lt, server_opt, pub, teacher, server_gen)
            glob = fns["logits_fn"](base, server_lt, pub)
            slt, sopt, _ = fns["kd_step_clients"](base, slt, sopt, pub_c,
                                                  glob, client_gens)
            return slt, sopt, server_lt, server_opt

        return kd_round_core


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
        self.base_c, self.base_s = split_mod.split_base(
            ctx.base, n_client, self.sfns["enc_dec"])
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

    def payload_bytes(self, ctx, payload) -> int:
        return M.tree_bytes(payload)

    def payload_arrays(self, payload):
        return tree_lib.leaves(payload)

    def aggregate(self, ctx, ex, kept, arrived, rnd):
        if kept:                                                       # cc2
            self.c_global = combine_arrivals(self.c_global, kept,
                                             ctx.total_w, ctx.fed,
                                             ctx.ranks)
        self.joined = split_mod.join_lora(self.c_global, self.s_lt)

    # -- streaming cc2 (cohort executor) ------------------------------- #
    def agg_init(self, ctx):
        return None

    def agg_fold(self, ctx, ex, state, kept, rnd):
        return _stream_fold_params(ctx, state, kept, self.c_global)

    def agg_finalize(self, ctx, ex, state, arrived, rnd):
        self.c_global = _finalize_param_fold(ctx, state, self.c_global)
        self.joined = split_mod.join_lora(self.c_global, self.s_lt)

    def edge_payload_bytes(self, ctx) -> int:
        return M.tree_bytes(self.c_global)

    def evaluate(self, ctx):
        return evaluate(ctx.fns, ctx.base, self.joined, ctx.test,
                        ctx.eval_batch, ctx.device)

    def final_state(self, ctx):
        return self.joined

    # -- checkpoint/resume (checkpoint/federated.py) --------------------- #
    def state_dict(self, ctx):
        return {"c_global": self.c_global, "s_lt": self.s_lt,
                "s_opt": self.s_opt}

    def load_state_dict(self, ctx, st):
        self.c_global, self.s_lt = st["c_global"], st["s_lt"]
        self.s_opt = st["s_opt"]
        self.joined = split_mod.join_lora(self.c_global, self.s_lt)

    @staticmethod
    def spmd_round(model, fed: FedConfig, task: str = "generative",
                   sfns=None):
        """The whole-round program of the launch layer: the client halves
        stacked, the server half carried over the clients in order, the
        closing cc2 combine (``fed_spmd.make_split_spmd_round``)."""
        return fed_spmd.make_split_spmd_round(model, fed, task, sfns=sfns)


PROGRAMS = {"fedllm": FedLLMProgram, "kd": KDProgram,
            "split": SplitProgram}


class _Seam:
    """The upload-seam middleware of ``run_program``, the reference's
    ``_submit``, ``_screen`` and ``_quarantine``: with ``fed.faults`` on,
    a seeded FaultPlan corrupts, drops or delays uploads; every arrival
    then passes the finite check and, with ``fed.screen_factor > 0``, the
    norm screen, and an offender is quarantined."""

    def __init__(self, ctx, program, schedule):
        self.ctx, self.program, self.schedule = ctx, program, schedule
        self.plan = FaultPlan(ctx.fed, ctx.n_clients) \
            if ctx.fed.faults.enabled else None

    def submit(self, outs, rnd):
        """Corruption happens before the upload stage, so the noise, the
        compression and the secure-agg masking all act on what a corrupt
        client sends; a dropped upload is lost after it (its bytes were
        spent: charged as ``retransmit``, its mask discarded); a
        straggler's upload arrives ``extra_delay`` rounds late."""
        ctx, plan = self.ctx, self.plan
        if plan is not None:
            outs = [(ci, plan.corrupt(p, rnd, ci)) for ci, p in outs]
        for ci, payload in self.program.upload(ctx, outs, rnd):
            if plan is not None and plan.dropped(rnd, ci):
                ctx.ledger.record(rnd, ci, "retransmit", M.UP,
                                  self.program.payload_bytes(ctx, payload))
                ctx.secagg.discard(ctx.secagg_start(rnd, ci), ci)
                continue
            extra = plan.extra_delay(rnd, ci) if plan is not None else 0
            self.schedule.submit(rnd, ci, payload, extra)

    def screen(self, arrivals):
        """The verdicts on the whole round's arrivals at once (the norm
        screen's median is the round's, so the flat and the streamed
        rounds quarantine the same set)."""
        if not arrivals:
            return []
        return fault_guard.screen(
            [self.program.payload_arrays(j.payload) for j in arrivals],
            self.ctx.fed.screen_factor)

    def quarantine(self, j, rnd):
        ctx = self.ctx
        ctx.ledger.record(rnd, j.client, "quarantine", M.UP,
                          self.program.payload_bytes(ctx, j.payload))
        ctx.secagg.discard(ctx.secagg_start(j.start, j.client), j.client)


def _below_quorum(fed, n_kept: int, starters) -> bool:
    """A round whose kept arrivals fall below ``fed.quorum`` times its
    starters rolls over: its masks settle and nothing folds."""
    return bool(fed.quorum > 0 and starters
                and n_kept < fed.quorum * len(starters))


def _flat_round(ctx, program, ex, seam, rnd):
    """One round of the sequential and spmd executors.  Returns (clients
    that arrived, whether the round rolled over)."""
    fed = ctx.fed
    # the clients starting this round form its secure-agg cohort
    starters = seam.schedule.starters(rnd)
    ctx.secagg.begin_cohort(ctx.ledger, rnd, starters)
    jobs = program.broadcast(ctx, starters, rnd)
    seam.submit(program.local_update(ctx, ex, jobs, rnd), rnd)
    arrivals = seam.schedule.pop_arrivals(rnd)
    kept, delivered, arrived = [], [], []
    for j, good in zip(arrivals, seam.screen(arrivals)):
        if not good:
            seam.quarantine(j, rnd)
            continue
        arrived.append(j)
        program.record_arrival(ctx, j, rnd)
        s = rnd - j.start
        if s <= fed.max_staleness:
            kept.append((j.client, j.payload, s, ctx.data_w[j.client]))
            delivered.append((j.start, j.client))
        else:
            ctx.secagg.discard(j.start, j.client)
    ctx.secagg.deliver(ctx.ledger, rnd, delivered)
    roll = _below_quorum(fed, len(kept), starters)
    if roll:
        kept, arrived = [], []
    program.aggregate(ctx, ex, kept, arrived, rnd)
    return len(arrived), roll


def _streamed_round(ctx, program, ex, seam, rnd, n_edges):
    """One round of the cohort-streaming executor: the starters stream
    through the executor a chunk at a time, each chunk its own
    secure-agg masking cohort; the whole round's arrivals are screened
    at once, then grouped by masking cohort (in insertion order), each
    group delivered and folded into the running aggregate before the
    next, then the round is finalized once.  Under ``n_edges > 1`` group
    g goes to edge g mod n_edges, and each edge that aggregated a group
    forwards one fused payload up and pulls the new global down
    (negative client ids: the edge aggregators).  Returns (clients that
    arrived, whether the round rolled over)."""
    fed, schedule = ctx.fed, seam.schedule
    starters = schedule.starters(rnd)
    for k, chunk in enumerate(_cohort_chunks(starters, fed.cohort_size)):
        cid = _cohort_uid(rnd, k)
        for ci in chunk:
            ctx._cohort_ids[(rnd, ci)] = cid
        ctx.secagg.begin_cohort(ctx.ledger, rnd, chunk, cohort_id=cid)
        jobs = program.broadcast(ctx, chunk, rnd)
        seam.submit(program.local_update(ctx, ex, jobs, rnd), rnd)
    arrivals = schedule.pop_arrivals(rnd)
    ok = seam.screen(arrivals)
    roll = _below_quorum(
        fed, sum(1 for j, good in zip(arrivals, ok)
                 if good and rnd - j.start <= fed.max_staleness), starters)
    groups: Dict[int, List] = {}
    for j, good in zip(arrivals, ok):
        groups.setdefault(ctx.secagg_start(j.start, j.client),
                          []).append((j, good))
    state = program.agg_init(ctx)
    arrived, used_edges = [], set()
    for gi, (gkey, gjobs) in enumerate(groups.items()):
        kept, delivered = [], []
        for j, good in gjobs:
            if not good:
                seam.quarantine(j, rnd)
                continue
            arrived.append(j.client)
            program.record_arrival(ctx, j, rnd)
            s = rnd - j.start
            if s <= fed.max_staleness:
                kept.append((j.client, j.payload, s, ctx.data_w[j.client]))
                delivered.append((gkey, j.client))
            else:
                ctx.secagg.discard(gkey, j.client)
        ctx.secagg.deliver(ctx.ledger, rnd, delivered)
        if not roll:
            state = program.agg_fold(ctx, ex, state, kept, rnd)
        used_edges.add(gi % n_edges)
    if roll:
        # the cohort's payloads were received and their masks settled,
        # but nothing folds into the global state
        state, arrived = None, []
    program.agg_finalize(ctx, ex, state, arrived, rnd)
    if n_edges > 1 and arrived:
        eb = program.edge_payload_bytes(ctx)
        for e in sorted(used_edges):
            for direction in (M.UP, M.DOWN):
                ctx.ledger.record(rnd, -(e + 1), "edge_agg", direction, eb,
                                  hop=M.EDGE_SERVER)
    return len(arrived), roll


def run_program(model, base, cfg: ModelConfig, fed: FedConfig, targets,
                public: Dict, clients_data, test: Dict, task: str,
                batch_size: int, eval_batch: int, verbose: bool, device,
                lora=None, checkpoint_every: int = 0,
                checkpoint_dir: str = None,
                resume_from: str = None) -> FedResult:
    """Run ``fed.rounds`` rounds of ``fed.framework`` under
    ``fed.aggregation``'s schedule, the clients' local work run by
    ``fed.backend``'s executor (``cohort``: a round streamed through the
    spmd executor, _streamed_round).  ``clients_data`` is a
    ClientPopulation or a list of shards.  ``lora`` (optional) is the
    initial LoRA state: the global tree for FedLLM, ``{"server": tree,
    "clients": [tree, ...]}`` for KD, the full-model tree (split at L)
    for Split.

    Fault tolerance: with ``fed.faults`` on, a seeded FaultPlan drops,
    delays or corrupts uploads at the seam between local_update and
    upload (_Seam); every arrival then passes the finite check and the
    optional norm screen, offenders are quarantined (ledger
    ``quarantine`` events; their masks discarded, so the cohort's
    survivors recover them as for any absent member), and a round whose
    kept arrivals fall below ``fed.quorum`` times its starters rolls
    over with the global state unchanged (``FedResult.rollovers``).

    Crash recovery: ``checkpoint_every > 0`` snapshots the whole run
    state into ``checkpoint_dir`` after every k-th round
    (checkpoint/federated.py); ``resume_from`` restores the latest
    snapshot of a directory and continues, to the same ledger, history
    and final state bit for bit as the run that was not interrupted
    (but for ``RoundMetrics.seconds``, wall time)."""
    ctx = RoundContext(model, base, cfg, fed, targets, public, clients_data,
                       test, task, batch_size, eval_batch, verbose, device)
    program = PROGRAMS[fed.framework](ctx, lora)
    ex = EXECUTORS[fed.backend](ctx)
    schedule = make_schedule(fed, ctx.n_clients)
    seam = _Seam(ctx, program, schedule)
    n_edges = (fed.n_edges or 1) if ex.streaming else 1
    if n_edges > 1:
        # two hops: every per-client wire event is the client -> edge hop
        ctx.ledger.default_hop = M.CLIENT_EDGE
    tag = f"{fed.framework}/{ex.backend}" + \
        ("/async" if fed.aggregation == "async" else "")
    mgr = None
    if checkpoint_every and checkpoint_every > 0:
        if not checkpoint_dir:
            raise ValueError("checkpoint_every requires checkpoint_dir")
        mgr = CheckpointManager(checkpoint_dir)
    start_rnd, rollovers = 0, 0
    if resume_from:
        start_rnd, rollovers = fed_ckpt.restore_run(resume_from, ctx,
                                                    program, schedule)
    for rnd in range(start_rnd, fed.rounds):
        t0 = time.perf_counter()
        if ex.streaming:
            n_arrived, roll = _streamed_round(ctx, program, ex, seam, rnd,
                                              n_edges)
        else:
            n_arrived, roll = _flat_round(ctx, program, ex, seam, rnd)
        rollovers += roll
        acc, loss = program.evaluate(ctx)
        ctx.history.append(M.RoundMetrics(
            rnd, acc, loss, ctx.ledger.mean_client_bytes_per_round(),
            float(np.mean([c.flops for c in ctx.cost])) if ctx.cost else 0.0,
            epsilon=round_epsilon(ctx.acct, max(ctx.releases, default=0)),
            seconds=time.perf_counter() - t0))
        if verbose:
            print(f"[{tag}] round {rnd}: acc={acc:.4f} loss={loss:.4f}"
                  + (f" arrived={n_arrived}"
                     if fed.aggregation == "async" else ""))
        if mgr is not None and (rnd + 1) % checkpoint_every == 0:
            fed_ckpt.save_run(mgr, ctx, program, schedule, rnd, rollovers)
    return FedResult(ctx.history, ctx.ledger, program.final_state(ctx),
                     [c.flops for c in ctx.cost], rollovers=rollovers)
