"""Model-facing kernel calls and the kernel dispatch layer.

Counterpart of ``src/repro/kernels/ops.py``.  ``ModelConfig.kernel_policy``
(``torch | cuda | auto``) becomes the ambient policy scope here, entered
by core/rounds.run_federated for a whole run and by
models/factory.Model.forward for callers that drive the model directly;
peft/lora.lora_apply, models/attention.attention_fwd, models/loss.kd_kl,
core/compression (``topk_quantize``, ``quantize``, ``quant_roundtrip``),
privacy/dp.clipped_grad_mean, models/rglru.rglru_fwd and
models/rwkv6.timemix_fwd call ``lora_matmul``, ``mha_attention``,
``kd_loss``, ``topk_quantize``, ``quantize``, ``quant_roundtrip``,
``quantize_pack4``, ``clip_mean_rows``, ``rglru`` and ``rwkv6``, which
follow it:

    ``cuda``  — the CUDA kernels (kernels/lora_matmul.py,
                kernels/flash_attention.py, kernels/kd_loss.py,
                kernels/quantize.py, kernels/dp_clip.py,
                kernels/rglru_scan.py, kernels/rwkv6_scan.py),
                differentiable where the reference's are and, for the
                two scans, with backward kernels where the reference
                lets XLA differentiate.  The tensors must be on a CUDA
                device: a CPU tensor raises rather than falling back,
                and so does a tensor that is not float32 (the kernels
                are fp32 instances; there are no bf16 ones yet).
    ``torch`` — the plain PyTorch versions (kernels/ref.py) on whatever
                device the tensors live, differentiated by autograd.
    ``auto``  — ``cuda`` for CUDA tensors, ``torch`` for CPU tensors.  It
                is also the policy outside any scope.

The kernels mask their ragged edges, so unlike the reference there is no
block fitting and no padding of M or R here.

A LoRA factor with a leading client axis (a (C, K, r), b (C, r, N): the
``spmd`` backend's stacked clients, core/fedavg's stacked train step)
makes ``lora_matmul`` one client-axis pass over the stacked batch
(kernels/lora_matmul.LoRAMatmulClients, under either policy).

``per_example_scope`` is the DP-SGD step's counterpart of the reference's
``vmap`` of the per-example loss (core/fedavg.per_example_grads): inside
it every LoRA projection is one batched pass whose backward gives each
example's LoRA gradients (kernels/lora_matmul.LoRAMatmulExamples, under
either policy).  With stacked clients' factors inside the scope (the
``spmd`` backend's DP-SGD step, core/fedavg.per_example_grads_clients:
the reference's ``vmap`` over clients of that ``vmap``) the projection
is the client-axis pass whose backward gives each example's gradients
with respect to its own client's factors
(kernels/lora_matmul.LoRAMatmulClientsExamples).
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch import dtensor
from repro_torch.kernels import dp_clip as _dp
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import kd_loss as _kd
from repro_torch.kernels import lora_matmul as _lm
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import rwkv6_scan as _rw

POLICIES = ("torch", "cuda", "auto")
_ACTIVE = "auto"
_EXAMPLES = None        # (batch, sites) of the open per_example_scope
_CLIENTS = None         # stacked clients of the open clients_scope


def resolve(policy: str, device) -> str:
    """``auto`` -> ``cuda`` for a CUDA device, ``torch`` otherwise."""
    if policy not in POLICIES:
        raise ValueError(f"unknown kernel_policy {policy!r} "
                         f"(expected one of {POLICIES})")
    if policy == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    return policy


@contextlib.contextmanager
def policy_scope(policy: str):
    """Make ``policy`` the ambient kernel policy; ``auto`` is resolved per
    call against the device of the tensors it is given."""
    global _ACTIVE
    resolve(policy, "cpu")                  # validates the name
    prev = _ACTIVE
    _ACTIVE = policy
    try:
        yield
    finally:
        _ACTIVE = prev


@contextlib.contextmanager
def per_example_scope(batch: int):
    """Route every lora_matmul to its per-example form for one batched
    pass of ``batch`` examples.  Yields the pass's sites: (a, b, sink_a,
    sink_b) for each call of lora_matmul, in call order; the gradient of
    the summed per-example losses with respect to sink_a (B, K, r) and
    sink_b (B, r, N) is each example's gradient with respect to the bound
    a and b.  Every LoRA projection's input must lead with the batch, and
    no layer may mix examples: a MoE layer routes each example on its own
    and gives each its aux term (models/moe.py); core/fedavg's
    per_example_grads refuses a scalar ``aux`` that carries a gradient.
    With stacked clients' factors a (C, K, r), b (C, r, N), ``batch``
    counts the C·B examples of the stacked batch, client c's B one after
    another: sink row c·B + j is example j of client c, its gradient with
    respect to a[c] and b[c]."""
    global _EXAMPLES
    if _EXAMPLES is not None:
        raise RuntimeError("per_example_scope: already open")
    _EXAMPLES = (batch, [])
    try:
        yield _EXAMPLES[1]
    finally:
        _EXAMPLES = None


@contextlib.contextmanager
def clients_scope(n_clients: int):
    """Mark one forward of ``n_clients`` stacked clients' batches, laid
    one after another on the batch axis (the ``spmd`` backend's stacked
    steps, core/fedavg): a layer that mixes the rows of its batch (the
    MoE router's capacity and load-balance term, models/moe.py) keeps
    each client's rows to themselves, as the reference's ``vmap`` over
    clients does."""
    global _CLIENTS
    prev, _CLIENTS = _CLIENTS, n_clients
    try:
        yield
    finally:
        _CLIENTS = prev


def scope_state():
    """The open scopes (kernel policy, stacked clients): what a
    recomputation in the backward (models/transformer.forward's
    ``remat``) must run under to take the forward's path.  A recompute
    inside a per_example_scope would record its sites twice, so the
    state refuses it."""
    if _EXAMPLES is not None:
        raise ValueError("recomputation (remat) is not supported inside a "
                         "per_example_scope")
    return _ACTIVE, _CLIENTS


@contextlib.contextmanager
def restored_scopes(state):
    """Re-enter a ``scope_state()``."""
    global _ACTIVE, _CLIENTS
    prev = _ACTIVE, _CLIENTS
    _ACTIVE, _CLIENTS = state
    try:
        yield
    finally:
        _ACTIVE, _CLIENTS = prev


def example_batch():
    """The batch of the open per_example_scope, or None."""
    return None if _EXAMPLES is None else _EXAMPLES[0]


def stacked_clients():
    """The client count of the open clients_scope, or None."""
    return _CLIENTS


def use_cuda(t: torch.Tensor) -> bool:
    return resolve(_ACTIVE, t.device) == "cuda"


def _require_cuda(op: str, *tensors) -> None:
    """Refuses what the CUDA kernels cannot take: a tensor off the card, or
    one that is not float32 (the kernels are fp32 instances and read raw
    fp32 pointers).  It never casts and never falls back to the plain
    version."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{op}: kernel policy 'cuda' needs CUDA tensors, "
                             f"got one on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{op}: the CUDA kernels take float32 tensors, "
                             f"got {t.dtype}")


def lora_matmul(x, w, a, b):
    """x: (..., K) -> (..., N): x@W + (x@A)@B, differentiable.  With
    stacked clients' factors, a (C, K, r) and b (C, r, N), the rows of x
    come in C equal groups, one a client (_lora_matmul_clients)."""
    if a.dim() == 3:
        if _EXAMPLES is not None:
            return _lora_matmul_clients_examples(x, w, a, b)
        return _lora_matmul_clients(x, w, a, b)
    if _EXAMPLES is not None:
        return _lora_matmul_examples(x, w, a, b)
    if not use_cuda(x):
        return ref.lora_matmul_ref(x, w, a, b)
    _require_cuda("lora_matmul", x, w, a, b)
    *lead, K = x.shape
    out = _lm.lora_matmul(x.reshape(math.prod(lead), K).contiguous(), w, a, b)
    return out.reshape(*lead, w.shape[1])


def _lora_matmul_examples(x, w, a, b):
    """lora_matmul under per_example_scope: x (B, ..., K) as (B, S, K);
    a and b enter detached, and two fresh sinks, recorded in the scope's
    sites, carry each example's gradients."""
    B, sites = _EXAMPLES
    *lead, K = x.shape
    if not lead or lead[0] != B:
        raise ValueError(f"lora_matmul: a per-example pass of {B} examples "
                         f"needs inputs that lead with the batch, got "
                         f"{tuple(x.shape)}")
    if w.requires_grad:
        raise ValueError("lora_matmul: a per-example pass forms no gradient "
                         "of the bound base weight")
    cuda = use_cuda(x)
    if cuda:
        _require_cuda("lora_matmul", x, w, a, b)
    r, N = b.shape
    sa = torch.empty((B, K, r), dtype=a.dtype, device=a.device,
                     requires_grad=True)
    sb = torch.empty((B, r, N), dtype=b.dtype, device=b.device,
                     requires_grad=True)
    sites.append((a, b, sa, sb))
    S = math.prod(lead[1:])
    y = _lm.LoRAMatmulExamples.apply(x.reshape(B, S, K).contiguous(), w,
                                     a.detach(), b.detach(), sa, sb, cuda)
    return y.reshape(*lead, N)


def _lora_matmul_clients(x, w, a, b):
    """lora_matmul for the stacked clients of the ``spmd`` backend (the
    reference's ``vmap`` over clients, W shared): x (C·B, ..., K) viewed
    as (C, M_c, K), client c's rows against a[c] and b[c]; the kernels of
    kernels/lora_matmul.LoRAMatmulClients under the ``cuda`` policy, their
    plain twins under ``torch``.  A client-axis pass forms no gradient of
    the bound base weight."""
    if w.requires_grad:
        raise ValueError("lora_matmul: a client-axis pass forms no gradient "
                         "of the bound base weight")
    if dtensor.is_distributed(x):
        return _distributed_lora_clients(x, w, a, b)
    C = a.shape[0]
    *lead, K = x.shape
    rows = math.prod(lead)
    if not lead or lead[0] % C:
        raise ValueError(f"lora_matmul: {C} stacked clients need inputs "
                         f"whose leading axis is a multiple of {C}, got "
                         f"{tuple(x.shape)}")
    cuda = use_cuda(x)
    if cuda:
        _require_cuda("lora_matmul", x, w, a, b)
    y = _lm.LoRAMatmulClients.apply(
        x.reshape(C, rows // C, K).contiguous(), w, a.contiguous(),
        b.contiguous(), cuda)
    return y.reshape(*lead, w.shape[1])


def _distributed_lora_clients(x, w, a, b):
    """_lora_matmul_clients on DTensors.  The stacked rows' client axis
    is folded into their batch dim, which DTensor cannot split back out
    of a sharded dim, so: x@W by DTensor's own rule, and the LoRA term on
    each rank's local rows, which hold whole clients' blocks in client
    order (the rows' batch shards) against its clients' factors: A whole
    and B's columns sharded as W's, but for a sharded client axis."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    # in x's dtype, as the reference's XLA lora_apply (the twins' fp32
    # copies of x would each be kept for the backward)
    w, a, b = (t.to(x.dtype) for t in (w, a, b))
    base = x @ w
    x = dtensor.replicated(x, (-1,), "kernels/ops: a stacked-clients LoRA "
                          "site's input features")
    client = [p.is_shard() and p.dim == 0 for p in a.placements]
    a = dtensor.relayout(a, [Shard(0) if c else Replicate()
                            for c in client])
    col = [p.is_shard() and p.dim == 1 for p in w.placements]
    b = dtensor.relayout(b, [Shard(0) if c else Replicate()
                            for c in client])
    # the gradients of the local pieces: x's a partial sum over the axes
    # sharding W's columns, the factors' partial sums over the axes
    # sharding the rows (each rank's rows' share), B's also over the
    # axes sharding W's columns (each rank's slice of B's columns, cut
    # below, zero elsewhere): no collective for them in the backward
    rows = [dtensor.shard_dim(p) == 0 for p in x.placements]
    xl = x.to_local(grad_placements=[Partial() if k else p for p, k in
                                     zip(x.placements, col)])
    al, bl = (t.to_local(grad_placements=[
        Partial() if (r and not c) or (k and t is b) else p
        for p, r, c, k in zip(t.placements, rows, client, col)])
        for t in (a, b))
    for i in (i for i, k in enumerate(col) if k):
        n = bl.shape[2] // mesh.size(i)
        bl = bl.narrow(2, mesh.get_local_rank(i) * n, n)
    if xl.shape[0] % al.shape[0]:
        raise ValueError(f"lora_matmul: {xl.shape[0]} local stacked rows "
                         f"do not hold whole blocks of {al.shape[0]} "
                         f"clients")
    xc = xl.reshape(al.shape[0], -1, xl.shape[-1])
    lora = ((xc @ al) @ bl).reshape(*xl.shape[:-1], bl.shape[-1])
    pl = [Shard(x.dim() - 1) if k else p if dtensor.shard_dim(p) == 0
          else Replicate() for p, k in zip(x.placements, col)]
    shape = (*x.shape[:-1], w.shape[1])
    return base + DTensor.from_local(lora, mesh, pl, run_check=False,
                                     shape=shape,
                                     stride=_global_stride(lora, shape))


def _lora_matmul_clients_examples(x, w, a, b):
    """lora_matmul of stacked clients under per_example_scope: x (C·B,
    ..., K) as (C, B·S, K) against each client's a[c], b[c], which enter
    detached; the two sinks, (C·B, K, r) and (C·B, r, N), carry each
    example's gradients with respect to its own client's factors."""
    n, sites = _EXAMPLES
    C = a.shape[0]
    *lead, K = x.shape
    if not lead or lead[0] != n or n % C:
        raise ValueError(f"lora_matmul: a per-example pass of {n} examples "
                         f"over {C} stacked clients needs inputs that lead "
                         f"with the stacked batch, got {tuple(x.shape)}")
    if w.requires_grad:
        raise ValueError("lora_matmul: a per-example pass forms no gradient "
                         "of the bound base weight")
    cuda = use_cuda(x)
    if cuda:
        _require_cuda("lora_matmul", x, w, a, b)
    r, N = b.shape[1:]
    sa = torch.empty((n, K, r), dtype=a.dtype, device=a.device,
                     requires_grad=True)
    sb = torch.empty((n, r, N), dtype=b.dtype, device=b.device,
                     requires_grad=True)
    sites.append((a, b, sa, sb))
    S = math.prod(lead[1:])
    y = _lm.LoRAMatmulClientsExamples.apply(
        x.reshape(C, n // C * S, K).contiguous(), w,
        a.detach().contiguous(), b.detach().contiguous(), sa, sb, S, cuda)
    return y.reshape(*lead, N)


def mha_attention(q, k, v, causal: bool = True, window: int = 0,
                  q_offset: int = 0):
    """q: (B, Sq, H, D); k, v: (B, Skv, KV, D) -> (B, Sq, H, D).

    Same transposes as the reference: heads move next to the batch into
    the kernel layout (B·H, S, D), and back.  DTensors go through
    _distributed_attention."""
    if dtensor.is_distributed(q):
        return _distributed_attention(q, k, v, causal, window, q_offset)
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    qf = q.transpose(1, 2).reshape(B * H, Sq, D)
    kf = k.transpose(1, 2).reshape(B * KV, Skv, D)
    vf = v.transpose(1, 2).reshape(B * KV, Skv, D)
    if use_cuda(q):
        _require_cuda("mha_attention", q, k, v)
        out = _fa.flash_attention(qf.contiguous(), kf.contiguous(),
                                  vf.contiguous(), causal, window, q_offset)
    else:
        out = ref.attention_ref(qf, kf, vf, causal, window, q_offset)
    return out.reshape(B, H, Sq, D).transpose(1, 2)


def _distributed_attention(q, k, v, causal, window, q_offset):
    """mha_attention on DTensors, each rank on its own block of (batch,
    head): q keeps its batch and head shards (anything else of it, a
    sharded sequence or D or a partial sum, made whole); k and v take
    q's batch shards and, where q's heads are sharded over a mesh axis,
    their own heads over it when KV divides by its extent, else their
    heads repeated to H first (each rank then holds its q heads' KV
    heads, G = 1 there).  Each rank runs mha_attention on its local
    blocks; the result has q's placements."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    qpl, kvpl, expand = [], [], False
    for i, p in enumerate(q.placements):
        if dtensor.shard_dim(p) == 0:
            qpl.append(p)
            kvpl.append(p)
        elif p.is_shard(2):
            qpl.append(p)
            kvpl.append(p)
            expand |= KV % mesh.size(i) != 0
        else:
            qpl.append(Replicate())
            kvpl.append(Replicate())
    if tuple(qpl) != tuple(q.placements):
        q = dtensor.replicated(q, (1, 3), "kernels/ops.mha_attention: q's "
                              "sequence or head dim")
        q = dtensor.relayout(q, qpl)

    def local(x):
        """This rank's K or V block for its q heads."""
        if not expand:
            return dtensor.relayout(x, kvpl).to_local()
        # the heads whole, repeated to H and cut to this rank's q heads
        # locally; the gradient a partial sum over the head axes
        whole = dtensor.relayout(x, [p if dtensor.shard_dim(p) == 0
                                    else Replicate() for p in kvpl])
        loc = whole.to_local(grad_placements=[
            Partial() if p.is_shard(2) else w
            for p, w in zip(kvpl, whole.placements)])
        loc = loc.repeat_interleave(H // KV, dim=2)
        for i, p in enumerate(kvpl):
            if p.is_shard(2):
                n = loc.shape[2] // mesh.size(i)
                loc = loc.narrow(2, mesh.get_local_rank(i) * n, n)
        return loc

    out = mha_attention(q.to_local(), local(k), local(v), causal, window,
                        q_offset)
    return DTensor.from_local(out, mesh, qpl, run_check=False,
                              shape=q.shape, stride=_global_stride(out,
                                                                   q.shape))


def kd_loss(teacher, student, temperature: float = 1.0, mask=None):
    """teacher/student: (..., V) -> scalar mean KD loss (masked),
    differentiable w.r.t. both logit sets: the streaming KD kernels under
    the ``cuda`` policy, the log-softmax form (kernels/ref.py) under
    ``torch``."""
    rows = kd_loss_rows(teacher, student, temperature)
    if mask is None:
        return rows.mean()
    m = mask.reshape(-1).float()
    return (rows * m).sum() / torch.clamp_min(m.sum(), 1.0)


def kd_loss_rows(teacher, student, temperature: float = 1.0):
    """teacher/student: (..., V) -> each row's KD loss, flattened (R,),
    differentiable: kd_loss before its mean."""
    V = teacher.shape[-1]
    t = teacher.reshape(-1, V).float()
    s = student.reshape(-1, V).float()
    if use_cuda(teacher):
        _require_cuda("kd_loss", teacher, student)
        return _kd.kd_loss_rows(t.contiguous(), s.contiguous(), temperature)
    return ref.kd_loss_rows_ref(t, s, temperature)


def topk_quantize(x, k: int, bits: int = 8):
    """x: (..., V) -> (q int8 (..., k), idx int32 (..., k), scale (..., 1)).

    The fused KD b3 upload: the CUDA kernel under the ``cuda`` policy, the
    bit-identical plain version (kernels/ref.py) under ``torch``."""
    *lead, V = x.shape
    xf = x.reshape(-1, V).float()
    if use_cuda(x):
        _require_cuda("topk_quantize", x)
        q, idx, sc = _q.topk_quantize(xf.contiguous(), k, bits)
    else:
        q, idx, sc = ref.topk_quantize_rows_ref(xf, k, bits)
    return (q.reshape(*lead, k), idx.reshape(*lead, k),
            sc.reshape(*lead, 1))


def quantize(x, bits: int = 8):
    """x: (..., C) -> (q int8 (..., C), scale fp32 (..., 1)): symmetric
    per-row levels, the Split boundary's wire format.  The CUDA kernel
    under the ``cuda`` policy, the bit-identical plain version
    (kernels/ref.py) under ``torch``."""
    *lead, C = x.shape
    xf = x.reshape(-1, C).float()
    if use_cuda(x):
        _require_cuda("quantize", x)
        q, sc = _q.quantize_rows(xf.contiguous(), bits)
    else:
        q, sc = ref.quantize_rows_ref(xf, bits)
    return q.reshape(*lead, C), sc.reshape(*lead, 1)


def quant_roundtrip(x, bits: int = 8):
    """x: (..., C) -> fp32 (..., C): ``quantize``'s levels times their row
    scale, the Split boundary's straight-through value.  One CUDA kernel
    under the ``cuda`` policy (no levels in memory), the bit-identical
    plain version (kernels/ref.py) under ``torch``."""
    *lead, C = x.shape
    xf = x.reshape(-1, C).float()
    if use_cuda(x):
        _require_cuda("quant_roundtrip", x)
        y = _q.quant_roundtrip_rows(xf.contiguous(), bits)
    else:
        y, _ = ref.quant_roundtrip_rows_ref(xf, bits)
    return y.reshape(*lead, C)


def quantize_pack4(x):
    """x: (..., C) -> (packed uint8 (..., ceil(C/2)), scale (..., 1)): int4
    levels two a byte.  Odd C is zero-padded by one column first, as the
    reference does (a zero changes no row's absmax)."""
    *lead, C = x.shape
    xf = x.reshape(-1, C).float()
    if C % 2:
        xf = torch.nn.functional.pad(xf, (0, 1))
    if use_cuda(x):
        _require_cuda("quantize_pack4", x)
        q, sc = _q.quantize_pack4(xf.contiguous())
    else:
        q, sc = ref.quantize_pack4_rows_ref(xf)
    return q.reshape(*lead, (C + 1) // 2), sc.reshape(*lead, 1)


def clip_mean_rows(g, clip: float):
    """g: (B, P) stacked per-example grads -> (P,) fp32 mean of the
    per-example L2-clipped rows: the DP-SGD clip-scale-accumulate step
    (privacy/dp.py).  The two CUDA kernels of kernels/dp_clip.py under the
    ``cuda`` policy, the plain version (kernels/ref.py) under ``torch``.
    Forward only: it runs on gradients."""
    if not use_cuda(g):
        return ref.clip_mean_rows_ref(g, clip)
    _require_cuda("clip_mean_rows", g)
    return _dp.clip_mean_rows(g.float().contiguous(), clip)


def clip_mean_rows_clients(g, clip: float):
    """g: (C, B, P) each stacked client's per-example grads -> (C, P)
    fp32, each client's mean of its L2-clipped rows (clip_mean_rows with a
    client axis, privacy/dp.clipped_grad_mean_clients): the norm kernel
    over the C·B rows and the clip-accumulate kernel with the client on a
    grid axis under the ``cuda`` policy, the plain version
    (kernels/ref.py) under ``torch``.  Forward only."""
    if not use_cuda(g):
        return ref.clip_mean_rows_clients(g, clip)
    _require_cuda("clip_mean_rows_clients", g)
    return _dp.clip_mean_rows_clients(g.float().contiguous(), clip)


# --------------------------------------------------------------------------- #
# The scans on tensors without data (launch/dryrun.py)
# --------------------------------------------------------------------------- #
_COST_SINK = None       # charge(flops, bytes) of the open shape_only_costs


@contextlib.contextmanager
def shape_only_costs(charge):
    """While open, the scans' shape-only path reports the FLOPs and bytes
    of the step-by-step twin it stands for to ``charge(flops, nbytes)``
    (a dry run's counter)."""
    global _COST_SINK
    prev, _COST_SINK = _COST_SINK, charge
    try:
        yield
    finally:
        _COST_SINK = prev


def shape_only(t) -> bool:
    """Whether ``t`` holds no data: a tensor on the ``meta`` device or a
    FakeTensor.  Only such tensors take the scans' shape-only path; a CPU
    or CUDA tensor never does."""
    from torch._subclasses.fake_tensor import is_fake
    return t.is_meta or is_fake(t)


def rglru_twin_cost(B: int, S: int, W: int, itemsize: int, h0: bool,
                    backward: bool, h0_grad: bool = False):
    """(flops, bytes) that a dry run's counter reads off ref.rglru_scan
    on (B, S, W) inputs (``h0`` given or not): its forward, or with
    ``backward`` the autograd backward through a, b (and h0 with
    ``h0_grad``) after it.  The step-by-step twin does no matrix
    products; the select backward of each step writes a whole (B, S, W)
    gradient, hence the S² term.  tests/test_torch_dryrun.py holds these
    to the counter."""
    n = B * W
    fwd = itemsize * n * (8 * S + (0 if h0 else 2))
    if not backward:
        return 0, fwd
    total = 8 * S * S + 13 * S - (1 if not h0 else 0 if h0_grad else 3)
    return 0, itemsize * n * total - fwd


def rwkv6_twin_cost(BH: int, S: int, D: int, U: int, itemsize: int,
                    backward: bool):
    """(flops, bytes) that a dry run's counter reads off ref.rwkv6_scan
    on (BH, S, D) inputs and a (U, D) bonus, D >= 2: its forward (one
    (1, D) x (D, D) product a row and step), or with ``backward`` the
    autograd backward through r, k, v and logw after it (u frozen)."""
    n, n2 = BH * D, BH * D * D
    fwd = (2 * n2 * S, itemsize * (n + 24 * n * S + n2 + 7 * n2 * S + U * D
                                   + 2 * BH * S))
    if not backward:
        return fwd
    flops = 6 * n2 * S - 2 * n2
    nbytes = itemsize * (-2 * n + 55 * n * S + 16 * n * S * S - 5 * n2
                         + 24 * n2 * S + U * D + 4 * BH * S)
    return flops - fwd[0], nbytes - fwd[1]


def _charge(cost) -> None:
    if _COST_SINK is not None:
        _COST_SINK(*cost)


class _ShapeOnlyRGLRU(torch.autograd.Function):
    """The RG-LRU scan's outputs (empty, right shapes and dtypes) and
    gradients, with the twin's FLOPs and bytes charged."""

    @staticmethod
    def forward(ctx, a, b, h0):
        B, S, W = a.shape
        ctx.dims = (B, S, W, a.element_size(), h0 is not None)
        _charge(rglru_twin_cost(*ctx.dims, False))
        return torch.empty_like(a), torch.empty_like(a[:, 0])

    @staticmethod
    def backward(ctx, dh, dh_final):
        a_grad, b_grad, h0_grad = ctx.needs_input_grad
        _charge(rglru_twin_cost(*ctx.dims, True, h0_grad))
        B, S, W, _, has_h0 = ctx.dims
        empty = dh.new_empty
        return (empty((B, S, W)) if a_grad else None,
                empty((B, S, W)) if b_grad else None,
                empty((B, W)) if has_h0 and h0_grad else None)


class _ShapeOnlyWKV(torch.autograd.Function):
    """The WKV recurrence's outputs (y (BH, S, D), S_final (BH, D, D),
    empty) and gradients, with the twin's FLOPs and bytes charged."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u):
        BH, S, D = r.shape
        ctx.dims = (BH, S, D, u.shape[0], r.element_size())
        _charge(rwkv6_twin_cost(*ctx.dims, False))
        return torch.empty_like(r), r.new_empty((BH, D, D))

    @staticmethod
    def backward(ctx, dy, dS):
        _charge(rwkv6_twin_cost(*ctx.dims, True))
        BH, S, D, U, _ = ctx.dims
        need = ctx.needs_input_grad
        grads = [dy.new_empty((BH, S, D)) if need[i] else None
                 for i in range(4)]
        return (*grads, dy.new_empty((U, D)) if need[4] else None)


def _distributed_scan(fn, xs, in_dims, outs):
    """``fn`` (rglru or rwkv6) on DTensors, each rank on its local
    shards: the scan runs along its sequence dim independently over the
    others, so the inputs keep the lead input's batch and channel (or
    head) shards and have every other dim made whole.  ``in_dims[i]``
    maps input i's dims to the lead input's (None: made whole); ``outs``
    is each output's (global shape, dims).  Returns DTensors."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = xs[0].device_mesh
    lead = xs[0].placements
    keep = {i: dtensor.shard_dim(p) for i, p in enumerate(lead)
            if dtensor.shard_dim(p) is not None
            and dtensor.shard_dim(p) in in_dims[0]}

    def placements(dims):
        # a lead shard of the same dim index kept as it is (a strided
        # batch shard stays strided), else a Shard of the mapped dim
        return [(lead[i] if dims.index(keep[i]) == keep[i]
                 else Shard(dims.index(keep[i])))
                if i in keep and keep[i] in dims else Replicate()
                for i in range(mesh.ndim)]

    locs = []
    for x, dims in zip(xs, in_dims):
        if x is not None:
            pl = placements(dims)
            if tuple(x.placements) != tuple(pl):
                x = dtensor.replicated(
                    x, [d for d in range(x.dim()) if dims[d] is None],
                    "kernels/ops: a scan's sequence dim")
                x = dtensor.relayout(x, pl)
            x = x.to_local()
        locs.append(x)
    res = fn(*locs)
    return tuple(DTensor.from_local(o, mesh, placements(dims),
                                    run_check=False, shape=shape,
                                    stride=_global_stride(o, shape))
                 for o, (shape, dims) in zip(res, outs))


def _global_stride(local, shape):
    """The strides of ``shape`` laid out in the dim order of the local
    tensor's (a transposed view's order kept)."""
    order = sorted(range(local.dim()), key=lambda d: -local.stride(d))
    stride, step = [0] * len(shape), 1
    for d in reversed(order):
        stride[d] = step
        step *= shape[d]
    return tuple(stride)


def rglru(a, b, h0=None):
    """a, b: (B, S, W) fp32; h0: (B, W) or None (zeros) -> (h (B, S, W),
    h_final (B, W)): the RG-LRU recurrence h_t = a_t·h_{t-1} + b_t,
    differentiable.  The CUDA kernels of kernels/rglru_scan.py under the
    ``cuda`` policy, the step-by-step plain version (kernels/ref.py, the
    same bits) under ``torch``."""
    if dtensor.is_distributed(a):
        B, S, W = a.shape
        seq = (0, None, 2)
        return _distributed_scan(rglru, (a, b, h0), (seq, seq, (0, 2)),
                                 (((B, S, W), seq), ((B, W), (0, 2))))
    if not use_cuda(a):
        if shape_only(a):
            return _ShapeOnlyRGLRU.apply(a, b, h0)
        return ref.rglru_scan(a, b, h0)
    _require_cuda("rglru", a, b, *(() if h0 is None else (h0,)))
    return _rg.rglru_scan(a.contiguous(), b.contiguous(),
                          None if h0 is None else h0.contiguous())


def rwkv6(r, k, v, logw, u):
    """r, k, v, logw: (B, S, H, D) fp32; u: (H, D) -> (y (B, S, H, D),
    S_final (B, H, D, D)): the RWKV-6 WKV recurrence from a zero state,
    differentiable.  Same transposes as the reference: heads move next to
    the batch into the kernel layout (B·H, S, D), where row b·H + h takes
    u[h].  The CUDA kernels of kernels/rwkv6_scan.py under the ``cuda``
    policy, the step-by-step plain version (kernels/ref.py) under
    ``torch``."""
    if dtensor.is_distributed(r):
        B, S, H, D = r.shape
        seq = (0, None, 2, None)
        return _distributed_scan(rwkv6, (r, k, v, logw, u),
                                 (seq,) * 4 + ((2, None),),
                                 (((B, S, H, D), seq),
                                  ((B, H, D, D), (0, 2, None, None))))
    B, S, H, D = r.shape

    def flat(x):
        return x.transpose(1, 2).reshape(B * H, S, D)

    if not use_cuda(r) and shape_only(r):
        y, sf = _ShapeOnlyWKV.apply(*(flat(x) for x in (r, k, v, logw)), u)
    elif use_cuda(r):
        _require_cuda("rwkv6", r, k, v, logw, u)
        y, sf = _rw.rwkv6_scan(*(flat(x).contiguous()
                                 for x in (r, k, v, logw)), u.contiguous())
    else:
        y, sf = ref.rwkv6_scan(*(flat(x) for x in (r, k, v, logw)), u)
    return y.reshape(B, H, S, D).transpose(1, 2), sf.reshape(B, H, D, D)


def launches() -> dict:
    """Launch counts of every ported kernel since the last reset."""
    return {**_lm.LAUNCHES, **_fa.LAUNCHES, **_kd.LAUNCHES, **_q.LAUNCHES,
            **_dp.LAUNCHES, **_rg.LAUNCHES, **_rw.LAUNCHES}


def reset_launches() -> None:
    for mod in (_lm, _fa, _kd, _q, _dp, _rg, _rw):
        mod.reset_launches()
