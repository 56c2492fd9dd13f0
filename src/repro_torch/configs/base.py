"""Configuration dataclasses of the PyTorch port.

Reproduces ``src/repro/configs/base.py``: ``ModelConfig`` (one schema for
every architecture family), ``ShapeConfig`` (one assigned input shape)
and ``FedConfig`` with its ``PrivacyConfig`` and ``FaultConfig`` members,
field for field.  The only difference is the
kernel policy, which names the port's implementations:

    ``torch`` — plain PyTorch (kernels/ref.py), on whatever device the
                tensors live;
    ``cuda``  — the hand-written CUDA kernels (kernels/csrc/*.cu);
    ``auto``  — ``cuda`` when the run's device is CUDA, ``torch`` when the
                caller asked for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Layer kinds (same names as the reference's models/transformer.py)
ATTN = "attn"              # global causal self-attention
LOCAL_ATTN = "local_attn"  # sliding-window self-attention
RGLRU = "rglru"            # RG-LRU recurrent block (RecurrentGemma)
RWKV6 = "rwkv6"            # RWKV-6 "Finch" time-mix block

FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "audio")
KERNEL_POLICIES = ("torch", "cuda", "auto")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters.  One instance per assigned arch."""

    name: str
    family: str                       # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int                      # query heads (0 for attn-free archs)
    n_kv_heads: int                   # GQA KV heads
    d_ff: int
    vocab_size: int

    # -- attention details ----------------------------------------------
    head_dim: int = 0                 # 0 -> d_model // n_heads
    qkv_bias: bool = False            # qwen2-style QKV bias
    qk_norm: bool = False             # qwen3-style per-head RMSNorm on q,k
    sliding_window: int = 0           # 0 -> global attention (mixtral: 4096)
    rope_theta: float = 10_000.0
    use_rope: bool = True             # False -> learned absolute positions
    max_position_embeddings: int = 1_048_576

    # -- MLP / MoE --------------------------------------------------------
    activation: str = "swiglu"        # swiglu | gelu | relu2
    n_experts: int = 0                # 0 -> dense MLP
    top_k: int = 0
    router_aux_coef: float = 0.01     # load-balance loss coefficient
    moe_capacity_factor: float = 1.25  # train-time token-drop threshold
    moe_dispatch: str = "global"      # global | batched | shard_map (batched)

    # -- layer pattern ----------------------------------------------------
    layer_pattern: Optional[Tuple[str, ...]] = None

    # -- recurrent-family extras -----------------------------------------
    lru_width: int = 0                # RG-LRU recurrence width (0 -> d_model)
    conv1d_width: int = 4             # RecurrentGemma temporal-conv width
    local_window: int = 2048          # window for LOCAL_ATTN layers

    # -- norms / embeddings ----------------------------------------------
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    tie_embeddings: bool = False
    embed_scale: bool = False         # gemma-style sqrt(d_model) scaling

    # -- encoder-decoder (whisper) ----------------------------------------
    n_encoder_layers: int = 0         # >0 -> encoder-decoder model
    encoder_seq_len: int = 1500       # whisper 30s -> 1500 frames

    # -- multimodal (llava) ------------------------------------------------
    n_image_tokens: int = 0           # >0 -> embedding-prefix VLM
    image_embed_dim: int = 0          # projector input dim (stubbed frontend)

    dtype: str = "bfloat16"
    citation: str = ""

    # -- kernel dispatch (see module docstring) ----------------------------
    kernel_policy: str = "auto"

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.kernel_policy not in KERNEL_POLICIES:
            raise ValueError(
                f"unknown kernel_policy {self.kernel_policy!r} "
                "(expected 'torch' | 'cuda' | 'auto')")
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    # ------------------------------------------------------------------ #
    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Expanded per-layer kind sequence of length n_layers."""
        if self.layer_pattern is None:
            return (ATTN,) * self.n_layers
        pat = self.layer_pattern
        reps = -(-self.n_layers // len(pat))
        return (pat * reps)[: self.n_layers]

    @property
    def is_encoder_decoder(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attention_free(self) -> bool:
        return all(k in (RGLRU, RWKV6) for k in self.layer_kinds)

    @property
    def subquadratic(self) -> bool:
        """True when the decode state does not grow with the context."""
        return all(
            k in (RGLRU, RWKV6, LOCAL_ATTN) for k in self.layer_kinds
        ) or (self.sliding_window > 0)

    # -- parameter counting (analytic; used by the fed metrics) ----------
    def param_count(self) -> int:
        return sum(x for x, _ in self._param_terms())

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts active)."""
        return sum(a for _, a in self._param_terms())

    def _param_terms(self):
        """Yields (total, active) parameter-count pairs per component."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        yield V * d, V * d                                   # embedding
        if not self.tie_embeddings:
            yield V * d, V * d                               # lm head
        for kind in self.layer_kinds:
            if kind in (ATTN, LOCAL_ATTN):
                q = d * self.n_heads * self.head_dim
                kv = 2 * d * self.n_kv_heads * self.head_dim
                o = self.n_heads * self.head_dim * d
                yield q + kv + o, q + kv + o
            elif kind == RGLRU:
                w = self.lru_width
                n = 2 * d * w + self.conv1d_width * w + 3 * w + w * d
                yield n, n
            elif kind == RWKV6:
                n = 5 * d * d + 2 * d * 64 + 6 * d
                yield n, n
            # MLP
            if self.n_experts and kind != RWKV6:
                mult = 3 if self.activation == "swiglu" else 2
                per_e = mult * d * ff
                yield (self.n_experts * per_e + d * self.n_experts,
                       self.top_k * per_e + d * self.n_experts)
            else:
                mult = 3 if self.activation == "swiglu" else 2
                yield mult * d * ff, mult * d * ff
        if self.is_encoder_decoder:
            enc = self.n_encoder_layers * (
                4 * d * d + 2 * d * ff)
            xattn = self.n_layers * 4 * d * d
            yield enc + xattn, enc + xattn

    def reduced(self, n_layers: int = 2, d_model: int = 256,
                n_experts: int = 4) -> "ModelConfig":
        """A smoke-test-sized variant of the same family (the reference's
        ``ModelConfig.reduced``: <=4 heads, d_ff 3d, V 512, window 64;
        at least one full layer pattern)."""
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = min(self.n_kv_heads, n_heads) if n_heads else 0
        if self.layer_pattern is not None:
            n_layers = max(n_layers, len(self.layer_pattern))
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=max(1, n_kv),
            head_dim=d_model // n_heads if n_heads else 0,
            d_ff=d_model * 3,
            vocab_size=512,
            n_experts=min(self.n_experts, n_experts) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            lru_width=d_model,
            local_window=64,
            sliding_window=64 if self.sliding_window else 0,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            encoder_seq_len=16 if self.n_encoder_layers else 1500,
            n_image_tokens=8 if self.n_image_tokens else 0,
            image_embed_dim=64 if self.image_embed_dim else 0,
            max_position_embeddings=4096,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape (configs/shapes.py)."""
    name: str
    seq_len: int
    global_batch: int
    mode: str            # "train" | "prefill" | "decode"


@dataclasses.dataclass(frozen=True)
class PrivacyConfig:
    """Privacy mechanisms for the federated wire (reference:
    ``repro.configs.base.PrivacyConfig``; the port's privacy/ package).

    DP-SGD (``dp_clip`` / ``dp_noise_multiplier``): per-example gradient
    clipping inside every local fine-tune step (FedLLM a2, KD b1), through
    the clip-scale-accumulate kernels, plus seeded Gaussian noise on the
    uploaded payload: the LoRA params for FedLLM, the public-set logits for
    KD (clipped per row, before the top-k/int-quant compression).  The
    noise comes from a per-(round, client) stream of its own
    (privacy/dp.noise_generator).  An RDP accountant
    (privacy/accountant.py) reports (ε, δ) per round in RoundMetrics.

    Simulated secure aggregation (``secure_agg``): seeded pairwise
    additive masks over fixed-point payloads that cancel exactly in the
    server sum (privacy/secure_agg.py checks it in uint64 at every
    aggregation event); key-exchange bytes (and recovery bytes for absent
    members) go into the CommLedger.

    The port runs them for FedLLM, KD-FedLLM and Split-FedLLM (on Split
    the c2 boundary clip and noise)."""

    dp_clip: float = 0.0             # C: per-example L2 clip (0 = DP off)
    dp_noise_multiplier: float = 0.0  # sigma: noise stddev / dp_clip
    dp_delta: float = 1e-5           # delta of the reported (eps, delta)
    secure_agg: bool = False         # pairwise-masked aggregation overlay
    secure_agg_frac_bits: int = 24   # fixed-point fraction bits for masks
    seed: int = 0                    # privacy noise stream

    @property
    def dp_enabled(self) -> bool:
        return self.dp_clip > 0.0

    @property
    def noise_std(self) -> float:
        """Gaussian stddev of the payload noise (sigma * C)."""
        return self.dp_noise_multiplier * self.dp_clip

    @property
    def enabled(self) -> bool:
        return self.dp_enabled or self.secure_agg


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Seeded fault injection knobs (reference:
    ``repro.configs.base.FaultConfig``), run by faults/plan.FaultPlan at
    core/round_program's upload seam."""

    dropout_rate: float = 0.0        # P(upload lost) per started job
    straggler_rate: float = 0.0      # P(upload delayed) per started job
    straggler_delay: int = 2         # extra rounds a straggling upload takes
    byzantine: int = 0               # number of permanently corrupt clients
    byzantine_mode: str = "sign_flip"  # nan | inf | sign_flip | norm_inflation
    byzantine_scale: float = 100.0   # multiplier for norm_inflation
    seed: int = 0                    # fault stream (folded with FedConfig.seed)

    @property
    def enabled(self) -> bool:
        return (self.dropout_rate > 0.0 or self.straggler_rate > 0.0
                or self.byzantine > 0)


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Federated fine-tuning round configuration (paper SSII/V)."""
    framework: str = "fedllm"        # fedllm | kd | split
    backend: str = "sequential"      # sequential | spmd | cohort
    n_clients: int = 3
    cohort_size: int = 0
    n_virtual_clients: int = 0
    n_edges: int = 0
    rounds: int = 10
    local_epochs: int = 1
    # PEFT
    peft: str = "lora"               # lora | adapter | prompt | full
    lora_rank: int = 8
    lora_alpha: float = 32.0
    lora_dropout: float = 0.1
    lora_targets: Tuple[str, ...] = ("wq", "wk", "wv")  # paper: attn.c_attn
    # KD-FedLLM
    public_dataset_size: int = 512
    kd_temperature: float = 2.0
    kd_epochs: int = 1
    logit_topk: int = 0              # 0 = dense logits (paper baseline)
    logit_quant_bits: int = 0        # 0 = fp32 logits
    # Split-FedLLM
    split_layer: int = 1             # client keeps layers [0, split_layer)
    split_mode: str = "inter"        # inter | intra
    activation_quant_bits: int = 0   # 0 = bf16/fp32 activations
    # heterogeneous clients (SS IV.A.2)
    client_ranks: Optional[Tuple[int, ...]] = None
    hetero_agg: str = "zeropad"      # zeropad | svd
    # aggregation schedule
    aggregation: str = "sync"        # sync | async
    staleness_decay: float = 0.5     # weight = (1 + staleness)^-decay
    max_staleness: int = 4
    # privacy / fault tolerance
    privacy: PrivacyConfig = dataclasses.field(default_factory=PrivacyConfig)
    faults: FaultConfig = dataclasses.field(default_factory=FaultConfig)
    robust_agg: str = "mean"         # mean | median | trimmed_mean | norm_clip
    trim_frac: float = 0.2           # per-side trim fraction (trimmed_mean)
    clip_norm: float = 0.0           # norm_clip threshold (0 = median norm)
    quorum: float = 0.0              # 0 = no quorum gate
    screen_factor: float = 0.0       # 0 = norm screen off
    # optimization
    lr: float = 1e-3
    optimizer: str = "adam"
    seed: int = 0
