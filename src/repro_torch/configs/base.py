"""Model / run configuration dataclasses (the port's own copy).

A copy of ``repro.configs.base``: the port imports nothing of ``repro``,
so these dataclasses are repeated here, field for field, and a parity
test holds the two copies equal.  The layer stack is a *periodic
pattern*: ``pattern`` is the tuple of block kinds inside one period and
``n_periods`` repeats it, so ``n_layers == len(pattern) * n_periods``.
The port runs every block kind of the reference: ``attn``, ``swa``,
``moe``, ``moe_swa``, ``mamba2``, ``shared_attn``, ``mlstm``, ``slstm``,
``cross`` (self-attention, then cross-attention to the vision stub or
the encoder's output) and ``enc_attn`` (the whisper encoder's
bidirectional blocks).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    # projection names inside attention blocks that receive adapters
    targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # layer program -----------------------------------------------------
    pattern: Tuple[str, ...] = ("attn",)
    n_periods: int = 0               # 0 -> n_layers / len(pattern)
    # attention ----------------------------------------------------------
    head_dim: int = 0                # 0 -> d_model // n_heads
    rope_theta: float = 500000.0
    sliding_window: int = 0          # 0 -> full attention
    # extras ---------------------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_dim: int = 4
    # vlm / enc-dec --------------------------------------------------------
    n_vision_tokens: int = 0
    encoder_layers: int = 0
    encoder_len_ratio: int = 1
    decoder_len_ratio: int = 1
    # adapters / training --------------------------------------------------
    lora: Optional[LoRAConfig] = LoRAConfig()
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    remat: bool = True
    remat_policy: str = "full"
    attn_block: int = 512
    mlstm_chunk: int = 0
    batched_vjp: bool = True
    tensor_parallel: bool = True
    # provenance -----------------------------------------------------------
    source: str = ""
    # capability flags -------------------------------------------------------
    subquadratic: bool = False
    is_encoder_decoder: bool = False

    # ------------------------------------------------------------------ derived
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_periods == 0:
            object.__setattr__(
                self, "n_periods", max(1, self.n_layers // len(self.pattern)))

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def reduced(self, n_layers: int = 2, d_model: int = 256,
                vocab: int = 512) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests.

        It has ``n_heads == n_kv_heads`` for llama, i.e. no GQA: tests that
        need grouped heads replace ``n_kv_heads`` afterwards.
        """
        pat = self.pattern
        n_per = max(1, n_layers // len(pat))
        n_heads = max(2, min(4, self.n_heads))
        n_kv = max(1, min(n_heads, self.n_kv_heads))
        if n_heads % n_kv:
            n_kv = 1
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(self.moe,
                                      n_experts=min(4, self.moe.n_experts),
                                      top_k=min(2, self.moe.top_k))
        return dataclasses.replace(
            self, name=self.name + "-smoke", n_layers=n_per * len(pat),
            n_periods=n_per, d_model=d_model, n_heads=n_heads,
            n_kv_heads=n_kv, head_dim=d_model // n_heads,
            d_ff=2 * d_model, vocab=vocab, moe=moe,
            ssm_state=min(16, self.ssm_state) if self.ssm_state else 0,
            n_vision_tokens=min(16, self.n_vision_tokens),
            encoder_layers=min(2, self.encoder_layers),
            sliding_window=min(128, self.sliding_window)
            if self.sliding_window else 0,
        )

    def param_count(self, active_only: bool = False) -> int:
        """Parameters of every block kind, adapters excluded: the
        reference's arithmetic, copied as it is.  ``active_only`` counts
        the top-k experts of an MoE block in place of all of them (its
        router still counts every expert).

        A ``shared_attn`` slot counts its parameter set once per pattern
        slot, although the tree holds one set: for zamba2-1.2b (3 shared
        slots) that gives 1,150,912,512 where the tree holds 1,017,085,952
        parameters (262,144 of them the shared block's f32 LoRA factors).
        """
        d, dff, hd = self.d_model, self.d_ff, self.head_dim
        per = {}
        q = self.n_heads * hd
        kv = self.n_kv_heads * hd
        attn = d * q + 2 * d * kv + q * d
        mlp = 3 * d * dff
        if self.moe is not None:
            n_e = self.moe.top_k if active_only else self.moe.n_experts
            moe_mlp = 3 * d * dff * n_e + d * self.moe.n_experts
        else:
            moe_mlp = mlp
        din = self.ssm_expand * d
        nh_ssm = max(1, din // self.ssm_head_dim) if self.ssm_state else 0
        mamba = (d * (2 * din + 2 * self.ssm_state + nh_ssm)  # in_proj
                 + self.conv_dim * (din + 2 * self.ssm_state)
                 + din * d + nh_ssm * 2)                       # out_proj, A, D
        per["attn"] = attn + mlp + 2 * d
        per["enc_attn"] = per["attn"]
        per["swa"] = per["attn"]
        per["moe"] = attn + moe_mlp + 2 * d
        per["moe_swa"] = per["moe"]
        per["cross"] = attn + (d * q + 2 * d * kv + q * d) + mlp + 3 * d
        per["mamba2"] = mamba + d
        per["shared_attn"] = attn + mlp + 2 * d
        per["mlstm"] = (d * 3 * q + q * d + 2 * d * dff if dff else
                        d * 3 * q + q * d + 3 * self.n_heads * hd) + d
        per["slstm"] = 4 * (d * d + d * d + 2 * d) + d
        total = 0
        for kind in self.pattern:
            # one parameter set for every shared_attn slot
            n = 1 if kind == "shared_attn" else self.n_periods
            total += per[kind] * n
        total += self.vocab * d              # embed
        if not self.tie_embeddings:
            total += self.vocab * d          # lm head
        total += d                           # final norm
        if self.encoder_layers:
            total += self.encoder_layers * per["enc_attn"]
        return int(total)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class FIRMConfig:
    """Hyper-parameters of the paper's algorithm (Alg. 1 + App. A)."""
    n_objectives: int = 2
    n_clients: int = 8
    rounds: int = 16
    local_steps: int = 3             # K
    batch_size: int = 16             # B prompts per local step
    beta: float = 0.01               # MGDA regularization (T2)
    preference: Optional[Tuple[float, ...]] = None   # p vector (Eq. 3)
    participation: float = 1.0
    client_preferences: Optional[Tuple[Tuple[float, ...], ...]] = None
    client_local_steps: Optional[Tuple[int, ...]] = None
    lambda_smoothing: bool = True    # eta_t smoothing (Alg. 2, Eq. 12)
    eta0: float = 1.0
    actor_lr: float = 6e-5
    critic_lr: float = 1e-4
    ppo_clip: float = 0.2
    kl_target: float = 0.03
    kl_coef_init: float = 0.1
    gamma: float = 0.99
    gae_lambda: float = 0.95
    trace_normalize: bool = True     # App. A Gram normalisation
    solver: str = "pgd"              # pgd | closed_form_m2 | frank_wolfe
    solver_iters: int = 100


@dataclasses.dataclass(frozen=True)
class SchedConfig:
    """Scheduler knobs (the reference's ``repro.fed.sched``), field for
    field, read by the planner and ``fed.sched.ScheduledTrainer``.

    ``policy`` selects the aggregation discipline; ``profile`` names a
    heterogeneity preset.  The deadline policy over-selects by
    ``overselect`` and drops participants whose predicted round time
    exceeds the deadline (absolute seconds, or the ``deadline_quantile``
    of the selected cohort's predicted times when set).  The fedbuff
    policy aggregates every ``buffer_size`` arrivals with staleness
    weights w ~ (1+s)^-staleness_pow and scales FIRM's beta by the
    client's observed staleness bucket.
    """
    policy: str = "sync"             # sync | deadline | fedbuff
    profile: str = "homogeneous"     # profiles preset name
    profile_seed: int = 0
    # deadline policy
    overselect: float = 1.0          # select overselect * (p * C) clients
    deadline_s: float = float("inf")
    deadline_quantile: Optional[float] = None
    # fedbuff policy
    buffer_size: int = 0             # aggregate every B arrivals; 0 -> C
    staleness_pow: float = 0.5
    staleness_beta_gain: float = 0.0
    staleness_beta_cap: float = 8.0
    staleness_bucket_max: int = 3    # beta buckets bound retraces


# Deployment-profile codec presets (``repro_torch.comms`` registry specs):
# the (uplink, downlink) pairs of ``repro.configs.base.CODEC_PRESETS``.
# Uplink is the scarce direction for cross-device FL, hence the asymmetry.
CODEC_PRESETS = {
    "datacenter": ("identity", "identity"),      # measured baseline
    "wan": ("int8+ef", "identity"),              # ~4x uplink reduction
    "mobile": ("int4+ef", "int8"),               # both directions coded
    "extreme": ("topk:0.05+ef", "int8"),         # ~10x uplink reduction
    "powersgd": ("lowrank:4+ef", "identity"),    # rank-r sketch uplink
}
