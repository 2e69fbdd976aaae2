"""Architecture configuration schema shared by all assigned archs."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int           # per-expert FFN hidden dim
    n_shared: int = 0       # shared (always-on) experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str             # dense | moe | vlm | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 128
    activation: str = "swiglu"   # swiglu | relu2 | gelu
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    # MoE
    moe: MoEConfig | None = None

    # hybrid (recurrentgemma): block pattern unit, e.g. ("rec","rec","attn")
    block_pattern: tuple[str, ...] | None = None
    local_window: int | None = None
    d_rnn: int | None = None
    conv_width: int = 4

    # ssm (rwkv6)
    rwkv_head_dim: int = 64

    # encdec (whisper)
    n_encoder_layers: int = 0
    n_frames: int = 1500      # stubbed audio frontend output length

    # vlm (phi-3-vision): stubbed patch-embedding prefix
    n_patches: int = 0

    # paper-technique integration: LUT-approximated nonlinearities
    lut_activation: bool = False
    lut_act_bits_in: int = 10
    lut_act_bits_out: int = 10
    # which registered sites (repro_torch.sites) get LUT treatment: "act"
    # (activation sites only — the default, pre-registry behavior),
    # "all", or an explicit tuple of site keys
    lut_sites: str | tuple = "act"
    # fuse the LUT activation into the surrounding matmul epilogue (one
    # Pallas kernel: GEMM -> quantize -> Eq.(1) -> dequantize while the
    # tile is in VMEM); Pallas backend, single-device serving only —
    # under a mesh or an active capture the unfused path runs instead
    lut_fuse: bool = False
    # tanh soft-capping scale applied to the final logits (None = off);
    # when set, the softcap tanh is itself a registered LUT site
    logit_softcap: float | None = None

    # quality-of-life
    max_seq_len: int = 524288

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode memory: SSM state or bounded local window."""
        return self.family in ("ssm", "hybrid")

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    def n_params(self) -> int:
        """Approximate parameter count (embeddings included)."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            per_layer = d * d * 4 + d * self.d_ff * 2 + d * 64
        elif self.family == "hybrid":
            drnn = self.d_rnn or d
            rec = d * drnn * 3 + drnn * self.conv_width + drnn * d
            attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
            unit = self.block_pattern or ("rec", "rec", "attn")
            frac_attn = unit.count("attn") / len(unit)
            per_layer = rec * (1 - frac_attn) + attn * frac_attn
            per_layer += 3 * d * self.d_ff
        else:
            attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
            if self.moe:
                ff = 3 * d * self.moe.d_expert * (
                    self.moe.n_experts + self.moe.n_shared
                ) + d * self.moe.n_experts
            else:
                mult = 3 if self.activation == "swiglu" else 2
                ff = mult * d * self.d_ff
            per_layer = attn + ff
        n = emb + int(per_layer) * self.n_layers
        if self.family == "encdec":
            n += self.n_encoder_layers * int(per_layer)
        return int(n)

    def n_active_params(self) -> int:
        """Params touched per token (MoE: only routed-active experts)."""
        if not self.moe:
            return self.n_params()
        d = self.d_model
        attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        ff = 3 * d * self.moe.d_expert * (self.moe.top_k + self.moe.n_shared)
        ff += d * self.moe.n_experts  # router
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(emb + (attn + ff) * self.n_layers)
