"""LM architecture configuration, a jax-free copy of
`repro.models.lm.config`.

One `LMConfig` describes every architecture family of the reference:
dense GQA transformers, MoE, SSM (mamba2 SSD), hybrid (parallel attn+SSM
heads), VLM/audio backbones and encoder-decoder.  `layer_types` gives the
per-layer block type (period-2 alternation for gemma2, fixed global
islands for hymba, uniform otherwise).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # attention
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attn_softcap: float | None = None
    final_softcap: float | None = None
    window: int | None = None          # sliding-window width
    layer_pattern: str = "global"      # global | swa | local_global | hymba
    attn_scale: float | None = None    # override 1/sqrt(head_dim)

    # block structure
    mlp: str = "swiglu"                # swiglu | geglu | gelu | none
    norm: str = "rmsnorm"              # rmsnorm | layernorm | nonparam_ln
    sandwich_norm: bool = False        # gemma2 pre+post norms
    scale_embedding: bool = False      # gemma-style sqrt(d) input scaling
    tie_embeddings: bool = True

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 / hymba SSM heads)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 64

    # encoder-decoder
    n_enc_layers: int = 0              # >0 => enc-dec (encoder bidirectional)

    # modality frontend stub: input_specs() supplies (B, S_front, d) embeds
    frontend: str | None = None        # vit_stub | audio_stub
    frontend_len: int = 0              # frontend positions per sample

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    def layer_types(self) -> list[str]:
        """Per-layer block type."""
        n = self.n_layers
        if self.family == "ssm":
            return ["ssm"] * n
        if self.layer_pattern == "global":
            return ["attn"] * n
        if self.layer_pattern == "swa":
            return ["swa"] * n
        if self.layer_pattern == "local_global":
            # gemma2: alternating local (sliding window) / global
            return ["swa" if i % 2 == 0 else "attn" for i in range(n)]
        if self.layer_pattern == "hymba":
            # hymba: parallel attn+SSM heads everywhere; full attention on
            # first / middle / last layers, SWA elsewhere (arXiv:2411.13676)
            glob = {0, n // 2, n - 1}
            return ["hybrid_g" if i in glob else "hybrid_s" for i in range(n)]
        raise ValueError(self.layer_pattern)

    def params_per_token(self) -> float:
        """Active parameters touched per token (for 6ND MODEL_FLOPS)."""
        d, hq, hkv, hd = self.d_model, self.n_heads, self.n_kv_heads, \
            self.head_dim
        total = 0.0
        for t in self.layer_types():
            if t in ("attn", "swa"):
                attn = d * (hq + 2 * hkv) * hd + hq * hd * d
                total += attn
                total += self._mlp_params()
            elif t == "ssm":
                total += self._ssm_params()
            elif t.startswith("hybrid"):
                attn = d * (hq + 2 * hkv) * hd + hq * hd * d
                total += attn + self._ssm_params() + self._mlp_params()
        if self.is_encdec:   # add encoder + cross-attention
            enc = self.n_enc_layers * (4 * d * hq * hd + self._mlp_params())
            cross = self.n_layers * (4 * d * hq * hd)
            total += enc + cross
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        return total

    def _mlp_params(self) -> float:
        if self.mlp == "none" or self.d_ff == 0:
            return 0.0
        mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        per_ff = mult * self.d_model * self.d_ff
        if self.n_experts:           # active experts only
            return self.top_k * per_ff + self.d_model * self.n_experts
        return per_ff

    def total_params(self) -> float:
        """Total (not active) parameters, for memory estimates."""
        act = self.params_per_token()
        if self.n_experts:
            mult = 3 if self.mlp in ("swiglu", "geglu") else 2
            per_ff = mult * self.d_model * self.d_ff
            act += self.n_layers * (self.n_experts - self.top_k) * per_ff
        return act

    def _ssm_params(self) -> float:
        di, ds, h = self.d_inner, self.ssm_state, self.ssm_heads
        in_proj = self.d_model * (2 * di + 2 * ds + h)
        out_proj = di * self.d_model
        return in_proj + out_proj + self.ssm_conv * (di + 2 * ds)
