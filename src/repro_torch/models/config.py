"""Model configuration — one dataclass covering all 10 assigned families.

The port's own copy of ``repro.models.config.ModelConfig``, with the same
fields and defaults, so that a config means the same thing to both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // num_heads

    # attention options
    qk_norm: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    # repeating block pattern, e.g. ("local", "global") for gemma2,
    # ("rglru", "rglru", "local") for recurrentgemma, ("ssd",) for mamba2.
    pattern: Tuple[str, ...] = ("global",)
    rope_theta: float = 10000.0

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    first_dense_layers: int = 0
    first_dense_ff: int = 0
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_width: int = 4
    ssd_chunk: int = 128

    # RG-LRU (recurrentgemma)
    lru_width: int = 0

    # encoder-decoder
    enc_layers: int = 0            # encdec: encoder depth (num_layers = dec)
    cross_attention: bool = False

    # modality frontend stub
    frontend: Optional[str] = None     # "patches" | "frames"
    frontend_tokens: int = 0           # tokens contributed by the frontend

    # norms / misc
    norm_eps: float = 1e-6
    act: str = "silu"
    tie_embeddings: bool = True
    embed_scale: bool = False          # gemma-style sqrt(d_model) scaling
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "nothing_saveable"    # "none" | "nothing_saveable" | "dots"
    # attention implementation: "auto" picks the CUDA flash kernel for CUDA
    # tensors and the chunked path on the CPU; "chunked" always takes the
    # chunked path
    attn_impl: str = "auto"
    attn_chunk: int = 512
    # chunked cross-entropy: compute logits+CE over sequence chunks of this
    # size (0 = whole sequence at once); bounds the (B,S,V) logits temp
    ce_chunk: int = 0

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    # -- derived -------------------------------------------------------------

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def pattern_repeats(self) -> Tuple[int, int]:
        """(full pattern repeats, tail length) over num_layers."""
        n = len(self.pattern)
        return self.num_layers // n, self.num_layers % n

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        e, h, kv, hd, f, v = (self.d_model, self.num_heads, self.num_kv_heads,
                              self.head_dim, self.d_ff, self.vocab_size)
        embed = v * e * (1 if self.tie_embeddings else 2)
        total = embed
        reps, tail = self.pattern_repeats
        counts = {}
        for kind in self.pattern:
            counts[kind] = counts.get(kind, 0) + reps
        for i, kind in enumerate(self.pattern[:tail]):
            counts[kind] = counts.get(kind, 0) + 1
        for kind, n in counts.items():
            if kind in ("global", "local"):
                attn = e * (h * hd + 2 * kv * hd) + h * hd * e
                blk = attn + 3 * e * f + 2 * e
            elif kind == "moe":
                attn = e * (h * hd + 2 * kv * hd) + h * hd * e
                routed = self.num_experts * 3 * e * self.expert_d_ff
                shared = self.num_shared_experts * 3 * e * self.expert_d_ff
                blk = attn + routed + shared + e * self.num_experts + 2 * e
            elif kind == "ssd":
                di = self.d_inner
                blk = (e * (2 * di + 2 * self.ssm_state + self.ssm_heads)
                       + di * e + self.conv_width * di + 2 * e)
            elif kind == "rglru":
                w = self.lru_width or e
                blk = (e * 2 * w + w * e + 2 * w * self.conv_width
                       + 2 * w * w + 3 * w + 3 * e * f + 2 * e)
            elif kind == "cross":
                blk = e * (h * hd * 2 + 2 * kv * hd) + h * hd * e + 2 * e
            else:
                blk = 0
            total += n * blk
        if self.family == "moe" and self.first_dense_layers:
            # replace routed block ffn with a dense one for the first layers
            total += self.first_dense_layers * (
                3 * self.d_model * (self.first_dense_ff or self.d_ff))
        if self.enc_layers:
            attn = e * (h * hd + 2 * kv * hd) + h * hd * e
            total += self.enc_layers * (attn + 3 * e * f + 2 * e)
            # decoder cross-attention
            total += self.num_layers * (e * (h * hd + 2 * kv * hd)
                                        + h * hd * e + e)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        full = self.param_count()
        inactive = (self.num_experts - self.top_k) * 3 * self.d_model \
            * self.expert_d_ff * self.num_layers
        return full - inactive
