"""Architecture configuration dataclass shared by all 10 assigned archs.

The port's own copy of repro.models.config.ArchConfig (importing that one
runs repro/models/__init__.py, which imports the JAX registry): the same
fields, defaults and counts (vocab_padded, param_count,
active_param_count, _pattern).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # MLP / MoE
    activation: str = "swiglu"  # swiglu | relu2 | gelu
    n_experts: int = 0          # 0 -> dense MLP
    top_k: int = 0

    # Attention flavour
    attention: str = "full"     # full | sliding
    window: int = 4096
    qk_norm: bool = False
    rope_theta: float = 10_000.0

    # Hybrid (recurrentgemma): repeating layer pattern, 'R' = RG-LRU block,
    # 'A' = (local) attention block. Empty -> all 'A' (or all 'R' for ssm).
    layer_pattern: Tuple[str, ...] = ()

    # SSM (rwkv6)
    rwkv_head_dim: int = 64

    # Encoder-decoder (whisper)
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500

    # VLM (pixtral): number of prefix patch-embedding positions in train.
    n_patch_tokens: int = 0

    # Numerics / training
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    optimizer_dtype: str = "float32"   # AdamW moment dtype (bf16 for giants)
    remat: bool = True
    microbatches: int = 1              # gradient-accumulation steps

    # Sharding knobs (see distributed/sharding.py)
    fsdp: bool = True                  # shard weights over the data axis too
    shard_heads: bool = True
    zero1: bool = False                # ZeRO-1: params/grads TP-only
                                       # (contractions local), optimizer
                                       # moments fully sharded (fsdp x tp)
    pregather: bool = False            # all-gather FSDP weights once per
                                       # step (not per microbatch) — trades
                                       # peak memory for HBM/ICI traffic
    seq_shard_acts: bool = False       # sequence-parallel activations:
                                       # shard S over the model axis at
                                       # layer boundaries (reduce-scatter/
                                       # all-gather instead of all-reduce)
    rwkv_chunk: int = 64               # WKV chunk length (perf knob)
    attn_scores_f32: bool = True       # f32 softmax (False: bf16 scores —
                                       # halves attention HBM traffic)

    # Padded vocab for TP divisibility (0 -> auto: next multiple of 128*tp).
    padded_vocab: int = 0

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def vocab_padded(self, tp: int = 16) -> int:
        if self.padded_vocab:
            return self.padded_vocab
        mult = 128 * tp
        return -(-self.vocab_size // mult) * mult

    def param_count(self) -> int:
        """Total parameters (embedding + layers + head), for 6ND roofline."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        attn = d * hd * (nq + 2 * nkv) + nq * hd * d
        if self.activation in ("swiglu", "geglu"):
            mlp_dense = 3 * d * f
        else:
            mlp_dense = 2 * d * f
        mlp = mlp_dense * max(self.n_experts, 1)
        if self.n_experts:
            mlp += d * self.n_experts       # router
        per_layer = attn + mlp + 2 * d
        if self.family == "ssm":
            # rwkv6: r,k,v,g,w projections + output (~6 d^2) + ffn (2 d f)
            per_layer = 6 * d * d + 2 * d * f + 2 * d
        if self.family == "hybrid":
            # average over pattern: R blocks ~ (3 d^2 + gates) vs attn
            n_r = sum(1 for c in self._pattern() if c == "R")
            n_a = self.n_layers - n_r
            r_block = 3 * d * d + 2 * d * f
            a_block = attn + (3 * d * f if self.activation == "swiglu"
                              else 2 * d * f)
            return (v * d * 2 + n_r * r_block + n_a * a_block + 2 * d)
        total = v * d * 2 + self.n_layers * per_layer + d
        if self.family == "encdec":
            # encoder layers: self-attn + mlp; decoder adds cross-attn.
            enc = self.n_encoder_layers * (attn + mlp_dense + 2 * d)
            dec = self.n_layers * (2 * attn + mlp_dense + 3 * d)
            total = v * d * 2 + enc + dec + d
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts), for 6*N_act*D."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp_dense = (3 if self.activation in ("swiglu", "geglu") else 2) * d * f
        inactive = (self.n_experts - self.top_k) * mlp_dense * self.n_layers
        return self.param_count() - inactive

    def _pattern(self) -> Tuple[str, ...]:
        """Full per-layer pattern of length n_layers."""
        if not self.layer_pattern:
            return tuple("A" * self.n_layers)
        reps = -(-self.n_layers // len(self.layer_pattern))
        return (self.layer_pattern * reps)[: self.n_layers]
