"""dbrx-132b [hf:databricks/dbrx-base; unverified] — 16 experts top-4."""
from repro_torch.models.config import ArchConfig

config = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab_size=100352, head_dim=128, activation="swiglu",
    n_experts=16, top_k=4, attention="full", microbatches=8,
    optimizer_dtype="bfloat16",
)

smoke_config = ArchConfig(
    name="dbrx-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=512, activation="swiglu", n_experts=4, top_k=2,
    attention="full", param_dtype="float32", dtype="float32",
    remat=False, padded_vocab=512,
)
