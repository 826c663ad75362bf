"""mixtral-8x7b [arXiv:2401.04088; hf] — 8 experts top-2, SWA."""
from repro_torch.models.config import ArchConfig

config = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, head_dim=128, activation="swiglu",
    n_experts=8, top_k=2, attention="sliding", window=4096, microbatches=4,
)

smoke_config = ArchConfig(
    name="mixtral-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, activation="swiglu", n_experts=4, top_k=2,
    attention="sliding", window=32, param_dtype="float32", dtype="float32",
    remat=False, padded_vocab=512,
)
