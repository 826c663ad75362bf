"""phi4-mini-3.8b [arXiv:2412.08905; hf] — RoPE SwiGLU GQA."""
from repro_torch.models.config import ArchConfig

config = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab_size=200064, activation="swiglu", attention="full",
    microbatches=2,
)

smoke_config = ArchConfig(
    name="phi4-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, activation="swiglu", attention="full",
    param_dtype="float32", dtype="float32", remat=False, padded_vocab=512,
)
