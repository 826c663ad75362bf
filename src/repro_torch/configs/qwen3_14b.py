"""qwen3-14b [hf:Qwen/Qwen3-8B family; hf] — qk_norm, GQA."""
from repro_torch.models.config import ArchConfig

config = ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=17408,
    vocab_size=151936, head_dim=128, activation="swiglu", attention="full",
    qk_norm=True, microbatches=2,
)

smoke_config = ArchConfig(
    name="qwen3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, activation="swiglu", attention="full", qk_norm=True,
    param_dtype="float32", dtype="float32", remat=False, padded_vocab=512,
)
