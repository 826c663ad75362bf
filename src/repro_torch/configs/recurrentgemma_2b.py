"""recurrentgemma-2b [arXiv:2402.19427; hf] — RG-LRU + local attn, 1:2."""
from repro_torch.models.config import ArchConfig

config = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab_size=256000, activation="geglu", attention="sliding", window=2048,
    layer_pattern=("R", "R", "A"), microbatches=4,
)

smoke_config = ArchConfig(
    name="recurrentgemma-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
    vocab_size=512, activation="geglu", attention="sliding", window=32,
    layer_pattern=("R", "R", "A"), param_dtype="float32", dtype="float32",
    remat=False, padded_vocab=512,
)
