"""command-r-plus-104b [hf:CohereForAI; unverified] — GQA, no-bias."""
from repro_torch.models.config import ArchConfig

config = ArchConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=33792,
    vocab_size=256000, head_dim=128, activation="swiglu", attention="full",
    microbatches=8, optimizer_dtype="bfloat16",
)

smoke_config = ArchConfig(
    name="command-r-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, activation="swiglu", attention="full",
    param_dtype="float32", dtype="float32", remat=False, padded_vocab=512,
)
