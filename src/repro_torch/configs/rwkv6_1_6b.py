"""rwkv6-1.6b Finch [arXiv:2404.05892; unverified] — data-dependent decay."""
from repro_torch.models.config import ArchConfig

config = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=0, n_kv_heads=0, d_ff=7168,
    vocab_size=65536, activation="relu2", attention="full",
    rwkv_head_dim=64, microbatches=2,
)

smoke_config = ArchConfig(
    name="rwkv6-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=128,
    vocab_size=512, activation="relu2", rwkv_head_dim=16,
    param_dtype="float32", dtype="float32", remat=False, padded_vocab=512,
)
