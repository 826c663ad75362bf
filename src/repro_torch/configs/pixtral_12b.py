"""pixtral-12b [hf:mistralai/Pixtral-12B-2409; unverified] — ViT stub + nemo."""
from repro_torch.models.config import ArchConfig

config = ArchConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=131072, head_dim=128, activation="swiglu", attention="full",
    n_patch_tokens=1024, microbatches=2,
)

smoke_config = ArchConfig(
    name="pixtral-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, activation="swiglu", attention="full", n_patch_tokens=8,
    param_dtype="float32", dtype="float32", remat=False, padded_vocab=512,
)
