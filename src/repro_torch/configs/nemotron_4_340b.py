"""nemotron-4-340b [arXiv:2402.16819; unverified] — GQA, squared-ReLU."""
from repro_torch.models.config import ArchConfig

config = ArchConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, d_ff=73728,
    vocab_size=256000, activation="relu2", attention="full",
    microbatches=16, optimizer_dtype="bfloat16",
)

smoke_config = ArchConfig(
    name="nemotron-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab_size=512, activation="relu2", attention="full",
    param_dtype="float32", dtype="float32", remat=False, padded_vocab=512,
)
