"""whisper-large-v3 [arXiv:2212.04356; unverified] — enc-dec, conv stub."""
from repro_torch.models.config import ArchConfig

config = ArchConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab_size=51866, activation="gelu", attention="full",
    n_encoder_layers=32, n_audio_frames=1500, microbatches=2,
)

smoke_config = ArchConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, activation="gelu", attention="full",
    n_encoder_layers=2, n_audio_frames=16, param_dtype="float32",
    dtype="float32", remat=False, padded_vocab=512,
)
