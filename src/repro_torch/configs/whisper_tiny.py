"""whisper-tiny — enc-dec audio; conv frontend is a STUB (input_specs
provides precomputed 1500-frame embeddings). [arXiv:2212.04356; unverified]
4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,            # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51_865,
    pattern=("xattn",),
    is_encoder_decoder=True,
    n_enc_layers=4,
    enc_seq=1500,
    tie_embeddings=True,
)
