"""gemma3-27b — 5:1 local:global interleave, 128k context, qk-norm.
[hf:google/gemma-3-1b-pt; unverified]  62L d_model=5376 32H (kv=16)
d_ff=21504 vocab=262144, sliding window 1024."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21_504,
    vocab_size=262_144,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
