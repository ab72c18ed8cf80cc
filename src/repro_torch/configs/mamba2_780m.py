"""mamba2-780m — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]  48L d_model=1536 d_ff=0 vocab=50280 state=128."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=24,        # unused (attn-free); kept for head_dim bookkeeping
    n_kv_heads=24,
    d_ff=0,
    vocab_size=50_280,
    pattern=("ssm",),
    ssm_state=128,
    d_inner=3072,      # 2 * d_model
    ssm_head_dim=64,   # -> 48 SSD heads
    conv_width=4,
    ssm_chunk=64,
    tie_embeddings=True,
)
