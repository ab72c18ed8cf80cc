"""moonshot-v1-16b-a3b (kimi/moonlight) — MoE 64e top-6, 2 shared.
[hf:moonshotai/Moonlight-16B-A3B; hf]
48L d_model=2048 16H (kv=16) expert d_ff=1408 vocab=163840."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=11_264,          # dense FFN width of the first (non-MoE) layer
    vocab_size=163_840,
    pattern=("attn",),
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    tie_embeddings=True,
)
