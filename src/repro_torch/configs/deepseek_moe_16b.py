"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6,
first layer dense. [arXiv:2401.06066; hf]
28L d_model=2048 16H (kv=16) expert d_ff=1408 vocab=102400."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10_944,          # dense FFN width of the first (non-MoE) layer
    vocab_size=102_400,
    pattern=("attn",),
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    tie_embeddings=True,
)
