"""recurrentgemma-9b — RG-LRU + local attention, 2 recurrent : 1 attn.
[arXiv:2402.19427; unverified]  38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000, window 2048."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    pattern=("rglru", "rglru", "local"),
    window=2048,
    lru_width=4096,
    conv_width=4,
    tie_embeddings=True,
)
