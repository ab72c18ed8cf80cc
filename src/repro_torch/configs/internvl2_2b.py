"""internvl2-2b — VLM: InternViT frontend STUB (precomputed patch
embeddings) + InternLM2 backbone. [arXiv:2404.16821; hf]
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92_553,
    pattern=("attn",),
    n_patches=256,
    tie_embeddings=True,
)
