"""pixtral-12b [vlm]: pixtral-ViT frontend (STUB: input_specs supplies
precomputed patch embeddings) + mistral-nemo-like decoder backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]
40L d_model=5120 32H(kv=8) d_ff=14336 vocab=131072, head_dim=128."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=128,
    n_img_tokens=1024, rope_theta=1_000_000.0, fsdp=True,
)
SCHEDULE = "cosine"
