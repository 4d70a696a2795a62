"""qwen3-4b [dense]: GQA + per-head qk RMSNorm. [hf:Qwen/Qwen3-8B family; hf]
36L d_model=2560 32H(kv=8) d_ff=9728 vocab=151936, head_dim=128."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0,
)
SCHEDULE = "cosine"
