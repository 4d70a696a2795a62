"""qwen3-moe-30b-a3b [moe]: 128 experts top-8, the skewed-expert-placement
showcase. [hf:Qwen/Qwen3-30B-A3B; hf]  48L d_model=2048 32H(kv=4)
per-expert d_ff=768 vocab=151936, head_dim=128, qk_norm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=0, moe_d_ff=768, n_experts=128, top_k=8,
    vocab_size=151936, head_dim=128,
    qk_norm=True, skewed_experts=True, fsdp=True,
    capacity_factor=1.25, rope_theta=1_000_000.0,
)
SCHEDULE = "cosine"
