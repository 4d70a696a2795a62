"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]  38L d_model=2048 32H(kv=32) d_ff=8192 vocab=32000,
ssm_state=64.  Shared transformer block applied every 6 mamba layers with
concat([h, h0]) input projection (Zamba-style weight sharing)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    shared_attn_period=6, rope_theta=10_000.0,
    parallelism="zero3",
)
SCHEDULE = "cosine"
