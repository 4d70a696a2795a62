"""grok-1-314b [moe]: 8 experts top-2, attention/logit softcap 30.
[hf:xai-org/grok-1; unverified]  64L d_model=6144 48H(kv=8) d_ff=32768
vocab=131072.  Few big experts -> tensor parallelism inside the experts
(expert_tp, so the expert permutations are the identity).  Carried as a
config: its 316 B parameters fit on no single card."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=0, moe_d_ff=32768, n_experts=8, top_k=2,
    vocab_size=131072, head_dim=128,
    attn_softcap=30.0, logit_softcap=30.0, act="gelu",
    expert_tp=True, fsdp=True, capacity_factor=1.25,
    rope_theta=10_000.0,
)
SCHEDULE = "cosine"
