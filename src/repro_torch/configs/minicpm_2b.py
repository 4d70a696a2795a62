"""minicpm-2b [dense]: llama-like with mup-style scaling + WSD schedule.
[arXiv:2404.06395; hf]  40L d_model=2304 36H(kv=36) d_ff=5760 vocab=122753.
Tied embeddings; embed x12; residual x(1.4/sqrt(40)); logits x(256/2304)."""
import math

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab_size=122753,
    tie_embeddings=True,
    embed_scale=12.0,
    residual_scale=1.4 / math.sqrt(40),
    logit_scale=256.0 / 2304.0,
    rope_theta=10_000.0,
    parallelism="zero3",
)
SCHEDULE = "wsd"  # warmup-stable-decay (optim.schedules.wsd)
