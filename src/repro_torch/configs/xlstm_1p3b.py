"""xlstm-1.3b [ssm]: mLSTM + sLSTM blocks. [arXiv:2405.04517; unverified]
48L d_model=2048 4H d_ff=0 vocab=50304.  7:1 mLSTM:sLSTM ratio
(slstm_every=8); mLSTM proj_factor 2 -> d_inner=4096, P=1024 per head."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304, slstm_every=8,
    parallelism="zero3",
)
SCHEDULE = "cosine"
