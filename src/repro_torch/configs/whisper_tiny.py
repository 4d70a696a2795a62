"""whisper-tiny [audio]: enc-dec, conv frontend STUB (input_specs supplies
precomputed frame embeddings). [arXiv:2212.04356; unverified]
4L enc + 4L dec, d_model=384 6H(kv=6) d_ff=1536 vocab=51865.
Positions are sinusoidal, as in the reference (``models.encdec``): a
deviation from Whisper's learned decoder table."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, n_enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865, n_frames=1500,
    norm="layernorm", act="gelu", tie_embeddings=True,
    parallelism="zero3",  # 41M params: same analytic rule as qwen2/minicpm
)
SCHEDULE = "cosine"
