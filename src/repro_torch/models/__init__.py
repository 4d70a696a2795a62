"""Model zoo of the port: the decoder-only LM of the dense, vlm, moe,
hybrid and ssm families, and the whisper-style encoder-decoder."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import LM


def build_model(cfg: ModelConfig) -> LM | EncDecLM:
    """Facade constructor: the same interface for every family;
    ``EncDecLM`` for the encdec family, ``LM`` for the others."""
    return EncDecLM(cfg) if cfg.family == "encdec" else LM(cfg)


__all__ = ["EncDecLM", "LM", "ModelConfig", "build_model"]
