"""Model zoo of the port: the decoder-only LM of the dense, moe, hybrid and
ssm families (other families wait for ROADMAP A9)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM


def build_model(cfg: ModelConfig) -> LM:
    """Facade constructor; raises for a family the port does not run."""
    return LM(cfg)


__all__ = ["LM", "ModelConfig", "build_model"]
