from petals_tpu_torch.models.mixtral.config import MixtralBlockConfig
from petals_tpu_torch.models.mixtral.model import FAMILY  # noqa: F401  (registers "mixtral")

__all__ = ["MixtralBlockConfig"]
