from petals_tpu_torch.models.bloom.config import BloomBlockConfig
from petals_tpu_torch.models.bloom.model import FAMILY  # noqa: F401  (registers "bloom")

__all__ = ["BloomBlockConfig"]
