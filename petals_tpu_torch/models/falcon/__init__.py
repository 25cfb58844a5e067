from petals_tpu_torch.models.falcon.config import FalconBlockConfig
from petals_tpu_torch.models.falcon.model import FAMILY  # noqa: F401  (registers "falcon")

__all__ = ["FalconBlockConfig"]
