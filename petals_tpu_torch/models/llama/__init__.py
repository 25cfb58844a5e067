from petals_tpu_torch.models.llama.config import LlamaBlockConfig
from petals_tpu_torch.models.llama.model import FAMILY  # noqa: F401  (registers "llama")

__all__ = ["LlamaBlockConfig"]
