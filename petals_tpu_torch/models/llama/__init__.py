from petals_tpu_torch.models.llama.block import FAMILY  # noqa: F401  (registers "llama")
from petals_tpu_torch.models.llama.config import LlamaBlockConfig

__all__ = ["LlamaBlockConfig"]
