"""Model families served by the port: llama, mistral and qwen2."""

import petals_tpu_torch.models.llama  # noqa: F401  (registers "llama")
import petals_tpu_torch.models.mistral  # noqa: F401  (registers "mistral")
import petals_tpu_torch.models.qwen2  # noqa: F401  (registers "qwen2")
