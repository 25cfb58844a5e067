"""Model families served by the port: llama, mistral, qwen2, gemma and phi3
(the llama block), bloom, falcon, mixtral and gemma2."""

import petals_tpu_torch.models.bloom  # noqa: F401  (registers "bloom")
import petals_tpu_torch.models.falcon  # noqa: F401  (registers "falcon")
import petals_tpu_torch.models.gemma  # noqa: F401  (registers "gemma")
import petals_tpu_torch.models.gemma2  # noqa: F401  (registers "gemma2")
import petals_tpu_torch.models.llama  # noqa: F401  (registers "llama")
import petals_tpu_torch.models.mistral  # noqa: F401  (registers "mistral")
import petals_tpu_torch.models.mixtral  # noqa: F401  (registers "mixtral")
import petals_tpu_torch.models.phi3  # noqa: F401  (registers "phi3")
import petals_tpu_torch.models.qwen2  # noqa: F401  (registers "qwen2")
