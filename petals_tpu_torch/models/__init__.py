"""Model families served by the port: llama and mistral."""

import petals_tpu_torch.models.llama  # noqa: F401  (registers "llama")
import petals_tpu_torch.models.mistral  # noqa: F401  (registers "mistral")
