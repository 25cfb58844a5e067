"""Prompt tuning: trainable prompts held by the client
(petals_tpu/client/ptune.py).

- "ptune": ``pre_seq_len`` virtual tokens prepended to the input
  embeddings.
- "deep_ptune": also one trainable prompt a remote block, sent with every
  request and added by the servers to each block's input over its first
  ``pre_seq_len`` positions.

The prompts are float32 ``nn.Parameter``s on the client's device, drawn
from a ``torch.Generator`` seeded by ``seed`` (scaled by hidden**-0.5, as
petals_tpu scales its ``jax.random.normal`` draws; the draws themselves
differ). ``set_trainable_params`` copies values in place, so a torch
optimizer over ``parameters()`` keeps its references.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch


@dataclasses.dataclass
class PTuneConfig:
    pre_seq_len: int = 0
    tuning_mode: Optional[str] = None  # None | "ptune" | "deep_ptune"


class PTuneMixin:
    """Requires ``self.cfg`` (hidden_size, num_hidden_layers) and
    ``self.device``."""

    def init_ptune(self, ptune: Optional[PTuneConfig], seed: int = 0) -> None:
        self.ptune = ptune or PTuneConfig()
        self.prompt_embeddings: Optional[torch.nn.Parameter] = None
        self.deep_prompt_embeddings: Optional[torch.nn.Parameter] = None
        if self.ptune.tuning_mode is None or self.ptune.pre_seq_len == 0:
            return
        if self.ptune.tuning_mode not in ("ptune", "deep_ptune"):
            raise ValueError(f"tuning_mode must be 'ptune' or 'deep_ptune', got {self.ptune.tuning_mode!r}")
        gen = torch.Generator().manual_seed(seed)
        scale = 1.0 / math.sqrt(self.cfg.hidden_size)
        pre, hidden = self.ptune.pre_seq_len, self.cfg.hidden_size
        self.prompt_embeddings = torch.nn.Parameter(
            (torch.randn(pre, hidden, generator=gen) * scale).to(self.device))
        if self.ptune.tuning_mode == "deep_ptune":
            self.deep_prompt_embeddings = torch.nn.Parameter(
                (torch.randn(self.cfg.num_hidden_layers, pre, hidden, generator=gen) * scale).to(self.device))

    def apply_shallow_prompts(self, hidden: torch.Tensor) -> torch.Tensor:
        """``hidden`` [batch, seq, hidden] with the prompts prepended (the
        callers ask for them on a sequence's first feed only)."""
        if self.prompt_embeddings is None:
            return hidden
        prompts = self.prompt_embeddings.to(hidden.dtype)[None].expand(hidden.shape[0], -1, -1)
        return torch.cat([prompts, hidden], dim=1)

    def deep_prompts_for_batch(self, batch: int) -> Optional[torch.Tensor]:
        """The deep prompts broadcast over ``batch`` rows, [n_blocks, batch,
        pre_seq, hidden] (a view: its gradient sums over the rows)."""
        if self.deep_prompt_embeddings is None:
            return None
        deep = self.deep_prompt_embeddings
        return deep[:, None].expand(deep.shape[0], batch, *deep.shape[1:])

    def strip_shallow_prompt_logits(self, logits: torch.Tensor) -> torch.Tensor:
        if self.prompt_embeddings is None:
            return logits
        return logits[:, self.ptune.pre_seq_len :]

    def trainable_params(self) -> Dict[str, torch.nn.Parameter]:
        out = {}
        if self.prompt_embeddings is not None:
            out["prompt_embeddings"] = self.prompt_embeddings
        if self.deep_prompt_embeddings is not None:
            out["deep_prompt_embeddings"] = self.deep_prompt_embeddings
        return out

    def parameters(self) -> List[torch.nn.Parameter]:
        """The trainable prompts, for a torch optimizer."""
        return list(self.trainable_params().values())

    def set_trainable_params(self, params: dict) -> None:
        """Copy new values (tensors or arrays) into the prompts, in place."""
        with torch.no_grad():
            for name, param in self.trainable_params().items():
                if name in params:
                    param.copy_(torch.as_tensor(params[name]).to(param.device, param.dtype))
