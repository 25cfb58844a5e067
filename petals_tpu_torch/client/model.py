"""Causal LM over the swarm: embeddings, final norm and LM head local (on
the client's device), every transformer block remote
(petals_tpu/client/model.py, family-agnostic through the registry's
client fields).

    model = AutoDistributedModelForCausalLM.from_pretrained(path, initial_peers=[...])
    ids = model.generate(input_ids, max_new_tokens=32)

The client's parameters sit on the CUDA card unless the caller passes a CPU
device; with no card and no explicit CPU, ``from_pretrained`` raises, as
the port's server entry points do.

``DistributedModelForSpeculativeGeneration`` generates greedily with a
local draft, verified by the swarm (client/speculative.py).

``forward(input_ids)`` is a stateless forward over the swarm (the
servers' ``rpc_forward``): the causal LM returns float32 logits, the bare
model its last hidden state after the final norm.

Waiting, each raising with its slice named: trained prompts
(``PTuneMixin``, ``ptune=``, A13) and
``DistributedModelForSequenceClassification`` (A13).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from petals_tpu_torch.client.config import ClientConfig
from petals_tpu_torch.client.from_pretrained import load_client_params
from petals_tpu_torch.client.remote_generation import RemoteGenerationMixin
from petals_tpu_torch.client.remote_sequential import RemoteSequential
from petals_tpu_torch.data_structures import make_uid
from petals_tpu_torch.server.from_pretrained import get_block_config
from petals_tpu_torch.server.server import default_dht_prefix
from petals_tpu_torch.utils.device import resolve_device


class _DistributedModelBase:
    """Local embeddings (and norm/head), remote blocks."""

    _drop_head = False  # the bare model never projects to the vocabulary

    def __init__(self, family, cfg, client_params: dict, remote: RemoteSequential):
        self.family = family
        self.cfg = cfg
        self.client_params = client_params
        self.remote = remote
        self.device = client_params["embed"].device

    @classmethod
    def from_pretrained(
        cls,
        model_name_or_path: str,
        *,
        initial_peers: Sequence[str],
        config: Optional[ClientConfig] = None,
        dht_prefix: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
        ptune=None,
        **config_overrides,
    ):
        """``device``: where the client's parameters and its embed / head
        compute live (default: the CUDA card; the CPU only when asked for).
        ``model_name_or_path`` is a local checkpoint directory."""
        if ptune is not None:
            raise NotImplementedError("trained prompts (PTune) wait for A13 in this port")
        device = resolve_device(device)  # before touching the swarm
        family, cfg = get_block_config(model_name_or_path)
        client_params = load_client_params(model_name_or_path, dtype=dtype, device=device, family=family, cfg=cfg)
        if cls._drop_head:
            client_params.pop("head", None)
        if config is None:
            config = ClientConfig(initial_peers=list(initial_peers), **config_overrides)
        prefix = dht_prefix or config.dht_prefix or default_dht_prefix(model_name_or_path)
        block_uids = [make_uid(prefix, i) for i in range(cfg.num_hidden_layers)]
        return cls(family, cfg, client_params, RemoteSequential(config, block_uids))

    @torch.no_grad()
    def embed(self, input_ids) -> torch.Tensor:
        """Input embeddings [batch, seq, hidden] on the client's device."""
        ids = torch.as_tensor(input_ids, dtype=torch.long).to(self.device)
        return self.family.client_embed(self.client_params, ids, self.cfg)

    def _remote_hidden(self, input_ids) -> torch.Tensor:
        """The last block's output for ``input_ids`` (a stateless forward),
        on the client's device."""
        hidden = self.embed(input_ids)
        return self.remote.forward(hidden.cpu()).to(self.device)

    def close(self) -> None:
        self.remote.close()


class DistributedModelForCausalLM(RemoteGenerationMixin, _DistributedModelBase):
    """Embeddings / norm / head local (PyTorch), blocks remote (the swarm)."""

    @torch.no_grad()
    def lm_logits(self, hidden) -> torch.Tensor:
        """float32 logits [..., vocab] of hidden states from the last block."""
        hidden = torch.as_tensor(hidden).to(self.device)
        return self.family.client_head(self.client_params, hidden, self.cfg)

    def forward(self, input_ids) -> torch.Tensor:
        """float32 logits [batch, seq, vocab] of a whole sequence through a
        stateless swarm forward."""
        return self.lm_logits(self._remote_hidden(input_ids))

    __call__ = forward


class DistributedModel(_DistributedModelBase):
    """The bare model: embeddings local, blocks remote, final norm local."""

    _drop_head = True

    def __init__(self, family, cfg, client_params, remote):
        if family.client_norm is None:
            raise NotImplementedError(f"{family.name} has no client_norm hook")
        super().__init__(family, cfg, client_params, remote)

    @torch.no_grad()
    def final_norm(self, hidden) -> torch.Tensor:
        """The last hidden state after the final norm."""
        hidden = torch.as_tensor(hidden).to(self.device)
        return self.family.client_norm(self.client_params, hidden, self.cfg)

    def forward(self, input_ids) -> torch.Tensor:
        """last_hidden_state [batch, seq, hidden] after the final norm, as
        HF's *Model forward returns it."""
        return self.final_norm(self._remote_hidden(input_ids))

    __call__ = forward


class DistributedModelForSequenceClassification:
    @classmethod
    def from_pretrained(cls, *args, **kwargs):
        raise NotImplementedError("sequence classification waits for A13 in this port")


class DistributedModelForSpeculativeGeneration:
    """A causal LM over the swarm plus a LOCAL draft for draft-and-verify
    greedy decoding (petals_tpu/client/model.py's, family-agnostic). The
    output is plain greedy decoding's; a bad draft only costs speed."""

    def __init__(self, model: DistributedModelForCausalLM, draft_fn, *, speculative_tokens: int = 4):
        self.model = model
        self.draft_fn = draft_fn
        self.speculative_tokens = speculative_tokens
        self.cfg = model.cfg

    @classmethod
    def from_pretrained(cls, model_name_or_path: str, draft_model_path: str, *, speculative_tokens: int = 4,
                        **kwargs) -> "DistributedModelForSpeculativeGeneration":
        """``kwargs`` go to ``DistributedModelForCausalLM.from_pretrained``;
        the draft runs on the same device as the client's parameters."""
        from petals_tpu_torch.client.speculative import make_local_draft_fn

        model = DistributedModelForCausalLM.from_pretrained(model_name_or_path, **kwargs)
        return cls(model, make_local_draft_fn(draft_model_path, device=model.device),
                   speculative_tokens=speculative_tokens)

    def generate(self, input_ids, *, max_new_tokens: int, speculative_tokens: Optional[int] = None):
        from petals_tpu_torch.client.speculative import speculative_generate

        return speculative_generate(
            self.model, self.draft_fn, input_ids, max_new_tokens=max_new_tokens,
            speculative_tokens=speculative_tokens if speculative_tokens is not None else self.speculative_tokens,
        )

    def close(self) -> None:
        self.model.close()


class AutoDistributedModelForCausalLM:
    """Dispatch on the checkpoint's model_type (through the registry)."""

    @classmethod
    def from_pretrained(cls, model_name_or_path: str, **kwargs) -> DistributedModelForCausalLM:
        return DistributedModelForCausalLM.from_pretrained(model_name_or_path, **kwargs)


class AutoDistributedModel:
    @classmethod
    def from_pretrained(cls, model_name_or_path: str, **kwargs) -> DistributedModel:
        return DistributedModel.from_pretrained(model_name_or_path, **kwargs)
