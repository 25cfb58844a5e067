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
model its last hidden state after the final norm, the classifier
(``DistributedModelForSequenceClassification``: embeddings, final norm and
the ``score`` head local) each row's logits at its last non-pad token.

Training (client/training.py): ``ptune=PTuneConfig(pre_seq_len, "ptune" |
"deep_ptune")`` gives the model trainable prompts (client/ptune.py),
``nn.Parameter``s on its device. ``forward`` differentiates through the
swarm (``RemoteSequentialFunction``: the servers' ``ptu.backward``), so a
loss on its output reaches them by ``loss.backward()``, and a torch
optimizer over ``model.parameters()`` trains them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

import numpy as np

from petals_tpu_torch.client.config import ClientConfig
from petals_tpu_torch.client.from_pretrained import load_client_params, load_cls_client_params
from petals_tpu_torch.client.ptune import PTuneConfig, PTuneMixin
from petals_tpu_torch.client.remote_generation import RemoteGenerationMixin
from petals_tpu_torch.client.remote_sequential import RemoteSequential
from petals_tpu_torch.data_structures import make_uid
from petals_tpu_torch.server.from_pretrained import get_block_config, load_hf_config
from petals_tpu_torch.server.server import default_dht_prefix
from petals_tpu_torch.utils.device import resolve_device


class _DistributedModelBase(PTuneMixin):
    """Local embeddings (and norm/head), remote blocks, trainable prompts
    under ``ptune``."""

    _drop_head = False  # the bare model never projects to the vocabulary

    def __init__(self, family, cfg, client_params: dict, remote: RemoteSequential, *,
                 ptune: Optional[PTuneConfig] = None):
        self.family = family
        self.cfg = cfg
        self.client_params = client_params
        self.remote = remote
        self.device = client_params["embed"].device
        self.init_ptune(ptune)

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
        ptune: Optional[PTuneConfig] = None,
        **config_overrides,
    ):
        """``device``: where the client's parameters and its embed / head
        compute live (default: the CUDA card; the CPU only when asked for).
        ``model_name_or_path`` is a local checkpoint directory."""
        device = resolve_device(device)  # before touching the swarm
        family, cfg = get_block_config(model_name_or_path)
        client_params = load_client_params(model_name_or_path, dtype=dtype, device=device, family=family, cfg=cfg)
        if cls._drop_head:
            client_params.pop("head", None)
        remote = cls._build_remote(model_name_or_path, initial_peers, config, dht_prefix, config_overrides, cfg)
        return cls(family, cfg, client_params, remote, ptune=ptune)

    @staticmethod
    def _build_remote(model_name_or_path, initial_peers, config, dht_prefix, config_overrides, cfg) -> RemoteSequential:
        if config is None:
            config = ClientConfig(initial_peers=list(initial_peers), **config_overrides)
        prefix = dht_prefix or config.dht_prefix or default_dht_prefix(model_name_or_path)
        block_uids = [make_uid(prefix, i) for i in range(cfg.num_hidden_layers)]
        return RemoteSequential(config, block_uids)

    def embed(self, input_ids, *, with_prompts: bool = True) -> torch.Tensor:
        """Input embeddings [batch, seq, hidden] on the client's device,
        with the shallow prompts prepended unless ``with_prompts`` is off
        (the embeddings carry no gradient; the prompts do)."""
        ids = torch.as_tensor(input_ids, dtype=torch.long).to(self.device)
        with torch.no_grad():
            hidden = self.family.client_embed(self.client_params, ids, self.cfg)
        return self.apply_shallow_prompts(hidden) if with_prompts else hidden

    def _remote_hidden(self, input_ids) -> torch.Tensor:
        """The last block's output for ``input_ids`` (a stateless forward,
        differentiable in the prompts), on the client's device."""
        hidden = self.embed(input_ids)
        out = self.remote.forward(hidden, self.deep_prompts_for_batch(hidden.shape[0]))
        return out.to(self.device)

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
        stateless swarm forward (the shallow prompts' positions cut off)."""
        hidden = self._remote_hidden(input_ids)
        return self.strip_shallow_prompt_logits(self.family.client_head(self.client_params, hidden, self.cfg))

    __call__ = forward


class DistributedModel(_DistributedModelBase):
    """The bare model: embeddings local, blocks remote, final norm local."""

    _drop_head = True

    def __init__(self, family, cfg, client_params, remote, *, ptune: Optional[PTuneConfig] = None):
        if family.client_norm is None:
            raise NotImplementedError(f"{family.name} has no client_norm hook")
        super().__init__(family, cfg, client_params, remote, ptune=ptune)

    @torch.no_grad()
    def final_norm(self, hidden) -> torch.Tensor:
        """The last hidden state after the final norm."""
        hidden = torch.as_tensor(hidden).to(self.device)
        return self.family.client_norm(self.client_params, hidden, self.cfg)

    def forward(self, input_ids) -> torch.Tensor:
        """last_hidden_state [batch, seq, hidden] after the final norm, as
        HF's *Model forward returns it."""
        hidden = self._remote_hidden(input_ids)
        return self.strip_shallow_prompt_logits(self.family.client_norm(self.client_params, hidden, self.cfg))

    __call__ = forward


class DistributedModelForSequenceClassification(_DistributedModelBase):
    """Sequence classification over the swarm (petals_tpu/client/model.py
    :150-245): embeddings, final norm and the ``score`` head local, blocks
    remote; each row is pooled at its last non-pad token, as HF's
    *ForSequenceClassification pools it."""

    def __init__(self, family, cfg, client_params: dict, remote: RemoteSequential, *, num_labels: int,
                 pad_token_id: Optional[int] = None, ptune: Optional[PTuneConfig] = None):
        if family.cls_head is None:
            raise NotImplementedError(f"{family.name} has no sequence-classification head")
        super().__init__(family, cfg, client_params, remote, ptune=ptune)
        self.num_labels = num_labels
        self.pad_token_id = pad_token_id

    @classmethod
    def from_pretrained(cls, model_name_or_path: str, *, initial_peers: Sequence[str],
                        config: Optional[ClientConfig] = None, dht_prefix: Optional[str] = None,
                        dtype: torch.dtype = torch.float32, device=None, ptune: Optional[PTuneConfig] = None,
                        **config_overrides) -> "DistributedModelForSequenceClassification":
        """As the causal LM's, with the checkpoint's ``score`` head; the
        label count comes from its ``id2label`` (HF's ``num_labels``)."""
        device = resolve_device(device)
        family, cfg = get_block_config(model_name_or_path)
        hf_config = load_hf_config(model_name_or_path)
        client_params = load_cls_client_params(model_name_or_path, dtype=dtype, device=device, family=family, cfg=cfg)
        remote = cls._build_remote(model_name_or_path, initial_peers, config, dht_prefix, config_overrides, cfg)
        id2label = getattr(hf_config, "id2label", None)
        num_labels = len(id2label) if id2label else getattr(hf_config, "num_labels", 2)
        return cls(family, cfg, client_params, remote, num_labels=num_labels,
                   pad_token_id=getattr(hf_config, "pad_token_id", None), ptune=ptune)

    def cls_logits(self, hidden) -> torch.Tensor:
        """Per-position float32 [batch, seq, num_labels] logits (norm + score)."""
        return self.family.cls_head(self.client_params, torch.as_tensor(hidden).to(self.device), self.cfg)

    def pool_positions(self, input_ids) -> np.ndarray:
        """Each row's pooled position in the (prompt-prefixed) sequence:
        its LAST non-pad token, as HF pools."""
        input_ids = np.asarray(input_ids)
        batch, seq = input_ids.shape
        pre_seq = self.ptune.pre_seq_len if self.ptune.tuning_mode else 0
        if self.pad_token_id is None:
            if batch > 1:
                raise ValueError(
                    "Cannot handle batch sizes > 1 without a pad token "
                    "(set pad_token_id, matching HF *ForSequenceClassification)"
                )
            return np.asarray([pre_seq + seq - 1])
        non_pad = (input_ids != self.pad_token_id).astype(np.int64)
        last = (np.arange(seq)[None, :] * non_pad).argmax(axis=-1)
        return pre_seq + last

    def forward(self, input_ids) -> torch.Tensor:
        """Pooled float32 classification logits [batch, num_labels]."""
        input_ids = np.asarray(input_ids)
        logits = self.cls_logits(self._remote_hidden(input_ids))
        pos = torch.as_tensor(self.pool_positions(input_ids), device=logits.device)
        return logits[torch.arange(input_ids.shape[0], device=logits.device), pos]

    __call__ = forward


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


class AutoDistributedModelForSequenceClassification:
    """Dispatch on a classification checkpoint's model_type."""

    @classmethod
    def from_pretrained(cls, model_name_or_path: str, **kwargs) -> DistributedModelForSequenceClassification:
        return DistributedModelForSequenceClassification.from_pretrained(model_name_or_path, **kwargs)
