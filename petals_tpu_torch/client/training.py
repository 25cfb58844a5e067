"""Client-side training through the swarm (petals_tpu/client/training.py):
the loss and the gradients of the client's trainable prompts, with the
servers' blocks in the middle.

The embeddings (and shallow prompts) are computed on the client, the
blocks run remote through ``RemoteSequentialFunction`` (the servers'
``ptu.forward``, then ``ptu.backward``, each server recomputing its span),
and the head and the loss are local; ``torch.autograd.grad`` carries the
gradient from the loss through all three. The returned grads are keyed as
the JAX package's: ``prompt_embeddings`` [pre_seq, hidden] and
``deep_prompt_embeddings`` [n_blocks, pre_seq, hidden] (summed over the
batch, as the deep prompts are broadcast over it).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch


def cross_entropy(logits: torch.Tensor, labels, ignore_index: int = -100) -> torch.Tensor:
    """The mean negative log-likelihood over the labels that are not
    ``ignore_index``, in float32."""
    labels = torch.as_tensor(labels, device=logits.device).long()
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    mask = labels != ignore_index
    safe = torch.where(mask, labels, 0)
    nll = -torch.gather(logprobs, -1, safe[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1)


def _swarm_loss_and_grads(model, input_ids, back_fn: Callable) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The local front (embeddings and shallow prompts), the swarm, then
    ``back_fn`` (head and loss) on the last block's output; returns (the
    loss, the gradient of each trainable parameter)."""
    params = model.trainable_params()
    input_ids = np.asarray(input_ids)
    with torch.enable_grad():
        hidden = model.embed(input_ids)
        deep = model.deep_prompts_for_batch(hidden.shape[0])
        out = model.remote.forward(hidden, deep).to(model.device)
        loss = back_fn(out)
        if not params:
            return float(loss.detach()), {}
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return float(loss.detach()), {
        name: g if g is not None else torch.zeros_like(p)
        for (name, p), g in zip(params.items(), grads)
    }


def compute_loss_and_grads(model, input_ids, labels) -> Tuple[float, Dict[str, torch.Tensor]]:
    """A causal-LM training step's (loss, grads) over
    ``model.trainable_params()``: next-token cross-entropy, the shallow
    prompts' positions ignored."""
    pre_seq = model.ptune.pre_seq_len if model.ptune.tuning_mode else 0
    labels = np.asarray(labels)
    if pre_seq:
        pad = np.full((labels.shape[0], pre_seq), -100, dtype=labels.dtype)
        labels = np.concatenate([pad, labels], axis=1)

    def back(out_hidden):
        logits = model.family.client_head(model.client_params, out_hidden, model.cfg)
        return cross_entropy(logits[:, :-1], labels[:, 1:])

    return _swarm_loss_and_grads(model, input_ids, back)


def compute_cls_loss_and_grads(model, input_ids, labels) -> Tuple[float, Dict[str, torch.Tensor]]:
    """A classification training step's (loss, grads): cross-entropy on
    each row's logits at its last non-pad token (``labels``: [batch] class
    ids)."""
    input_ids = np.asarray(input_ids)
    pos = torch.as_tensor(model.pool_positions(input_ids))

    def back(out_hidden):
        logits = model.cls_logits(out_hidden)  # [batch, seq, labels]
        rows = torch.arange(input_ids.shape[0], device=logits.device)
        return cross_entropy(logits[rows, pos.to(logits.device)], labels)

    return _swarm_loss_and_grads(model, input_ids, back)


def sgd_step(model, grads: Dict[str, torch.Tensor], lr: float) -> None:
    """One plain SGD update of the trainable parameters, in place."""
    params = model.trainable_params()
    with torch.no_grad():
        model.set_trainable_params({name: params[name] - lr * grads[name] for name in params})
