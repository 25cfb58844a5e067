"""Client-side speculative decoding (petals_tpu/client/speculative.py): a
local draft proposes tokens, the swarm verifies them in one step, and the
session's caches roll back past the rejected drafts (``session.position``,
which the servers apply through ``start_from_position`` on the next step).

Greedy verification: a draft token is accepted while it equals the target
model's argmax, so the output is plain greedy decoding's, token for token,
whatever the draft proposes; a bad draft only costs speed.
"""

from __future__ import annotations

import logging
from typing import Callable

import numpy as np
import torch

logger = logging.getLogger(__name__)

# draft_fn(context_ids [seq], k) -> proposed next tokens [k]
DraftFn = Callable[[np.ndarray, int], np.ndarray]


@torch.no_grad()
def speculative_generate(model, draft_fn: DraftFn, input_ids, *, max_new_tokens: int, speculative_tokens: int = 4,
                         session=None) -> np.ndarray:
    """Greedy generation accelerated by draft-and-verify (batch 1). Returns
    the prompt and its ``max_new_tokens`` new tokens, [1, seq + new]."""
    input_ids = np.asarray(input_ids)
    assert input_ids.shape[0] == 1, "speculative decoding is single-stream"
    k = max(int(speculative_tokens), 1)
    own_session = session is None
    if session is None:
        total = input_ids.shape[1] + max_new_tokens + k + 1
        session = model.remote.inference_session(max_length=total, batch_size=1)
    stats = {"steps": 0, "accepted": 0, "drafted": 0}
    try:
        # prefill all but the last token: it rides with the drafts
        generated = input_ids
        if input_ids.shape[1] > 1:
            session.step(model.embed(input_ids[:, :-1], with_prompts=False))
        while generated.shape[1] - input_ids.shape[1] < max_new_tokens:
            budget = max_new_tokens - (generated.shape[1] - input_ids.shape[1])
            n_draft = min(k, max(budget - 1, 0))
            drafts = (np.asarray(draft_fn(generated[0], n_draft)).reshape(-1)[:n_draft] if n_draft > 0
                      else np.empty(0, np.int64))
            stats["drafted"] += len(drafts)
            # one verification step: [last pending token, d1 .. d_{n-1}]
            chunk = np.concatenate([generated[0, -1:], drafts[:-1]]) if len(drafts) else generated[0, -1:]
            base_position = session.position
            out_hidden = session.step(model.embed(chunk[None].astype(np.int64), with_prompts=False))
            targets = model.lm_logits(out_hidden)[0].argmax(dim=-1).cpu().numpy()  # g_1 .. g_len
            accepted = 0
            while accepted < len(drafts) and drafts[accepted] == targets[accepted]:
                accepted += 1
            if accepted < len(drafts):
                # the first miss: the accepted prefix and the target's correction
                new_tokens = list(drafts[:accepted]) + [targets[accepted]]
                # roll the servers' caches back past the rejected suffix
                session.position = base_position + 1 + accepted
            elif len(drafts):
                # all accepted: the last draft was never fed, so it stays
                # pending for the next round (no bonus logit)
                new_tokens = list(drafts)
            else:
                new_tokens = [targets[0]]  # a plain greedy step (no draft budget)
            stats["accepted"] += accepted
            stats["steps"] += 1
            new_tokens = np.asarray(new_tokens[:budget], dtype=np.int64)
            generated = np.concatenate([generated, new_tokens[None]], axis=1)
        if stats["drafted"]:
            logger.debug(f"Speculative: {stats['accepted']}/{stats['drafted']} drafts accepted over "
                         f"{stats['steps']} verify steps")
        return generated
    finally:
        if own_session:
            session.close()


def make_local_draft_fn(model_path: str, *, dtype: torch.dtype = torch.float32, device=None) -> DraftFn:
    """A greedy draft from a small local checkpoint run whole on the client
    (``device``: the CUDA card unless the CPU is asked for), re-running the
    context for each proposed token."""
    from petals_tpu_torch.client.from_pretrained import load_client_params
    from petals_tpu_torch.models.registry import num_kv_heads
    from petals_tpu_torch.server.from_pretrained import get_block_config, load_block_params
    from petals_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    family, cfg = get_block_config(model_path)
    client_params = load_client_params(model_path, dtype=dtype, device=device, family=family, cfg=cfg)
    blocks = [load_block_params(model_path, i, dtype=dtype, device=device, family=family, cfg=cfg)
              for i in range(cfg.num_hidden_layers)]
    kv_shape = (num_kv_heads(cfg), cfg.head_dim)

    @torch.no_grad()
    def draft(context: np.ndarray, k: int) -> np.ndarray:
        ids = torch.as_tensor(np.asarray(context), dtype=torch.long, device=device)[None]
        out = []
        for _ in range(k):
            hidden = family.client_embed(client_params, ids, cfg).to(dtype)
            for p in blocks:
                kv = tuple(torch.zeros((1, ids.shape[1], *kv_shape), dtype=dtype, device=device) for _ in range(2))
                hidden, _ = family.block_apply(p, hidden, kv, 0, cfg)
            nxt = int(family.client_head(client_params, hidden[:, -1:], cfg)[0, -1].argmax())
            out.append(nxt)
            ids = torch.cat([ids, torch.tensor([[nxt]], device=device)], dim=1)
        return np.asarray(out, np.int64)

    return draft
