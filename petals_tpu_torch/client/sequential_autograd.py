"""Fault-tolerant stateless forward through remote blocks
(petals_tpu/client/sequential_autograd.py:37-78, 145-165, 197-219).

``sequential_forward`` routes [start, end) through a max-throughput chain,
retrying a failed span on fresh servers (the failed peer is banned, the
route rebuilt from the current block after a backoff), and returns every
span's input activation with the spans used, which a backward pass needs.
``sequential_forward_batched`` splits a batch of more than
``MAX_TOKENS_IN_BATCH`` tokens into sub-batches that run concurrently,
possibly over different chains, and joins their outputs.

The backward halves and the autograd function come with the servers'
``rpc_backward`` (ROADMAP A13).
"""

from __future__ import annotations

import asyncio
import logging
from typing import List, Optional, Tuple

import torch

from petals_tpu_torch.client.remote_forward_backward import run_remote_forward
from petals_tpu_torch.client.routing.sequence_manager import RemoteSequenceManager
from petals_tpu_torch.data_structures import RemoteSpanInfo
from petals_tpu_torch.rpc.serialization import as_tensor

logger = logging.getLogger(__name__)

MAX_TOKENS_IN_BATCH = 1024


async def sequential_forward(
    seq_manager: RemoteSequenceManager,
    hidden,
    prompts=None,
    start_index: int = 0,
    end_index: Optional[int] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor], List[RemoteSpanInfo]]:
    """Returns (output, each span's input activation, the spans used).
    ``prompts`` [n_blocks, batch, pre_seq, hidden] covers every block of
    the chain; each span is sent its own blocks' rows."""
    end_index = end_index if end_index is not None else len(seq_manager.block_uids)
    hidden = as_tensor(hidden)
    if hidden.dim() != 3:
        raise ValueError(f"hidden must be [batch, seq, hidden], got {tuple(hidden.shape)}")
    prompts = as_tensor(prompts) if prompts is not None else None
    inputs_history: List[torch.Tensor] = []
    spans_used: List[RemoteSpanInfo] = []
    block_idx = start_index
    attempt = 0
    chain: List[RemoteSpanInfo] = []
    while block_idx < end_index:
        if not chain:
            chain = await seq_manager.make_sequence(block_idx, end_index, mode="max_throughput")
        span = chain.pop(0)
        try:
            span_prompts = prompts[span.start : span.end] if prompts is not None else None
            outputs = await run_remote_forward(seq_manager, span, hidden, span_prompts)
            if tuple(outputs.shape) != tuple(hidden.shape):
                raise ValueError(f"span [{span.start}:{span.end}] returned {tuple(outputs.shape)} "
                                 f"for an input of {tuple(hidden.shape)}")
            inputs_history.append(hidden)
            spans_used.append(span)
            hidden = outputs
            block_idx = span.end
            seq_manager.on_request_success(span.peer_id)
            attempt = 0
        except Exception as e:
            attempt += 1
            seq_manager.on_request_failure(span.peer_id)
            if seq_manager.config.max_retries is not None and attempt > seq_manager.config.max_retries:
                raise
            delay = min(seq_manager.config.min_backoff * (2 ** (attempt - 1)), seq_manager.config.max_backoff)
            logger.warning(f"Forward failed at blocks [{span.start}:{span.end}], retrying in {delay:.1f}s: {e!r}")
            await asyncio.sleep(delay)
            await seq_manager.update()
            chain = []  # re-route from the current block
    return hidden, inputs_history, spans_used


async def sequential_forward_batched(seq_manager: RemoteSequenceManager, hidden, prompts=None) -> Tuple:
    """A batch of more than ``MAX_TOKENS_IN_BATCH`` tokens splits into
    sub-batches of whole rows that run concurrently (swarm microbatching);
    returns (the joined output, the histories, the spans), the last two per
    sub-batch when it split."""
    hidden = as_tensor(hidden)
    splits = _split_batch(hidden)
    if len(splits) == 1:
        return await sequential_forward(seq_manager, hidden, prompts)
    prompt_splits = _split_prompts(as_tensor(prompts) if prompts is not None else None, splits)
    results = await asyncio.gather(
        *(sequential_forward(seq_manager, part, p_part) for part, p_part in zip(splits, prompt_splits))
    )
    outputs = torch.cat([r[0] for r in results], dim=0)
    return outputs, [r[1] for r in results], [r[2] for r in results]


def _split_batch(hidden: torch.Tensor) -> List[torch.Tensor]:
    batch, seq = hidden.shape[:2]
    max_rows = max(MAX_TOKENS_IN_BATCH // max(seq, 1), 1)
    return [hidden[i : i + max_rows] for i in range(0, batch, max_rows)]


def _split_prompts(prompts: Optional[torch.Tensor], splits: List[torch.Tensor]) -> list:
    if prompts is None:
        return [None] * len(splits)
    out, offset = [], 0
    for part in splits:
        out.append(prompts[:, offset : offset + part.shape[0]])
        offset += part.shape[0]
    return out
