"""Fault-tolerant forward and backward through remote blocks
(petals_tpu/client/sequential_autograd.py).

``sequential_forward`` routes [start, end) through a max-throughput chain,
retrying a failed span on fresh servers (the failed peer is banned, the
route rebuilt from the current block after a backoff), and returns every
span's input activation with the spans used, which the backward needs.
``sequential_backward`` walks those spans in reverse through the servers'
``ptu.backward`` (each recomputes its span from the input it is sent);
when a span's server is gone it retries on a fresh one, and when the span
is now served in fragments it first re-runs the forward over the fragments
to regain their inputs. ``sequential_forward_batched`` splits a batch of
more than ``MAX_TOKENS_IN_BATCH`` tokens into sub-batches that run
concurrently, possibly over different chains, and joins their outputs;
``sequential_backward_batched`` walks each sub-batch's chain.

``RemoteSequentialFunction`` is the autograd function over both (the JAX
package's ``custom_vjp``): ``loss.backward()`` on a client loss reaches the
hidden states and deep prompts fed to the swarm.
"""

from __future__ import annotations

import asyncio
import logging
from typing import List, Optional, Tuple

import torch

from petals_tpu_torch.client.remote_forward_backward import run_remote_backward, run_remote_forward
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


async def sequential_backward(
    seq_manager: RemoteSequenceManager,
    grad_out,
    inputs_history: List[torch.Tensor],
    spans_used: List[RemoteSpanInfo],
    prompts=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Walk the spans in reverse; returns (the gradient at the chain's
    input, the gradient at ``prompts`` [n_blocks, batch, pre_seq, hidden]
    or None)."""
    grad_out = as_tensor(grad_out)
    prompts = as_tensor(prompts) if prompts is not None else None
    inputs_history = list(inputs_history)
    spans_used = list(spans_used)
    grad_prompts_parts: List[Tuple[int, int, torch.Tensor]] = []
    while spans_used:
        span = spans_used.pop()
        span_inputs = inputs_history.pop()
        span_prompts = prompts[span.start : span.end] if prompts is not None else None
        attempt = 0
        while True:
            try:
                grad_out, grad_prompts = await run_remote_backward(
                    seq_manager, span, span_inputs, grad_out, span_prompts
                )
                seq_manager.on_request_success(span.peer_id)
                if grad_prompts is not None:
                    grad_prompts_parts.append((span.start, span.end, grad_prompts))
                break
            except Exception as e:
                attempt += 1
                seq_manager.on_request_failure(span.peer_id)
                if seq_manager.config.max_retries is not None and attempt > seq_manager.config.max_retries:
                    raise
                delay = min(seq_manager.config.min_backoff * (2 ** (attempt - 1)), seq_manager.config.max_backoff)
                logger.warning(f"Backward failed at blocks [{span.start}:{span.end}], retrying in {delay:.1f}s: {e!r}")
                await asyncio.sleep(delay)
                await seq_manager.update()
                # a fresh server for this span: the input is still held here,
                # and the server recomputes from it
                new_chain = await seq_manager.make_sequence(span.start, span.end, mode="max_throughput")
                if len(new_chain) == 1:
                    span = new_chain[0]
                else:
                    # the span is served in fragments now: re-run the forward
                    # over them to regain each fragment's input
                    _, frag_inputs, frag_spans = await sequential_forward(
                        seq_manager, span_inputs, prompts, span.start, span.end
                    )
                    spans_used.extend(frag_spans)
                    inputs_history.extend(frag_inputs)
                    span = spans_used.pop()
                    span_inputs = inputs_history.pop()
                    span_prompts = prompts[span.start : span.end] if prompts is not None else None
    grad_prompts = None
    if prompts is not None and grad_prompts_parts:
        grad_prompts = torch.zeros(prompts.shape, dtype=grad_prompts_parts[0][2].dtype)
        for start, end, part in grad_prompts_parts:
            grad_prompts[start:end] += part
    return grad_out, grad_prompts


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


async def sequential_backward_batched(
    seq_manager: RemoteSequenceManager, grad_out, histories: List, spans: List, prompts=None
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The backward of ``sequential_forward_batched``: one chain, or each
    sub-batch's own chain concurrently, the gradients joined along the
    batch."""
    grad_out = as_tensor(grad_out)
    if spans and isinstance(spans[0], RemoteSpanInfo):
        return await sequential_backward(seq_manager, grad_out, histories, spans, prompts)
    prompts = as_tensor(prompts) if prompts is not None else None
    splits = _split_batch_like(grad_out, histories)
    prompt_splits = _split_prompts(prompts, splits)
    results = await asyncio.gather(
        *(sequential_backward(seq_manager, g, h, s, p) for g, h, s, p in zip(splits, histories, spans, prompt_splits))
    )
    grad_in = torch.cat([r[0] for r in results], dim=0)
    grad_prompts = None
    if prompts is not None and any(r[1] is not None for r in results):
        # a sub-batch that returned no prompt gradients adds zeros of its width
        parts = [r[1] if r[1] is not None else torch.zeros(p.shape, dtype=p.dtype)
                 for r, p in zip(results, prompt_splits)]
        grad_prompts = torch.cat(parts, dim=1)  # the prompts' batch axis
    return grad_in, grad_prompts


class RemoteSequentialFunction(torch.autograd.Function):
    """``hidden`` [batch, seq, hidden] (and deep ``prompts`` [n_blocks,
    batch, pre_seq, hidden]) through the swarm as one differentiable op: the
    forward is ``sequential_forward_batched``, the backward
    ``sequential_backward_batched`` over the spans the forward used.
    ``runtime`` runs the coroutines (client/runtime.py).

    Its tensors lie on the host (``RemoteSequential.forward`` moves them
    there and back, differentiably): autograd runs a host node on the
    thread that called ``backward``, whereas a node on a card would hold
    that card's autograd thread through the network round trip, and a
    server in the same process needs that thread for its own backward."""

    @staticmethod
    def forward(ctx, hidden: torch.Tensor, prompts: Optional[torch.Tensor], seq_manager, runtime):
        out, histories, spans = runtime.run(sequential_forward_batched(seq_manager, hidden.detach(), prompts))
        ctx.state = (seq_manager, runtime, histories, spans, None if prompts is None else prompts.detach())
        return out.to(hidden.dtype)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        seq_manager, runtime, histories, spans, prompts = ctx.state
        grad_in, grad_prompts = runtime.run(
            sequential_backward_batched(seq_manager, grad_out.detach(), histories, spans, prompts)
        )
        grad_in = grad_in.to(grad_out.dtype)
        if prompts is not None:
            grad_prompts = torch.zeros_like(prompts) if grad_prompts is None else grad_prompts.to(prompts.dtype)
        return grad_in, grad_prompts, None, None


def _split_batch(hidden: torch.Tensor) -> List[torch.Tensor]:
    batch, seq = hidden.shape[:2]
    max_rows = max(MAX_TOKENS_IN_BATCH // max(seq, 1), 1)
    return [hidden[i : i + max_rows] for i in range(0, batch, max_rows)]


def _split_batch_like(grad: torch.Tensor, histories: List) -> List[torch.Tensor]:
    """``grad`` cut along the batch as the sub-batches of ``histories`` were."""
    out, offset = [], 0
    for h in histories:
        size = h[0].shape[0]
        out.append(grad[offset : offset + size])
        offset += size
    return out


def _split_prompts(prompts: Optional[torch.Tensor], splits: List[torch.Tensor]) -> list:
    if prompts is None:
        return [None] * len(splits)
    out, offset = [], 0
    for part in splits:
        out.append(prompts[:, offset : offset + part.shape[0]])
        offset += part.shape[0]
    return out
