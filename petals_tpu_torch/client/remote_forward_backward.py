"""The unary stateless forward and backward calls to one server
(petals_tpu/client/remote_forward_backward.py): the payloads are petals_tpu's
byte for byte, the client's ``compression`` both ways, its
``active_adapter`` when set."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from petals_tpu_torch.client.routing.sequence_manager import RemoteSequenceManager
from petals_tpu_torch.data_structures import CHAIN_DELIMITER, RemoteSpanInfo
from petals_tpu_torch.rpc.serialization import CompressionType, deserialize_array, serialize_array


async def run_remote_forward(
    seq_manager: RemoteSequenceManager,
    span: RemoteSpanInfo,
    hidden: torch.Tensor,
    prompts: Optional[torch.Tensor] = None,
    *,
    timeout: Optional[float] = None,
) -> torch.Tensor:
    """``ptu.forward`` of ``hidden`` [batch, seq, hidden] (and deep
    ``prompts`` [span blocks, batch, pre_seq, hidden]) through
    ``span``'s blocks: the span's output on the host."""
    stub = await seq_manager.get_stub(span.peer_id)
    uids = CHAIN_DELIMITER.join(seq_manager.block_uids[span.start : span.end])
    comp = CompressionType(seq_manager.config.compression)
    tensors = {"hidden": serialize_array(hidden, comp)}
    if prompts is not None:
        tensors["prompts"] = serialize_array(prompts, comp)
    # always sent: "none" must override a server whose default is lossy
    payload = {"uids": uids, "tensors": tensors, "compression": comp.value}
    if seq_manager.config.active_adapter:
        payload["active_adapter"] = seq_manager.config.active_adapter
    result = await stub.call("ptu.forward", payload, timeout=timeout or seq_manager.config.request_timeout)
    return deserialize_array(result["tensors"]["hidden"])


async def run_remote_backward(
    seq_manager: RemoteSequenceManager,
    span: RemoteSpanInfo,
    hidden: torch.Tensor,
    grad_out: torch.Tensor,
    prompts: Optional[torch.Tensor] = None,
    *,
    timeout: Optional[float] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``ptu.backward`` of ``span``'s blocks at their input ``hidden`` with
    the gradient ``grad_out`` at their output (and deep ``prompts``):
    (grad at the input, grad at the prompts or None), on the host."""
    stub = await seq_manager.get_stub(span.peer_id)
    uids = CHAIN_DELIMITER.join(seq_manager.block_uids[span.start : span.end])
    comp = CompressionType(seq_manager.config.compression)
    tensors = {
        "hidden": serialize_array(hidden, comp),
        "grad_out": serialize_array(grad_out, comp),
    }
    if prompts is not None:
        tensors["prompts"] = serialize_array(prompts, comp)
    payload = {"uids": uids, "tensors": tensors, "compression": comp.value}
    if seq_manager.config.active_adapter:
        payload["active_adapter"] = seq_manager.config.active_adapter
    result = await stub.call("ptu.backward", payload, timeout=timeout or seq_manager.config.request_timeout)
    grad_hidden = deserialize_array(result["tensors"]["grad_hidden"])
    grad_prompts = None
    if "grad_prompts" in result["tensors"]:
        grad_prompts = deserialize_array(result["tensors"]["grad_prompts"])
    return grad_hidden, grad_prompts
