"""The unary stateless-forward call to one server
(petals_tpu/client/remote_forward_backward.py:18-41). Its backward twin,
``run_remote_backward``, comes with the servers' ``rpc_backward`` (ROADMAP
A13)."""

from __future__ import annotations

from typing import Optional

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
    result = await stub.call("ptu.forward", payload, timeout=timeout or seq_manager.config.request_timeout)
    return deserialize_array(result["tensors"]["hidden"])
