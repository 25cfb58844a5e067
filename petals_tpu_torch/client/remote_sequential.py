"""RemoteSequential: the chain of remote blocks as one object with a
synchronous API (petals_tpu/client/remote_sequential.py). Stateless
``forward``/``backward`` need the servers' ``rpc_forward`` and
``rpc_backward``, which wait for A11 and A13."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from petals_tpu_torch.client.config import ClientConfig
from petals_tpu_torch.client.inference_session import InferenceSession
from petals_tpu_torch.client.routing.sequence_manager import RemoteSequenceManager
from petals_tpu_torch.client.runtime import SwarmRuntime
from petals_tpu_torch.data_structures import ModuleUID


class RemoteSequential:
    """Synchronous facade over the async swarm stack."""

    def __init__(
        self,
        config: ClientConfig,
        block_uids: Sequence[ModuleUID],
        *,
        runtime: Optional[SwarmRuntime] = None,
        dht=None,
    ):
        self.config = config
        self.block_uids = tuple(block_uids)
        self._owns_runtime = runtime is None
        self.runtime = runtime or SwarmRuntime()
        self.sequence_manager: RemoteSequenceManager = self.runtime.run(
            RemoteSequenceManager.create(config, self.block_uids, dht=dht)
        )

    def __len__(self) -> int:
        return len(self.block_uids)

    def __getitem__(self, index) -> "RemoteSequential":
        """A sub-chain over a contiguous block range. The slice shares this
        instance's runtime and DHT node but owns its router (background
        refresh and connections): close() it when done, or use it as a
        context manager. Closing a slice never tears down the parent."""
        if isinstance(index, int):
            if index < 0:
                index += len(self)
            if not 0 <= index < len(self):
                raise IndexError("RemoteSequential index out of range")
            index = slice(index, index + 1)
        if not isinstance(index, slice):
            raise TypeError(f"Expected int or slice, got {type(index).__name__}")
        start, stop, step = index.indices(len(self))
        if step != 1 or stop <= start:
            raise ValueError("RemoteSequential slices must be contiguous and non-empty")
        return RemoteSequential(
            self.config, self.block_uids[start:stop], runtime=self.runtime, dht=self.sequence_manager.dht,
        )

    def __enter__(self) -> "RemoteSequential":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def forward(self, hidden, prompts=None):
        raise NotImplementedError("stateless forward needs the servers' rpc_forward, which waits for A11")

    __call__ = forward

    def backward(self, *args, **kwargs):
        raise NotImplementedError("backward needs the servers' rpc_backward, which waits for A13")

    def inference_session(self, max_length: int, batch_size: int = 1) -> "SyncInferenceSession":
        return SyncInferenceSession(InferenceSession(self.sequence_manager, max_length, batch_size), self.runtime)

    def update_routing(self) -> None:
        self.runtime.run(self.sequence_manager.update())

    def close(self) -> None:
        self.runtime.run(self.sequence_manager.shutdown())
        if self._owns_runtime:
            self.runtime.shutdown()


class SyncInferenceSession:
    """Blocking wrapper around the async InferenceSession."""

    def __init__(self, session: InferenceSession, runtime: SwarmRuntime):
        self._session = session
        self._runtime = runtime

    def step(self, hidden, **kwargs) -> torch.Tensor:
        return self._runtime.run(self._session.step(hidden, **kwargs))

    def generate_remote(self, hidden, n_tokens: int, embed_fn, sampling=None):
        return self._runtime.run(self._session.generate_remote(hidden, n_tokens, embed_fn, sampling=sampling))

    @property
    def position(self) -> int:
        return self._session.position

    @position.setter
    def position(self, value: int) -> None:
        self._session.position = value

    @property
    def max_length(self) -> int:
        return self._session.max_length

    @property
    def batch_size(self) -> int:
        return self._session.batch_size

    def usage_report(self) -> dict:
        return self._session.usage_report()

    def close(self) -> None:
        self._runtime.run(self._session.close())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
