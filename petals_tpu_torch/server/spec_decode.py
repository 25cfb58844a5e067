"""Server-side speculative decoding: the draft model
(petals_tpu/server/spec_decode.py).

The span verifies k draft tokens per lane in ONE paged step (the backend's
``paged_spec_verify_step``); this module supplies the k drafts. A
``DraftModel`` is a SMALL full model (embeddings, every block, head;
nf4a-quantized by default) loaded beside the span through ``--draft_model``.
It keeps no state across ticks:

- No draft KV cache survives a call. Each ``propose`` re-prefills a bounded
  WINDOW (the last ``window`` tokens of each lane's context) at position 0
  into fresh dense buffers, then decodes k tokens greedily. The drafts are a
  function of the window's tokens alone: nothing to roll back when the
  verify step rejects a suffix, nothing to migrate.
- Bucketed shapes: the speculating lanes are compacted to the front and
  padded to the next power-of-two lane count (at most the pool's), so one
  speculating lane pays for a [1, window] prefill, not the pool's. On a CUDA
  device each (bucket, window, k) is one ``TrackedGraph("draft_propose",
  steady=True)``, its buffers from the graph pool, the tokens and lengths
  copied into static inputs; ``warmup`` captures every bucket, so serving
  captures nothing. On the CPU the same body runs eagerly.
- Greedy argmax proposals. The draft's quality moves the acceptance rate
  only: the verify step samples the target's own tokens and accepts a draft
  by exact match, so the emitted stream is plain decode's whatever the
  draft says.

Attention is the plain ``attend_reference`` on the dense buffers
(``use_flash=False``, as the reference sends it to XLA); an nf4a draft's
projections run the dequant-matmul kernels on the card (K5: the prefill
kernel over the window's rows, the decode kernel at the bucket's rows).
Window positions are chunk-local, so a draft conditioned on a truncated
context sees shifted rotary phases: that costs acceptance on long sessions
and nothing else; a window that covers the whole context sees exact
positions.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from petals_tpu_torch.telemetry.observatory import CudaGraphCapture, TrackedGraph, counted_once
from petals_tpu_torch.models.registry import num_kv_heads

logger = logging.getLogger(__name__)

DEFAULT_WINDOW = 64
# the acceptance-rate EMA floor below which a lane falls back to plain
# decode for a cooldown (the batcher's auto-disable)
MIN_ACCEPT_ENV = "PETALS_TPU_SPEC_MIN_ACCEPT"


def min_accept_floor(default: float = 0.1) -> float:
    try:
        return float(os.environ.get(MIN_ACCEPT_ENV, default))
    except ValueError:
        return default


class DraftModel:
    """A small full model proposing k greedy tokens per lane per tick.
    ``block_params`` is a list of per-block parameter dicts (quantized
    leaves included), run one block after another."""

    def __init__(self, family, cfg, block_params: Sequence[dict], client_params: dict, *, spec_k: int,
                 window: int = DEFAULT_WINDOW, compute_dtype: torch.dtype = torch.float32, device=None):
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if window < 1:
            raise ValueError(f"draft window must be >= 1, got {window}")
        if family.client_embed is None or family.client_head is None:
            raise ValueError(f"{family.name} has no client embed/head mapping")
        self.family = family
        self.cfg = cfg
        self.block_params = list(block_params)
        self.client_params = client_params
        self.spec_k = int(spec_k)
        self.window = int(window)
        self.compute_dtype = compute_dtype
        self.device = torch.device(device) if device is not None else client_params["embed"].device
        self.num_kv_heads = num_kv_heads(cfg)
        self.head_dim = cfg.head_dim
        self._program = None
        if self.device.type == "cuda":
            self._program = TrackedGraph("draft_propose", CudaGraphCapture(self.device))

    @classmethod
    def from_pretrained(cls, model_name_or_path: str, *, spec_k: int, window: int = DEFAULT_WINDOW,
                        quant_type: str = "nf4a", compute_dtype: torch.dtype = torch.float32,
                        device=None) -> "DraftModel":
        """Every block and the client's leaves of a (small) local
        checkpoint, on ``device`` (default: the CUDA card), the blocks
        quantized per ``quant_type`` (nf4a by default, utils/convert_block.py)."""
        from petals_tpu_torch.client.from_pretrained import load_client_params
        from petals_tpu_torch.server.from_pretrained import get_block_config, load_block_params
        from petals_tpu_torch.utils.convert_block import QuantType, convert_block_params
        from petals_tpu_torch.utils.device import resolve_device

        device = resolve_device(device)
        family, cfg = get_block_config(model_name_or_path)
        n_blocks = cfg.num_hidden_layers
        block_params = [
            convert_block_params(
                load_block_params(model_name_or_path, i, dtype=compute_dtype, device=device, family=family, cfg=cfg),
                family.name, QuantType(quant_type),
            )
            for i in range(n_blocks)
        ]
        client_params = load_client_params(model_name_or_path, dtype=torch.float32, device=device, family=family,
                                           cfg=cfg)
        logger.info(f"Draft model {model_name_or_path}: {n_blocks} blocks ({quant_type}), window={window}, "
                    f"k={spec_k}, on {device}")
        return cls(family, cfg, block_params, client_params, spec_k=spec_k, window=window,
                   compute_dtype=compute_dtype, device=device)

    # --------------------------------------------------------------- program

    def _propose_eager(self, tokens: torch.Tensor, lengths: torch.Tensor):
        """The propose body, launched op by op (what the CPU runs, and what
        a bucket's program captures). tokens [n, W] left-aligned; lengths
        [n] int32 (0: a padded row, whose drafts are garbage no one reads).
        Returns (drafts [n, k] int32,)."""
        family, cfg, dtype = self.family, self.cfg, self.compute_dtype
        n, W = tokens.shape
        k = self.spec_k
        tokens = tokens.to(self.device, torch.long)
        lengths = lengths.to(self.device, torch.int32)
        # the window prefill and k - 1 decode writes
        shape = (n, W + k, self.num_kv_heads, self.head_dim)
        caches = [(torch.zeros(shape, dtype=dtype, device=self.device),
                   torch.zeros(shape, dtype=dtype, device=self.device)) for _ in self.block_params]

        block_apply = counted_once(family.block_apply)  # a capture counts one block of each shape

        def run(hidden, position):
            h = hidden.to(dtype)
            for p_block, kv in zip(self.block_params, caches):
                h, _ = block_apply(p_block, h, kv, position, cfg, use_flash=False)
            return h

        # the window at position 0: rows past a lane's length are garbage, but
        # the causal mask keeps them out of the rows read. The position is a
        # tensor on the device: a host int would be uploaded, which a capture
        # refuses
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        hidden = run(family.client_embed(self.client_params, tokens, cfg), zero)
        last = (lengths.long() - 1).clamp(0, W - 1)
        row = hidden.gather(1, last[:, None, None].expand(n, 1, hidden.shape[2]))
        tok = torch.argmax(family.client_head(self.client_params, row, cfg)[:, -1], dim=-1)
        drafts = [tok]
        pos = lengths.clamp_min(1)  # the next token is written AT the length
        for _ in range(k - 1):
            h = run(family.client_embed(self.client_params, tok[:, None], cfg), pos)
            tok = torch.argmax(family.client_head(self.client_params, h, cfg)[:, -1], dim=-1)
            drafts.append(tok)
            pos = pos + 1
        return (torch.stack(drafts, dim=1).to(torch.int32),)

    def _run(self, tokens: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        inputs = (torch.from_numpy(tokens), torch.from_numpy(lengths))
        if self._program is None:
            (drafts,) = self._propose_eager(*inputs)
        else:
            (drafts,) = self._program.run((tokens.shape[0], self.window, self.spec_k), self._propose_eager, inputs)
        return drafts.cpu().numpy()

    # ------------------------------------------------------------------ host

    @staticmethod
    def _buckets(max_lanes: int) -> List[int]:
        """The padded batch sizes the propose program serves: the powers of
        two below ``max_lanes``, then ``max_lanes`` itself."""
        out, b = [], 1
        while b < max_lanes:
            out.append(b)
            b <<= 1
        out.append(max(int(max_lanes), 1))
        return out

    def warmup(self, max_lanes: int) -> None:
        """Run (on a card: capture) every bucket once, so that serving never
        captures. The batcher calls it on the compute thread at its first
        spec tick."""
        for b in self._buckets(max_lanes):
            self._run(np.zeros((b, self.window), np.int64), np.zeros((b,), np.int32))

    def propose(self, contexts: Sequence[Optional[Sequence[int]]]) -> np.ndarray:
        """Greedy k-token proposals for a batch of lanes. ``contexts[i]`` is
        lane i's token history (the client's context, when it sent one, and
        every generated token, the last committed one included), or None
        for a lane not speculating this tick. Returns int32
        [len(contexts), k]; rows of None or empty contexts are garbage the
        caller ignores."""
        n = len(contexts)
        W = self.window
        active = [i for i, ctx in enumerate(contexts) if ctx]
        out = np.zeros((n, self.spec_k), np.int32)
        if not active:
            return out
        B = next(b for b in self._buckets(n) if b >= len(active))
        tokens = np.zeros((B, W), np.int64)
        lengths = np.zeros((B,), np.int32)
        for row, i in enumerate(active):
            tail = list(contexts[i])[-W:]
            tokens[row, : len(tail)] = tail
            lengths[row] = len(tail)
        drafts = self._run(tokens, lengths)
        for row, i in enumerate(active):
            out[i] = drafts[row]
        return out


__all__ = ["DraftModel", "DEFAULT_WINDOW", "MIN_ACCEPT_ENV", "min_accept_floor"]
