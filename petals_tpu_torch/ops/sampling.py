"""Token sampling for server-side generation (petals_tpu/ops/sampling.py), in
plain PyTorch on tensors: one step program serves a pool of lanes whose
sampling settings differ, so every setting is a per-row VECTOR:

- ``do_sample``            [b] bool   - False rows take the greedy argmax
- ``temperature``          [b] f32    - 1.0 disables
- ``top_k``                [b] int    - 0 disables
- ``top_p``                [b] f32    - 1.0 disables
- ``repetition_penalty``   [b] f32    - 1.0 disables
- ``seen_mask``            [b, vocab] bool - tokens the penalty applies to
- ``u``                    [b] f32    - the row's uniform for this draw

The order is petals_tpu's: repetition penalty -> temperature -> top-k ->
top-p -> softmax -> inverse-CDF against ``u``. Where petals_tpu draws
``u`` inside its program from (seed, draw index), the port takes it as an
input: ``ops/threefry.py`` computes the same float32 on the host
(``sampling_uniforms``). Ties resolve as jax resolves them: the top-p sort
is stable (equal scores keep index order), and the argmax takes the first
maximum. No value leaves the device, so a step program captures all of it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from petals_tpu_torch.ops.threefry import uniform_for_draw

_NEG_INF = float("-inf")


def penalize_repetition(logits: torch.Tensor, seen_mask: torch.Tensor, penalty: torch.Tensor) -> torch.Tensor:
    """HF's repetition penalty: a seen positive score is divided by the
    row's penalty, a seen non-positive one multiplied; 1.0 is a no-op."""
    pen = penalty[:, None]
    penalized = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(seen_mask, penalized, logits)


def warp_logits(scores: torch.Tensor, temperature: torch.Tensor, top_k: torch.Tensor,
                top_p: torch.Tensor) -> torch.Tensor:
    """temperature -> top-k -> top-p, each per row and each off at 1.0 / 0
    / 1.0 (petals_tpu/ops/sampling.py:51-77)."""
    vocab = scores.shape[-1]
    scores = scores / temperature[:, None]

    # top-k: the k-th largest score is the threshold (k == 0: off; k past
    # the vocabulary clips to its last entry)
    sorted_desc = torch.sort(scores, dim=-1, descending=True).values
    kth_idx = (top_k.long() - 1).clamp(0, vocab - 1)
    kth = sorted_desc.gather(-1, kth_idx[:, None])
    k_mask = (top_k > 0)[:, None] & (scores < kth)
    scores = scores.masked_fill(k_mask, _NEG_INF)

    # top-p nucleus: drop what lies past the cumulative cutoff; the most
    # probable token always stays (cum - prob is 0 there)
    ss, order = torch.sort(-scores, dim=-1, stable=True)
    ss = -ss
    probs = torch.softmax(ss, dim=-1)
    cut = (torch.cumsum(probs, dim=-1) - probs) > top_p[:, None]
    ss = ss.masked_fill(cut, _NEG_INF)
    restored = torch.full_like(scores, _NEG_INF).scatter(-1, order, ss)
    return torch.where((top_p < 1.0)[:, None], restored, scores)


def sample_tokens(logits: torch.Tensor, *, do_sample: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor, repetition_penalty: torch.Tensor,
                  seen_mask: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The next token of each row of ``logits`` [b, vocab] -> [b] int64.
    Greedy rows take the argmax of the penalized logits (penalty 1.0: the
    raw argmax); sampling rows the inverse-CDF draw of ``u``."""
    logits = logits.float()
    penalized = penalize_repetition(logits, seen_mask, repetition_penalty)
    greedy = torch.argmax(penalized, dim=-1)
    warped = warp_logits(penalized, temperature, top_k, top_p)
    cdf = torch.cumsum(torch.softmax(warped, dim=-1), dim=-1)
    drawn = (cdf < u[:, None]).sum(-1).clamp(max=logits.shape[-1] - 1)
    return torch.where(do_sample, drawn, greedy)


def sampling_vectors(batch: int, vocab: int, sampling: Optional[dict] = None, *,
                     offset_override: Optional[int] = None) -> dict:
    """Host-side: every row's settings for a batch whose rows share one
    validated ``sampling`` dict (rpc/protocol.py ``validate_gen_sampling``),
    or none (greedy). The same numpy dict as petals_tpu's; the defaults are
    exact no-ops for every warp stage."""
    vec = {
        "do_sample": np.zeros((batch,), bool),
        "temperature": np.ones((batch,), np.float32),
        "top_k": np.zeros((batch,), np.int32),
        "top_p": np.ones((batch,), np.float32),
        "repetition_penalty": np.ones((batch,), np.float32),
        "seen_mask": np.zeros((batch, vocab), bool),
        "seeds": np.zeros((batch,), np.int32),
        "draw_idx": np.zeros((batch,), np.int32),
    }
    if sampling is None:
        return vec
    vec["do_sample"][:] = bool(sampling.get("do_sample", False))
    vec["temperature"][:] = float(sampling.get("temperature", 1.0))
    vec["top_k"][:] = int(sampling.get("top_k", 0) or 0)
    vec["top_p"][:] = float(sampling.get("top_p", 1.0) or 1.0)
    rep = float(sampling.get("repetition_penalty", 1.0) or 1.0)
    vec["repetition_penalty"][:] = rep
    vec["seeds"][:] = int(sampling.get("seed", 0))
    offset = int(sampling.get("offset", 0))
    vec["draw_idx"][:] = offset if offset_override is None else offset_override
    if rep != 1.0:
        for tok in sampling.get("context") or ():
            t = int(tok)
            if 0 <= t < vocab:
                vec["seen_mask"][:, t] = True
    return vec


def sampling_uniforms(vec: dict, n_draws: Optional[int] = None) -> np.ndarray:
    """Each sampling row's float32 uniform for its (seed, draw index) in
    ``vec``; 0 for a greedy row, which reads none. With ``n_draws``, each
    row's [n_draws] uniforms for draws draw_idx .. draw_idx + n_draws - 1
    (the speculative verify step's rows)."""
    rows = vec["do_sample"]
    seeds, draws = vec["seeds"][rows], vec["draw_idx"][rows]
    if n_draws is not None:
        seeds, draws = seeds[:, None], draws[:, None].astype(np.int64) + np.arange(n_draws)
    u = np.zeros(rows.shape + (() if n_draws is None else (n_draws,)), np.float32)
    if rows.any():
        u[rows] = uniform_for_draw(seeds, draws)
    return u


def sampling_tensors(vec: dict, device=None) -> dict:
    """``sample_tokens``' keyword tensors from a ``sampling_vectors`` dict,
    on ``device``; ``u`` is ``vec["u"]`` where a caller drew it ahead,
    else ``sampling_uniforms``."""
    names = ("do_sample", "temperature", "top_k", "top_p", "repetition_penalty", "seen_mask")
    out = {name: torch.from_numpy(np.ascontiguousarray(vec[name])).to(device) for name in names}
    u = vec["u"] if "u" in vec else sampling_uniforms(vec)
    out["u"] = torch.from_numpy(np.ascontiguousarray(u, np.float32)).to(device)
    return out
