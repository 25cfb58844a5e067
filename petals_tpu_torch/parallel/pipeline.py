"""A microbatch pipeline schedule over a list of stage devices (the port of
petals_tpu/parallel/pipeline.py).

Where the JAX package expresses GPipe in SPMD over a "pp" mesh axis (a
``vmap`` over the stage axis, the hop a ``jnp.roll``), the port runs the
same schedule over a plain list of devices, one stage each:

- Stage s holds layers [s * L / S, (s + 1) * L / S) of the span, moved to
  ``devices[s]``.
- At step t stage s runs microbatch t - s (when 0 <= t - s < M); its input
  is microbatch t for stage 0, else stage s - 1's output of the step
  before, copied to its device (``Tensor.to``: a copy between cards,
  nothing where two stages share one). Within a step the stages run last
  first, and their launches queue on their own cards, so on several cards
  the stages overlap.
- After M + S - 1 steps the last stage has produced every microbatch. The
  copies and the stages are differentiable, so autograd gives the
  pipelined backward.

The bubble is the textbook (S - 1) / (M + S - 1); pick M >= S. No server
path calls it, as in the JAX package. ``STEPS`` counts the schedule's steps.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch

STEPS = [0]  # schedule steps run since the last reset


def microbatch_split(x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """[batch, ...] -> [M, batch / M, ...] (M must divide batch)."""
    batch = x.shape[0]
    if batch % num_microbatches:
        raise ValueError(f"batch {batch} does not divide into {num_microbatches} microbatches")
    return x.reshape(num_microbatches, batch // num_microbatches, *x.shape[1:])


def _to(p: Any, device: torch.device) -> Any:
    if isinstance(p, dict):
        return {k: _to(v, device) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return type(p)(_to(v, device) for v in p)
    return p.to(device) if isinstance(p, torch.Tensor) else p


def stage_params(params: Sequence[Any], devices: Sequence) -> List[list]:
    """The span's per-layer parameters cut into len(devices) stages of
    consecutive layers, each moved to its stage's device."""
    n_layers, n_stages = len(params), len(devices)
    if n_layers % n_stages:
        raise ValueError(f"layer stack {n_layers} does not divide {n_stages} stages")
    per = n_layers // n_stages
    return [[_to(p, torch.device(d)) for p in params[s * per : (s + 1) * per]] for s, d in enumerate(devices)]


def pipeline_apply(
    stage_fn: Callable[[list, torch.Tensor], torch.Tensor],
    params: Sequence[Any],
    microbatches: torch.Tensor,
    devices: Sequence,
) -> torch.Tensor:
    """Run microbatches [M, ...one microbatch...] through a pipeline of
    ``len(devices)`` stages. ``stage_fn(stage_params, h) -> h`` applies one
    stage's layers (a list of per-layer parameters) to one microbatch;
    ``params`` lists the span's per-layer parameters. Returns y [M, ...] on
    the microbatches' device: ``stage_fn`` over all the layers, microbatch
    by microbatch."""
    devices = [torch.device(d) for d in devices]
    stages = stage_params(params, devices)
    n_stages, n_micro = len(devices), microbatches.shape[0]
    held = [None] * n_stages  # held[s]: stage s's output of the last step
    outs = []
    for t in range(n_micro + n_stages - 1):
        STEPS[0] += 1
        for s in reversed(range(n_stages)):  # last first: each reads its predecessor's previous output
            m = t - s
            if not 0 <= m < n_micro:
                held[s] = None
                continue
            src = microbatches[m] if s == 0 else held[s - 1]
            held[s] = stage_fn(stages[s], src.to(devices[s]))
        if t >= n_stages - 1:
            outs.append(held[-1].to(microbatches.device))
    return torch.stack(outs)


def schedule_steps() -> int:
    return STEPS[0]


def reset_schedule_steps() -> None:
    STEPS[0] = 0


__all__ = ["microbatch_split", "pipeline_apply", "stage_params", "schedule_steps", "reset_schedule_steps"]
