"""Drive petals_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

1. Build: compile petals_tpu_torch/csrc/paged_attention.cu with nvcc
   (sm_90a) into build/kernels/, and print the card's name and power limit.
2. Kernels: at Mistral-7B-v0.1 widths (32 query heads, 8 KV heads, head_dim
   128, page 64, bf16) hold each CUDA kernel against its plain PyTorch
   version on the same inputs, and time the kernel, the plain version and a
   library yardstick (page gather + scaled_dot_product_attention, timed here
   and used nowhere in the port) with CUDA events, the L2 cache flushed
   before every launch.
   - K1 paged decode: 8 lanes at ragged positions up to 1023 on permuted
     tables with holes past each frontier, one lane idle at the sentinel,
     with the sliding window off, at Mistral's 4096 and at 200.
   - K2 chunked prefill: a 512-row chunk at position 0 and its 188-row
     continuation at 512.
   Tolerance: bf16 inputs against the plain version computed in float32 on
   the same bf16 values; the kernels accumulate in float32 and round once to
   bf16, so outputs of magnitude < 4 differ by at most half a bf16 ulp
   (2**-7) plus summation order: max abs error <= 2e-2.
3. Server: write a seeded Mistral-7B-v0.1-shaped checkpoint of 8 blocks
   (bf16, random weights) with the port's safetensors writer, start
   petals_tpu_torch's Server on 127.0.0.1 with the CLI's defaults, and open
   4 concurrent sessions through the port's RpcClient: prompts of 700, 450,
   300 and 64 tokens (700 > the 512-token prefill budget forces a
   continuation chunk), then 32 decode steps each, after a short warm-up
   run. Every reply is held against a reference computed on the card, one
   session at a time, by the port's block functions over a dense bf16 cache
   with plain attention; the tolerance is twice that reference's own bf16
   rounding error, measured against the same network run in float32. So
   are the K/V rows the server wrote: after the last step, while every
   session is still open, each lane's rows are read from the page pools
   through its block table and held, row by row (block, position), against
   the reference's dense caches with the same tolerance, so a lost or
   misplaced write fails even where it moves the replies by less than bf16
   noise. The kernels' launch counters must show both kernels ran on every
   block of every step of the measured run.
4. Profile: where a step's time goes. The served span's backend runs a
   paged decode step and a mixed step carrying a 512-token chunk directly
   (no RPC) at 4 lanes; for each, the host wall (median, launch to
   synchronize), and from torch.profiler over PROFILE_CALLS further calls
   the device busy time, the kernel launches and the top operations, with
   the idle share 1 - busy / wall of those same calls.

float32 matmuls run in full float32: TF32 is switched off for matmuls and
convolutions. Exits non-zero on any failure. The last line is the JSON
object ``{"ok": true, "device": {...}}``; the line before it lists the
kernels with their times, bounds and main-path launch counts.
"""

from __future__ import annotations

import asyncio
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# Mistral-7B-v0.1 config.json (mistralai/Mistral-7B-v0.1), depth cut to the
# span of 8 blocks that is served; weights are random from SEED
MISTRAL_7B = {
    "model_type": "mistral", "architectures": ["MistralForCausalLM"],
    "hidden_size": 4096, "intermediate_size": 14336, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128, "num_hidden_layers": 32,
    "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "sliding_window": 4096,
    "vocab_size": 32000, "hidden_act": "silu", "max_position_embeddings": 32768,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
}
SPAN = 8
PAGE = 64
PROMPTS = (700, 450, 300, 64)
DECODE_STEPS = 32

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth and
# bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

KERNEL_TOL = 2e-2
# server replies: both sides compute in bf16, but the server splits the
# 700-token prompt into 512 + 188-row chunks and batches decode rows, so
# its matmuls run at other shapes and round differently, and a bf16 ulp of
# difference in one block's output feeds every later block. The tolerance
# is that rounding noise itself, measured (see check_session).
REPLY_NOISE_FACTOR = 2.0
REPLY_BF16_MEAN_REL = 5e-2  # beyond this the bf16 network is too unstable to judge
WARMUP_PROMPTS = (64, 300)  # first-call costs (cuBLAS plans, page faults) off the clock

PROFILE_LANES = 4
PROFILE_REPS = 20  # unprofiled calls for the median host wall
PROFILE_CALLS = 5  # calls inside the profiler
PROFILE_CHUNK = 512


def log(*parts) -> None:
    print(*parts, flush=True)


# ----------------------------------------------------------------- timing


class Timer:
    """Median device time of a callable over ``reps`` launches, measured
    with CUDA events; a write of 2x the L2 cache before each launch makes
    every launch read its inputs from device memory, as a step does."""

    def __init__(self, device):
        self.flush = torch.empty(100 * 2**20, dtype=torch.uint8, device=device)

    def __call__(self, fn, reps: int = 30, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_ms(nbytes: int, flops: int):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the bf16 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _visible(q_pos: int, kv_len: int, window) -> int:
    """kv positions row ``q_pos`` attends to (causal, ragged, windowed)."""
    hi = min(q_pos + 1, kv_len)
    lo = 0 if window is None else max(0, q_pos - window + 1)
    return max(0, hi - lo)


def _sdpa(q, k, v, mask):
    """q [b, hq, s, d], k/v [b, hkv, kv, d] through PyTorch's fused
    attention, GQA heads expanded by the call itself where it can."""
    import torch.nn.functional as F

    group = q.shape[1] // k.shape[1]
    if tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=group > 1)
    k, v = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


# ----------------------------------------------------------------- phases


def build() -> None:
    from petals_tpu_torch.kernels import build as kbuild

    t0 = time.perf_counter()
    path = kbuild.build("paged_attention")
    log(f"build: {os.path.relpath(path, REPO)} in {time.perf_counter() - t0:.1f} s")
    report = open(f"{path}.log").read().splitlines()
    for line in report:
        if "registers" in line or "spill" in line or line.startswith("built in"):
            log(f"  {line.strip()}")


def check_kernels(device, timer):
    """Kernel vs plain version at Mistral-7B widths; returns the K1/K2
    report entries (without main-path launch counts)."""
    from petals_tpu_torch.ops import paged_flash_attention as pfa
    from petals_tpu_torch.ops.paged_attention import gather_pages, paged_attend, paged_prefill_attend

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    hq, hkv, d = 32, 8, 128

    # ---- K1: 8 lanes, ragged, permuted + holey tables, one idle lane
    n_lanes, max_pages = 8, 1024 // PAGE
    max_len = max_pages * PAGE
    positions = torch.tensor([0, 63, 64, 200, 511, 700, 1023, max_len], dtype=torch.int32)
    n_pages = n_lanes * max_pages + 16
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(SEED + 2))
    tables = torch.full((n_lanes, max_pages), -1, dtype=torch.int32)
    cursor = 0
    for lane, pos in enumerate(positions.tolist()):
        used = max_pages if pos >= max_len else -(-(pos + 1) // PAGE)
        tables[lane, :used] = perm[cursor : cursor + used].to(torch.int32)
        cursor += used
    kp = torch.randn(n_pages, PAGE, hkv, d, generator=gen, device=device).to(torch.bfloat16)
    vp = torch.randn(n_pages, PAGE, hkv, d, generator=gen, device=device).to(torch.bfloat16)
    q = torch.randn(n_lanes, 1, hq, d, generator=gen, device=device).to(torch.bfloat16)
    tables, positions = tables.to(device), positions.to(device)
    active = slice(0, n_lanes - 1)  # the sentinel lane's output is never read
    k1_err = 0.0
    for window in (None, 4096, 200):
        got = pfa.paged_flash_attend(q, kp, vp, tables, positions, sliding_window=window)
        torch.cuda.synchronize()
        want = paged_attend(q.float(), kp.float(), vp.float(), tables, positions, sliding_window=window)
        if not torch.isfinite(got).all():
            raise AssertionError(f"K1 window={window}: non-finite output")
        err = (got[active].float() - want[active]).abs().max().item()
        log(f"K1 decode, window={window}: max abs err {err:.3e} (tol {KERNEL_TOL})")
        if err > KERNEL_TOL:
            raise AssertionError(f"K1 disagrees with its plain version: {err} > {KERNEL_TOL}")
        k1_err = max(k1_err, err)

    window = MISTRAL_7B["sliding_window"]
    kv_lens = [min(p + 1, max_len) for p in positions.tolist()]
    rows = sum(_visible(kl - 1, kl, window) for kl in kv_lens)
    k1_bytes = 2 * rows * hkv * d * 2 + 2 * q.numel() * 2 + tables.numel() * 4 + positions.numel() * 4
    k1_bound, k1_by = bound_ms(k1_bytes, 4 * hq * d * rows)

    def k1_library():
        k = gather_pages(kp, tables).transpose(1, 2)
        v = gather_pages(vp, tables).transpose(1, 2)
        kv_pos = torch.arange(k.shape[2], device=device)
        mask = (kv_pos[None, :] <= positions[:, None].long()) & (kv_pos[None, :] > positions[:, None].long() - window)
        return _sdpa(q.transpose(1, 2), k, v, mask[:, None, None, :])

    lib_err = (k1_library().transpose(1, 2)[active].float() - paged_attend(
        q.float(), kp.float(), vp.float(), tables, positions, sliding_window=window)[active]).abs().max().item()
    k1 = {
        "name": "paged_decode_attention", "route": "cuda",
        "source": "petals_tpu_torch/csrc/paged_attention.cu",
        "replaces": "petals_tpu/ops/paged_flash_attention.py:220",
        "max_abs_err": k1_err,
        "ms": timer(lambda: pfa.paged_flash_attend(q, kp, vp, tables, positions, sliding_window=window)),
        "plain_ms": timer(lambda: paged_attend(q, kp, vp, tables, positions, sliding_window=window)),
        "bound_ms": k1_bound, "bound_by": k1_by,
        "library_ms": timer(k1_library),
    }
    log(f"K1 at 8 lanes, window 4096: {k1['ms']:.4f} ms kernel, {k1['plain_ms']:.4f} ms plain, "
        f"{k1['library_ms']:.4f} ms gather+SDPA (its err {lib_err:.3e}), bound {k1_bound:.4f} ms ({k1_by})")

    # ---- K2: a 512-row chunk at 0, then its 188-row continuation at 512
    max_pages2 = 1024 // PAGE
    n_pages2 = max_pages2 + 8
    perm2 = torch.randperm(n_pages2, generator=torch.Generator().manual_seed(SEED + 3))
    total = 512 + 188
    table_row = torch.full((max_pages2,), -1, dtype=torch.int32)
    used = -(-total // PAGE)
    table_row[:used] = perm2[:used].to(torch.int32)
    table_row = table_row.to(device)
    kp2 = torch.randn(n_pages2, PAGE, hkv, d, generator=gen, device=device).to(torch.bfloat16)
    vp2 = torch.randn(n_pages2, PAGE, hkv, d, generator=gen, device=device).to(torch.bfloat16)
    k2_err, k2_cases = 0.0, {}
    for chunk_pos, n in ((0, 512), (512, 188)):
        qc = torch.randn(1, n, hq, d, generator=gen, device=device).to(torch.bfloat16)
        got = pfa.paged_flash_prefill_attend(qc, kp2, vp2, table_row, chunk_pos, n, sliding_window=window)
        torch.cuda.synchronize()
        want = paged_prefill_attend(
            qc.float(), kp2.float(), vp2.float(), table_row, chunk_pos, n, sliding_window=window
        )
        if not torch.isfinite(got).all():
            raise AssertionError(f"K2 chunk_pos={chunk_pos}: non-finite output")
        err = (got.float() - want).abs().max().item()
        log(f"K2 prefill, chunk_pos={chunk_pos}, {n} rows: max abs err {err:.3e} (tol {KERNEL_TOL})")
        if err > KERNEL_TOL:
            raise AssertionError(f"K2 disagrees with its plain version: {err} > {KERNEL_TOL}")
        k2_err = max(k2_err, err)
        k2_cases[chunk_pos] = qc

    qc = k2_cases[0]
    n = qc.shape[1]
    rows = sum(_visible(r, n, window) for r in range(n))
    k2_bytes = 2 * n * hkv * d * 2 + 2 * qc.numel() * 2 + table_row.numel() * 4
    k2_bound, k2_by = bound_ms(k2_bytes, 4 * hq * d * rows)

    def k2_library():
        k = gather_pages(kp2, table_row[None])[:, :n].transpose(1, 2)
        v = gather_pages(vp2, table_row[None])[:, :n].transpose(1, 2)
        pos = torch.arange(n, device=device)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        return _sdpa(qc.transpose(1, 2), k, v, mask)

    k2 = {
        "name": "paged_prefill_attention", "route": "cuda",
        "source": "petals_tpu_torch/csrc/paged_attention.cu",
        "replaces": "petals_tpu/ops/paged_flash_attention.py:488",
        "max_abs_err": k2_err,
        "ms": timer(lambda: pfa.paged_flash_prefill_attend(qc, kp2, vp2, table_row, 0, n, sliding_window=window)),
        "plain_ms": timer(lambda: paged_prefill_attend(qc, kp2, vp2, table_row, 0, n, sliding_window=window)),
        "bound_ms": k2_bound, "bound_by": k2_by,
        "library_ms": timer(k2_library),
    }
    qc2 = k2_cases[512]
    k2_cont_ms = timer(lambda: pfa.paged_flash_prefill_attend(qc2, kp2, vp2, table_row, 512, 188, sliding_window=window))
    log(f"K2 at a 512-row chunk: {k2['ms']:.4f} ms kernel, {k2['plain_ms']:.4f} ms plain, "
        f"{k2['library_ms']:.4f} ms gather+SDPA, bound {k2_bound:.4f} ms ({k2_by}); "
        f"188-row continuation at 512: {k2_cont_ms:.4f} ms kernel")
    return [k1, k2]


def write_checkpoint(path: str, device) -> None:
    """A Mistral-7B-v0.1-shaped checkpoint of SPAN blocks, one safetensors
    shard per block plus the index, random bf16 weights from SEED (HF
    layout [out, in], std 0.02 as HF initializes, norms at 1)."""
    from petals_tpu_torch.utils.safetensors_io import save_file

    cfg = MISTRAL_7B
    h, m, hq, hkv, d = (cfg[k] for k in ("hidden_size", "intermediate_size", "num_attention_heads",
                                          "num_key_value_heads", "head_dim"))
    shapes = {
        "self_attn.q_proj.weight": (hq * d, h), "self_attn.k_proj.weight": (hkv * d, h),
        "self_attn.v_proj.weight": (hkv * d, h), "self_attn.o_proj.weight": (h, hq * d),
        "mlp.gate_proj.weight": (m, h), "mlp.up_proj.weight": (m, h), "mlp.down_proj.weight": (h, m),
    }
    gen = torch.Generator(device=device).manual_seed(SEED)
    weight_map = {}
    for i in range(SPAN):
        fname = f"model-{i + 1:05d}-of-{SPAN:05d}.safetensors"
        tensors = {
            f"model.layers.{i}.{name}": (torch.randn(shape, generator=gen, device=device) * 0.02).to(torch.bfloat16)
            for name, shape in shapes.items()
        }
        for norm in ("input_layernorm.weight", "post_attention_layernorm.weight"):
            tensors[f"model.layers.{i}.{norm}"] = torch.ones(h, dtype=torch.bfloat16)
        save_file(tensors, os.path.join(path, fname), metadata={"format": "pt"})
        weight_map.update({name: fname for name in tensors})
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)


async def drive_server(server, prompts, n_steps, seed, at_end=None):
    """Concurrent sessions (a prefill, then ``n_steps`` decode steps each)
    through the port's RpcClient. Every stream stays open until all sessions
    have their last reply; ``at_end()`` is called then, before any ends.
    Returns per-session inputs, replies and each reply's step_meta, the
    client-side timings and what ``at_end`` returned."""
    from petals_tpu_torch.data_structures import CHAIN_DELIMITER, make_uid
    from petals_tpu_torch.rpc import RpcClient
    from petals_tpu_torch.rpc.serialization import deserialize_array, serialize_array

    hsz = server.cfg.hidden_size
    uids = CHAIN_DELIMITER.join(make_uid(server.dht_prefix, i) for i in range(SPAN))
    gen = torch.Generator().manual_seed(seed)
    inputs = [
        (torch.randn(1, n, hsz, generator=gen).to(torch.bfloat16),
         [torch.randn(1, 1, hsz, generator=gen).to(torch.bfloat16) for _ in range(n_steps)])
        for n in prompts
    ]
    client = await RpcClient.connect("127.0.0.1", server.rpc_server.port)
    t_start = time.perf_counter()
    n_done, all_done, at_end_result = [0], asyncio.Event(), []

    async def session(prompt, steps):
        stream = await client.open_stream("ptu.inference")
        await stream.send({"uids": uids, "max_length": server.batcher.max_length, "batch_size": 1})
        if not (await stream.recv(timeout=120))["session_open"]:
            raise AssertionError("session did not open")
        outs, metas = [], []
        for i, h in enumerate([prompt] + steps):
            await stream.send({"tensors": {"hidden": serialize_array(h)}})
            reply = await stream.recv(timeout=300)
            if reply["position"] != prompt.shape[1] + i:
                raise AssertionError(f"position {reply['position']} after step {i}")
            outs.append(deserialize_array(reply["tensors"]["hidden"]))
            metas.append(reply["step_meta"])
            if i == 0:
                prefill_done = time.perf_counter()
        decode_s = time.perf_counter() - prefill_done
        # the lanes keep their tables until the streams end
        n_done[0] += 1
        if n_done[0] == len(inputs):
            at_end_result.append(at_end() if at_end else None)
            all_done.set()
        await asyncio.wait_for(all_done.wait(), timeout=300)
        await stream.end()
        return outs, metas, prefill_done, decode_s

    try:
        results = await asyncio.gather(*(session(p, s) for p, s in inputs))
    finally:
        await client.close()
    timing = {
        "prefill_wall_s": max(r[2] for r in results) - t_start,
        "decode_round_trip_ms": statistics.median(r[3] / n_steps * 1e3 for r in results),
    }
    return inputs, [r[0] for r in results], [r[1] for r in results], timing, at_end_result[0]


def lane_kv_rows(batcher, lengths):
    """The K/V rows each open session's lane holds, read from the page pools
    through the lane's block table: per entry of ``lengths`` (the session's
    tokens so far), (k, v) of [n_blocks, length, hkv, d]. Lanes are told
    apart by their allocated page count, so the lengths must differ in
    pages."""
    torch.cuda.synchronize()
    k_pool, v_pool = batcher._buffers()
    tables, ps = batcher._tables.copy(), batcher.page_size
    held = [(int((row >= 0).sum()), lane) for lane, row in enumerate(tables) if (row >= 0).any()]
    by_pages = dict(held)
    want_pages = [-(-n // ps) for n in lengths]
    if len(by_pages) != len(held) or sorted(by_pages) != sorted(want_pages):
        raise AssertionError(f"lanes hold {sorted(by_pages)} pages, sessions need {sorted(want_pages)}")
    rows = []
    for n, used in zip(lengths, want_pages):
        pages = torch.as_tensor(tables[by_pages[used], :used], dtype=torch.long, device=k_pool.device)
        rows.append(tuple(pool[:, pages].flatten(1, 2)[:, :n].clone() for pool in (k_pool, v_pool)))
    return rows


@torch.no_grad()
def reference_session(block_params, family, cfg, prompt, steps, device, dtype):
    """One session alone through the port's block functions over a dense
    cache [1, length, hkv, d] per block, with plain attention, in ``dtype``.
    Returns the replies and the caches as (k, v) of [n_blocks, length, hkv, d]."""
    shape = (1, prompt.shape[1] + len(steps), cfg.num_key_value_heads, cfg.head_dim)
    caches = [
        (torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device))
        for _ in block_params
    ]
    outs, position = [], 0
    for x in [prompt] + steps:
        h = x.to(device, dtype)
        for params, kv in zip(block_params, caches):
            h, _ = family.block_apply(params, h, kv, position, cfg)
        position += x.shape[1]
        outs.append(h.float().cpu())
    k, v = (torch.cat([kv[j] for kv in caches]) for j in (0, 1))
    return outs, (k, v)


def _rel_errors(got, want):
    """Worst, over a session's replies, of max|got-want| / max|want| and of
    mean|got-want| / mean|want|."""
    worst_max, worst_mean = 0.0, 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"reply of shape {tuple(g.shape)} (want {tuple(w.shape)}) or non-finite")
        diff = (g - w).abs()
        worst_max = max(worst_max, diff.max().item() / w.abs().max().item())
        worst_mean = max(worst_mean, diff.mean().item() / w.abs().mean().item())
    return worst_max, worst_mean


def _row_rel_error(got, want) -> float:
    """Worst, over cached rows (block, position), of max|got-want| / max|want|
    within the row."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"KV rows of shape {tuple(got.shape)} (want {tuple(want.shape)}) or non-finite")
    return ((got - want).abs().amax(dim=(-2, -1)) / want.abs().amax(dim=(-2, -1))).max().item()


def check_session(got, kv, ref_bf16, ref_f32, label):
    """The server's replies and written K/V rows against the dense bf16
    reference. Tolerance: they may differ from it by at most
    REPLY_NOISE_FACTOR times the bf16 reference's own rounding error,
    measured against the same network evaluated in float32 on the same
    inputs. Two bf16 evaluations with independent rounding differ by up to
    twice their error from float32. Returns the list of what failed."""
    (out_bf16, kv_bf16), (out_f32, kv_f32) = ref_bf16, ref_f32
    srv_ref = _rel_errors(got, out_bf16)
    noise = _rel_errors(out_bf16, out_f32)
    srv_f32 = _rel_errors(got, out_f32)
    log(f"{label}: vs dense bf16 reference max-rel {srv_ref[0]:.3e} mean-rel {srv_ref[1]:.3e}; "
        f"bf16 reference vs float32 max-rel {noise[0]:.3e} mean-rel {noise[1]:.3e}; "
        f"server vs float32 max-rel {srv_f32[0]:.3e} mean-rel {srv_f32[1]:.3e}")
    failed = []
    if noise[1] > REPLY_BF16_MEAN_REL:
        failed.append(f"{label}: the network itself is unstable in bf16 ({noise[1]:.3e})")
    if srv_ref[0] > REPLY_NOISE_FACTOR * noise[0] or srv_ref[1] > REPLY_NOISE_FACTOR * noise[1]:
        failed.append(f"{label}: replies disagree with the dense reference beyond bf16 rounding")
    for name, srv, want, want_f32 in zip("KV", kv, kv_bf16, kv_f32):
        err, row_noise = _row_rel_error(srv, want), _row_rel_error(want, want_f32)
        log(f"{label}: written {name} rows vs dense bf16 cache, worst row max-rel {err:.3e}; "
            f"bf16 cache vs float32 worst row {row_noise:.3e}")
        if err > REPLY_NOISE_FACTOR * row_noise:
            failed.append(f"{label}: written {name} rows disagree with the dense cache beyond bf16 rounding")
    return failed


def profile_steps(backend, device) -> None:
    """Where a step's time goes, on the served span's backend called directly
    (no RPC): a paged decode step at PROFILE_LANES lanes and a mixed step
    that also carries a PROFILE_CHUNK-token chunk, on fresh random pools."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg, ps, max_len = backend.cfg, PAGE, 1024
    max_pages = max_len // ps
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    shape = (backend.n_blocks, PROFILE_LANES * max_pages, ps, cfg.num_key_value_heads, cfg.head_dim)
    pools = tuple(torch.randn(shape, generator=gen, device=device).to(torch.bfloat16) for _ in range(2))
    tables = torch.arange(PROFILE_LANES * max_pages, dtype=torch.int32).reshape(PROFILE_LANES, max_pages)
    positions = torch.linspace(64, max_len - 64, PROFILE_LANES).to(torch.int32)
    hidden = torch.randn(PROFILE_LANES, 1, cfg.hidden_size, generator=gen, device=device).cpu()
    chunk = torch.randn(1, PROFILE_CHUNK, cfg.hidden_size, generator=gen, device=device).cpu()
    mixed_positions = positions.clone()
    mixed_positions[0] = max_len  # lane 0 prefills: its decode row idles
    steps = {
        "decode step": lambda: backend.paged_decode_step(hidden, pools, positions, tables),
        f"mixed step ({PROFILE_CHUNK}-token chunk)": lambda: backend.paged_mixed_step(
            hidden, pools, mixed_positions, tables, chunk, 0, 0),
    }
    log(f"profile: {backend.n_blocks} blocks, {PROFILE_LANES} lanes at positions {positions.tolist()}")
    for label, fn in steps.items():
        fn()
        walls = []
        for _ in range(PROFILE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PROFILE_CALLS):
                fn()
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3 / PROFILE_CALLS
        events = prof.key_averages()
        # device-side events only: an operator's row repeats its kernels' time
        busy = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA) / 1e3 / PROFILE_CALLS
        launches = sum(e.count for e in events if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
        log(f"{label}: host wall {statistics.median(walls):.3f} ms (median of {PROFILE_REPS}); "
            f"profiled, per call over {PROFILE_CALLS}: host wall {prof_wall:.3f} ms, device busy {busy:.3f} ms, "
            f"idle share {1 - busy / prof_wall:.3f}, {launches / PROFILE_CALLS:g} kernel launches")
        log(events.table(sort_by="self_device_time_total", row_limit=10, max_name_column_width=60))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from petals_tpu_torch.cli.run_server import build_parser, build_server
    from petals_tpu_torch.ops import paged_flash_attention as pfa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    build()
    timer = Timer(device)
    kernels = check_kernels(device, timer)

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke-ckpt-", dir=os.path.join(REPO, "build")) as ckpt:
        t0 = time.perf_counter()
        write_checkpoint(ckpt, device)
        log(f"checkpoint: {SPAN} Mistral-7B-shaped blocks written in {time.perf_counter() - t0:.1f} s")
        args = build_parser().parse_args([ckpt, "--first_block", "0", "--num_blocks", str(SPAN), "--host", "127.0.0.1"])
        t0 = time.perf_counter()
        server = build_server(args)
        log(f"server: loaded in {time.perf_counter() - t0:.1f} s, {server.batcher.n_lanes} lanes x "
            f"{server.batcher.max_length} tokens, page {server.batcher.page_size}, "
            f"prefill budget {server.batcher.prefill_token_budget}")

        async def serve():
            await server.start()
            try:
                await drive_server(server, WARMUP_PROMPTS, 2, SEED + 5)
                before = dict(server.batcher.stats)
                pfa.paged_flash_attend.launches = 0
                pfa.paged_flash_prefill_attend.launches = 0
                result = await drive_server(
                    server, PROMPTS, DECODE_STEPS, SEED + 4,
                    at_end=lambda: lane_kv_rows(server.batcher, [n + DECODE_STEPS for n in PROMPTS]),
                )
                launches = (pfa.paged_flash_attend.launches, pfa.paged_flash_prefill_attend.launches)
            finally:
                await server.shutdown()
            stats = {k: v - before[k] if not k.startswith("max") else v for k, v in server.batcher.stats.items()}
            return result, launches, stats

        (inputs, replies, metas, timing, lane_kv), (k1_launches, k2_launches), stats = asyncio.run(serve())
        log(f"server stats of the measured run: {stats}")
        need_k1, need_k2 = stats["decode_steps"] * SPAN, stats["mixed_steps"] * SPAN
        log(f"launches on the main path: K1 {k1_launches} (>= {need_k1}), K2 {k2_launches} (>= {need_k2})")
        if stats["mixed_steps"] < len(PROMPTS) + 1 or k1_launches < need_k1 or k2_launches < need_k2 or not (
            k1_launches and k2_launches
        ):
            raise AssertionError("the main path did not run both kernels on every block of every step")
        decode_compute = [m["compute_s"] for ms in metas for m in ms[1:]]
        prefill_compute = sum(ms[0]["compute_s"] for ms in metas)
        log(f"main path: prefill {sum(PROMPTS) / timing['prefill_wall_s']:.1f} tokens/s over {sum(PROMPTS)} "
            f"tokens ({timing['prefill_wall_s'] * 1e3:.1f} ms wall, {prefill_compute * 1e3:.1f} ms of steps "
            f"carrying chunks); decode step {statistics.median(decode_compute) * 1e3:.3f} ms "
            f"(median batched-step compute on the server), {timing['decode_round_trip_ms']:.3f} ms "
            f"client round trip (median per session)")
        block_params = server.backend.block_params
        params_f32 = [{k: v.float() for k, v in p.items()} for p in block_params]
        failed = []
        for (prompt, steps), got, kv, n in zip(inputs, replies, lane_kv, PROMPTS):
            args = (server.family, server.cfg, prompt, steps, device)
            failed += check_session(
                got, kv, reference_session(block_params, *args, torch.bfloat16),
                reference_session(params_f32, *args, torch.float32), f"session with a {n}-token prompt",
            )
        if failed:
            raise AssertionError("; ".join(failed))
        del params_f32, lane_kv
        profile_steps(server.backend, device)
        del server, block_params
    kernels[0]["launches"] = k1_launches
    kernels[1]["launches"] = k2_launches
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
