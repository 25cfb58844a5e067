"""Drive petals_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

1. Build: compile every CUDA source of the port (csrc/paged_attention.cu,
   csrc/quant_matmul.cu, csrc/flash_attention.cu) with nvcc (sm_90a) into build/kernels/, one nvcc
   each, all started together, and print each one's build seconds; print
   the card's name and power limit.
2. Kernels: at Mistral-7B-v0.1 widths (32 query heads, 8 KV heads, head_dim
   128, page 64, bf16) hold each CUDA kernel against its plain PyTorch
   version on the same inputs, and time the kernel, the plain version and a
   library yardstick (page gather + scaled_dot_product_attention, timed here
   and used nowhere in the port) with CUDA events, the L2 cache flushed
   before every launch and the card kept busy (a device-side spin) while the
   host enqueues the timed call, so the events bracket device time only.
   - K1 paged decode: 8 lanes at ragged positions up to 1023 on permuted
     tables with holes past each frontier, one lane idle at the sentinel,
     with the sliding window off, at Mistral's 4096 and at 200; its split
     merge bit-equal over DECODE_REPEATS repeats; and three long contexts,
     one lane and 8 lanes at position 4095 (tables of 4096 tokens) and 4
     lanes at 1000 on tables of 8192 (short lanes on wide tables), each
     against its plain version and timed beside gather + SDPA and the
     bound. Each decode entry reports library_factor = kernel / library.
   - K2 chunked prefill (bf16: paged_prefill_wgmma_kernel), its chunk
     position and length passed as int32 scalars on the card (as the
     served step passes them, so a graph replays one launch for any
     position): a 512-row chunk at position 0 and its 188-row continuation
     at 512, then the long
     chunks of LONG_PREFILL, 512 rows at 3584 on a 4096-token table and at
     4608 on an 8192-token table (Mistral's window), three pages inside each
     visible range holes; each timed beside gather + SDPA with a mask that
     hides the holes (library_factor = kernel / library) and the bound.
   - K3, the quantized-pool arms of both (int8 and nf4a), on the same
     inputs with the pools quantized on the card; the yardstick gathers and
     dequantizes the pages before SDPA. Bounds count the stored bytes that
     some query row sees.
   Tolerance: bf16 inputs against the plain version computed in float32 on
   the same bf16 values; the kernels accumulate in float32 and round once to
   bf16, so outputs of magnitude < 4 differ by at most half a bf16 ulp
   (2**-7) plus summation order: max abs error <= KERNEL_TOL = 2e-2 (for
   K3 the plain version decodes the pool to bf16 values, the kernel to
   float32, within the same bound). K1 on a bf16 pool is held tighter,
   lane by lane: within OUT_REL_TOL = 2**-7 (twice its output's bf16
   rounding) of the lane's largest output magnitude, so a lost split
   fails where outputs are small (scripts/plant_attention_faults.py). K2
   and K3 prefill are held query row by query row: within ROW_REL_TOL =
   2**-7 (bf16 pool) or KV_ROW_REL_TOL = 2**-5 (quantized pool) of the
   row's largest output magnitude, derived beside the constants; a row
   that sees nothing must be exact zeros.
3. Server: write a seeded Mistral-7B-v0.1-shaped checkpoint of 8 blocks
   and the client's tensors (model.embed_tokens [32000, 4096], model.norm,
   lm_head; bf16, random weights) with the port's safetensors writer, start
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
   block of every step of the measured run. The server's paged steps are
   step programs: the batcher captures them as CUDA graphs when its pool
   opens, and its stats must show every batched step of the run a replay
   and no capture after warm-up (check_graph_stats, in every served paged
   run of phases 3, 6-8 and 12-14; the launch counters count each replay's
   kernels).
4. Profile: where a step's time goes. A sibling of the served span's
   backend (its weights, step programs of its own) runs a paged decode step
   and a mixed step carrying a 512-token chunk directly (no RPC) at 4
   lanes, each two ways: the eager block loop and the replayed step
   program; for each, the host wall (median, launch to synchronize) and
   the device span (CUDA events around the same calls), and from
   torch.profiler over PROFILE_CALLS further calls the device busy time,
   the kernel and graph launches and the top operations, with the idle
   share 1 - busy / wall of those same calls (and of the device span), and
   each of the port's kernels' device time a call and share of the busy
   time (K1 or K3's decode arm is paged_decode_kernel, K2 or K3's prefill
   arm paged_prefill_wgmma_kernel).
5. Dequant-matmul kernels (K5: nf4, nf4a, int4; K6: int8) at the four
   projections of a Mistral-7B block as the port serves them, wqkv [4096,
   6144], wo [4096, 4096], gate+up [4096, 28672] and down [14336, 4096], at
   1, 4, 8 and 32 rows (the decode kernel: one session to a batched decode
   step) and 64, 188 and 512 rows (the prefill kernel: the main path's chunk
   lengths), seeded bf16 weights quantized on the card: each against its
   plain version (x rounded to bf16 against dequantize(w, bf16), summed in
   float32) within QUANT_REL_TOL of the output's largest magnitude, the
   decode kernel (whose split slabs are merged inside the launch) also
   bit-equal over two more calls, timed beside a dense bf16 torch.matmul
   (the product the quantized kernel replaces, timed here only) and the
   bound; the plain version is timed at gate+up only, at 8 and 512 rows, the
   shape the kernels line reports. A line names every decode shape where
   nf4a is not faster than the dense matmul. Then K5 nf4a the same way at
   the four projections of a Qwen2.5-7B block as phase 14 serves them
   (QWEN_QUANT_SHAPES: wqkv [3584, 4608], wo [3584, 3584], gate+up [3584,
   37888], down [18944, 3584]) at 1, 2, 4 and 8 rows and at phase 14's 64-
   and 300-row chunks, timed at gate+up only, at 8 and 300 rows; the kernels
   line carries those as "qwen2_5_7b". (This phase runs right after phase
   2.)
6. Quantized server: the same 8-block span served with --quant_type nf4a
   (quantized on the card at load, qkv and gate+up fused) to the traffic of
   phase 3, checked as phase 3 checks, against dense references over the
   dequantized weights in bf16 and float32; the decode kernel must have run
   for every projection of every block of every step and the prefill
   kernel for every chunk's. Then phase 4's profile of the nf4a span.
7. Other kinds, short: int8, nf4, int4 and nf4a+o served at 2 blocks, one
   session each (a 300-token prompt, 8 decode steps), checked the same way,
   so every arm of K5 and K6 runs on the served path.
8. Quantized KV pool: the bf16 8-block span served with --kv_quant_type
   nf4a to the traffic of phase 3 (8 lanes where bf16 gets 4), then phase
   4's profile of it; and, short as in 7, --kv_quant_type int8 and
   --quant_type nf4a --kv_quant_type nf4a. The references write each K/V
   row as the pool holds it (encoded, then decoded to the cache's type), in
   bf16 and float32, and the replies are checked as in phase 3. Each K/V
   row the server wrote is read through the block tables and decoded; it
   must lie within RT_BOUND[kind] of its absmax (per kv head) of the bf16
   reference's row as computed, plus twice that row's bf16 error from
   float32: a lost or misplaced write is off by the order of the absmax.
   The counters must show K3's arm of the kind on every block of every step
   and no launch of K1, K2 or the other kind in that run.

9. Dense flash attention (K4), right after phase 2: at Mistral-7B widths,
   bf16, on strided views of a span-stacked cache [blocks, batch, 2048, 8,
   128] (a session's per-block cache, never copied): (a) 512 rows at offset
   0, (b) the 188-row continuation at 512, (c) batch 2, 700 rows, window
   200, (d) batch 2, 333 rows at offset 100 over a buffer of 1000 rows (no multiple
   of 128 or of the kernel's tile). Against its plain version (float32
   scores, probabilities rounded to bf16 for the PV product as the kernel
   rounds them) within KERNEL_TOL, for the reason phase 2 states, on the
   bf16 (wgmma) kernel and, on the same views in float32, the CUDA-core
   kernel within F32_KERNEL_TOL = 1e-5 (the same arithmetic in another
   order; inputs rounded to bf16 read ~1e-3). Times (bf16, with library_factor per case):
   the kernel, the plain version and the yardstick, one
   scaled_dot_product_attention call with an explicit mask over the valid
   part of the buffer (timed here, used nowhere in the port). The kernel is
   called and timed with its position and length as int32 scalars on the
   card, as a served step passes them (a replayed graph reads them there),
   and must give the bytes its host-integer form gives. The bound
   counts q, the output and the K/V rows some query row sees, once per KV
   head, and 4 * batch * hq * d operations per visible (q, kv) pair.
10. Private sessions: the bf16 8-block span with the CLI's defaults; a
   session of batch 2 and max_length 2048 (a 700-token prefill, a 300-token
   step at 700, 16 decode steps) and a sub-span session (blocks 2..6, batch
   1: a 300-token prefill, 4 decode steps). Replies are checked as in phase
   3, and the private cache's K/V rows row by row against the reference's.
   Each step is a call of its backend's private step program: a chunk
   (padded to its bucket) runs its key once, eagerly; the decode key runs
   eagerly, is captured on the second decode step and replays every later
   one, and the program's counts must say exactly that. K4's counter must
   equal blocks x steps of more than one token (each padded to 8 rows and
   more; a replay counts through the capture's record), and K1/K2 must
   read 0. Then, on the served weights, phase 15's dense programs and the
   profile's dense rows (profile_dense_steps: the private batch-2 decode
   step on a 2048-token cache and the dense pool's 4-lane decode step,
   eager and replayed, and B6, the plain decode attention they run,
   captured alone and profiled as a replay).
11. The dense lane pool: the span with --page_size 0 (and a chunk bound of
   512 tokens' activations, so the 700-token prompt's prefill runs as two
   queue tasks) to phase 3's four sessions at 16 decode steps: replies
   checked as in phase 3; K4 must have run on every block of every prefill
   chunk and K1/K2 never. The pool's programs are captured when it opens
   (the batched decode step; on each lane's view of the pool the chunk at
   bucket 0 and every bucket up to the chunk bound): the measured run must
   capture none, every batched step must replay the batched decode program
   and every prefill chunk a lane program. Then measure_dense_graph_pool
   reads the memory the dense programs keep reserved (this pool's, a
   private batch-2 session's and the forward's) beside the eager peaks,
   against the reserve choose_num_blocks leaves.
12. Swarm: a port DHT bootstrap node on 127.0.0.1, then two port servers
   built by the CLI (its 8192-token budget, --update_period 2,
   --throughput auto with a fresh cache under build/): A on blocks [0, 4),
   whose throughput probe runs on the card (a one-lane paged decode step
   and a 1024-token forward of one random block; printed with the card's
   name and power limit), and B with --num_blocks 4 and no --first_block,
   which must place itself at block 4 (B reads A's cached probe). Prints
   choose_num_blocks for the full Mistral-7B-v0.1 config (32 layers) at the
   CLI's budget, none and nf4a, from the card's memory. Reads the directory
   through a query-only port DHT node: exactly two ONLINE spans, [0, 4) and
   [4, 8), each announcing the port's version, a positive throughput and
   cache_tokens_left; within SWARM_WAIT_S, A's next_pings holds B's id.
   Then two sessions (prompts of 300 and 64 tokens, 16 decode steps) run
   through the chain with the port's RpcClient over an identity-proving
   connection pool, dialing the directory's addresses (each server must
   prove the peer id it announced): A for blocks 0-3, B for 4-7, A's reply
   fed into B at each step. Every final hidden state is held against phase
   3's dense reference over all 8 blocks with check_session's tolerance;
   the chain's step times are printed, and K1 and K2 must have run on both
   servers (K4 in A's probe). Then B shuts down and the directory must read
   its records OFFLINE.
13. Client: the port's own client over a chain of two port servers. A
   sibling of the checkpoint whose config says 8 layers (the depth cut: the
   client's model is every block served); two port servers built by the CLI
   join a port DHT bootstrap, A at [0, 4), B placing itself at [4, 8), on a
   loop thread of their own. AutoDistributedModelForCausalLM.from_pretrained
   loads the client's parameters on the card (float32, the head held in
   float32) and, on its own loop, runs: greedy generation of 32 tokens from a
   300-token prompt; a batch of 2 prompts (16 tokens); seeded sampling
   (CLIENT_SAMPLING) twice, whose streams must be identical; 2-beam search;
   a two-call chat session. What the client sent is held to its own tokens:
   the prompt step is the checkpoint's embeddings of the prompt; every later
   step of a greedy, sampled or chat stream the embedding of the token
   chosen before it; every later beam step's rows rows of the embedding
   table, each among the 2 x beams tokens its parent lane's logits rank
   highest. Every session is teacher-forced through a dense
   reference on the card (the client's inputs through the 8 blocks in bf16 and float32 by
   reference_session, with each step's hypo_ids reordering the caches, then
   the final norm and a float32 head): the client's logits must lie within
   REPLY_NOISE_FACTOR times the bf16 reference's error from float32 (as
   phase 3 holds replies), and each greedy token's float32 reference logit
   within REPLY_NOISE_FACTOR times the largest bf16 logit error of the
   reference's largest (random weights leave the top two nearly equal, so
   exact argmax equality is no test). K1 and K2 must have run during the
   client's runs; the servers' loop thread is a SwarmRuntime, as the
   client's is. Prints the per-token round trip the client sees (median,
   max), its embed and head time a token, the time to the first token, with
   the card's name and power limit.
14. Qwen2: a checkpoint at Qwen2.5-7B's widths (QWEN2_5_7B: 28 query heads
   over 4 kv heads, a GQA group of 7; q/k/v biases drawn with std 0.1;
   vocabulary 152064, untied), depth cut to 4 blocks; served by one port
   server in bf16 and then with --quant_type nf4a to two sessions (300 and
   64 tokens, 16 decode steps), checked as phase 3 checks them; then the
   port client generates 16 greedy tokens over an nf4a server, held as in
   phase 13, and K1, K2 and K5 must have run on its path. (K1/K2 at group 7
   are held to their plain versions and timed beside Mistral's shapes right
   after phase 2; the kernels line carries them as "group_7".)
15. Step programs against the eager loop (check_step_programs, right after
   phase 3 for the bf16 weights with a bf16, int8 and nf4a pool, after phase
   6 for nf4a weights, after each 2-block run of phase 7): on a sibling
   backend, seeded pools at 4 lanes on 1024-token tables, two decode steps
   and mixed steps at STEP_CHUNKS (buckets 8, 64 and 512 captured, then
   300 tokens padded to 512 and 5 padded to 8, which replay those graphs at
   another lane, position and real length), each replayed and run through
   the eager block loop (the same padded chunk and device scalars) on a
   clone of the pools. Every output row and every pool byte must be
   bit-equal (the prefilling lane's decode row, at the sentinel, is left
   out only on the step that captures its bucket); 4 captures and a replay
   a step. The dense programs (check_dense_programs, after phase 10's
   sessions on its weights): a seeded private cache of 2 rows and 1024
   tokens, the private step at buckets 8, 64 and 512 (each run eagerly,
   then captured by a second chunk of the bucket; the last, 300 tokens
   padded to 512, past the cache's end), three decode steps, three with
   hypo_ids, deep prompts over a chunk that straddles their end; a 4-lane
   dense pool warmed as a batcher warms it, its batched decode step and a
   lane-view chunk; the forward three times; each against the same call on
   a backend without programs on a clone, bit-equal; the private decode
   steps again on 2 of phase 6's nf4a blocks, so K5's decode kernel runs
   inside a dense graph; and in phase 16, where the client's leaves are
   loaded, the private generation step (8 greedy and 8 sampled tokens)
   and the dense pool's generation step (check_private_gen_program).
   Beside the 8-block bf16 and nf4a runs, measure_graph_pool reads
   the memory the step programs keep reserved (warmed as the served
   batcher warms them, and up to the last prefill bucket) beside the eager
   paths' peaks, and fails if they pass the reserve choose_num_blocks
   leaves. At the end the observatory's digest must count no capture after
   warm-up.
16. Server-side generation (serve_gen_and_check, after phase 14): the
   8-layer cut of the checkpoint served whole by one port server built by
   the CLI (so it loads the client's float32 leaves and announces
   server_gen), in bf16 and then with --quant_type nf4a, GEN_LANES lanes.
   The port client takes its fast path (chunks of up to 32 tokens a round
   trip): greedy GEN_NEW tokens of a GEN_PROMPT-token prompt, seeded
   sampling (GEN_SAMPLING) twice (identical), greedy under GEN_PENALTY,
   seeded sampling on a private cache, GEN_LONG_NEW greedy tokens alone,
   then GEN_SESSIONS generating sessions at once beside a per-token session
   and a GEN_LATE_PROMPT-token prompt arriving once all of them generate.
   Each generated stream is fed back per token through the same server,
   and every token must be the client's own pick on those logits (the
   Threefry draw for a sampled one, ties within float rounding counted);
   each is teacher-forced through the dense reference (greedy tokens within
   the noise of the maximum; sampled draws against the reference's, those
   its noise moves counted); the per-token sessions are checked as in phase
   13. Every generation step must be one replay of the step program that
   runs K1 on every block (and, with nf4a weights, K5's decode kernel on
   every projection), no capture after warm-up, gen_steps > 0,
   max_gen_lanes >= GEN_SESSIONS, a prefill chunk in a mixed step while
   lanes generate. The generation step's program is held bit-equal to its
   eager loop on cloned pools and profiled beside the decode step (the
   share of the embedding, head and sampling). Prints the client's time per
   generated token on the fast path (1 and GEN_SESSIONS sessions), the
   server's per-token round trip and both step bodies' host walls, with the
   card's name and power limit. Phase 14's server runs with
   --no_server_side_generation, so its client keeps the per-token path.
17. The prefix cache (serve_prefix_and_check, last), at its defaults (256
   MiB host tier, 256 MiB HBM tier, radix, swarm scope); every earlier phase
   runs its servers with --prefix_cache_bytes 0, so their counts of kernels,
   steps and chunks mean what they meant. The 8-block bf16 span with lanes
   of PREFIX_LANE tokens (the CLI's are 1024: the 1024-token shared prompt,
   a tail and the decode steps must fit one), after a warm-up session:
   sessions share a PREFIX_SHARED-token prompt (8 segments, 16 pages) with
   tails of 64 and 37 tokens, 4 decode steps each; an exact match of the
   prompt decodes 16 steps; a session that hit rolls back to position
   PREFIX_ROLLBACK and rewrites 4 tokens there; a fresh exact match
   follows. Each session runs alone with the launch counters at 0. The
   miss stores 8 segments and pins their pages; the hit must adopt them
   (page_hits), its 37-token tail run alone as one mixed step (K2 once a
   block, at q_offset 1024 over the adopted pages) and its decode steps run
   K1 over them; the exact match runs nothing (variant "cached", no prefill
   token); the rollback forks exactly 1 page, and the fresh exact match
   gets the first one's outputs bit for bit (the cached prefix intact); 20
   pages stay pinned; no step program is captured after the pool's warm-up.
   The same traffic at 2 blocks on an nf4a pool (K3's nf4a prefill once a
   block on the hit's tail), on the --page_size 0 dense pool (a device-tier
   seed; K4 once a block on the tail at q_offset 1024), and in private
   sessions (max_length past the lanes: the device tier is dropped after
   the miss, so the hit and the exact match read the host tier, which
   promotes the path, and a fourth session hits the device tier; K4 once a
   block on each hit's tail). Every reply is checked as phase 3 checks
   replies, against the dense references without a cache (the rewrite's
   against the prompt's first PREFIX_ROLLBACK rows and the rewrite). Prints
   each prefill's reply wall (the miss, the hit, the exact match) beside
   the server's own time for it, the first step after the storing prefill
   (it waits for the store's snapshot) against the later ones, the host's
   time to hash the prompt, the cache's summary and the pool's pages, with
   the card's name and power limit.

float32 matmuls run in full float32: TF32 is switched off for matmuls and
convolutions. Exits non-zero on any failure. The last line is the JSON
object ``{"ok": true, "device": {...}}``; the line before it lists the
kernels with their times, bounds and main-path launch counts (K1/K2 from
the bf16 run, K3's nf4a arms from the nf4a-pool run and its int8 arms from
the short int8-pool run, K5's nf4a arm from the nf4a run, its nf4 and int4
arms and K6 from their short runs, K4 from the private sessions' run). Every run prints its lanes, pages and
pool bytes.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
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
# K1 on a bf16 pool against its plain version in float32 on the same values:
# the kernel's one rounding is its output's, to bf16, at most 2**-8 of the
# value; so each lane's max abs error must lie within twice that of the
# lane's largest output magnitude. At 4095 tokens the outputs are ~0.03,
# where KERNEL_TOL is about one typical value and would pass a dropped
# split; scripts/plant_attention_faults.py shows each limit rejects one.
OUT_REL_TOL = 2**-7
# K2 and K3 prefill on bf16 queries, held row by row (each query row, a
# (position, head), within a share of its largest output magnitude). The
# kernel rounds each probability to bf16 before the PV product and its
# output once; the plain version rounds neither. The output's rounding moves
# a row by at most 2**-9 of its largest output; P's moves output d by
# sum_j delta_j p_j v_jd / l with independent |delta_j| <= 2**-9, about
# 2**-9 of the row's largest output too, up to ~3x where a row's few visible
# values cancel. Two roundings, doubled: ROW_REL_TOL. A quantized pool puts two
# more bf16 roundings of every K and V value between the two sides (the
# kernel's of nf4a's unscaled cubic, the plain version's of each decoded
# value), K's moving the scores and so every probability: four roundings,
# K's twice, KV_ROW_REL_TOL. At 4000 visible positions the outputs are
# ~0.02-0.08 and a dropped 64-slot tile moves them by ~2e-3, several times
# ROW_REL_TOL; KERNEL_TOL would pass it (scripts/plant_attention_faults.py;
# tests/test_torch_prefill_model.py holds a model of the kernel's arithmetic
# to these limits on the CPU).
ROW_REL_TOL = 2**-7
KV_ROW_REL_TOL = 2**-5
# K4's float32 kernel (CUDA cores) against its float32 plain version: the
# same arithmetic in another order, 3.7e-7 at most on an H100; inputs
# rounded to bf16 would read ~1e-3
F32_KERNEL_TOL = 1e-5
# K3 against its plain version on the same quantized pool: the plain version
# decodes to bf16 values, the kernel to float32 registers, so every K/V value
# may differ by half a bf16 ulp as well; the same KERNEL_TOL covers it
KV_QUANT_KINDS = ("int8", "nf4a")
# a decoded pool row may differ from the row as computed by this share of the
# row's absmax (per kv head): half the widest code gap plus rounding slack
# (tests/test_kv_quant.py RT_BOUND)
RT_BOUND = {"int8": 0.005, "nf4a": 0.145}
# server replies: both sides compute in bf16, but the server splits the
# 700-token prompt into 512 + 188-row chunks and batches decode rows, so
# its matmuls run at other shapes and round differently, and a bf16 ulp of
# difference in one block's output feeds every later block. The tolerance
# is that rounding noise itself, measured (see check_session).
REPLY_NOISE_FACTOR = 2.0
REPLY_BF16_MEAN_REL = 5e-2  # beyond this the bf16 network is too unstable to judge
# With a quantized pool the bf16 reference differs from its float32 twin by
# more than rounding: a row that rounds differently in bf16 can take the
# neighbouring code, and the flip carries through the later blocks (nf4a at
# 8 blocks: 8.2e-2 to 1.4e-1 mean-rel, measured on the H100). Beyond this
# the quantized network is too unstable to judge.
REPLY_KV_QUANT_MEAN_REL = 0.25
WARMUP_PROMPTS = (64, 300)  # first-call costs (cuBLAS plans, page faults) off the clock

KERNEL_SOURCES = ("paged_attention", "quant_matmul", "flash_attention")

# private sessions (phase 10) and the dense pool (phase 11)
PRIVATE_BATCH = 2
PRIVATE_MAX_LENGTH = 2048
PRIVATE_STEPS = (700, 300) + (1,) * 16  # tokens a step
SUB_SPAN = (2, 6)
SUB_SPAN_STEPS = (300,) + (1,) * 4
DENSE_DECODE_STEPS = 16
SWARM_HALF = 4  # two port servers, blocks [0, 4) and [4, 8)
SWARM_PROMPTS = (300, 64)
SWARM_STEPS = 16
SWARM_UPDATE_PERIOD = 2.0  # seconds between announces
SWARM_WAIT_S = 20.0  # the longest wait for an announce to show
LOOP_TIMEOUT_S = 600  # the longest wait for a call on the servers' loop thread
CLI_ATTN_CACHE_TOKENS = 8192  # run_server's --attn_cache_tokens default
# the client (phases 13 and 14): greedy generation from a CLIENT_PROMPT-token
# prompt; seeded sampling as tests/test_full_model.py samples
CLIENT_PROMPT = 300
CLIENT_NEW = 32
CLIENT_SAMPLING = dict(do_sample=True, top_k=10, temperature=0.8, seed=7)
# Qwen2.5-7B's config.json (Qwen/Qwen2.5-7B): 28 query heads over 4 kv heads
# (a GQA group of 7), q/k/v biases, untied; depth cut to QWEN_SPAN blocks,
# random weights from SEED
QWEN2_5_7B = {
    "model_type": "qwen2", "architectures": ["Qwen2ForCausalLM"],
    "hidden_size": 3584, "intermediate_size": 18944, "num_attention_heads": 28, "num_key_value_heads": 4,
    "num_hidden_layers": 28, "rms_norm_eps": 1e-6, "rope_theta": 1000000.0, "vocab_size": 152064,
    "hidden_act": "silu", "max_position_embeddings": 131072, "max_window_layers": 28, "sliding_window": 131072,
    "use_sliding_window": False, "tie_word_embeddings": False, "bos_token_id": 151643, "eos_token_id": 151643,
    "torch_dtype": "bfloat16",
}
QWEN_SPAN = 4
QWEN_NEW = 16
# phase 16: server-side generation over one port server of the 8-block cut
GEN_PROMPT = 300
GEN_NEW = 32
GEN_SAMPLING = dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.9, seed=1234)
GEN_PENALTY = 1.2
GEN_SESSIONS = 4  # concurrent generating sessions
GEN_LONG_NEW = 96  # three chunks of 32: the later two time the fast path per token
GEN_LATE_PROMPT = 450  # a prompt that arrives while the sessions generate
GEN_LANES = 8  # room for the sessions, the per-token one and the late prompt in one pool
GEN_CACHE_TOKENS = 2 * CLI_ATTN_CACHE_TOKENS  # 8 lanes of 1024 tokens in half the budget
GEN_PRIVATE_MAX_LENGTH = 2048  # past a lane's 1024 tokens: a private cache
# a token that is not the pick on the server's own logits is a tie when its
# logit lies this close to the maximum (greedy) or u this close to its CDF
# interval (sampled): float32 sums in another order, float64 on the client
GEN_TIE_LOGIT = 1e-3
GEN_TIE_CDF = 1e-4
DENSE_CHUNK_TOKENS = 512  # the dense pool's chunk bound, in tokens of activations
# the earlier phases count kernels, steps and chunks of traffic that would hit
# the prefix cache (warm-ups, repeated prompts): their servers run without it
NO_PREFIX_CACHE = ("--prefix_cache_bytes", "0")
# phase 17: the prefix cache. Sessions share a PREFIX_SHARED-token prompt (8
# segments of 128 tokens, 16 pages of 64) with tails of PREFIX_TAILS tokens;
# an exact match of it decodes PREFIX_EXACT_STEPS tokens; a session that hit
# rolls back to PREFIX_ROLLBACK and rewrites PREFIX_REWRITE tokens there.
# Lanes of PREFIX_LANE tokens (the CLI's are 1024) hold the prompt, a tail
# and the decode steps; a private session opens PREFIX_PRIVATE_MAX_LENGTH
PREFIX_SHARED = 1024
PREFIX_TAILS = (64, 37)
PREFIX_STEPS = 4
PREFIX_EXACT_STEPS = 16
PREFIX_ROLLBACK = 600
PREFIX_REWRITE = 4
PREFIX_LANE = 2048
PREFIX_PRIVATE_MAX_LENGTH = 2048
PREFIX_WARMUP = 300

# K5/K6 at the four projections of a Mistral-7B block as the port serves
# them (qkv and gate+up fused), at decode batches (1, 4, 8 and 32 rows: one
# session, the profile's 4 lanes, the 8-lane pool, a batched step at the
# decode kernel's limit) and at the chunk lengths of the main path's prefill
# (64, 188 and 512 rows). The kernels line reports gate+up at 8 and 512 rows,
# the shape its rows have always been taken at, and only there is the plain
# version timed.
QUANT_SHAPES = {"wqkv": (4096, 4096 + 2 * 1024), "wo": (4096, 4096), "wgu": (4096, 2 * 14336), "wd": (14336, 4096)}
QUANT_DECODE_ROWS = (1, 4, 8, 32)
QUANT_ROWS = QUANT_DECODE_ROWS + (64, 188, 512)
QUANT_REPORT = ("wgu", (8, 512))
QUANT_KINDS = ("nf4", "nf4a", "int4", "int8")
# kernel vs plain, as a share of the output's largest magnitude: the kernel
# rounds its float32 sum once to bf16 (2**-9 relative); a 4-bit weight of
# the decode kernel is the plain version's round(level x scale) but near a
# rounding boundary (nf4a: one weight in ~800 one bf16 ulp apart), the
# prefill kernel's nf4a cubic in float32 the same; int8's kernels scale the
# sum where the plain version rounds each scaled weight to bf16 (2**-9 per
# product) (tests/test_torch_quant.py models the decode kernel's weights)
QUANT_REL_TOL = 1e-2
# K5 nf4a at the four projections of a Qwen2.5-7B block as phase 14 serves
# them (wqkv N = 3584 + 2 * 4 * 128, gate+up N = 2 * 18944, down K = 18944),
# at its decode batches and prefill chunks; only gate+up at 8 and 300 rows
# is timed
QWEN_QUANT_SHAPES = {"wqkv": (3584, 3584 + 2 * 512), "wo": (3584, 3584), "wgu": (3584, 2 * 18944),
                     "wd": (18944, 3584)}
QWEN_QUANT_ROWS = (1, 2, 4, 8, 64, 300)
QWEN_QUANT_REPORT = ("wgu", (8, 300))
SHORT_KINDS = ("int8", "nf4", "int4", "nf4a+o")  # served at 2 blocks, one session each
# (--quant_type, --kv_quant_type) served at 2 blocks, one session each: K3's
# int8 arms, and nf4a weights with an nf4a pool (the operator's combined setting)
SHORT_KV_RUNS = (("none", "int8"), ("nf4a", "nf4a"))
SHORT_SPAN = 2
SHORT_PROMPT = 300
SHORT_STEPS = 8

PROFILE_LANES = 4
PROFILE_REPS = 20  # unprofiled calls for the median host wall
PROFILE_CALLS = 5  # calls inside the profiler
PROFILE_CHUNK = 512
# phase 15: mixed steps replayed against the eager loop, (chunk length,
# chunk lane, chunk position): buckets 8, 64 and 512 captured, then 300
# tokens padded to 512 and 5 padded to 8 replay those graphs at another
# lane, position and real length
STEP_CHUNKS = ((8, 0, 128), (64, 1, 200), (512, 2, 64), (300, 3, 600), (5, 1, 700))
# phase 15's dense programs, on a private cache of PRIVATE_BATCH rows and
# DENSE_MAX_LENGTH tokens: (tokens, position) of the private step's chunks,
# buckets 8, 64 and 512 each run eagerly and then captured by a second
# chunk of the bucket, the last (300 tokens) padded to 512 past the cache's
# end; a dense pool warmed to chunks of DENSE_WARM_CHUNK tokens
DENSE_MAX_LENGTH = 1024
DENSE_STEP_CHUNKS = ((8, 0), (5, 8), (64, 13), (40, 77), (512, 117), (300, 629))
DENSE_WARM_CHUNK = 64
STEADY_DENSE_PROGRAMS = ("_dense_decode_program", "_lane_program")  # the dense pool's, captured when it opens
DENSE_PROFILE_POSITION = 1000  # the profiled private decode step's position in its PRIVATE_MAX_LENGTH cache
# the port's kernels, by the name each has in a profile
PORT_KERNELS = ("paged_decode_kernel", "paged_prefill_wgmma_kernel", "paged_prefill_kernel", "flash_attention_kernel",
                "flash_wgmma_kernel", "quant_decode_ring_kernel", "quant_prefill_kernel", "split_reduce_kernel")
# K1 at long contexts (phase 2), Mistral-7B's window: (lanes, position of
# each, tokens of each lane's table). The last is the common state of a
# long-context server: short lanes on tables sized for --batch_max_length 8192.
LONG_DECODE = ((1, 4095, 4096), (8, 4095, 4096), (4, 1000, 8192))
# K2 and K3 prefill at long chunks (phase 2), Mistral-7B's window:
# (position of a 512-row chunk, tokens of the lane's table). The last chunk
# of a 4096-token prompt, and a chunk past the window on a table sized for
# --batch_max_length 8192. Three pages inside each visible range are holes.
LONG_PREFILL = ((3584, 4096), (4608, 8192))
PREFILL_ROWS = 512
DECODE_REPEATS = 5  # K1's split merge must give bit-equal outputs on repeats


def log(*parts) -> None:
    print(*parts, flush=True)


# ----------------------------------------------------------------- timing


class Timer:
    """Median device time of a callable over ``reps`` launches, measured
    with CUDA events; a write of 2x the L2 cache before each launch makes
    every launch read its inputs from device memory, as a step does. A
    device-side spin between the flush and the start event, longer than the
    host takes to enqueue the callable (measured in its warm-up), keeps the
    card busy while the host enqueues: the events then bracket the
    callable's kernels back to back, not the host's Python in front of
    them. A launch whose enqueue outlasted its spin (a slow host moment) is
    timed again, up to ``reps`` more times, so no sample holds host time."""

    def __init__(self, device):
        self.flush = torch.empty(100 * 2**20, dtype=torch.uint8, device=device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(1_000_000)
        end.record()
        end.synchronize()
        self.cycles_per_ms = 1_000_000 / start.elapsed_time(end)

    def __call__(self, fn, reps: int = 30, warmup: int = 3) -> float:
        host_ms = 0.0
        for _ in range(warmup):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host_ms = max(host_ms, (time.perf_counter() - t0) * 1e3)
        spin_ms = min(50.0, 2 * host_ms + 0.1)
        spin = int(self.cycles_per_ms * spin_ms)
        times = []
        for _ in range(2 * reps):
            self.flush.zero_()
            torch.cuda._sleep(spin)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            end.synchronize()
            if enqueue_ms < spin_ms:
                times.append(start.elapsed_time(end))
                if len(times) == reps:
                    break
        if not times:
            raise RuntimeError(f"every enqueue outlasted the {spin_ms:.3f} ms spin: no device time measured")
        return statistics.median(times)


def bound_ms(nbytes: int, flops: int):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the bf16 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def quant_bytes_and_flops(m: int, w):
    """What one dequant-matmul must move and compute: x read once (bf16),
    the weight bytes and scales its k loop reaches read once, the output
    written once (bf16); 2*M*in*out operations."""
    k, n = w.in_features, w.out_features
    weight = k * n + 4 * n if w.kind == "int8" else k * n // 2 + 2 * (k // 64) * n
    return 2 * m * k + weight + 2 * m * n, 2 * m * k * n


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
    """Compile every CUDA source of the port at once (one nvcc each) and
    print each one's build seconds and the compiler's register report."""
    from concurrent.futures import ThreadPoolExecutor

    from petals_tpu_torch.kernels import build as kbuild

    def one(name):
        t0 = time.perf_counter()
        path = kbuild.build(name)
        return name, path, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = list(pool.map(one, KERNEL_SOURCES))
    log(f"build: {len(built)} sources in {time.perf_counter() - t0:.1f} s")
    for name, path, seconds in built:
        log(f"build: {os.path.relpath(path, REPO)} in {seconds:.1f} s")
        for line in open(f"{path}.log").read().splitlines():
            if "registers" in line or "spill" in line or line.startswith("built in"):
                log(f"  {line.strip()}")


def attention_cases(device, hq=32, hkv=8):
    """The seeded inputs of the attention kernels at Mistral-7B widths (or
    ``hq`` query heads over ``hkv`` kv heads): K1's 8 lanes (ragged positions
    up to 1023 on permuted tables with holes past each frontier, one lane
    idle at the sentinel) and K2's lane (a 512-row chunk at 0 and its
    188-row continuation), bf16 pools."""
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    d = 128
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
    window = MISTRAL_7B["sliding_window"]
    kv_lens = [min(p + 1, max_len) for p in positions.tolist()]
    decode = {
        "q": q, "kp": kp, "vp": vp, "tables": tables.to(device), "positions": positions.to(device),
        "active": slice(0, n_lanes - 1),  # the sentinel lane's output is never read
        "rows": sum(_visible(kl - 1, kl, window) for kl in kv_lens),  # kv rows read at window 4096
    }
    max_pages2 = 1024 // PAGE
    n_pages2 = max_pages2 + 8
    perm2 = torch.randperm(n_pages2, generator=torch.Generator().manual_seed(SEED + 3))
    table_row = torch.full((max_pages2,), -1, dtype=torch.int32)
    table_row[: -(-(512 + 188) // PAGE)] = perm2[: -(-(512 + 188) // PAGE)].to(torch.int32)
    kp2 = torch.randn(n_pages2, PAGE, hkv, d, generator=gen, device=device).to(torch.bfloat16)
    vp2 = torch.randn(n_pages2, PAGE, hkv, d, generator=gen, device=device).to(torch.bfloat16)
    chunks = {pos: torch.randn(1, n, hq, d, generator=gen, device=device).to(torch.bfloat16)
              for pos, n in ((0, 512), (512, 188))}
    prefill = {"kp": kp2, "vp": vp2, "table_row": table_row.to(device), "chunks": chunks}
    return decode, prefill


def _library_decode(case, kp, vp, window):
    """The yardstick for the decode kernels: the pages gathered (and
    dequantized) into a dense view, then PyTorch's fused attention."""
    from petals_tpu_torch.ops.paged_attention import gather_pages

    q, tables, positions = case["q"], case["tables"], case["positions"]
    k = gather_pages(kp, tables).transpose(1, 2)
    v = gather_pages(vp, tables).transpose(1, 2)
    kv_pos = torch.arange(k.shape[2], device=q.device)
    pos = positions[:, None].long()
    mask = (kv_pos[None, :] <= pos) & (kv_pos[None, :] > pos - window)
    return _sdpa(q.transpose(1, 2), k, v, mask[:, None, None, :]).transpose(1, 2)


def _library_prefill(kp, vp, table_row, qc, chunk_pos, window):
    """The yardstick for the prefill kernels: the lane's pages gathered (and
    dequantized) into a dense view, then PyTorch's fused attention with a
    mask (causal, the window, the chunk's end, holes)."""
    from petals_tpu_torch.ops.paged_attention import gather_pages, slot_valid

    kv_len = chunk_pos + qc.shape[1]
    k = gather_pages(kp, table_row[None])[:, :kv_len].transpose(1, 2)
    v = gather_pages(vp, table_row[None])[:, :kv_len].transpose(1, 2)
    kv_pos = torch.arange(kv_len, device=qc.device)
    q_pos = chunk_pos + torch.arange(qc.shape[1], device=qc.device)
    mask = (kv_pos[None, :] <= q_pos[:, None]) & (kv_pos[None, :] > q_pos[:, None] - window)
    mask &= slot_valid(kp, table_row[None])[0, :kv_len][None, :]
    return _sdpa(qc.transpose(1, 2), k, v, mask).transpose(1, 2)


def _prefill_work(table_row, n_pages, chunk_pos, n, window):
    """(kv rows some query row sees, visible (query, kv) pairs) of a chunk of
    ``n`` rows at ``chunk_pos``: slots on a hole are seen by none."""
    valid = (table_row >= 0) & (table_row < n_pages)
    valid = valid.cpu().repeat_interleave(PAGE)[: chunk_pos + n].long()
    seen = torch.cumsum(torch.cat([torch.zeros(1, dtype=torch.long), valid]), 0)  # seen[i] = valid slots < i
    q_pos = chunk_pos + torch.arange(n)
    lo = (q_pos - window + 1).clamp_min(0)
    pairs = int((seen[q_pos + 1] - seen[lo]).sum())
    return int(seen[-1] - seen[int(lo[0])]), pairs


def check_attention_kernels(device, timer, dec, pf, kind="none", long=True):
    """The decode and prefill kernels at one pool storage, against their
    plain versions: K1/K2 on the cases' bf16 pools, or K3's ``kind`` arms on
    pools quantized on the card from them; ``long`` adds the long contexts
    and chunks. Returns the two report entries (without main-path launch
    counts)."""
    from petals_tpu_torch.ops import paged_flash_attention as pfa
    from petals_tpu_torch.ops.paged_attention import (
        PagedPool,
        kv_wire_bytes_per_token,
        paged_attend,
        paged_prefill_attend,
        quantize_kv_rows,
    )

    hq, hkv, d = dec["q"].shape[2], dec["kp"].shape[2], dec["kp"].shape[3]
    window = MISTRAL_7B["sliding_window"]
    if kind == "none":
        kp, vp, kp2, vp2 = dec["kp"], dec["vp"], pf["kp"], pf["vp"]
        plain_pool = lambda pool: pool.float()  # noqa: E731  (the plain version in float32)
        label, names, where = "", ("K1", "K2"), ("220", "488")
    else:
        kp, vp, kp2, vp2 = (PagedPool(*quantize_kv_rows(p, kind)) for p in (dec["kp"], dec["vp"], pf["kp"], pf["vp"]))
        plain_pool = lambda pool: pool  # noqa: E731  (a PagedPool: the plain version decodes it)
        label, names, where = f"[kv_{kind}]", (f"K3 {kind} decode", f"K3 {kind} prefill"), ("150", "150")
    if hq // hkv != 4:  # not Mistral-7B's group
        names = tuple(f"{name} at group {hq // hkv}" for name in names)
    side_bytes = kv_wire_bytes_per_token(hkv, d, kind)  # one token row of k (or v) of one block

    # ---- decode
    q, tables, positions, active = dec["q"], dec["tables"], dec["positions"], dec["active"]
    dec_err = 0.0
    for w in (None, 4096, 200):
        got = pfa.paged_flash_attend(q, kp, vp, tables, positions, sliding_window=w)
        torch.cuda.synchronize()
        want = paged_attend(q.float(), plain_pool(kp), plain_pool(vp), tables, positions, sliding_window=w)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{names[0]} window={w}: non-finite output")
        if kind == "none":
            err = check_lanes(f"{names[0]}, window={w}", got[active], want[active])
        else:
            err = (got[active].float() - want[active]).abs().max().item()
            log(f"{names[0]}, window={w}: max abs err {err:.3e} (tol {KERNEL_TOL})")
            if err > KERNEL_TOL:
                raise AssertionError(f"{names[0]} disagrees with its plain version: {err} > {KERNEL_TOL}")
        dec_err = max(dec_err, err)
    rows = dec["rows"]
    dec_bytes = 2 * rows * side_bytes + 2 * q.numel() * 2 + tables.numel() * 4 + positions.numel() * 4
    dec_bound, dec_by = bound_ms(dec_bytes, 4 * hq * d * rows)
    lib_err = (_library_decode(dec, kp, vp, window)[active].float() - paged_attend(
        q.float(), plain_pool(kp), plain_pool(vp), tables, positions, sliding_window=window)[active]).abs().max().item()
    decode = {
        "name": f"paged_decode_attention{label}", "route": "cuda",
        "source": "petals_tpu_torch/csrc/paged_attention.cu",
        "replaces": f"petals_tpu/ops/paged_flash_attention.py:{where[0]}",
        "max_abs_err": dec_err,
        "ms": timer(lambda: pfa.paged_flash_attend(q, kp, vp, tables, positions, sliding_window=window)),
        "plain_ms": timer(lambda: paged_attend(q, kp, vp, tables, positions, sliding_window=window)),
        "bound_ms": dec_bound, "bound_by": dec_by,
        "library_ms": timer(lambda: _library_decode(dec, kp, vp, window)),
    }
    decode["library_factor"] = decode["ms"] / decode["library_ms"]
    log(f"{names[0]} at 8 lanes, window 4096: {decode['ms']:.4f} ms kernel, {decode['plain_ms']:.4f} ms plain, "
        f"{decode['library_ms']:.4f} ms gather+SDPA (its err {lib_err:.3e}; kernel {decode['library_factor']:.3f}x), "
        f"bound {dec_bound:.4f} ms ({dec_by}, {dec_bytes / 1e6:.2f} MB), "
        f"{pfa.decode_split_plan(q.shape[0], hkv, tables.shape[1] * PAGE, _sm_count(device))} splits")
    # the split merge is deterministic: the same bits whichever block merges
    first = pfa.paged_flash_attend(q, kp, vp, tables, positions, sliding_window=window)
    for _ in range(DECODE_REPEATS):
        if not torch.equal(pfa.paged_flash_attend(q, kp, vp, tables, positions, sliding_window=window), first):
            raise AssertionError(f"{names[0]}: the split merge is not bit-equal on repeats")
    log(f"{names[0]}: bit-equal over {DECODE_REPEATS} repeats")
    if kind == "none" and long:
        decode["long_context"] = [check_long_decode(device, timer, *case) for case in LONG_DECODE]

    # ---- prefill: a 512-row chunk at 0, then its 188-row continuation at
    # 512, held row by row
    table_row = pf["table_row"]
    rel_tol = ROW_REL_TOL if kind == "none" else KV_ROW_REL_TOL
    pf_err = 0.0
    for chunk_pos, qc in pf["chunks"].items():
        n = qc.shape[1]
        # chunk_pos and n_valid as the served step passes them: on the card
        cp, nv = pfa.chunk_scalars(chunk_pos, n, device)
        got = pfa.paged_flash_prefill_attend(qc, kp2, vp2, table_row, cp, nv, sliding_window=window)
        torch.cuda.synchronize()
        want = paged_prefill_attend(
            qc.float(), plain_pool(kp2), plain_pool(vp2), table_row, chunk_pos, n, sliding_window=window
        )
        pf_err = max(pf_err, check_rows(f"{names[1]}, chunk_pos={chunk_pos}, {n} rows", got, want, rel_tol))
    qc, qc2 = pf["chunks"][0], pf["chunks"][512]
    n = qc.shape[1]
    at0, at512 = pfa.chunk_scalars(0, n, device), pfa.chunk_scalars(512, 188, device)
    seen, pairs = _prefill_work(table_row, kp2.shape[0], 0, n, window)
    pf_bytes = 2 * seen * side_bytes + 2 * qc.numel() * 2 + table_row.numel() * 4
    pf_bound, pf_by = bound_ms(pf_bytes, 4 * hq * d * pairs)
    prefill = {
        "name": f"paged_prefill_attention{label}", "route": "cuda",
        "source": "petals_tpu_torch/csrc/paged_attention.cu",
        "replaces": f"petals_tpu/ops/paged_flash_attention.py:{where[1]}",
        "max_abs_err": pf_err,
        "ms": timer(lambda: pfa.paged_flash_prefill_attend(qc, kp2, vp2, table_row, *at0, sliding_window=window)),
        "plain_ms": timer(lambda: paged_prefill_attend(qc, kp2, vp2, table_row, 0, n, sliding_window=window)),
        "bound_ms": pf_bound, "bound_by": pf_by,
        "library_ms": timer(lambda: _library_prefill(kp2, vp2, table_row, qc, 0, window)),
    }
    prefill["library_factor"] = prefill["ms"] / prefill["library_ms"]
    cont_ms = timer(lambda: pfa.paged_flash_prefill_attend(qc2, kp2, vp2, table_row, *at512, sliding_window=window))
    cont_lib_ms = timer(lambda: _library_prefill(kp2, vp2, table_row, qc2, 512, window))
    log(f"{names[1]} at a 512-row chunk: {prefill['ms']:.4f} ms kernel, {prefill['plain_ms']:.4f} ms plain, "
        f"{prefill['library_ms']:.4f} ms gather+SDPA (kernel {prefill['library_factor']:.3f}x), "
        f"bound {pf_bound:.4f} ms ({pf_by}); 188-row continuation at 512: {cont_ms:.4f} ms kernel, "
        f"{cont_lib_ms:.4f} ms gather+SDPA")
    prefill["continuation"] = {"ms": cont_ms, "library_ms": cont_lib_ms}
    if long:
        prefill["long_chunks"] = [check_long_prefill(device, timer, kind, *case) for case in LONG_PREFILL]
    return [decode, prefill]


def check_lanes(label, got, want) -> float:
    """K1's output on a bf16 pool against its plain version (float32), lane
    by lane: each lane's max abs error within OUT_REL_TOL of its largest
    output magnitude; returns the max abs error."""
    return _check_relative(label, got.flatten(1), want.flatten(1), OUT_REL_TOL, "lane")


def check_rows(label, got, want, rel_tol) -> float:
    """K2 / K3 prefill (bf16) against its plain version (float32), query row
    by query row (position, head): each row's max abs error within
    ``rel_tol`` of its largest output magnitude (a row that sees nothing must
    be exact zeros); returns the max abs error."""
    return _check_relative(label, got, want, rel_tol, "row")


def _check_relative(label, got, want, rel_tol, unit) -> float:
    """Each ``unit`` (a slice along the last dim) of ``got`` within
    ``rel_tol`` of that unit's largest |want|, in max abs error."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite output")
    err = (got.float() - want).abs().amax(dim=-1)
    limit = rel_tol * want.abs().amax(dim=-1)
    worst = (err / limit.clamp_min(1e-30)).max().item()
    log(f"{label}: max abs err {err.max().item():.3e}, at most {worst:.3f} of its {unit}'s limit "
        f"({rel_tol} x the {unit}'s max |output|)")
    if (err > limit).any():
        raise AssertionError(f"{label} disagrees with its plain version: {worst:.3f} x its {unit}'s limit")
    return err.max().item()


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def long_prefill_case(device, chunk_pos, table_tokens):
    """A PREFILL_ROWS-row chunk at ``chunk_pos`` of one lane at Mistral-7B
    widths, bf16: its permuted table of ``table_tokens`` tokens holds pages
    up to the chunk's end, three of them inside the visible range holes (a
    hole anywhere is seen by no query)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 20 + chunk_pos // PAGE)
    hq, hkv, d = 32, 8, 128
    used = -(-(chunk_pos + PREFILL_ROWS) // PAGE)
    n_pages = used + 4
    table_row = torch.full((table_tokens // PAGE,), -1, dtype=torch.int32)
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(SEED + 21))
    table_row[:used] = perm[:used].to(torch.int32)
    table_row[[used // 5, used // 2, used - 12]] = -1
    kp, vp = (torch.randn(n_pages, PAGE, hkv, d, generator=gen, device=device).to(torch.bfloat16) for _ in range(2))
    q = torch.randn(1, PREFILL_ROWS, hq, d, generator=gen, device=device).to(torch.bfloat16)
    return q, kp, vp, table_row.to(device)


def check_long_prefill(device, timer, kind, chunk_pos, table_tokens):
    """K2 (``kind`` "none") or K3's prefill arm of ``kind`` at a long chunk
    (long_prefill_case; window 4096) against its plain version, row by row,
    timed beside gather + SDPA and the bound."""
    from petals_tpu_torch.ops import paged_flash_attention as pfa
    from petals_tpu_torch.ops.paged_attention import (
        PagedPool,
        kv_wire_bytes_per_token,
        paged_prefill_attend,
        quantize_kv_rows,
    )

    q, kp, vp, table_row = long_prefill_case(device, chunk_pos, table_tokens)
    if kind != "none":
        kp, vp = (PagedPool(*quantize_kv_rows(p, kind)) for p in (kp, vp))
    window = MISTRAL_7B["sliding_window"]
    hq, d, n = q.shape[2], q.shape[3], q.shape[1]
    name = "K2" if kind == "none" else f"K3 {kind} prefill"
    label = f"{name} at {n} rows x position {chunk_pos}, tables of {table_tokens}"
    scalars = pfa.chunk_scalars(chunk_pos, n, device)  # on the card, as the served step passes them
    got = pfa.paged_flash_prefill_attend(q, kp, vp, table_row, *scalars, sliding_window=window)
    torch.cuda.synchronize()
    plain = (kp.float(), vp.float()) if kind == "none" else (kp, vp)
    want = paged_prefill_attend(q.float(), *plain, table_row, chunk_pos, n, sliding_window=window)
    err = check_rows(label, got, want, ROW_REL_TOL if kind == "none" else KV_ROW_REL_TOL)
    lib_err = (_library_prefill(kp, vp, table_row, q, chunk_pos, window).float() - want).abs().max().item()
    del want, plain
    seen, pairs = _prefill_work(table_row, kp.shape[0], chunk_pos, n, window)
    nbytes = 2 * seen * kv_wire_bytes_per_token(kp.shape[2], d, kind) + 2 * q.numel() * 2 + table_row.numel() * 4
    bound, by = bound_ms(nbytes, 4 * hq * d * pairs)
    entry = {
        "position": chunk_pos, "rows": n, "table_tokens": table_tokens, "max_abs_err": err,
        "ms": timer(lambda: pfa.paged_flash_prefill_attend(q, kp, vp, table_row, *scalars, sliding_window=window)),
        "library_ms": timer(lambda: _library_prefill(kp, vp, table_row, q, chunk_pos, window)),
        "bound_ms": bound, "bound_by": by,
    }
    entry["library_factor"] = entry["ms"] / entry["library_ms"]
    log(f"{label}: {entry['ms']:.4f} ms kernel, {entry['library_ms']:.4f} ms gather+SDPA (its err {lib_err:.3e}; "
        f"kernel {entry['library_factor']:.3f}x), bound {bound:.4f} ms ({by}, {nbytes / 1e6:.1f} MB, "
        f"{4 * hq * d * pairs / 1e9:.1f} GFLOP)")
    if entry["ms"] >= entry["library_ms"]:
        log(f"{label}: NOT faster than gather+SDPA")
    return entry


def check_long_decode(device, timer, n_lanes, position, table_tokens):
    """K1 at a long context: ``n_lanes`` lanes at ``position`` on permuted
    tables of ``table_tokens`` tokens (bf16 pools at Mistral-7B widths,
    window 4096), against its plain version and timed beside gather + SDPA
    and the bound."""
    from petals_tpu_torch.ops import paged_flash_attention as pfa
    from petals_tpu_torch.ops.paged_attention import paged_attend

    gen = torch.Generator(device=device).manual_seed(SEED + 10 + n_lanes)
    hq, hkv, d, max_pages = 32, 8, 128, table_tokens // PAGE
    window = MISTRAL_7B["sliding_window"]
    n_pages = n_lanes * max_pages
    tables = torch.randperm(n_pages, generator=torch.Generator().manual_seed(SEED + 11)).to(torch.int32)
    tables = tables.reshape(n_lanes, max_pages).to(device)
    positions = torch.full((n_lanes,), position, dtype=torch.int32, device=device)
    kp, vp = (torch.randn(n_pages, PAGE, hkv, d, generator=gen, device=device).to(torch.bfloat16) for _ in range(2))
    q = torch.randn(n_lanes, 1, hq, d, generator=gen, device=device).to(torch.bfloat16)
    case = {"q": q, "tables": tables, "positions": positions}
    got = pfa.paged_flash_attend(q, kp, vp, tables, positions, sliding_window=window)
    torch.cuda.synchronize()
    want = paged_attend(q.float(), kp.float(), vp.float(), tables, positions, sliding_window=window)
    err = check_lanes(f"K1 at {n_lanes} lane(s) x position {position}, tables of {table_tokens}", got, want)
    del want
    rows = n_lanes * _visible(position, position + 1, window)
    nbytes = 2 * rows * hkv * d * 2 + 2 * q.numel() * 2 + tables.numel() * 4 + positions.numel() * 4
    bound, by = bound_ms(nbytes, 4 * hq * d * rows)
    entry = {
        "lanes": n_lanes, "position": position, "table_tokens": table_tokens, "max_abs_err": err,
        "ms": timer(lambda: pfa.paged_flash_attend(q, kp, vp, tables, positions, sliding_window=window)),
        "library_ms": timer(lambda: _library_decode(case, kp, vp, window)), "bound_ms": bound, "bound_by": by,
        "splits": pfa.decode_split_plan(n_lanes, hkv, min(table_tokens, window), _sm_count(device)),
    }
    entry["library_factor"] = entry["ms"] / entry["library_ms"]
    log(f"K1 at {n_lanes} lane(s) x position {position}, tables of {table_tokens}: {entry['ms']:.4f} ms kernel, "
        f"{entry['library_ms']:.4f} ms gather+SDPA ({entry['library_factor']:.3f}x), bound {bound:.4f} ms "
        f"({by}, {nbytes / 1e6:.1f} MB), {entry['splits']} splits")
    if entry["ms"] >= entry["library_ms"]:
        log(f"K1 at {n_lanes} lane(s) x position {position}: NOT faster than gather+SDPA")
    return entry


def check_quant_kernels(device, timer, shapes=QUANT_SHAPES, rows=QUANT_ROWS, kinds=QUANT_KINDS,
                        report_at=QUANT_REPORT, time_all=True, model="Mistral-7B"):
    """K5 (nf4, nf4a, int4) and K6 (int8) against the plain version at the
    four projections of a ``model`` block (``shapes``) and ``rows`` rows,
    the decode kernel's output also bit-equal over two more calls; each
    case timed beside the dense bf16 product and the bound (only
    ``report_at``'s with ``time_all`` False); returns one report entry per
    kernel and arm (decode and prefill) at ``report_at``'s shape (without
    main-path launch counts)."""
    from petals_tpu_torch.ops import quant_matmul as qmm
    from petals_tpu_torch.ops.quant import dequant_matmul_reference, dequantize, quantize

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    entries, table = {}, []
    for shape_name, (k, n) in shapes.items():
        dense = (torch.randn(k, n, generator=gen, device=device) * 0.02).to(torch.bfloat16)
        xs = {m: torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16) for m in rows}
        # the yardstick: the dense bf16 product the quantized kernel replaces
        library = {m: timer(lambda m=m: torch.matmul(xs[m], dense)) for m in rows
                   if time_all or (shape_name == report_at[0] and m in report_at[1])}
        for kind in kinds:
            w = quantize(dense, kind)
            deq = dequantize(w, torch.bfloat16).float()
            for m in rows:
                x, decode = xs[m], m <= 32
                fn = qmm.quant_decode_matmul if decode else qmm.quant_prefill_matmul
                got = fn(x, w)
                torch.cuda.synchronize()
                want = x.float() @ deq
                if got.shape != want.shape or not torch.isfinite(got).all():
                    raise AssertionError(f"{kind} {shape_name} M={m}: output {tuple(got.shape)} or non-finite")
                err = (got.float() - want).abs().max().item()
                scale = want.abs().max().item()
                label = (f"{model} {'K6' if kind == 'int8' else 'K5'} {'decode' if decode else 'prefill'} {kind} "
                         f"{shape_name} {k}x{n} M={m}")
                if err > QUANT_REL_TOL * scale:
                    raise AssertionError(f"{label}: disagrees with its plain version: {err} > {QUANT_REL_TOL} * {scale}")
                if decode and not all(torch.equal(fn(x, w), got) for _ in range(2)):
                    raise AssertionError(f"{label}: the decode kernel's output differs between calls")
                name = f"quant_{'decode' if decode else 'prefill'}_matmul[{kind}]"
                entry = entries.setdefault(name, {
                    "name": name, "route": "cuda", "source": "petals_tpu_torch/csrc/quant_matmul.cu",
                    "replaces": "petals_tpu/ops/quant.py:" + (
                        "1030" if kind == "int8" else "781" if decode else "720"),
                    "max_abs_err": 0.0,
                })
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                report = shape_name == report_at[0] and m in report_at[1]
                if not (time_all or report):
                    log(f"{label}: max abs err {err:.3e}, rel {err / scale:.3e} (tol {QUANT_REL_TOL})"
                        + ("; bit-equal on two repeats" if decode else ""))
                    continue
                ms = timer(lambda: fn(x, w))
                plain_ms = timer(lambda: dequant_matmul_reference(x, w)) if report else None
                nbytes, flops = quant_bytes_and_flops(m, w)
                bound, by = bound_ms(nbytes, flops)
                plan = " plan {}".format(tuple(qmm.decode_plan(m, k, n, n_sm, kind) if decode
                                               else qmm.prefill_plan(m, k, n, n_sm)))
                log(f"{label}: max abs err {err:.3e}, rel {err / scale:.3e} (tol {QUANT_REL_TOL}); "
                    f"{ms:.4f} ms kernel, " + (f"{plain_ms:.4f} ms plain, " if report else "")
                    + f"{library[m]:.4f} ms dense bf16 matmul ({ms / library[m]:.2f}x), "
                    f"bound {bound:.4f} ms ({by}, {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP){plan}")
                table.append((kind, shape_name, m, ms, library[m], bound))
                if report:
                    entry.update(shape=f"{shape_name} [{k}, {n}], M={m}", ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound, bound_by=by, library_ms=library[m],
                                 library_factor=ms / library[m])
            del w, deq
        del dense, xs
    log(f"{model} dequant-matmul times, ms (kernel / dense bf16 matmul / bound):")
    for kind in kinds:
        log(f"  {kind}: " + "; ".join(f"{s} M={m} {ms:.4f}/{lib:.4f}/{b:.4f}"
                                      for kd, s, m, ms, lib, b in table if kd == kind))
    slower = [f"{s} M={m}" for kd, s, m, ms, lib, _ in table if kd == "nf4a" and m <= 32 and ms >= lib]
    if "nf4a" in kinds and time_all:
        log("K5 decode nf4a against the dense bf16 matmul: " + (
            f"NOT faster at {', '.join(slower)}" if slower else "faster at every decode shape"))
    return list(entries.values())


def _visible_pairs(q_len, q_offset, kv_length, window) -> int:
    return sum(_visible(q_offset + i, kv_length, window) for i in range(q_len))


def check_flash_kernel(device, timer):
    """K4 against its plain version at Mistral-7B widths, bf16, on strided
    views of a span-stacked cache; returns its report entry (without the
    main-path launch count), timed at the 512-row chunk."""
    from petals_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    hq, hkv, d, buf = 32, 8, 128, 2048
    window = MISTRAL_7B["sliding_window"]
    k_stack, v_stack = (torch.randn(2, 2, buf, hkv, d, generator=gen, device=device).to(torch.bfloat16) for _ in range(2))
    cases = {
        # name: (batch, q_len, q_offset, window, buffer rows)
        "a: 512 rows at 0": (1, 512, 0, window, buf),
        "b: 188 rows at 512": (1, 188, 512, window, buf),
        "c: batch 2, 700 rows, window 200": (2, 700, 0, 200, buf),
        "d: batch 2, 333 rows at 100, buffer of 1000": (2, 333, 100, window, 1000),
    }
    worst, timed = 0.0, {}
    for name, (batch, q_len, q_offset, w, rows) in cases.items():
        q = torch.randn(batch, q_len, hq, d, generator=gen, device=device).to(torch.bfloat16)
        # block 1 of the stacked cache, its last `batch` rows, the first `rows` positions: views
        k, v = (stack[1, 2 - batch :, :rows] for stack in (k_stack, v_stack))
        if rows != buf and k.is_contiguous():
            raise AssertionError("the sliced buffer was meant to be a strided view")
        kv_length = q_offset + q_len
        kw = dict(q_offset=q_offset, kv_length=kv_length, sliding_window=w)
        # as the served step passes them: position and length as int32s on the card
        scalars = torch.tensor([q_offset, kv_length], dtype=torch.int32, device=device)
        kw_dev = dict(q_offset=scalars[0], kv_length=scalars[1], sliding_window=w)
        before = fa.flash_attend.launches
        got = fa.flash_attend(q, k, v, **kw_dev)
        torch.cuda.synchronize()
        if fa.flash_attend.launches != before + 1:
            raise AssertionError("K4's wrapper did not count its launch")
        if not torch.equal(got, fa.flash_attend(q, k, v, **kw)):
            raise AssertionError(f"K4 {name}: host-integer and device-held positions give other bytes")
        want = fa.flash_attend_reference(q.float(), k, v, **kw)
        if got.shape != q.shape or not torch.isfinite(got).all():
            raise AssertionError(f"K4 {name}: output {tuple(got.shape)} or non-finite")
        err = (got.float() - want).abs().max().item()
        # float32 keeps the CUDA-core kernel: the same views in float32
        q32, k32, v32 = q.float(), k.float(), v.float()
        got32 = fa.flash_attend(q32, k32, v32, **kw_dev)
        torch.cuda.synchronize()
        err32 = (got32 - fa.flash_attend_reference(q32, k32, v32, **kw)).abs().max().item()
        del q32, k32, v32, got32
        log(f"K4 {name}: max abs err {err:.3e} bf16 (wgmma, tol {KERNEL_TOL}), "
            f"{err32:.3e} float32 (CUDA cores, tol {F32_KERNEL_TOL})")
        if err > KERNEL_TOL or err32 > F32_KERNEL_TOL:
            raise AssertionError(f"K4 {name} disagrees with its plain version: bf16 {err} > {KERNEL_TOL} "
                                 f"or float32 {err32} > {F32_KERNEL_TOL}")
        worst = max(worst, err)

        def library(q=q, k=k, v=v, q_offset=q_offset, kv_length=kv_length, w=w):
            kv_pos = torch.arange(kv_length, device=device)
            q_pos = q_offset + torch.arange(q.shape[1], device=device)
            mask = (kv_pos[None, :] <= q_pos[:, None]) & (kv_pos[None, :] > q_pos[:, None] - w)
            return _sdpa(q.transpose(1, 2), k[:, :kv_length].transpose(1, 2), v[:, :kv_length].transpose(1, 2), mask)

        lib_err = (library().transpose(1, 2).float() - want).abs().max().item()
        first_seen = max(0, q_offset - w + 1)  # the first kv row any query row sees
        nbytes = 2 * q.numel() * 2 + 2 * batch * (kv_length - first_seen) * hkv * d * 2
        bound, by = bound_ms(nbytes, 4 * batch * hq * d * _visible_pairs(q_len, q_offset, kv_length, w))
        timed[name] = {
            "ms": timer(lambda: fa.flash_attend(q, k, v, **kw_dev)),
            "plain_ms": timer(lambda: fa.flash_attend_reference(q, k, v, **kw)),
            "library_ms": timer(library), "bound_ms": bound, "bound_by": by,
        }
        t = timed[name]
        t["library_factor"] = t["ms"] / t["library_ms"]
        log(f"K4 {name}: {t['ms']:.4f} ms kernel, {t['plain_ms']:.4f} ms plain, {t['library_ms']:.4f} ms SDPA with a "
            f"mask (its err {lib_err:.3e}; kernel {t['library_factor']:.3f}x), bound {bound:.4f} ms ({by}, "
            f"{nbytes / 1e6:.2f} MB)")
        if t["ms"] >= t["library_ms"]:
            log(f"K4 {name}: NOT faster than SDPA with a mask")
    return {
        "name": "flash_attention", "route": "cuda", "source": "petals_tpu_torch/csrc/flash_attention.cu",
        "replaces": "petals_tpu/ops/flash_attention.py:104", "max_abs_err": worst,
        "shape": "q [1, 512, 32, 128] at offset 0, cache view [1, 2048, 8, 128]", **timed["a: 512 rows at 0"],
        "cases": {name: {k: t[k] for k in ("ms", "library_ms", "bound_ms", "library_factor")} for name, t in timed.items()},
    }


def write_checkpoint(path: str, device, cfg=None, n_blocks: int = SPAN) -> None:
    """A checkpoint of ``n_blocks`` blocks at ``cfg``'s widths (default
    MISTRAL_7B), one safetensors shard per block plus one of the client's
    tensors (model.embed_tokens, model.norm, lm_head) and the index; random
    bf16 weights from SEED (HF layout [out, in], std 0.02 as HF initializes,
    norms at 1; a qwen2 config's q/k/v biases std 0.1, where zeros would
    hide a missing bias). The blocks are drawn first, so they do not depend
    on the client's tensors."""
    from petals_tpu_torch.utils.safetensors_io import save_file

    cfg = cfg or MISTRAL_7B
    h, m, hq, hkv = (cfg[k] for k in ("hidden_size", "intermediate_size", "num_attention_heads",
                                      "num_key_value_heads"))
    d = cfg.get("head_dim") or h // hq
    shapes = {
        "self_attn.q_proj.weight": (hq * d, h), "self_attn.k_proj.weight": (hkv * d, h),
        "self_attn.v_proj.weight": (hkv * d, h), "self_attn.o_proj.weight": (h, hq * d),
        "mlp.gate_proj.weight": (m, h), "mlp.up_proj.weight": (m, h), "mlp.down_proj.weight": (h, m),
    }
    biases = {"self_attn.q_proj.bias": hq * d, "self_attn.k_proj.bias": hkv * d, "self_attn.v_proj.bias": hkv * d}
    gen = torch.Generator(device=device).manual_seed(SEED)
    weight_map = {}

    def save(fname, tensors):
        save_file(tensors, os.path.join(path, fname), metadata={"format": "pt"})
        weight_map.update({name: fname for name in tensors})

    for i in range(n_blocks):
        tensors = {
            f"model.layers.{i}.{name}": (torch.randn(shape, generator=gen, device=device) * 0.02).to(torch.bfloat16)
            for name, shape in shapes.items()
        }
        if cfg["model_type"] == "qwen2":
            tensors.update({
                f"model.layers.{i}.{name}": (torch.randn(n, generator=gen, device=device) * 0.1).to(torch.bfloat16)
                for name, n in biases.items()
            })
        for norm in ("input_layernorm.weight", "post_attention_layernorm.weight"):
            tensors[f"model.layers.{i}.{norm}"] = torch.ones(h, dtype=torch.bfloat16)
        save(f"model-{i + 1:05d}-of-{n_blocks:05d}.safetensors", tensors)
    vocab = cfg["vocab_size"]
    client = {name: (torch.randn(vocab, h, generator=gen, device=device) * 0.02).to(torch.bfloat16)
              for name in ("model.embed_tokens.weight", "lm_head.weight")}
    client["model.norm.weight"] = torch.ones(h, dtype=torch.bfloat16)
    save("model-client.safetensors", client)
    del client
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)


def cut_checkpoint(src: str, dst: str, n_layers: int) -> str:
    """A sibling of checkpoint ``src`` whose config says ``n_layers`` layers
    (the depth cut, so a client's model is every block that is served): the
    same index, its shards linked, not copied."""
    os.makedirs(dst)
    for name in os.listdir(src):
        if name.endswith(".safetensors"):
            os.symlink(os.path.join(src, name), os.path.join(dst, name))
    with open(os.path.join(src, "model.safetensors.index.json")) as f:
        index = f.read()
    with open(os.path.join(dst, "model.safetensors.index.json"), "w") as f:
        f.write(index)
    with open(os.path.join(src, "config.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(dict(cfg, num_hidden_layers=n_layers), f)
    return dst


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
    uids = CHAIN_DELIMITER.join(make_uid(server.dht_prefix, i) for i in range(server.num_blocks))
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


def _pool_rows(pool, pages, n):
    """Rows [n_blocks, n, hkv, d] of the pages ``pages`` of a span pool; a
    quantized pool's codes and scales are read and decoded to float32."""
    from petals_tpu_torch.ops.paged_attention import PagedPool, dequantize_kv

    if isinstance(pool, PagedPool):
        codes, scales = (t[:, pages].flatten(1, 2)[:, :n] for t in pool)
        return dequantize_kv(codes, scales, pool.kind, torch.float32)
    return pool[:, pages].flatten(1, 2)[:, :n].clone()


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
        pages = torch.as_tensor(tables[by_pages[used], :used], dtype=torch.long, device=batcher.backend.device)
        rows.append(tuple(_pool_rows(pool, pages, n) for pool in (k_pool, v_pool)))
    return rows


@contextlib.contextmanager
def quantized_kv_writes(family, kind, written):
    """While active, the block's KV write stores each new row as the
    quantized pool would hold it (encoded with ``kind``, decoded back to the
    cache's dtype), after appending the row as computed to ``written``."""
    from petals_tpu_torch.ops.paged_attention import dequantize_kv, quantize_kv_rows

    module = sys.modules[family.block_apply.__module__]
    original = module.update_kv_cache

    def write(kv, k_new, v_new, position, n_valid=None):
        written.append((k_new, v_new))
        k_new, v_new = (dequantize_kv(*quantize_kv_rows(x, kind), kind, x.dtype) for x in (k_new, v_new))
        return original(kv, k_new, v_new, position, n_valid)

    module.update_kv_cache = write
    try:
        yield
    finally:
        module.update_kv_cache = original


@torch.no_grad()
def reference_session(block_params, family, cfg, prompt, steps, device, dtype, kv_quant="none", hypo_ids=None):
    """One session alone through the port's block functions over a dense
    cache [batch, length, hkv, d] per block, with plain attention, in
    ``dtype``; with a ``kv_quant`` kind, each row enters the cache as the
    quantized pool would hold it. ``hypo_ids`` (one entry per step, None or
    a [batch] lane order) reorders the caches' lanes before the step, as a
    server does for beam search. Returns the replies and the K/V rows as
    computed (before any quantization), (k, v) of [n_blocks * batch, length,
    hkv, d]."""
    length = prompt.shape[1] + sum(x.shape[1] for x in steps)
    shape = (prompt.shape[0], length, cfg.num_key_value_heads, cfg.head_dim)
    caches = [
        (torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device))
        for _ in block_params
    ]
    written = []
    outs, position = [], 0
    with quantized_kv_writes(family, kv_quant, written) if kv_quant != "none" else contextlib.nullcontext():
        for i, x in enumerate([prompt] + steps):
            if hypo_ids is not None and hypo_ids[i] is not None:
                order = torch.as_tensor(hypo_ids[i], dtype=torch.long, device=device)
                caches = [(k[order], v[order]) for k, v in caches]
            h = x.to(device, dtype)
            for params, kv in zip(block_params, caches):
                h, _ = family.block_apply(params, h, kv, position, cfg)
            position += x.shape[1]
            outs.append(h.float().cpu())
    if kv_quant == "none":
        k, v = (torch.cat([kv[j] for kv in caches]) for j in (0, 1))
    else:  # written holds (k, v) of each step, block by block
        n = len(block_params)
        k, v = (torch.cat([torch.cat([w[j] for w in written[b::n]], dim=1) for b in range(n)]) for j in (0, 1))
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


def _quant_row_error(got, want, want_f32, kind) -> float:
    """Worst, over cached rows, of the decoded row's error from the
    reference's row as computed (before quantization), over what it may be:
    RT_BOUND[kind] of the row's absmax (per kv head, as the pool quantizes)
    plus REPLY_NOISE_FACTOR times that row's bf16 error from float32."""
    got, want, want_f32 = got.float(), want.float(), want_f32.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"KV rows of shape {tuple(got.shape)} (want {tuple(want.shape)}) or non-finite")
    absmax = want.abs().amax(dim=-1, keepdim=True)
    noise = (want - want_f32).abs().amax(dim=(-2, -1), keepdim=True)
    allowed = (RT_BOUND[kind] * absmax + REPLY_NOISE_FACTOR * noise).clamp_min(1e-30)
    return ((got - want).abs() / allowed).max().item()


def check_session(got, kv, ref_bf16, ref_f32, label, kv_quant="none"):
    """The server's replies and written K/V rows against the dense bf16
    reference. Tolerance: they may differ from it by at most
    REPLY_NOISE_FACTOR times the bf16 reference's own rounding error,
    measured against the same network evaluated in float32 on the same
    inputs. Two bf16 evaluations with independent rounding differ by up to
    twice their error from float32. A quantized pool's rows are decoded and
    may also differ by one quantization (_quant_row_error). ``kv`` None
    checks the replies only. Returns the list of what failed."""
    (out_bf16, kv_bf16), (out_f32, kv_f32) = ref_bf16, ref_f32
    srv_ref = _rel_errors(got, out_bf16)
    noise = _rel_errors(out_bf16, out_f32)
    srv_f32 = _rel_errors(got, out_f32)
    log(f"{label}: vs dense bf16 reference max-rel {srv_ref[0]:.3e} mean-rel {srv_ref[1]:.3e}; "
        f"bf16 reference vs float32 max-rel {noise[0]:.3e} mean-rel {noise[1]:.3e}; "
        f"server vs float32 max-rel {srv_f32[0]:.3e} mean-rel {srv_f32[1]:.3e}")
    failed = []
    if noise[1] > (REPLY_BF16_MEAN_REL if kv_quant == "none" else REPLY_KV_QUANT_MEAN_REL):
        failed.append(f"{label}: the network itself is unstable in bf16 ({noise[1]:.3e})")
    if srv_ref[0] > REPLY_NOISE_FACTOR * noise[0] or srv_ref[1] > REPLY_NOISE_FACTOR * noise[1]:
        failed.append(f"{label}: replies disagree with the dense reference beyond bf16 rounding")
    for name, srv, want, want_f32 in zip("KV", kv or (), kv_bf16, kv_f32):
        if kv_quant != "none":
            ratio = _quant_row_error(srv, want, want_f32, kv_quant)
            log(f"{label}: written {name} rows, decoded, vs the bf16 reference's rows as computed: worst "
                f"error {ratio:.3f} of (RT_BOUND[{kv_quant}] x absmax + {REPLY_NOISE_FACTOR:g} x row noise)")
            if ratio > 1:
                failed.append(f"{label}: written {name} rows are off beyond one {kv_quant} quantization")
            continue
        err, row_noise = _row_rel_error(srv, want), _row_rel_error(want, want_f32)
        log(f"{label}: written {name} rows vs dense bf16 cache, worst row max-rel {err:.3e}; "
            f"bf16 cache vs float32 worst row {row_noise:.3e}")
        if err > REPLY_NOISE_FACTOR * row_noise:
            failed.append(f"{label}: written {name} rows disagree with the dense cache beyond bf16 rounding")
    return failed


def sibling_backend(backend, kv_quant_type=None):
    """A backend over ``backend``'s own block parameters (no copy), with
    step programs of its own, for work off the served path: its captures
    do not run up the served backend's call counts, so the served programs'
    warm-up stays what serving made it."""
    from petals_tpu_torch.server.backend import TransformerBackend

    return TransformerBackend(
        backend.family, backend.cfg, backend.block_params, first_block=backend.first_block,
        n_blocks=backend.n_blocks, device=backend.device, compute_dtype=backend.compute_dtype,
        quant_type=backend.quant_type, kv_quant_type=kv_quant_type or backend.kv_quant_type,
    )


def sub_span_backend(backend, n_blocks: int):
    """A backend over the first ``n_blocks`` of ``backend``'s blocks (their
    parameters, no copy), with step programs of its own."""
    from petals_tpu_torch.server.backend import TransformerBackend

    return TransformerBackend(
        backend.family, backend.cfg, backend.block_params[:n_blocks], first_block=backend.first_block,
        n_blocks=n_blocks, device=backend.device, compute_dtype=backend.compute_dtype,
        quant_type=backend.quant_type, kv_quant_type=backend.kv_quant_type,
    )


def _random_pools(backend, device, n_pages, seed):
    """Seeded random bf16 span pools [n_blocks, n_pages, PAGE, hkv, d],
    quantized on the card to the backend's pool kind."""
    from petals_tpu_torch.ops.paged_attention import PagedPool, quantize_kv_rows

    cfg = backend.cfg
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (backend.n_blocks, n_pages, PAGE, cfg.num_key_value_heads, cfg.head_dim)
    pools = tuple(torch.randn(shape, generator=gen, device=device).to(torch.bfloat16) for _ in range(2))
    if backend.kv_quant_type != "none":
        pools = tuple(PagedPool(*quantize_kv_rows(p, backend.kv_quant_type)) for p in pools)
    return pools


def _pool_tensors(pools):
    from petals_tpu_torch.ops.paged_attention import PagedPool

    return [t for p in pools for t in (p if isinstance(p, PagedPool) else (p,))]


def _clone_pools(pools):
    from petals_tpu_torch.ops.paged_attention import PagedPool

    return tuple(PagedPool(p.codes.clone(), p.scales.clone()) if isinstance(p, PagedPool) else p.clone()
                 for p in pools)


def check_step_programs(backend, device, label) -> dict:
    """The step programs against the eager block loop (phase 15): on a
    sibling of the served backend (its weights, its pool kind), two decode
    steps and mixed steps at STEP_CHUNKS (buckets 8, 64 and 512 captured,
    then a 300-token chunk padded to 512 and a 5-token chunk padded to 8,
    which replay those graphs at another lane, position and real length),
    PROFILE_LANES lanes on 1024-token tables; the replayed steps on one copy
    of seeded pools, the eager loop (the same padded chunk, the same device
    scalars) on a clone. Every output row and every pool byte must be
    bit-equal after each step, with one exception: on the step that
    captures a bucket, the prefilling lane's decode row (at the idle
    sentinel, read by no caller) is left out, because the capture's warm-up
    has run the step once already, so that row's attention, which covers
    the lane's whole table, sees the chunk's rows written. On a replay of a
    bucket that row is held bit-equal as well."""
    from petals_tpu_torch.server.backend import bucket_length

    sib = sibling_backend(backend)
    cfg, max_pages = sib.cfg, 1024 // PAGE
    replayed = _random_pools(sib, device, PROFILE_LANES * max_pages, SEED + 7)
    eager = _clone_pools(replayed)
    tables = torch.arange(PROFILE_LANES * max_pages, dtype=torch.int32).reshape(PROFILE_LANES, max_pages)
    positions = torch.tensor([64, 362, 661, 960], dtype=torch.int32)[:PROFILE_LANES]
    gen = torch.Generator().manual_seed(SEED + 8)
    steps = [None, None] + list(STEP_CHUNKS)
    captured, sentinel_checked = set(), 0
    for i, step in enumerate(steps):
        hidden = torch.randn(PROFILE_LANES, 1, cfg.hidden_size, generator=gen)
        h_dev = hidden.to(torch.bfloat16).to(device)
        if step is None:
            got = sib.paged_decode_step(hidden, replayed, positions, tables)[:1]
            want = sib._paged_decode_eager(h_dev, eager, positions.to(device), tables.to(device))[:1]
            what = "decode"
        else:
            seq, lane, chunk_pos = step
            bucket = bucket_length(seq)
            chunk = torch.randn(1, seq, cfg.hidden_size, generator=gen)
            mixed = positions.clone()
            mixed[lane] = max_pages * PAGE  # the chunk's lane: its decode row idles
            padded = torch.zeros(1, bucket, cfg.hidden_size, dtype=torch.bfloat16)
            padded[:, :seq] = chunk.to(torch.bfloat16)
            sc = torch.tensor([lane, chunk_pos, seq], dtype=torch.int32).to(device)
            dec, out, _ = sib.paged_mixed_step(hidden, replayed, mixed, tables, chunk, lane, chunk_pos)
            w_dec, w_out, _ = sib._paged_mixed_eager(
                h_dev, eager, mixed.to(device), tables.to(device), padded.to(device), sc[0:1], sc[1], sc[2])
            rows = [r for r in range(PROFILE_LANES) if r != lane or bucket in captured]
            sentinel_checked += len(rows) == PROFILE_LANES
            captured.add(bucket)
            got, want = (dec[rows], out), (w_dec[rows], w_out[:, :seq])
            what = f"mixed, a {seq}-token chunk (bucket {bucket}) of lane {lane} at position {chunk_pos}"
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            diff = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            raise AssertionError(f"{label}: replayed {what} step differs from the eager loop (max abs {diff:.3e})")
        if not all(torch.equal(g, w) for g, w in zip(_pool_tensors(replayed), _pool_tensors(eager))):
            raise AssertionError(f"{label}: replayed {what} step wrote other pool bytes than the eager loop")
        positions = positions + 1
    stats = sib.step_program_stats()
    log(f"{label}: step programs bit-equal to the eager loop: decode x2, mixed at (tokens, lane, position) "
        f"{list(STEP_CHUNKS)}, the sentinel row held on the {sentinel_checked} replays of a captured bucket; {stats}")
    if stats["graph_captures"] != 4 or stats["graph_replays"] != len(steps) or sentinel_checked != 2:
        raise AssertionError(f"{label}: expected 4 captures (decode; buckets 8, 64, 512), {len(steps)} replays and "
                             f"2 bucket replays with the sentinel row held, got {stats}, {sentinel_checked}")
    return stats


def eager_sibling(backend):
    """A sibling of ``backend`` with no step programs: its steps run the
    eager block loop on the card (the same methods, the same padding and
    device scalars), the reference a replay must equal bit for bit."""
    sib = sibling_backend(backend)
    for name in ("_decode_program", "_mixed_program", "_gen_program", "_dense_decode_program", "_dense_gen_program",
                 "_lane_program", "_private_program", "_private_gen_program", "_forward_program"):
        setattr(sib, name, None)
    return sib


def _program_counts(prog) -> dict:
    c = prog.counts
    return {"calls": c.calls, "eager": c.eager_calls, "captures": c.captures, "replays": c.replays,
            "anomalies": c.anomalies}


def _count_delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _seeded_cache(backend, device, batch, max_length, seed):
    """Seeded bf16 dense K/V buffers [n_blocks, batch, max_length, hkv, d]."""
    cfg = backend.cfg
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (backend.n_blocks, batch, max_length, cfg.num_key_value_heads, cfg.head_dim)
    return tuple(torch.randn(shape, generator=gen, device=device).to(torch.bfloat16) for _ in range(2))


def _bit_equal(label, what, got, want, pairs) -> None:
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        diff = (got.float() - want.float()).abs().max().item() if got.shape == want.shape else "shape"
        raise AssertionError(f"{label}: replayed {what} differs from the eager loop (max abs {diff})")
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"{label}: replayed {what} wrote other cache bytes than the eager loop")


def check_dense_programs(backend, device, label, full=True) -> dict:
    """The dense programs against the eager block loop (phase 15): on a
    sibling of the served backend, a seeded private cache of PRIVATE_BATCH
    rows and DENSE_MAX_LENGTH tokens; the private step's chunks at
    DENSE_STEP_CHUNKS (each bucket run eagerly, then captured by its second
    chunk and replayed; the 300-token chunk padded to 512 past the cache's
    end), three decode steps, three with hypo_ids, and deep prompts over a
    chunk that straddles their end; a PROFILE_LANES-lane dense pool warmed
    as a batcher warms it (nothing written), its batched decode step twice
    and a chunk on a lane's view; the stateless forward three times. Each
    call on one cache, the same call on an ``eager_sibling`` on a clone:
    outputs and every cache byte bit-equal. ``full=False``: the decode steps
    alone (a quantized 2-block span: K5's decode kernel inside a dense
    graph). Every non-steady key: one eager call, one capture; no
    anomaly."""
    from petals_tpu_torch.server.backend import chunk_buckets

    sib, ref = sibling_backend(backend), eager_sibling(backend)
    hsz = sib.hidden_size
    cache = _seeded_cache(sib, device, PRIVATE_BATCH, DENSE_MAX_LENGTH, SEED + 18)
    eager = tuple(t.clone() for t in cache)
    gen = torch.Generator().manual_seed(SEED + 19)

    def hidden(batch, n):
        return torch.randn(batch, n, hsz, generator=gen)

    def private(what, h, position, **kw):
        got, _ = sib.inference_step(h, cache, position, **kw)
        want, _ = ref.inference_step(h, eager, position, **kw)
        _bit_equal(label, what, got, want, zip(cache, eager))

    done = []
    if full:
        for n, pos in DENSE_STEP_CHUNKS:
            private(f"private step, {n} tokens at {pos}", hidden(PRIVATE_BATCH, n), pos)
        done.append(f"chunks {list(DENSE_STEP_CHUNKS)}")
    position = 929
    for i in range(3):
        private("private decode step", hidden(PRIVATE_BATCH, 1), position + i)
    hypo = torch.arange(PRIVATE_BATCH - 1, -1, -1)
    for i in range(3):
        private("private decode step with hypo_ids", hidden(PRIVATE_BATCH, 1), position + 3 + i, hypo_ids=hypo)
    done.append("decode x3, with hypo_ids x3")
    if full:
        prompts = torch.randn(sib.n_blocks, PRIVATE_BATCH, 16, hsz, generator=gen) * 0.1
        private("private chunk with deep prompts", hidden(PRIVATE_BATCH, 8), 0, prompts=prompts)
        private("private chunk straddling the deep prompts", hidden(PRIVATE_BATCH, 8), 12, prompts=prompts)
        done.append("deep prompts (8 rows at 0, 8 at 12 over pre_seq 16)")
    private_counts = _program_counts(sib._private_program)
    n_keys = 2 + 3 * full + 1 * full  # decode, hypo decode; buckets 8, 64, 512; prompts
    stats = {"private": private_counts}
    if private_counts["eager"] != n_keys or private_counts["captures"] != n_keys or private_counts["anomalies"]:
        raise AssertionError(f"{label}: expected {n_keys} keys, each one eager call and one capture: {private_counts}")
    if full:
        pool = _seeded_cache(sib, device, PROFILE_LANES, DENSE_MAX_LENGTH, SEED + 20)
        eager_pool = tuple(t.clone() for t in pool)
        sib.warm_dense_programs(pool, PROFILE_LANES, DENSE_MAX_LENGTH, DENSE_WARM_CHUNK)
        _bit_equal(label, "dense pool warm-up", pool[0], eager_pool[0], zip(pool, eager_pool))
        positions = torch.tensor([64, 362, 661, DENSE_MAX_LENGTH], dtype=torch.int32)[:PROFILE_LANES]
        for i in range(2):
            h = hidden(PROFILE_LANES, 1)
            got, _ = sib.batched_decode_step(h, pool, positions + i)
            want, _ = ref.batched_decode_step(h, eager_pool, positions + i)
            _bit_equal(label, "dense pool batched decode step", got, want, zip(pool, eager_pool))
        h = hidden(1, 40)
        got, _ = sib.inference_step(h, sib.dense_lane_view(*pool, 2), 700)
        want, _ = ref.inference_step(h, ref.dense_lane_view(*eager_pool, 2), 700)
        _bit_equal(label, "lane-view chunk (40 tokens of lane 2 at 700)", got, want, zip(pool, eager_pool))
        stats["pool"] = {name: _program_counts(getattr(sib, attr)) for name, attr in
                         (("batched_decode", "_dense_decode_program"), ("lane", "_lane_program"))}
        n_lane = PROFILE_LANES * (1 + len(chunk_buckets(DENSE_WARM_CHUNK)))
        if (stats["pool"]["batched_decode"]["captures"] != 1 or stats["pool"]["lane"]["captures"] != n_lane
                or stats["pool"]["lane"]["replays"] != n_lane + 1):
            raise AssertionError(f"{label}: the dense pool's programs: {stats['pool']}")
        x = hidden(1, PROFILE_CHUNK)
        for i in range(3):
            _bit_equal(label, f"forward (call {i + 1})", sib.forward(x), ref.forward(x), ())
        stats["forward"] = _program_counts(sib._forward_program)
        done.append(f"dense pool: warm-up, batched decode x2, a lane-view chunk; forward x3 at {PROFILE_CHUNK}")
        del pool, eager_pool
    log(f"{label}: dense programs bit-equal to the eager loop: {'; '.join(done)}; {json.dumps(stats)}")
    return stats


def check_private_gen_program(backend, gen_params, device, label) -> dict:
    """The private generation step's program and the dense pool's generation
    step against the eager loop (phase 15, run here where the client's
    leaves are loaded): on a sibling, ``generate_tokens`` on a seeded
    private cache of one row, 8 tokens greedy then 8 sampled
    (GEN_SAMPLING), beside an ``eager_sibling`` on a clone: tokens and every
    cache byte bit-equal; then a warmed PROFILE_LANES-lane dense pool's
    ``batched_gen_decode_step`` twice (generating, sampled and decoding
    lanes) the same way."""
    from petals_tpu_torch.rpc.protocol import validate_gen_sampling

    sib, ref = sibling_backend(backend), eager_sibling(backend)
    cfg = sib.cfg
    cache = _seeded_cache(sib, device, 1, DENSE_MAX_LENGTH, SEED + 21)
    eager = tuple(t.clone() for t in cache)
    gen = torch.Generator().manual_seed(SEED + 22)
    last = torch.randn(1, 1, cfg.hidden_size, generator=gen).to(torch.bfloat16).to(device)
    position = 500
    for sampling in (None, validate_gen_sampling(GEN_SAMPLING)):
        got, _ = sib.generate_tokens(gen_params, last, cache, position, 8, sampling=sampling)
        want, _ = ref.generate_tokens(gen_params, last, eager, position, 8, sampling=sampling)
        _bit_equal(label, f"private generation ({'sampled' if sampling else 'greedy'})", torch.from_numpy(got),
                   torch.from_numpy(want), zip(cache, eager))
        position += 7
    private = _program_counts(sib._private_gen_program)
    pool = _seeded_cache(sib, device, PROFILE_LANES, DENSE_MAX_LENGTH, SEED + 23)
    eager_pool = tuple(t.clone() for t in pool)
    sib.warm_dense_programs(pool, PROFILE_LANES, DENSE_MAX_LENGTH, 8, gen_params)
    positions = torch.tensor([64, 362, 661, 960], dtype=torch.int32)[:PROFILE_LANES]
    vec, tokens, use_token = _gen_vectors(cfg.vocab_size, PROFILE_LANES,
                                          [lane != 1 for lane in range(PROFILE_LANES)], SEED + 22)
    for step in range(2):
        h = torch.randn(PROFILE_LANES, 1, cfg.hidden_size, generator=gen)
        got_h, got_t, _ = sib.batched_gen_decode_step(gen_params, h, tokens, use_token, pool, positions,
                                                      sampling_vecs=vec)
        want_h, want_t, _ = ref.batched_gen_decode_step(gen_params, h, tokens, use_token, eager_pool, positions,
                                                        sampling_vecs=vec)
        _bit_equal(label, f"dense pool generation step {step}", torch.cat([got_h.flatten(), got_t.float()]),
                   torch.cat([want_h.flatten(), want_t.float()]), zip(pool, eager_pool))
        tokens = torch.where(use_token, got_t.cpu(), 0)
        positions = positions + 1
        vec["draw_idx"] += 1
    stats = {"server_gen": private, "batched_gen_decode": _program_counts(sib._dense_gen_program)}
    log(f"{label}: private generation (8 greedy, 8 sampled tokens) and the dense pool's generation step x2 "
        f"bit-equal to the eager loop; {json.dumps(stats)}")
    # one key a sampling mode: its first step eager, its second captured
    if private["eager"] != 2 or private["captures"] != 2 or stats["batched_gen_decode"]["captures"] != 1:
        raise AssertionError(f"{label}: generation programs {stats}")
    return stats


def _graph_of(fn, device):
    """``fn`` captured in a CUDA graph of its own (warmed on a side
    stream first), for timing a piece of a step as its replay runs it."""
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def profile_dense_steps(backend, device, smi) -> dict:
    """Where a dense step's time goes (the profile phase's dense rows), on a
    sibling and an ``eager_sibling`` of the served span's backend: the
    private decode step of a PRIVATE_BATCH-row session on a
    PRIVATE_MAX_LENGTH-token cache at DENSE_PROFILE_POSITION, and the dense
    pool's PROFILE_LANES-lane batched decode step on DENSE_MAX_LENGTH-token
    lanes at the paged profile's positions, each eager (the block loop,
    host inputs uploaded per call) and replayed, as ``profile_calls``
    measures them. Then B6, the plain decode attention the dense steps run:
    the span's n_blocks calls of ``attend_reference`` at each step's shapes
    on the same caches, captured in one graph and profiled as its replay,
    beside the replayed step's device busy time."""
    from petals_tpu_torch.ops.attention import attend_reference

    sib, ref = sibling_backend(backend), eager_sibling(backend)
    cfg = sib.cfg
    gen = torch.Generator().manual_seed(SEED + 24)
    cache = _seeded_cache(sib, device, PRIVATE_BATCH, PRIVATE_MAX_LENGTH, SEED + 24)
    pool = _seeded_cache(sib, device, PROFILE_LANES, DENSE_MAX_LENGTH, SEED + 25)
    sib.warm_dense_programs(pool, PROFILE_LANES, DENSE_MAX_LENGTH, 8)
    pos = DENSE_PROFILE_POSITION
    positions = torch.linspace(64, DENSE_MAX_LENGTH - 64, PROFILE_LANES).to(torch.int32)
    h_private = torch.randn(PRIVATE_BATCH, 1, cfg.hidden_size, generator=gen)
    h_pool = torch.randn(PROFILE_LANES, 1, cfg.hidden_size, generator=gen)
    for _ in range(2):  # the private decode key: its eager call, then its capture
        sib.inference_step(h_private, cache, pos)
    private = f"private decode step (batch {PRIVATE_BATCH}, {PRIVATE_MAX_LENGTH}-token cache at {pos})"
    pooled = f"dense pool decode step ({PROFILE_LANES} lanes of {DENSE_MAX_LENGTH} tokens)"

    def b6(batch, k_stack, v_stack, q_offset):
        q = torch.randn(batch, 1, cfg.num_attention_heads, cfg.head_dim, device=device).to(torch.bfloat16)
        q_offset = q_offset.to(device)

        def run():
            for i in range(sib.n_blocks):
                attend_reference(q, k_stack[i], v_stack[i], q_offset=q_offset, kv_length=q_offset + 1,
                                 sliding_window=cfg.sliding_window)
        return _graph_of(run, device)

    b6_private = b6(PRIVATE_BATCH, *cache, torch.tensor(pos, dtype=torch.int32))
    b6_pool = b6(PROFILE_LANES, *pool, positions)
    steps = {
        f"{private}, eager": lambda: ref.inference_step(h_private, cache, pos),
        f"{private}, replayed": lambda: sib.inference_step(h_private, cache, pos),
        f"{pooled}, eager": lambda: ref.batched_decode_step(h_pool, pool, positions),
        f"{pooled}, replayed": lambda: sib.batched_decode_step(h_pool, pool, positions),
        f"B6 of the {private}, {sib.n_blocks} blocks in one graph": b6_private.replay,
        f"B6 of the {pooled}, {sib.n_blocks} blocks in one graph": b6_pool.replay,
    }
    log(f"dense profile (--quant_type {sib.quant_type}): {sib.n_blocks} blocks ({smi})")
    times = profile_calls(steps)
    for what in (private, pooled):
        b6_ms = times[f"B6 of the {what}, {sib.n_blocks} blocks in one graph"]["device_busy_ms"]
        step_ms = times[f"{what}, replayed"]["device_busy_ms"]
        log(f"dense profile: B6 (plain decode attention) takes {b6_ms:.3f} ms of the replayed {what}'s "
            f"{step_ms:.3f} ms device busy ({b6_ms / step_ms:.3f}) ({smi})")
    rows = {label: {k: round(v, 4) for k, v in t.items()} for label, t in times.items()}
    log(f"dense profile rows: {json.dumps(rows)}")
    return times


def measure_dense_graph_pool(backend, batcher, device, label) -> dict:
    """The card memory the dense programs keep reserved, as
    ``measure_graph_pool`` reads the paged ones: a sibling of the served
    backend warms them as the served dense batcher does (its lanes, its
    length, its longest chunk), then captures a private session's
    (PRIVATE_BATCH rows on a PRIVATE_MAX_LENGTH-token cache: the decode
    step and a PROFILE_CHUNK-token chunk) and the forward at PROFILE_CHUNK
    tokens; the reserved bytes are read before and after, the allocator's
    cache emptied each time. Beside them the eager peaks of a lane chunk at
    the longest chunk, the private chunk and the forward. Fails if the
    pool and the larger peak together pass the reserve that
    choose_num_blocks leaves."""
    from petals_tpu_torch.server.block_utils import AUTOGRAD_RESERVE_FRACTION

    total = torch.cuda.get_device_properties(device).total_memory
    reserve = AUTOGRAD_RESERVE_FRACTION * total
    sib, ref = sibling_backend(backend), eager_sibling(backend)
    hsz, n_lanes, max_length = sib.hidden_size, batcher.n_lanes, batcher.max_length
    pool = _seeded_cache(sib, device, n_lanes, max_length, SEED + 26)
    cache = _seeded_cache(sib, device, PRIVATE_BATCH, PRIVATE_MAX_LENGTH, SEED + 27)
    longest = min(backend.longest_chunk(1), max_length)
    token = torch.zeros(PRIVATE_BATCH, 1, hsz)
    chunk = torch.zeros(PRIVATE_BATCH, PROFILE_CHUNK, hsz)
    x = torch.zeros(1, PROFILE_CHUNK, hsz)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(device)
    sib.warm_dense_programs(pool, n_lanes, max_length, longest)
    for _ in range(2):
        sib.inference_step(token, cache, 0)
        sib.inference_step(chunk, cache, 0)
        sib.forward(x)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    graph_bytes = torch.cuda.memory_reserved(device) - before
    captures = sib.step_program_stats()["graph_captures"]
    peaks = {}
    for what, fn in (
        ("eager lane chunk", lambda: ref.inference_step(torch.zeros(1, longest, hsz), ref.dense_lane_view(*pool, 0), 0)),
        ("eager private chunk", lambda: ref.inference_step(chunk, cache, 0)),
        ("eager forward", lambda: ref.forward(x)),
    ):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        fn()
        torch.cuda.synchronize()
        peaks[what] = torch.cuda.max_memory_allocated(device) - base
    row = {"lanes": n_lanes, "max_length": max_length, "longest_chunk": longest, "captures": captures,
           "graph_pool_bytes": graph_bytes, **{f"{k} peak bytes": v for k, v in peaks.items()}}
    log(f"{label}: dense programs ({captures} captures: {n_lanes} lanes x {max_length} tokens warmed to "
        f"{longest}-token chunks, a private batch-{PRIVATE_BATCH} session's decode and {PROFILE_CHUNK}-token chunk, "
        f"the forward at {PROFILE_CHUNK}) hold {graph_bytes / 2**20:.1f} MiB reserved; eager peaks "
        + ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in peaks.items())
        + f"; reserve {reserve / 2**30:.2f} GiB ({AUTOGRAD_RESERVE_FRACTION:g} of {total / 2**30:.2f} GiB)")
    log(f"{label}: dense graph pool {json.dumps(row)}")
    if graph_bytes + max(peaks.values()) > reserve:
        raise AssertionError(f"{label}: the dense programs' pool and the eager peak pass the reserve: {row}")
    del sib, ref, pool, cache
    free_card()
    return row


def measure_graph_pool(backend, batcher, device, label) -> dict:
    """The card memory the step programs keep reserved, beside the eager
    paths' peaks and the reserve that choose_num_blocks leaves beside the
    weights and the KV budget (AUTOGRAD_RESERVE_FRACTION of the card). A
    sibling of the served backend warms its programs as the served batcher
    does (its lanes, its table width, its longest chunk), and a second
    sibling warms them up to the last prefill bucket on tables long enough
    for it; the reserved bytes are read before and after, the allocator's
    cache emptied each time, so what remains is the graphs' pool and their
    static buffers. Beside each: the peak allocation of one eager mixed
    step, and of the stateless forward (the dense paths' step, which runs
    eagerly), at the longest chunk. Fails if a pool and the larger eager
    peak together pass the reserve."""
    from petals_tpu_torch.server.backend import PREFILL_BUCKETS, bucket_length
    from petals_tpu_torch.server.block_utils import AUTOGRAD_RESERVE_FRACTION

    total = torch.cuda.get_device_properties(device).total_memory
    reserve = AUTOGRAD_RESERVE_FRACTION * total
    rows = {}
    for name, max_chunk in (("served", batcher.max_chunk()), ("last bucket", PREFILL_BUCKETS[-1])):
        max_pages = max(batcher.max_pages, -(-max_chunk // PAGE))
        sib = sibling_backend(backend)
        pools = _random_pools(sib, device, max_pages, SEED + 9)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(device)
        sib.warm_step_programs(pools, batcher.n_lanes, max_pages, max_chunk)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        graph_bytes = torch.cuda.memory_reserved(device) - before
        captures = sib.step_program_stats()["graph_captures"]
        longest = min(max_chunk, max_pages * PAGE)
        h = sib.hidden_size
        hidden = torch.zeros(batcher.n_lanes, 1, h, dtype=torch.bfloat16, device=device)
        positions = torch.full((batcher.n_lanes,), max_pages * PAGE, dtype=torch.int32, device=device)
        tables = torch.full((batcher.n_lanes, max_pages), -1, dtype=torch.int32, device=device)
        chunk = torch.zeros(1, bucket_length(longest), h, dtype=torch.bfloat16, device=device)
        sc = torch.tensor([0, 0, longest], dtype=torch.int32, device=device)
        peaks = {}
        for what, fn in (
            ("eager mixed step", lambda: sib._paged_mixed_eager(hidden, pools, positions, tables, chunk,
                                                                sc[0:1], sc[1], sc[2])),
            ("eager forward", lambda: sib.forward(chunk[:, :longest])),
        ):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            fn()
            torch.cuda.synchronize()
            peaks[what] = torch.cuda.max_memory_allocated(device) - base
        rows[name] = {"max_chunk": max_chunk, "lanes": batcher.n_lanes, "max_pages": max_pages,
                      "captures": captures, "graph_pool_bytes": graph_bytes, **{f"{k} peak bytes": v for k, v in
                                                                                  peaks.items()}}
        log(f"{label}: step programs warmed to {max_chunk}-token chunks ({captures} captures, {batcher.n_lanes} "
            f"lanes x {max_pages} pages) hold {graph_bytes / 2**20:.1f} MiB reserved; eager peaks at a "
            f"{longest}-token chunk: mixed step {peaks['eager mixed step'] / 2**20:.1f} MiB, forward "
            f"{peaks['eager forward'] / 2**20:.1f} MiB; reserve {reserve / 2**30:.2f} GiB "
            f"({AUTOGRAD_RESERVE_FRACTION:g} of {total / 2**30:.2f} GiB)")
        if graph_bytes + max(peaks.values()) > reserve:
            raise AssertionError(f"{label}: the step programs' pool and the eager peak pass the reserve: {rows[name]}")
        del sib, pools, hidden, positions, tables, chunk, sc
        free_card()
    log(f"{label}: graph pool {json.dumps(rows)}")
    return rows


def check_graph_stats(label, stats) -> None:
    """A served paged run stepped on its step programs: every batched step
    a replay, no capture after warm-up."""
    log(f"{label}: step programs: {stats['graph_captures']} captures, {stats['graph_replays']} replays, "
        f"{stats['graph_anomalies']} captures after warm-up, for {stats['batched_steps']} batched steps")
    if stats["graph_anomalies"] or stats["graph_replays"] < stats["batched_steps"] or not stats["batched_steps"]:
        raise AssertionError(f"{label}: served steps did not all replay step programs without a late capture: {stats}")


def profile_steps(backend, device, gen_params=None, smi="") -> None:
    """Where a step's time goes, beside the served span's backend (its
    weights, on a sibling backend, called directly, no RPC): a paged decode
    step at PROFILE_LANES lanes and a mixed step that also carries a
    PROFILE_CHUNK-token chunk, on fresh random pools, each run two ways:
    the eager block loop (host inputs uploaded per call, as the port ran
    every step before its step programs) and the replayed step program.
    With the client's leaves (``gen_params``), the generation step (every
    lane generating, sampled) beside the decode step in place of the mixed
    step, and the head and sampling's share of its device time: the
    generation step's busy time less the decode step's, over the former."""
    sib = sibling_backend(backend)
    cfg, max_len = sib.cfg, 1024
    max_pages = max_len // PAGE
    pools = _random_pools(sib, device, PROFILE_LANES * max_pages, SEED + 6)
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    tables = torch.arange(PROFILE_LANES * max_pages, dtype=torch.int32).reshape(PROFILE_LANES, max_pages)
    positions = torch.linspace(64, max_len - 64, PROFILE_LANES).to(torch.int32)
    hidden = torch.randn(PROFILE_LANES, 1, cfg.hidden_size, generator=gen, device=device).cpu()
    chunk = torch.randn(1, PROFILE_CHUNK, cfg.hidden_size, generator=gen, device=device).cpu()
    mixed_positions = positions.clone()
    mixed_positions[0] = max_len  # lane 0 prefills: its decode row idles
    scalars = torch.tensor([0, 0, PROFILE_CHUNK], dtype=torch.int32).to(device)
    steps = {
        "decode step, eager": lambda: sib._paged_decode_eager(hidden, pools, positions, tables),
        "decode step, replayed": lambda: sib.paged_decode_step(hidden, pools, positions, tables),
    }
    if gen_params is None:
        steps.update({
            f"mixed step ({PROFILE_CHUNK}-token chunk), eager": lambda: sib._paged_mixed_eager(
                hidden, pools, mixed_positions, tables, chunk, scalars[0:1], scalars[1], scalars[2]),
            f"mixed step ({PROFILE_CHUNK}-token chunk), replayed": lambda: sib.paged_mixed_step(
                hidden, pools, mixed_positions, tables, chunk, 0, 0),
        })
    else:
        vec, tokens, use_token = _gen_vectors(cfg.vocab_size, PROFILE_LANES, [True] * PROFILE_LANES, SEED + 6)
        samp = sib._sampling_inputs(vec, device)
        dev = [t.to(device) for t in (hidden.to(torch.bfloat16), tokens, use_token, positions, tables)]
        steps.update({
            "generation step, eager": lambda: sib._paged_gen_decode_eager(
                gen_params, dev[0], dev[1], dev[2], pools, dev[3], dev[4], samp),
            "generation step, replayed": lambda: sib.paged_gen_decode_step(
                gen_params, hidden, tokens, use_token, pools, positions, tables, sampling_vecs=vec),
        })
    log(f"profile (--quant_type {sib.quant_type} --kv_quant_type {sib.kv_quant_type}): "
        f"{sib.n_blocks} blocks, {PROFILE_LANES} lanes at positions {positions.tolist()}")
    times = profile_calls(steps)
    if gen_params is not None:
        gen, dec = times["generation step, replayed"], times["decode step, replayed"]
        share = (gen["device_busy_ms"] - dec["device_busy_ms"]) / gen["device_busy_ms"]
        log(f"profile (--quant_type {sib.quant_type}): the replayed generation step's device busy "
            f"{gen['device_busy_ms']:.3f} ms beside the decode step's {dec['device_busy_ms']:.3f} ms: the embedding, "
            f"float32 head and sampling take {share:.3f} of it ({gen['device_busy_ms'] - dec['device_busy_ms']:.3f} ms); "
            f"host wall {gen['host_wall_ms']:.3f} vs {dec['host_wall_ms']:.3f} ms ({smi})")


def profile_calls(steps: dict) -> dict:
    """Each of ``steps`` (label: a callable) profiled as the profile phase
    does: the host wall (median of PROFILE_REPS calls, launch to
    synchronize) and the device span (CUDA events around the same calls),
    then from torch.profiler over PROFILE_CALLS further calls the device
    busy time, the kernel and graph launches and the top operations, with
    the idle share 1 - busy / wall. Returns {label: {host_wall_ms,
    device_span_ms, device_busy_ms, idle_share, launches, graph_launches}}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    times = {}
    for label, fn in steps.items():
        fn()
        walls, spans = [], []
        for _ in range(PROFILE_REPS):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            spans.append(start.elapsed_time(end))
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
        graph_launches = sum(e.count for e in events if e.key.startswith(("cudaGraphLaunch", "cuGraphLaunch")))
        span = statistics.median(spans)
        times[label] = {"host_wall_ms": statistics.median(walls), "device_span_ms": span, "device_busy_ms": busy,
                        "idle_share": 1 - busy / prof_wall, "launches": launches / PROFILE_CALLS,
                        "graph_launches": graph_launches / PROFILE_CALLS}
        log(f"{label}: host wall {statistics.median(walls):.3f} ms (median of {PROFILE_REPS}; device span "
            f"{span:.3f} ms, CUDA events around the call); profiled, per call over "
            f"{PROFILE_CALLS}: host wall {prof_wall:.3f} ms, device busy {busy:.3f} ms, idle share "
            f"{1 - busy / prof_wall:.3f} (of the unprofiled device span: {1 - busy / span:.3f}), "
            f"{launches / PROFILE_CALLS:g} kernel launches, {graph_launches / PROFILE_CALLS:g} graph launches")
        for kernel in PORT_KERNELS:
            t = sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA and kernel in e.key)
            if t:
                log(f"{label}: {kernel} {t / 1e3 / PROFILE_CALLS:.3f} ms a call, "
                    f"{t / 1e3 / PROFILE_CALLS / busy:.3f} of device busy")
        log(events.table(sort_by="self_device_time_total", row_limit=10, max_name_column_width=60))
    return times


def dense_reference_params(block_params, dtype):
    """The served blocks with every quantized leaf dequantized (to bf16,
    the kernels' weights), then cast to ``dtype``."""
    from petals_tpu_torch.ops.quant import QUANTIZED_TYPES, dequantize

    return [
        {k: (dequantize(v, torch.bfloat16) if isinstance(v, QUANTIZED_TYPES) else v).to(dtype) for k, v in p.items()}
        for p in block_params
    ]


def serve_and_check(ckpt, device, quant_type, n_blocks, prompts, n_steps, seed, warmup_prompts, kv_quant_type="none"):
    """Serve blocks [0, n_blocks) of the checkpoint with ``--quant_type`` and
    ``--kv_quant_type`` through the CLI's build_server, drive concurrent
    sessions (after an optional warm-up), check the launch counters of the
    measured run, every reply and every written K/V row against dense
    references, and return the server (still holding its span) and the
    measured run's launch counts."""
    from petals_tpu_torch.cli.run_server import build_parser, build_server
    from petals_tpu_torch.ops import paged_flash_attention as pfa
    from petals_tpu_torch.ops import quant_matmul as qmm

    label = f"server (--quant_type {quant_type} --kv_quant_type {kv_quant_type}, {n_blocks} blocks)"
    args = build_parser().parse_args([
        ckpt, "--first_block", "0", "--num_blocks", str(n_blocks), "--host", "127.0.0.1", "--quant_type", quant_type,
        "--kv_quant_type", kv_quant_type, *NO_PREFIX_CACHE,
    ])
    server = build_server(args)

    async def serve():
        t0 = time.perf_counter()
        await server.start()
        try:
            torch.cuda.synchronize()
            b = server.batcher
            pool_bytes = sum(
                d.nbytes for d in server.backend.paged_cache_descriptors(b.n_pages, b.page_size, 0, n_blocks))
            log(f"{label}: started in {time.perf_counter() - t0:.1f} s (span loaded), {b.n_lanes} lanes x "
                f"{b.max_length} tokens, {b.n_pages} pages of {b.page_size}, pool {pool_bytes / 2**20:.1f} MiB "
                f"({server.backend.kv_bytes_per_token()} bytes a token) of a "
                f"{server.memory_cache.max_size_bytes / 2**20:.1f} MiB budget, prefill budget "
                f"{b.prefill_token_budget}; {torch.cuda.memory_allocated(device) / 2**30:.2f} GiB allocated on the card")
            if warmup_prompts:
                await drive_server(server, warmup_prompts, 2, SEED + 5)
            before = dict(server.batcher.stats)
            pfa.reset_launch_counts()
            qmm.reset_launch_counts()
            result = await drive_server(
                server, prompts, n_steps, seed,
                at_end=lambda: lane_kv_rows(server.batcher, [n + n_steps for n in prompts]),
            )
            launches = {
                "K1": pfa.paged_flash_attend.launches, "K2": pfa.paged_flash_prefill_attend.launches,
                "K3 decode": dict(pfa.paged_flash_attend.kv_quant_launches),
                "K3 prefill": dict(pfa.paged_flash_prefill_attend.kv_quant_launches),
                "decode": dict(qmm.quant_decode_matmul.launches), "prefill": dict(qmm.quant_prefill_matmul.launches),
            }
        finally:
            await server.shutdown()
        stats = {k: v - before[k] if not k.startswith("max") else v for k, v in server.batcher.stats.items()}
        return result, launches, stats

    (inputs, replies, metas, timing, lane_kv), launches, stats = asyncio.run(serve())
    log(f"{label}: stats of the measured run: {stats}")
    check_graph_stats(label, stats)
    # the attention kernels of this pool's storage: K1/K2 on a bf16 pool, K3's
    # arms of the kind on a quantized one, and no launch of the other storage's
    need_dec, need_pf = stats["decode_steps"] * n_blocks, stats["mixed_steps"] * n_blocks
    if kv_quant_type == "none":
        names, att_dec, att_pf = ("K1", "K2"), launches["K1"], launches["K2"]
    else:
        names = (f"K3 {kv_quant_type} decode", f"K3 {kv_quant_type} prefill")
        att_dec, att_pf = launches["K3 decode"][kv_quant_type], launches["K3 prefill"][kv_quant_type]
    other = launches["K1"] + launches["K2"] + sum(launches["K3 decode"].values()) + sum(
        launches["K3 prefill"].values()) - att_dec - att_pf
    log(f"{label}: launches on the main path: {names[0]} {att_dec} (>= {need_dec}), {names[1]} {att_pf} "
        f"(>= {need_pf}); K1 {launches['K1']}, K2 {launches['K2']}, K3 decode {launches['K3 decode']}, "
        f"K3 prefill {launches['K3 prefill']}")
    need_mixed = sum(-(-n // server.batcher.prefill_token_budget) for n in prompts)
    if stats["mixed_steps"] < need_mixed or att_dec < need_dec or att_pf < need_pf or not (att_dec and att_pf):
        raise AssertionError(f"{label}: the main path did not run both attention kernels on every block of every step")
    if other:
        raise AssertionError(f"{label}: {other} attention launches of another pool storage's kernels")
    if quant_type != "none":
        # 4 quantized projections a block (wqkv, wo, wgu, wd); every step
        # (batched_steps) runs the lanes' decode rows, a mixed step also its
        # chunk, of more than 32 rows at these prompt lengths
        arm = quant_type[:-2] if quant_type.endswith("+o") else quant_type
        need_dec = stats["batched_steps"] * n_blocks * 4
        need_pf = stats["mixed_steps"] * n_blocks * 4
        dec, pf = launches["decode"][arm], launches["prefill"][arm]
        log(f"{label}: launches on the main path: {arm} decode kernel {dec} (>= {need_dec}), "
            f"prefill kernel {pf} (>= {need_pf}); all kinds: decode {launches['decode']}, prefill {launches['prefill']}")
        if dec < need_dec or pf < need_pf:
            raise AssertionError(f"{label}: the main path did not run the dequant-matmul kernels on every projection")
    decode_compute = [m["compute_s"] for ms in metas for m in ms[1:]]
    prefill_compute = sum(ms[0]["compute_s"] for ms in metas)
    log(f"{label}: main path: prefill {sum(prompts) / timing['prefill_wall_s']:.1f} tokens/s over {sum(prompts)} "
        f"tokens ({timing['prefill_wall_s'] * 1e3:.1f} ms wall, {prefill_compute * 1e3:.1f} ms of steps "
        f"carrying chunks); decode step {statistics.median(decode_compute) * 1e3:.3f} ms "
        f"(median batched-step compute on the server), {timing['decode_round_trip_ms']:.3f} ms "
        f"client round trip (median per session)")
    params_bf16 = dense_reference_params(server.backend.block_params, torch.bfloat16)
    params_f32 = dense_reference_params(server.backend.block_params, torch.float32)
    failed = []
    for (prompt, steps), got, kv, n in zip(inputs, replies, lane_kv, prompts):
        args = (server.family, server.cfg, prompt, steps, device)
        failed += check_session(
            got, kv, reference_session(params_bf16, *args, torch.bfloat16, kv_quant_type),
            reference_session(params_f32, *args, torch.float32, kv_quant_type),
            f"{label}: session with a {n}-token prompt", kv_quant_type,
        )
    if failed:
        raise AssertionError("; ".join(failed))
    return server, launches


def _launch_counts():
    from petals_tpu_torch.ops import flash_attention as fa
    from petals_tpu_torch.ops import paged_flash_attention as pfa

    return {
        "K4": fa.flash_attend.launches, "K1": pfa.paged_flash_attend.launches,
        "K2": pfa.paged_flash_prefill_attend.launches,
        "K3": sum(pfa.paged_flash_attend.kv_quant_launches.values())
        + sum(pfa.paged_flash_prefill_attend.kv_quant_launches.values()),
    }


def _reset_launch_counts():
    from petals_tpu_torch.ops import flash_attention as fa
    from petals_tpu_torch.ops import paged_flash_attention as pfa
    from petals_tpu_torch.ops import quant_matmul as qmm

    fa.reset_launch_counts()
    pfa.reset_launch_counts()
    qmm.reset_launch_counts()


def _private_kv(server, n_tokens):
    """The K/V rows of the one open private session, read from its cache
    [n_blocks, batch, max_length, hkv, d]: (k, v) of [n_blocks * batch,
    n_tokens, hkv, d]."""
    torch.cuda.synchronize()
    cache = server.memory_cache
    pool_handles = set(server.batcher._handles or ())
    # the newest allocation: an earlier session's cache may not be freed yet
    handles = sorted(h for h in cache._allocated if h not in pool_handles)[-2:]
    if len(handles) != 2:
        raise AssertionError(f"expected a private cache (2 buffers), found handles {handles}")
    return tuple(buf[:, :, :n_tokens].flatten(0, 1).clone() for buf in cache.get_buffers(*handles))


async def _drive_private(server, blocks, batch, max_length, step_lens, seed):
    """One private session over blocks [blocks[0], blocks[1]) at ``batch``:
    steps of ``step_lens`` tokens each. Returns the inputs, the replies, each
    reply's step_meta and the cache's K/V rows read before the stream ends."""
    from petals_tpu_torch.data_structures import CHAIN_DELIMITER, make_uid
    from petals_tpu_torch.rpc import RpcClient
    from petals_tpu_torch.rpc.serialization import deserialize_array, serialize_array

    gen = torch.Generator().manual_seed(seed)
    inputs = [torch.randn(batch, n, server.cfg.hidden_size, generator=gen).to(torch.bfloat16) for n in step_lens]
    uids = CHAIN_DELIMITER.join(make_uid(server.dht_prefix, i) for i in range(*blocks))
    client = await RpcClient.connect("127.0.0.1", server.rpc_server.port)
    try:
        stream = await client.open_stream("ptu.inference")
        await stream.send({"uids": uids, "max_length": max_length, "batch_size": batch})
        if not (await stream.recv(timeout=120))["session_open"]:
            raise AssertionError("private session did not open")
        outs, metas, position = [], [], 0
        for h in inputs:
            await stream.send({"tensors": {"hidden": serialize_array(h)}})
            reply = await stream.recv(timeout=300)
            position += h.shape[1]
            if reply["position"] != position:
                raise AssertionError(f"position {reply['position']}, expected {position}")
            outs.append(deserialize_array(reply["tensors"]["hidden"]))
            metas.append(reply["step_meta"])
        kv = _private_kv(server, position)
        await stream.end()
    finally:
        await client.close()
    return inputs, outs, metas, kv


def serve_private_and_check(ckpt, device, smi):
    """Phase 10: the bf16 span with the CLI's defaults serving a batch-2
    session and a sub-span session from private caches, each step a call of
    its backend's private step program: a chunk's key runs once, eagerly;
    the decode key runs eagerly, is captured on the second decode step and
    replays every later one. Then phase 15's dense programs against the
    eager loop and the profile phase's dense rows, on the served weights.
    Returns the launch counts of the two sessions together."""
    from petals_tpu_torch.cli.run_server import build_parser, build_server
    from petals_tpu_torch.server.backend import bucket_length

    label = "private sessions (bf16, 8 blocks)"
    server = build_server(build_parser().parse_args(
        [ckpt, "--first_block", "0", "--num_blocks", str(SPAN), "--host", "127.0.0.1", *NO_PREFIX_CACHE]))
    sessions = (
        ("batch 2, whole span", (0, SPAN), PRIVATE_BATCH, PRIVATE_MAX_LENGTH, PRIVATE_STEPS),
        (f"sub-span [{SUB_SPAN[0]}, {SUB_SPAN[1]}), batch 1", SUB_SPAN, 1, 1024, SUB_SPAN_STEPS),
    )

    async def serve():
        await server.start()
        try:
            await _drive_private(server, (0, SPAN), PRIVATE_BATCH, 256, (64, 1, 1), SEED + 5)  # warm-up
            results = []
            for i, (_, blocks, batch, max_length, step_lens) in enumerate(sessions):
                # the backend the session's steps run on (the handler's, for a sub-span)
                program = server.handler._sub_backend(*blocks)._private_program
                before = _program_counts(program)
                _reset_launch_counts()
                result = await _drive_private(server, blocks, batch, max_length, step_lens, SEED + 10 + i)
                results.append((result, _launch_counts(), _count_delta(_program_counts(program), before)))
            return results
        finally:
            await server.shutdown()

    results = asyncio.run(serve())
    failed, total = [], {}
    for (name, blocks, batch, max_length, step_lens), ((inputs, outs, metas, kv), launches, programs) in zip(
            sessions, results):
        n_blocks = blocks[1] - blocks[0]
        # a chunk of more than one token is padded to a bucket of at least 8 rows: K4's
        need = n_blocks * sum(1 for n in step_lens if n > 1)
        n_decode = sum(1 for n in step_lens if n == 1)
        want = {"calls": len(step_lens), "eager": len({bucket_length(n) for n in step_lens if n > 1}) + 1,
                "captures": 1, "replays": n_decode - 1, "anomalies": 0}
        log(f"{label}: {name}: the private step program {programs} (every decode step from the second on a "
            f"replay: {want})")
        if programs != want:
            raise AssertionError(f"{label}: {name}: private step program counts {programs}, expected {want}")
        variants = sorted({m["variant"] for m in metas})
        decode = [m["compute_s"] for m, n in zip(metas, step_lens) if n == 1]
        log(f"{label}: {name}: steps of {step_lens[:2]}... tokens, max_length {max_length}, cache "
            f"{2 * n_blocks * batch * max_length * 8 * 128 * 2 / 2**20:.1f} MiB; variants {variants}; launches {launches} "
            f"(K4 must be {need}); prefill {metas[0]['compute_s'] * 1e3:.1f} ms for {batch} x {step_lens[0]} tokens, "
            f"decode step {statistics.median(decode) * 1e3:.3f} ms (median, queue included)")
        if variants != ["private"]:
            raise AssertionError(f"{label}: {name}: steps took {variants}, not the private path")
        if launches["K4"] != need or launches["K1"] or launches["K2"] or launches["K3"]:
            raise AssertionError(f"{label}: {name}: launches {launches}, K4 must be {need} and the paged kernels 0")
        for key, n in launches.items():
            total[key] = total.get(key, 0) + n
        params = [server.backend.block_params[i] for i in range(*blocks)]
        args = (server.family, server.cfg, inputs[0], inputs[1:], device)
        failed += check_session(
            outs, kv, reference_session(dense_reference_params(params, torch.bfloat16), *args, torch.bfloat16),
            reference_session(dense_reference_params(params, torch.float32), *args, torch.float32),
            f"{label}: {name}",
        )
    if failed:
        raise AssertionError("; ".join(failed))
    # phase 15's dense programs and the profile's dense rows, on the served weights
    check_dense_programs(server.backend, device, f"dense programs (--quant_type none, {SPAN} blocks)")
    profile_dense_steps(server.backend, device, smi)
    return total


def serve_dense_pool_and_check(ckpt, device):
    """Phase 11: the bf16 span with --page_size 0 (the dense lane pool) to
    phase 3's four sessions; replies against the dense references."""
    from petals_tpu_torch.cli.run_server import build_parser, build_server

    label = "dense pool (--page_size 0, bf16, 8 blocks)"
    cfg = MISTRAL_7B
    # chunk_plan's linear rule at batch 1: the activations of one token
    per_token = 2 * (2 * cfg["hidden_size"] + cfg["intermediate_size"] + cfg["num_attention_heads"] * cfg["head_dim"])
    server = build_server(build_parser().parse_args([
        ckpt, "--first_block", "0", "--num_blocks", str(SPAN), "--host", "127.0.0.1", "--page_size", "0",
        "--max_chunk_size_bytes", str(DENSE_CHUNK_TOKENS * per_token), *NO_PREFIX_CACHE,
    ]))

    async def serve():
        await server.start()
        try:
            b = server.batcher
            pool_bytes = sum(d.nbytes for d in server.backend.cache_descriptors(b.n_lanes, b.max_length, 0, SPAN))
            log(f"{label}: {b.n_lanes} lanes x {b.max_length} tokens, page_size {b.page_size}, pool "
                f"{pool_bytes / 2**20:.1f} MiB of a {server.memory_cache.max_size_bytes / 2**20:.1f} MiB budget")
            await drive_server(server, WARMUP_PROMPTS, 2, SEED + 5)
            before = dict(b.stats)
            steady = {name: _program_counts(getattr(server.backend, name)) for name in STEADY_DENSE_PROGRAMS}
            log(f"{label}: the pool's programs after warm-up: {json.dumps(steady)}")
            _reset_launch_counts()
            result = await drive_server(server, PROMPTS, DENSE_DECODE_STEPS, SEED + 4)
            late = {name: _count_delta(_program_counts(getattr(server.backend, name)), steady[name])
                    for name in STEADY_DENSE_PROGRAMS}
            stats = {k: v - before[k] if not k.startswith("max") else v for k, v in b.stats.items()}
            return result, _launch_counts(), stats, late
        finally:
            await server.shutdown()

    (inputs, replies, metas, timing, _), launches, stats, late = asyncio.run(serve())
    log(f"{label}: the pool's programs in the measured run: {json.dumps(late)}")
    check_graph_stats(label, stats)
    if any(c["captures"] for c in late.values()) or stats["graph_captures"]:
        raise AssertionError(f"{label}: the dense pool captured after its warm-up: {late}, {stats}")
    chunks = [server.backend.chunk_plan(1, n) for n in PROMPTS]
    if (late["_lane_program"]["replays"] != sum(len(p) for p in chunks)
            or late["_dense_decode_program"]["replays"] != stats["batched_steps"]):
        raise AssertionError(f"{label}: every prefill chunk and batched step must replay the pool's programs: "
                             f"{late}, chunk plans {chunks}, {stats['batched_steps']} batched steps")
    need = SPAN * sum(1 for plan in chunks for c in plan if c > 1)  # padded to >= 8 rows: K4's
    variants = sorted({m["variant"] for ms in metas for m in ms})
    decode = [m["compute_s"] for ms in metas for m in ms[1:]]
    log(f"{label}: stats of the measured run: {stats}; chunk plans {chunks}; variants {variants}; launches {launches} "
        f"(K4 must be {need}); prefill {sum(PROMPTS) / timing['prefill_wall_s']:.1f} tokens/s over {sum(PROMPTS)} tokens; "
        f"decode step {statistics.median(decode) * 1e3:.3f} ms (median batched-step compute), "
        f"{timing['decode_round_trip_ms']:.3f} ms client round trip")
    if variants != ["decode", "dense_prefill"]:
        raise AssertionError(f"{label}: steps took {variants}")
    if launches["K4"] != need or launches["K1"] or launches["K2"] or launches["K3"]:
        raise AssertionError(f"{label}: launches {launches}, K4 must be {need} and the paged kernels 0")
    if stats["exclusive_chunks"] != sum(len(p) for p in chunks if len(p) > 1) or not stats["batched_steps"]:
        raise AssertionError(f"{label}: stats {stats} do not show the chunked prefill and the batched steps")
    params_bf16 = dense_reference_params(server.backend.block_params, torch.bfloat16)
    params_f32 = dense_reference_params(server.backend.block_params, torch.float32)
    failed = []
    for (prompt, steps), got, n in zip(inputs, replies, PROMPTS):
        args = (server.family, server.cfg, prompt, steps, device)
        failed += check_session(
            got, None, reference_session(params_bf16, *args, torch.bfloat16),
            reference_session(params_f32, *args, torch.float32), f"{label}: session with a {n}-token prompt",
        )
    if failed:
        raise AssertionError("; ".join(failed))
    measure_dense_graph_pool(server.backend, server.batcher, device, label)
    return launches


async def _read_directory(peers, prefix, n_blocks):
    """The directory as a client reads it, through a query-only port node:
    (module infos of blocks [0, n_blocks), the address book)."""
    from petals_tpu_torch.data_structures import make_uid
    from petals_tpu_torch.dht import DHTNode
    from petals_tpu_torch.utils.dht_utils import get_remote_module_infos

    reader = await DHTNode.create(initial_peers=peers, client_mode=True)
    try:
        return await get_remote_module_infos(reader, [make_uid(prefix, i) for i in range(n_blocks)])
    finally:
        await reader.shutdown()


async def _drive_chain(chain, prompts, n_steps, seed, hsz):
    """Sessions through a chain of servers: each step's hidden states go to
    the first server, its reply to the next. ``chain`` lists (rpc client,
    uids) in block order. Returns the inputs, the last server's replies and
    the client's prefill and decode round-trip times."""
    from petals_tpu_torch.rpc.serialization import deserialize_array, serialize_array

    gen = torch.Generator().manual_seed(seed)
    inputs = [
        (torch.randn(1, n, hsz, generator=gen).to(torch.bfloat16),
         [torch.randn(1, 1, hsz, generator=gen).to(torch.bfloat16) for _ in range(n_steps)])
        for n in prompts
    ]

    async def session(prompt, steps):
        streams = []
        for client, uids in chain:
            stream = await client.open_stream("ptu.inference")
            await stream.send({"uids": uids, "max_length": prompt.shape[1] + n_steps, "batch_size": 1})
            if not (await stream.recv(timeout=120))["session_open"]:
                raise AssertionError("a chain session did not open")
            streams.append(stream)
        outs, times = [], []
        for h in [prompt] + steps:
            t0 = time.perf_counter()
            for stream in streams:
                await stream.send({"tensors": {"hidden": serialize_array(h)}})
                h = deserialize_array((await stream.recv(timeout=300))["tensors"]["hidden"])
            times.append(time.perf_counter() - t0)
            outs.append(h)
        for stream in streams:
            await stream.end()
        return outs, times

    results = await asyncio.gather(*(session(p, s) for p, s in inputs))
    return inputs, [r[0] for r in results], [r[1] for r in results]


def serve_swarm_and_check(ckpt, device, smi):
    """Phase 12: two port servers join a swarm and serve one model as a chain."""
    import petals_tpu_torch
    from petals_tpu_torch.cli.run_server import build_parser, build_server
    from petals_tpu_torch.data_structures import CHAIN_DELIMITER, ServerState, make_uid
    from petals_tpu_torch.dht import DHTNode, Identity
    from petals_tpu_torch.rpc.pool import ConnectionPool
    from petals_tpu_torch.server.block_utils import choose_num_blocks, device_memory_bytes
    from petals_tpu_torch.server.from_pretrained import get_block_config
    from petals_tpu_torch.utils.dht_utils import compute_spans

    label = "swarm (two port servers, bf16, blocks [0, 4) and [4, 8))"
    # a fresh throughput cache, so A's probe runs on the card here
    os.environ["PETALS_TPU_TORCH_CACHE"] = tempfile.mkdtemp(prefix="swarm-throughput-", dir=os.path.join(REPO, "build"))
    family, full_cfg = get_block_config(ckpt)  # the config keeps Mistral's 32 layers
    attn_cache_bytes = (2 * CLI_ATTN_CACHE_TOKENS * full_cfg.num_key_value_heads * full_cfg.head_dim * 2
                        * full_cfg.num_hidden_layers)
    sizes = {q: choose_num_blocks(family, full_cfg, quant_type=q, attn_cache_bytes=attn_cache_bytes, device=device)
             for q in ("none", "nf4a")}
    log(f"{label}: choose_num_blocks for Mistral-7B-v0.1 ({full_cfg.num_hidden_layers} layers) at the CLI's "
        f"{CLI_ATTN_CACHE_TOKENS}-token budget ({attn_cache_bytes / 2**30:.2f} GiB) on {device_memory_bytes(device) / 2**30:.2f} "
        f"GiB of card memory: {sizes['none']} blocks in bf16, {sizes['nf4a']} in nf4a ({smi})")

    async def run():
        boot = await DHTNode.create(host="127.0.0.1")
        peers = [boot.own_addr.to_string()]
        servers, pool = [], ConnectionPool(identity=Identity.generate())

        async def start(*span):
            server = build_server(build_parser().parse_args([
                ckpt, "--host", "127.0.0.1", "--initial_peers", *peers, "--update_period", str(SWARM_UPDATE_PERIOD),
                "--throughput", "auto", *NO_PREFIX_CACHE, *span,
            ]))
            t0 = time.perf_counter()
            await server.start()
            servers.append(server)
            return server, time.perf_counter() - t0

        try:
            _reset_launch_counts()
            a, a_s = await start("--first_block", "0", "--num_blocks", str(SWARM_HALF))
            probe_launches = _launch_counts()
            rps = a._rps_info
            log(f"{label}: server A started in {a_s:.1f} s; throughput probe on the card: inference_rps "
                f"{rps['inference_rps']:.1f} (one-lane paged decode steps a second, one block), forward_rps "
                f"{rps['forward_rps']:.1f} (tokens a second of a 1024-token forward, one block), network_rps "
                f"{rps['network_rps']:.1f}, throughput {rps['throughput']:.1f}; probe launches {probe_launches} ({smi})")
            b, b_s = await start("--num_blocks", str(SWARM_HALF))
            log(f"{label}: server B started in {b_s:.1f} s and placed itself at [{b.first_block}, "
                f"{b.first_block + b.num_blocks})")
            if b.first_block != SWARM_HALF:
                raise AssertionError(f"{label}: B placed itself at block {b.first_block}, not {SWARM_HALF}")
            ids = {a.dht.peer_id: "A", b.dht.peer_id: "B"}

            deadline = time.perf_counter() + SWARM_WAIT_S
            while True:  # A's next_pings holds B once one announce period has passed
                infos, addr_book = await _read_directory(peers, a.dht_prefix, SPAN)
                pings = infos[0].servers[a.dht.peer_id].next_pings or {}
                if b.dht.peer_id.to_string() in pings or time.perf_counter() > deadline:
                    break
                await asyncio.sleep(0.5)
            spans = compute_spans(infos)
            got = sorted((s.start, s.end, ids.get(pid, "?")) for pid, s in spans.items())
            log(f"{label}: directory: ONLINE spans {got}; A's next_pings {pings}")
            if got != [(0, SWARM_HALF, "A"), (SWARM_HALF, SPAN, "B")]:
                raise AssertionError(f"{label}: the directory holds the spans {got}")
            for pid, span in spans.items():
                info = span.server_info
                log(f"{label}: {ids[pid]} announces version {info.version}, throughput {info.throughput:.1f}, "
                    f"inference_rps {info.inference_rps:.1f}, forward_rps {info.forward_rps:.1f}, network_rps "
                    f"{info.network_rps:.1f}, cache_tokens_left {info.cache_tokens_left}, quant_type "
                    f"{info.quant_type}, compute_dtype {info.compute_dtype}, server_gen {info.server_gen}")
                if info.version != petals_tpu_torch.__version__ or not info.throughput > 0 or not (
                        info.cache_tokens_left or 0) > 0:
                    raise AssertionError(f"{label}: {ids[pid]} announces {info}")
            if b.dht.peer_id.to_string() not in pings:
                raise AssertionError(f"{label}: A's next_pings {pings} lacks B after {SWARM_WAIT_S} s")

            chain = []
            for server in (a, b):
                client = await pool.get_addr(addr_book[server.dht.peer_id])
                if await client.wait_authenticated() != server.dht.peer_id:
                    raise AssertionError(f"{label}: {ids[server.dht.peer_id]} did not prove its announced peer id")
                uids = CHAIN_DELIMITER.join(
                    make_uid(server.dht_prefix, i) for i in range(server.first_block, server.first_block + server.num_blocks))
                chain.append((client, uids))
            await _drive_chain(chain, (64,), 2, SEED + 5, a.cfg.hidden_size)  # warm-up
            _reset_launch_counts()
            result = await _drive_chain(chain, SWARM_PROMPTS, SWARM_STEPS, SEED + 12, a.cfg.hidden_size)
            launches = _launch_counts()
            stats = [dict(s.batcher.stats) for s in (a, b)]
            for name, st in zip("AB", stats):
                check_graph_stats(f"{label}: server {name}", st)

            await b.shutdown()
            servers.remove(b)
            infos, _ = await _read_directory(peers, a.dht_prefix, SPAN)
            states = [infos[i].servers[b.dht.peer_id].state if infos[i] and b.dht.peer_id in infos[i].servers else None
                      for i in range(SWARM_HALF, SPAN)]
            log(f"{label}: after B shut down, its records read {[None if s is None else s.name for s in states]}")
            if states != [ServerState.OFFLINE] * (SPAN - SWARM_HALF):
                raise AssertionError(f"{label}: B's records read {states} after it shut down, not OFFLINE")
            return result, launches, probe_launches, stats, [x.backend.block_params for x in (a, b)]
        finally:
            for server in servers:
                await server.shutdown()
            await pool.close()
            await boot.shutdown()

    t0 = time.perf_counter()
    (inputs, outs, times), launches, probe_launches, stats, params = asyncio.run(run())
    decode_ms = [t * 1e3 for ts in times for t in ts[1:]]
    log(f"{label}: chain of 2 servers x {SWARM_HALF} blocks: prefill round trip "
        f"{', '.join(f'{ts[0] * 1e3:.1f} ms ({n} tokens)' for ts, n in zip(times, SWARM_PROMPTS))}; decode step round "
        f"trip median {statistics.median(decode_ms):.3f} ms, max {max(decode_ms):.3f} ms over {len(decode_ms)} steps "
        f"({smi}); launches {launches}; batcher stats A {stats[0]}, B {stats[1]}")
    # a decode step runs K1 on each of the 8 blocks (the sessions' steps may
    # share one), a prefill chunk K2; the probe runs K1 and K4
    if launches["K1"] < SWARM_STEPS * SPAN or launches["K2"] < SPAN or not probe_launches["K4"] or not probe_launches["K1"]:
        raise AssertionError(f"{label}: launches {launches} (probe {probe_launches}) miss a kernel of the path")
    block_params = params[0] + params[1]
    params_bf16 = dense_reference_params(block_params, torch.bfloat16)
    params_f32 = dense_reference_params(block_params, torch.float32)
    family, cfg = get_block_config(ckpt)
    failed = []
    for (prompt, steps), got, n in zip(inputs, outs, SWARM_PROMPTS):
        args = (family, cfg, prompt, steps, device)
        failed += check_session(
            got, None, reference_session(params_bf16, *args, torch.bfloat16),
            reference_session(params_f32, *args, torch.float32), f"{label}: session with a {n}-token prompt",
        )
    if failed:
        raise AssertionError("; ".join(failed))
    log(f"{label}: phase done in {time.perf_counter() - t0:.1f} s")


class ClientRecorder:
    """Wraps a port DistributedModelForCausalLM: per inference session, each
    step's input hidden states (the embeddings the client sent), its
    hypo_ids, its round trip and the float32 logits the client read after
    it, and each server-side generation call (``generate_remote``: its
    input, the tokens asked and returned, its round trip, its sampling
    dict); per generate() call, the time to its first token's logits; the
    embed and head (logits to the host) times."""

    def __init__(self, model):
        self.sessions, self.embed_s, self.head_s, self.ttft_s = [], [], [], []
        self._current, self._call_t0 = None, None
        open_session, embed, host_logits, generate = (
            model.remote.inference_session, model.embed, model._host_logits, model.generate)

        def inference_session(**kwargs):
            session = open_session(**kwargs)
            entry = {"steps": [], "hypos": [], "logits": [], "step_s": [], "thread": threading.get_ident()}
            self.sessions.append(entry)
            step = session.step

            def timed_step(hidden, **step_kwargs):
                t0 = time.perf_counter()
                out = step(hidden, **step_kwargs)
                entry["step_s"].append(time.perf_counter() - t0)
                entry["steps"].append(hidden.detach().float().cpu())
                hypo = step_kwargs.get("hypo_ids")
                entry["hypos"].append(None if hypo is None else torch.as_tensor(hypo).clone())
                self._current = entry
                return out

            session.step = timed_step
            entry["gen"] = []
            generate_remote = session.generate_remote

            def timed_generate_remote(hidden, n_tokens, embed_fn, sampling=None):
                t0 = time.perf_counter()
                tokens = generate_remote(hidden, n_tokens, embed_fn, sampling=sampling)
                entry["gen"].append({"hidden": hidden.detach().float().cpu(), "asked": n_tokens, "tokens": tokens,
                                     "s": time.perf_counter() - t0, "sampling": sampling})
                return tokens

            session.generate_remote = timed_generate_remote
            return session

        def timed_embed(ids):
            t0 = time.perf_counter()
            out = embed(ids)
            torch.cuda.synchronize()
            self.embed_s.append(time.perf_counter() - t0)
            return out

        def timed_host_logits(out_hidden):
            t0 = time.perf_counter()
            logits = host_logits(out_hidden)  # on the host: the card is done
            self.head_s.append(time.perf_counter() - t0)
            self._current["logits"].append(torch.from_numpy(logits.copy()))
            if self._call_t0 is not None:
                self.ttft_s.append(time.perf_counter() - self._call_t0)
                self._call_t0 = None
            return logits

        def timed_generate(*args, **kwargs):
            self._call_t0 = time.perf_counter()
            return generate(*args, **kwargs)

        model.remote.inference_session = inference_session
        model.embed, model._host_logits, model.generate = timed_embed, timed_host_logits, timed_generate


def _reference_head(ckpt, device):
    """The checkpoint's embeddings (bf16, host), and its final norm then
    float32 head on the card: hidden [b, h] -> logits [b, vocab]."""
    from petals_tpu_torch.server.from_pretrained import get_block_config, load_tensors_with_prefixes

    _, cfg = get_block_config(ckpt)
    t = load_tensors_with_prefixes(ckpt, ("model.embed_tokens.", "model.norm.", "lm_head."), keep_full_names=True)
    head = t.get("lm_head.weight", t["model.embed_tokens.weight"]).to(device, torch.float32)
    norm = t["model.norm.weight"].to(device, torch.float32)

    def logits(h):
        h = h.to(device, torch.float32)
        return (h * torch.rsqrt((h * h).mean(-1, keepdim=True) + cfg.rms_norm_eps) * norm) @ head.t()

    return t["model.embed_tokens.weight"], logits


def _client_input_faults(tag, steps, hypos, got, tokens, prompt_len, embed):
    """What the client sent, held to its own tokens: the prompt step is the
    checkpoint's embeddings of the prompt (a beam's rows all begin with it);
    for a greedy, sampled or chat stream every later step is the embedding
    of the token chosen before it, so the steps laid end to end are the
    embeddings of the stream but its last token. A beam step's rows are
    rows of the table, each one of the 2 x beams tokens its parent lane's
    logits (the previous step's row hypo_ids names) rank highest: the beam
    search draws its candidates from those."""
    faults = []
    prompt_ids = torch.as_tensor(tokens[:, :prompt_len])
    if not torch.equal(steps[0], embed[prompt_ids].float().expand(steps[0].shape)):
        faults.append("the client's prompt hidden states are not the checkpoint's embeddings")
    if tag != "beam":
        sent = torch.cat(steps, dim=1)
        ids = torch.as_tensor(tokens[:, : tokens.shape[1] - 1])
        if sent.shape[:2] != ids.shape or not torch.equal(sent, embed[ids].float()):
            faults.append(f"the client's steps {tuple(sent.shape[:2])} are not the embeddings of its tokens "
                          f"{tuple(ids.shape)} but the last")
        return faults
    lanes = steps[0].shape[0]  # the smoke's beam streams are batch 1: a lane a beam
    for i in range(1, len(steps)):
        rows = steps[i][:, -1].to(torch.bfloat16)
        if steps[i].shape[1] != 1 or not torch.equal(rows.float(), steps[i][:, -1]):
            faults.append(f"beam step {i} is not one bf16 row a lane")
            continue
        parents = torch.arange(lanes) if hypos[i] is None else torch.as_tensor(hypos[i]).cpu()
        for lane in range(lanes):
            match = (embed == rows[lane]).all(-1).nonzero().flatten()
            top = got[i - 1][parents[lane]].topk(2 * lanes).indices
            if match.numel() == 0:
                faults.append(f"beam step {i} lane {lane}: the row is no row of the embedding table")
            elif not torch.isin(match, top).any():
                faults.append(f"beam step {i} lane {lane}: token {match.tolist()} is not among the "
                              f"{2 * lanes} its parent lane {int(parents[lane])}'s logits rank highest")
    return faults


def check_client_streams(label, entries, block_params, ckpt, device):
    """Each recorded session teacher-forced through a dense reference on the
    card: the client's inputs (held to its tokens by _client_input_faults)
    through the served blocks in bf16 and in float32 (reference_session,
    the servers' weights dequantized for a quantized span), then the final
    norm and a float32 head. The client's logits must lie within
    REPLY_NOISE_FACTOR times the bf16 reference's own error from float32 of
    the bf16 reference's (max-rel and mean-rel over the session's steps, as
    check_session holds replies); each greedy token's float32 reference
    logit within REPLY_NOISE_FACTOR times the largest absolute bf16 error
    of the reference's largest logit. ``entries``: (session, tag, tokens,
    prompt length), tag "greedy" or "other". Returns the list of what
    failed."""
    from petals_tpu_torch.server.from_pretrained import get_block_config

    family, cfg = get_block_config(ckpt)
    embed, ref_logits = _reference_head(ckpt, device)
    params_bf16 = dense_reference_params(block_params, torch.bfloat16)
    params_f32 = dense_reference_params(block_params, torch.float32)
    failed = []
    for n, (session, tag, tokens, prompt_len) in enumerate(entries):
        steps, hypos, got = session["steps"], session["hypos"], session["logits"]
        name = f"{label}: stream {n} ({tag}, batch {steps[0].shape[0]}, {len(steps)} steps)"
        input_faults = _client_input_faults(tag, steps, hypos, got, tokens, prompt_len, embed)
        failed += [f"{name}: {what}" for what in input_faults]
        args = (family, cfg, steps[0], steps[1:], device)
        want = [[ref_logits(o[:, -1]).cpu() for o in reference_session(p, *args, dtype, hypo_ids=hypos)[0]]
                for p, dtype in ((params_bf16, torch.bfloat16), (params_f32, torch.float32))]
        srv, noise = _rel_errors(got, want[0]), _rel_errors(want[0], want[1])
        tol = REPLY_NOISE_FACTOR * max((b - f).abs().max().item() for b, f in zip(*want))
        line = (f"{name}: logits vs the dense bf16 reference max-rel {srv[0]:.3e} mean-rel {srv[1]:.3e}; "
                f"bf16 reference vs float32 max-rel {noise[0]:.3e} mean-rel {noise[1]:.3e}")
        if any(h is not None for h in hypos):
            moved = sum(h is not None and not torch.equal(h, torch.arange(len(h))) for h in hypos)
            line += f"; {moved} of {len(hypos) - 1} hypo_ids steps reorder the lanes"
        if not input_faults:
            line += f"; every step's inputs held to the tokens ({'beam rows' if tag == 'beam' else 'embeddings'})"
        if srv[0] > REPLY_NOISE_FACTOR * noise[0] or srv[1] > REPLY_NOISE_FACTOR * noise[1]:
            failed.append(f"{name}: logits disagree with the dense reference beyond bf16 rounding")
        if tag == "greedy":
            new = torch.as_tensor(tokens[:, prompt_len:])
            if new.shape[1] != len(got):
                failed.append(f"{name}: {new.shape[1]} new tokens from {len(got)} steps' logits")
            else:
                gap = max((f.max(-1).values - f.gather(-1, new[:, i : i + 1])[:, 0]).max().item()
                          for i, f in enumerate(want[1]))
                line += f"; greedy tokens' reference logit at most {gap:.3e} below its max (tol {tol:.3e})"
                if gap > tol:
                    failed.append(f"{name}: a greedy token's reference logit is {gap:.3e} below the max (> {tol:.3e})")
        log(line)
    return failed


def drive_client(label, ckpt, device, smi, server_args, runs, place_check=None, after_runs=None):
    """Port servers built by the CLI (``server_args``: each one's span
    arguments), joined through a port DHT bootstrap on a loop thread of
    their own; then the port client, from_pretrained on the card, runs
    ``runs(model)`` (which returns the streams to check). The kernels'
    launch counters are set to 0 just before the client's runs and read
    just after; ``after_runs(servers)`` is called then, the servers still
    serving. Returns (the recorder, the streams, the launch counts, the
    servers' block params)."""
    from petals_tpu_torch.cli.run_server import build_parser, build_server
    from petals_tpu_torch.client import AutoDistributedModelForCausalLM
    from petals_tpu_torch.client.runtime import SwarmRuntime
    from petals_tpu_torch.dht import DHTNode

    loop = SwarmRuntime()  # the servers' loop thread; the client runs its own
    servers, boot = [], None
    try:
        boot = loop.run(DHTNode.create(host="127.0.0.1"), LOOP_TIMEOUT_S)
        peers = [boot.own_addr.to_string()]
        for args in server_args:
            server = build_server(build_parser().parse_args([
                ckpt, "--host", "127.0.0.1", "--initial_peers", *peers, "--update_period", str(SWARM_UPDATE_PERIOD),
                "--throughput", "auto", *NO_PREFIX_CACHE, *args,
            ]))
            t0 = time.perf_counter()
            loop.run(server.start(), LOOP_TIMEOUT_S)
            servers.append(server)
            log(f"{label}: server at [{server.first_block}, {server.first_block + server.num_blocks}) "
                f"(--quant_type {server.quant_type}) started in {time.perf_counter() - t0:.1f} s")
        if place_check is not None:
            place_check(servers)
        t0 = time.perf_counter()
        model = AutoDistributedModelForCausalLM.from_pretrained(ckpt, initial_peers=peers)
        torch.cuda.synchronize()
        log(f"{label}: client loaded in {time.perf_counter() - t0:.1f} s on {model.device}: "
            + ", ".join(f"{k} {tuple(v.shape)} {str(v.dtype).removeprefix('torch.')}"
                        for k, v in model.client_params.items()))
        if model.device.type != device.type or model.client_params["head"].dtype != torch.float32:
            raise AssertionError(f"{label}: the client's parameters are not on the card, or its head is not float32")
        try:
            rec = ClientRecorder(model)
            model.generate(torch.randint(0, model.cfg.vocab_size, (1, 64)).numpy(), max_new_tokens=2)  # warm-up
            for record in (rec.sessions, rec.embed_s, rec.head_s, rec.ttft_s):
                record.clear()
            _reset_launch_counts()
            streams = runs(model, rec)
            launches = dict(_launch_counts(), K5=_quant_launches())
            if after_runs is not None:
                after_runs(servers)
            for server in servers:
                check_graph_stats(f"{label}: server at [{server.first_block}, "
                                  f"{server.first_block + server.num_blocks})", server.batcher.stats)
        finally:
            model.close()
        return rec, streams, launches, [p for s in servers for p in s.backend.block_params]
    finally:
        for server in servers:
            loop.run(server.shutdown(), LOOP_TIMEOUT_S)
        if boot is not None:
            loop.run(boot.shutdown(), LOOP_TIMEOUT_S)
        loop.shutdown()


def _quant_launches():
    from petals_tpu_torch.ops import quant_matmul as qmm

    return sum(qmm.quant_decode_matmul.launches.values()) + sum(qmm.quant_prefill_matmul.launches.values())


def _client_timing_line(label, rec, session, smi):
    decode_ms = [t * 1e3 for t in session["step_s"][1:]]
    log(f"{label}: per-token round trip seen by the client (session.step, {len(decode_ms)} decode steps): "
        f"median {statistics.median(decode_ms):.3f} ms, max {max(decode_ms):.3f} ms; prefill round trip "
        f"{session['step_s'][0] * 1e3:.1f} ms; time to the first token {rec.ttft_s[0] * 1e3:.1f} ms; client embed "
        f"{statistics.median(rec.embed_s) * 1e3:.3f} ms and head (norm, float32 product, logits to the host) "
        f"{statistics.median(rec.head_s) * 1e3:.3f} ms a token (medians) ({smi})")


def serve_client_and_check(ckpt, device, smi):
    """Phase 13: the port client over a chain of two port servers."""
    label = f"client (two port servers, bf16, {SPAN} Mistral-7B blocks)"
    cut = cut_checkpoint(ckpt, os.path.join(ckpt, f"mistral-7b-{SPAN}-layers"), SPAN)

    def placed(servers):
        spans = [(s.first_block, s.num_blocks) for s in servers]
        if spans != [(0, SWARM_HALF), (SWARM_HALF, SWARM_HALF)]:
            raise AssertionError(f"{label}: the servers hold {spans}")

    gen = torch.Generator().manual_seed(SEED + 13)

    def ids(shape):
        return torch.randint(0, MISTRAL_7B["vocab_size"], shape, generator=gen).numpy()

    def runs(model, rec):
        streams = []
        prompt = ids((1, CLIENT_PROMPT))
        out = model.generate(prompt, max_new_tokens=CLIENT_NEW)
        streams.append((rec.sessions[-1], "greedy", out, CLIENT_PROMPT))
        batch = ids((2, 64))
        out = model.generate(batch, max_new_tokens=16)
        streams.append((rec.sessions[-1], "greedy", out, 64))
        prompt = ids((1, 64))
        a = model.generate(prompt, max_new_tokens=16, **CLIENT_SAMPLING)
        streams.append((rec.sessions[-1], "sampled", a, 64))
        b = model.generate(prompt, max_new_tokens=16, **CLIENT_SAMPLING)
        if not (a == b).all():
            raise AssertionError(f"{label}: two seeded sampling runs gave different streams")
        out = model.generate(prompt, max_new_tokens=8, num_beams=2)
        streams.append((rec.sessions[-1], "beam", out, 64))
        prompt = ids((1, 100))
        with model.inference_session(max_length=256):
            first = model.generate(prompt, max_new_tokens=8)
            second = model.generate(first, max_new_tokens=8)
        if not (second[:, : first.shape[1]] == first).all():
            raise AssertionError(f"{label}: the chat session's second call does not extend the first")
        streams.append((rec.sessions[-1], "greedy", second, 100))
        log(f"{label}: streams: greedy {CLIENT_NEW} tokens of a {CLIENT_PROMPT}-token prompt, a batch of 2 "
            f"(16 tokens), seeded sampling twice ({CLIENT_SAMPLING}; identical), 2-beam search (8 tokens), "
            f"a two-call chat session (8 + 8 tokens)")
        return streams

    t0 = time.perf_counter()
    rec, streams, launches, params = drive_client(
        label, cut, device, smi, [("--first_block", "0", "--num_blocks", str(SWARM_HALF)), ("--num_blocks", str(SWARM_HALF))],
        runs, place_check=placed,
    )
    _client_timing_line(label, rec, streams[0][0], smi)
    log(f"{label}: launches during the client's runs {launches}")
    if not (launches["K1"] > 0 and launches["K2"] > 0):
        raise AssertionError(f"{label}: K1 or K2 never ran on the client's path ({launches})")
    failed = check_client_streams(label, streams, params, cut, device)
    if failed:
        raise AssertionError("; ".join(failed))
    log(f"{label}: phase done in {time.perf_counter() - t0:.1f} s")
    return launches


def serve_qwen2_and_check(root, device, smi):
    """Phase 14: Qwen2.5-7B's widths (group 7, q/k/v biases), 4 blocks."""
    qdir = os.path.join(root, "qwen2.5-7b")
    os.makedirs(qdir)
    t0 = time.perf_counter()
    write_checkpoint(qdir, device, QWEN2_5_7B, QWEN_SPAN)
    log(f"checkpoint: {QWEN_SPAN} Qwen2.5-7B-shaped blocks and its client tensors written in "
        f"{time.perf_counter() - t0:.1f} s")
    counts = {}
    for quant_type in ("none", "nf4a"):
        server, launches = serve_and_check(
            qdir, device, quant_type, QWEN_SPAN, SWARM_PROMPTS, SWARM_STEPS, SEED + 14, WARMUP_PROMPTS,
        )
        del server
        free_card()
        counts[quant_type] = launches
    label = f"client (one port server, nf4a, {QWEN_SPAN} Qwen2.5-7B blocks)"
    cut = cut_checkpoint(qdir, os.path.join(root, f"qwen2.5-7b-{QWEN_SPAN}-layers"), QWEN_SPAN)
    gen = torch.Generator().manual_seed(SEED + 15)

    def runs(model, rec):
        prompt = torch.randint(0, QWEN2_5_7B["vocab_size"], (1, CLIENT_PROMPT), generator=gen).numpy()
        out = model.generate(prompt, max_new_tokens=QWEN_NEW)
        return [(rec.sessions[-1], "greedy", out, CLIENT_PROMPT)]

    rec, streams, launches, params = drive_client(
        label, cut, device, smi,
        # the per-token path, as before server-side generation (phase 16 drives that)
        [("--first_block", "0", "--num_blocks", str(QWEN_SPAN), "--quant_type", "nf4a", "--no_server_side_generation")],
        runs,
    )
    _client_timing_line(label, rec, streams[0][0], smi)
    log(f"{label}: launches during the client's run {launches}; served runs: bf16 K1 {counts['none']['K1']}, "
        f"K2 {counts['none']['K2']}; nf4a K1 {counts['nf4a']['K1']}, K2 {counts['nf4a']['K2']}, K5 decode "
        f"{counts['nf4a']['decode']}, K5 prefill {counts['nf4a']['prefill']} (group 7)")
    if not (launches["K1"] > 0 and launches["K2"] > 0 and launches["K5"] > 0):
        raise AssertionError(f"{label}: K1, K2 or K5 never ran on the client's path ({launches})")
    failed = check_client_streams(label, streams, params, cut, device)
    if failed:
        raise AssertionError("; ".join(failed))
    return counts, launches


def _gen_vectors(vocab, n_lanes, generating, seed):
    """Sampling vectors, previous tokens and use_token for a generation
    step: the generating lanes alternate greedy, sampled (GEN_SAMPLING) and
    greedy under GEN_PENALTY over a random seen mask."""
    from petals_tpu_torch.ops.sampling import sampling_vectors

    gen = torch.Generator().manual_seed(seed)
    vec = sampling_vectors(n_lanes, vocab)
    for lane in range(n_lanes):
        if lane % 3 == 1:
            vec["do_sample"][lane] = True
            vec["temperature"][lane] = GEN_SAMPLING["temperature"]
            vec["top_k"][lane] = GEN_SAMPLING["top_k"]
            vec["top_p"][lane] = GEN_SAMPLING["top_p"]
        elif lane % 3 == 2:
            vec["repetition_penalty"][lane] = GEN_PENALTY
            vec["seen_mask"][lane] = (torch.rand(vocab, generator=gen) < 0.01).numpy()
    vec["seeds"][:] = torch.randint(0, 2**31 - 1, (n_lanes,), generator=gen).numpy()
    vec["draw_idx"][:] = torch.randint(0, 64, (n_lanes,), generator=gen).numpy()
    tokens = torch.randint(0, vocab, (n_lanes,), generator=gen)
    use_token = torch.tensor(generating)
    return vec, tokens * use_token, use_token


def check_gen_step_program(backend, gen_params, device, label) -> dict:
    """The generation step's program against its eager loop (as phase 15
    holds the decode step): on a sibling of the served backend, seeded pools
    at PROFILE_LANES lanes on 1024-token tables, four steps whose lanes
    generate (greedy, sampled, penalised) or decode a hidden state, each
    replayed and run through the eager loop on a clone of the pools, the
    next step feeding the tokens the last one picked. Hidden states, tokens
    and every pool byte must be bit-equal; one capture, a replay a step."""
    sib = sibling_backend(backend)
    cfg, max_pages = sib.cfg, 1024 // PAGE
    replayed = _random_pools(sib, device, PROFILE_LANES * max_pages, SEED + 16)
    eager = _clone_pools(replayed)
    tables = torch.arange(PROFILE_LANES * max_pages, dtype=torch.int32).reshape(PROFILE_LANES, max_pages)
    positions = torch.tensor([64, 362, 661, 960], dtype=torch.int32)[:PROFILE_LANES]
    gen = torch.Generator().manual_seed(SEED + 17)
    generating = [lane != 1 for lane in range(PROFILE_LANES)]  # lane 1 decodes a hidden state
    vec, tokens, use_token = _gen_vectors(cfg.vocab_size, PROFILE_LANES, generating, SEED + 16)
    for step in range(4):
        hidden = torch.randn(PROFILE_LANES, 1, cfg.hidden_size, generator=gen)
        got_h, got_t, _ = sib.paged_gen_decode_step(gen_params, hidden, tokens, use_token, replayed, positions, tables,
                                                    sampling_vecs=vec)
        samp = sib._sampling_inputs(vec, device)
        want_h, want_t = sib._paged_gen_decode_eager(
            gen_params, hidden.to(torch.bfloat16).to(device), tokens.to(device), use_token.to(device), eager,
            positions.to(device), tables.to(device), samp)
        torch.cuda.synchronize()
        if not (torch.equal(got_h, want_h) and torch.equal(got_t, want_t)):
            raise AssertionError(f"{label}: replayed generation step {step} differs from its eager loop "
                                 f"(tokens {got_t.tolist()} vs {want_t.tolist()})")
        if not all(torch.equal(g, w) for g, w in zip(_pool_tensors(replayed), _pool_tensors(eager))):
            raise AssertionError(f"{label}: replayed generation step {step} wrote other pool bytes than its eager loop")
        tokens = torch.where(use_token, got_t.cpu(), 0)
        positions = positions + 1
        vec["draw_idx"] += 1
    stats = sib.step_program_stats()
    log(f"{label}: the generation step program bit-equal to its eager loop over 4 steps (hidden, tokens, pool "
        f"bytes; lanes generating greedy / sampled / penalised and one decoding); {stats}")
    if stats != {"graph_captures": 1, "graph_replays": 4, "graph_anomalies": 0}:
        raise AssertionError(f"{label}: expected 1 capture and 4 replays of the generation step, got {stats}")
    return stats


def _gen_input_faults(gen_calls, tokens, prompt_len, embed):
    """What the client sent on its fast path, held to its tokens: the first
    call's input is the embeddings of the prompt, each later one the
    embedding of the last token of the chunk before; the chunks' tokens laid
    end to end are the stream's new tokens."""
    faults, at = [], prompt_len
    for i, call in enumerate(gen_calls):
        want = embed[torch.as_tensor(tokens[:, :prompt_len] if i == 0 else tokens[:, at - 1 : at])].float()
        if not torch.equal(call["hidden"], want):
            faults.append(f"chunk {i}'s input is not the embeddings of the tokens before it")
        got = call["tokens"]
        if got is None or not (tokens[:, at : at + got.shape[1]] == got).all():
            faults.append(f"chunk {i}'s tokens are not the stream's")
            break
        at += got.shape[1]
    if at != tokens.shape[1]:
        faults.append(f"the chunks hold {at - prompt_len} of the stream's {tokens.shape[1] - prompt_len} new tokens")
    return faults


def _draw(logits, seen, kwargs, i):
    """The client's pick of new token ``i`` from float64 logits [1, vocab]:
    the repetition penalty over ``seen``, then argmax, or the inverse-CDF
    draw of ``uniform_for_draw(seed, i)`` on its numpy pipeline (as its
    per-token fallback draws). Returns (token, the penalized logits [vocab],
    the CDF or None, u or None)."""
    import numpy as np

    from petals_tpu_torch.client.remote_generation import (
        _softmax,
        _warp_scores,
        apply_repetition_penalty,
        uniform_for_draw,
    )

    z = apply_repetition_penalty(logits, seen, float(kwargs.get("repetition_penalty", 1.0)))
    if not kwargs.get("do_sample"):
        return int(z[0].argmax()), z[0], None, None
    warp = dict(temperature=kwargs["temperature"], top_k=kwargs.get("top_k"), top_p=kwargs.get("top_p"))
    cdf = np.cumsum(_softmax(_warp_scores(z, **warp))[0])
    u = uniform_for_draw(kwargs["seed"] % (1 << 31), i)
    return min(int((cdf < u).sum()), cdf.shape[0] - 1), z[0], cdf, u


def _off_interval(cdf, tok, u) -> float:
    """How far ``u`` lies outside token ``tok``'s CDF interval (0 inside)."""
    lo = cdf[tok - 1] if tok > 0 else 0.0
    return float(max(lo - u, u - cdf[tok], 0.0))


def check_gen_streams(label, entries, replayed, block_params, ckpt, device):
    """Each server-generated stream held two ways.

    The server's own logits: ``replayed`` holds, per stream (None for one
    whose prefill rode other chunks), the float32 logits the client read
    when it fed the same tokens through the same server per token (the
    decode step program, the same lanes and pages as the generation step
    program, whose blocks it shares). Every new token must be the client's
    pick on them (``_draw``: the penalty, then argmax or the inverse-CDF
    draw of ``uniform_for_draw(seed, i)``), but for a tie within float
    rounding of a boundary (a logit within GEN_TIE_LOGIT of the maximum, or
    ``u`` within GEN_TIE_CDF of the token's CDF interval): exact sampling,
    checked on the card.

    A dense reference: the prompt and every new token but the last,
    embedded, in one chunk through the served blocks in bf16 and float32,
    then the final norm and a float32 head (the network is causal, so a
    chunk's row i sees what step i saw). ``eps`` is REPLY_NOISE_FACTOR times
    the stream's largest |bf16 - float32| reference logit difference. A
    greedy token's float32 reference logit (after the penalty) must lie
    within ``eps`` of the maximum. A sampled token is the float32
    reference's draw, or a tie where ``u`` lies within the step's CDF noise
    (REPLY_NOISE_FACTOR times the bf16 and float32 references' largest CDF
    difference) of the token's interval, or beyond it; at random bf16
    weights the noise moves many draws, so these are counted and printed,
    and at least half of a stream's draws must be the reference's (a wrong
    uniform stream agrees on about one in ten).
    ``entries``: (recorded session, tokens, prompt length, generate
    kwargs). Returns (what failed, counts: tokens held to the server's own
    logits and their ties, sampled draws, those the dense reference moved
    within and beyond its noise)."""
    import numpy as np

    from petals_tpu_torch.server.from_pretrained import get_block_config

    family, cfg = get_block_config(ckpt)
    embed, ref_logits = _reference_head(ckpt, device)
    params = {dt: dense_reference_params(block_params, dt) for dt in (torch.bfloat16, torch.float32)}
    failed = []
    counts = dict.fromkeys(("own", "own_ties", "draws", "near", "beyond"), 0)
    for n, ((session, tokens, prompt_len, kwargs), own) in enumerate(zip(entries, replayed)):
        name = f"{label}: stream {n} ({kwargs or 'greedy'}, {tokens.shape[1] - prompt_len} tokens)"
        faults = _gen_input_faults(session["gen"], tokens, prompt_len, embed)
        failed += [f"{name}: {f}" for f in faults]
        x = embed[torch.as_tensor(tokens[:, :-1])].float()
        logits = {}
        for dt, p in params.items():
            out = reference_session(p, family, cfg, x, [], device, dt)[0][0]
            logits[dt] = ref_logits(out[0, prompt_len - 1 :]).cpu().double().numpy()
        noise = np.abs(logits[torch.bfloat16] - logits[torch.float32]).max()
        eps = REPLY_NOISE_FACTOR * noise
        sampled = bool(kwargs.get("do_sample"))
        worst, agree, near, beyond, own_ties, own_worst = 0.0, 0, 0, 0, 0, 0.0
        for i, tok in enumerate(int(t) for t in tokens[0, prompt_len:]):
            seen = tokens[:, : prompt_len + i]
            if own is not None:
                counts["own"] += 1
                pick, z, cdf, u = _draw(own[i : i + 1], seen, kwargs, i)
                if pick != tok:
                    miss = float(z.max() - z[tok]) if cdf is None else _off_interval(cdf, tok, u)
                    own_worst = max(own_worst, miss)
                    if miss <= (GEN_TIE_CDF if sampled else GEN_TIE_LOGIT):
                        own_ties += 1
                    else:
                        failed.append(f"{name}: token {i} is {tok}, the pick on the server's own logits {pick} "
                                      f"({'u' if sampled else 'logit'} {miss:.3e} off)")
            ref, z, cdf32, u = _draw(logits[torch.float32][i : i + 1], seen, kwargs, i)
            if not sampled:
                worst = max(worst, z.max() - z[tok])
                continue
            counts["draws"] += 1
            if ref == tok:
                agree += 1
                continue
            cdf16 = _draw(logits[torch.bfloat16][i : i + 1], seen, kwargs, i)[2]
            if _off_interval(cdf32, tok, u) <= REPLY_NOISE_FACTOR * np.abs(cdf16 - cdf32).max():
                near += 1
            else:
                beyond += 1
        counts["near"] += near
        counts["beyond"] += beyond
        counts["own_ties"] += own_ties
        line = f"{name}: reference bf16 vs float32 logits max {noise:.3e}"
        if own is not None:
            line += (f"; every token the client's pick on the server's own logits but {own_ties} ties "
                     f"(worst {own_worst:.2e} off)")
        if sampled:
            line += (f"; {agree} of {len(tokens[0]) - prompt_len} draws the dense float32 reference's, {near} within "
                     f"the step's CDF noise of it, {beyond} beyond")
            if agree * 2 < len(tokens[0]) - prompt_len:
                failed.append(f"{name}: only {agree} draws agree with the dense reference's")
        else:
            line += f"; each token's float32 reference logit at most {worst:.3e} below the max (tol {eps:.3e})"
            if worst > eps:
                failed.append(f"{name}: a greedy token's reference logit is {worst:.3e} below the max (> {eps:.3e})")
        if not faults:
            line += "; the client's inputs and the chunks held to the tokens"
        log(line)
    return failed, counts


def _server_logits(model, tokens, prompt_len, max_length=None):
    """The float32 logits [new tokens, vocab] the client reads when it feeds
    ``tokens`` (but the last) through the server per token, float64 on the
    host: what the server computed for each generated token. ``max_length``
    past the lanes' length puts the session on a private cache."""
    import numpy as np

    with model.remote.inference_session(max_length=max_length or tokens.shape[1]) as session:
        outs = [session.step(model.embed(tokens[:, :prompt_len]))[:, -1:]]
        for i in range(prompt_len, tokens.shape[1] - 1):
            outs.append(session.step(model.embed(tokens[:, i : i + 1])))
    return np.concatenate([model._host_logits(o) for o in outs]).astype(np.float64)


def serve_gen_and_check(ckpt, device, smi, quant_type) -> None:
    """Phase 16: server-side generation on the card. One port server built
    by the CLI serves every block of the 8-layer cut of the checkpoint (a
    whole model, cut in depth), with ``--quant_type``, GEN_LANES lanes in
    a GEN_CACHE_TOKENS budget; the port client runs, through its fast path:
    greedy GEN_NEW tokens from a GEN_PROMPT-token prompt; seeded sampling
    (GEN_SAMPLING) twice, whose streams must be identical; greedy under
    GEN_PENALTY; seeded sampling in a session longer than a lane
    (GEN_PRIVATE_MAX_LENGTH: a private cache, ``generate_tokens``' loop);
    greedy GEN_LONG_NEW tokens alone (the fast path's time per
    token: its chunks after the first); the per-token path alone (a
    pass-through logits processor keeps the client on it: the server's
    per-token round trip); then GEN_SESSIONS concurrent generating sessions
    (GEN_LONG_NEW tokens, greedy and sampled) beside one per-token session
    and a GEN_LATE_PROMPT-token prompt that arrives once they all generate,
    in one pool. Every generation step must replay the step program, with
    K1 on every block and, with nf4a weights, K5's decode kernel on every
    projection (counted around each call); no capture after warm-up;
    gen_steps > 0 and max_gen_lanes >= GEN_SESSIONS; a prefill chunk must
    have ridden a mixed step while lanes generated. Every stream is checked
    (check_gen_streams, check_client_streams for the per-token ones); the
    generation step's program is held bit-equal to its eager loop and
    profiled beside the decode step."""
    import concurrent.futures

    from petals_tpu_torch.ops import paged_flash_attention as pfa
    from petals_tpu_torch.ops import quant_matmul as qmm

    label = f"server-side generation (one port server, --quant_type {quant_type}, {SPAN} Mistral-7B blocks)"
    dst = os.path.join(ckpt, f"mistral-7b-{SPAN}-layers-gen-{quant_type}")
    cut = cut_checkpoint(ckpt, dst, SPAN)
    held, per_call, mixed_beside_gen, private_calls = [], [], [], []
    step_walls = {"_run_batch_gen": [], "_run_batch": []}  # the batcher's step bodies, host wall in ms

    def place(servers):
        (server,) = servers
        held.append(server)
        backend, batcher = server.backend, server.batcher
        if server.server_gen_params is None or not batcher.gen_params:
            raise AssertionError(f"{label}: the whole-model server holds no client leaves")
        nbytes = sum(t.numel() * t.element_size() for t in server.server_gen_params.values())
        log(f"{label}: client leaves {nbytes / 2**30:.3f} GiB on the card beside the weights, outside the "
            f"{server.memory_cache.max_size_bytes / 2**20:.1f} MiB KV budget; announce server_gen "
            f"{server._server_info(server._state).server_gen}")
        step, run_mixed = backend.paged_gen_decode_step, batcher._run_batch_mixed

        def counted(*args, **kwargs):
            before = (pfa.paged_flash_attend.launches, qmm.quant_decode_matmul.launches.get("nf4a", 0),
                      backend._gen_program.counts.captures, backend._gen_program.counts.replays)
            out = step(*args, **kwargs)
            after = (pfa.paged_flash_attend.launches, qmm.quant_decode_matmul.launches.get("nf4a", 0),
                     backend._gen_program.counts.captures, backend._gen_program.counts.replays)
            per_call.append(tuple(b - a for a, b in zip(before, after)))
            return out

        def mixed(batch, pf):
            mixed_beside_gen.append(len(batcher._gen_states))
            return run_mixed(batch, pf)

        backend.paged_gen_decode_step, batcher._run_batch_mixed = counted, mixed
        generate_tokens = backend.generate_tokens

        def private(*args, **kwargs):
            private_calls.append(args[4])
            return generate_tokens(*args, **kwargs)

        backend.generate_tokens = private
        for name, walls in step_walls.items():
            def timed(*args, _body=getattr(batcher, name), _walls=walls):
                t0 = time.perf_counter()
                out = _body(*args)
                _walls.append((time.perf_counter() - t0) * 1e3)
                return out

            setattr(batcher, name, timed)

    gen = torch.Generator().manual_seed(SEED + 16)

    def ids(n):
        return torch.randint(0, MISTRAL_7B["vocab_size"], (1, n), generator=gen).numpy()

    def runs(model, rec):
        first_call = len(per_call)
        streams, per_token = [], []

        def own_session():
            """This thread's last session (threads generate at once below)."""
            return [e for e in rec.sessions if e["thread"] == threading.get_ident()][-1]

        def stream(prompt, new, **kwargs):
            out = model.generate(prompt, max_new_tokens=new, **kwargs)
            return (own_session(), out, prompt.shape[1], kwargs)

        def per_token_stream(prompt, new):
            # a pass-through logits processor keeps the client on its per-token path
            out = model.generate(prompt, max_new_tokens=new, logits_processor=[lambda ids_, scores: scores])
            return (own_session(), "greedy", out, prompt.shape[1])

        streams.append(stream(ids(GEN_PROMPT), GEN_NEW))
        prompt = ids(64)
        a, b = stream(prompt, GEN_NEW, **GEN_SAMPLING), stream(prompt, GEN_NEW, **GEN_SAMPLING)
        if not (a[1] == b[1]).all():
            raise AssertionError(f"{label}: two seeded sampling runs gave different streams")
        streams.append(a)
        streams.append(stream(ids(64), GEN_NEW, repetition_penalty=GEN_PENALTY))
        # a session longer than a lane: a private cache, generate_tokens' loop
        with model.inference_session(max_length=GEN_PRIVATE_MAX_LENGTH):
            private_stream = stream(ids(64), GEN_NEW, **GEN_SAMPLING)
        g0 = len(step_walls["_run_batch_gen"])
        alone = stream(ids(64), GEN_LONG_NEW)
        streams.append(alone)
        d0 = len(step_walls["_run_batch"])
        per_token.append(per_token_stream(ids(64), GEN_NEW))
        alone_per_token = per_token[0][0]
        # the batcher's step bodies alone: generation steps, then decode steps
        walls = (step_walls["_run_batch_gen"][g0:], step_walls["_run_batch"][d0:])
        server = held[0]
        prompts = [ids(64) for _ in range(GEN_SESSIONS)]
        late, solo = ids(GEN_LATE_PROMPT), ids(64)

        def late_prompt():
            t0 = time.perf_counter()
            while len(server.batcher._gen_states) < GEN_SESSIONS:
                if time.perf_counter() - t0 > 60:
                    raise AssertionError(f"{label}: the {GEN_SESSIONS} sessions never generated together")
                time.sleep(0.0005)
            return stream(late, GEN_NEW)

        with concurrent.futures.ThreadPoolExecutor(GEN_SESSIONS + 2) as pool:
            gens = [pool.submit(stream, p, GEN_LONG_NEW, **(dict(GEN_SAMPLING, seed=i) if i % 2 else {}))
                    for i, p in enumerate(prompts)]
            tok = pool.submit(per_token_stream, solo, GEN_NEW)
            late_f = pool.submit(late_prompt)
            together = [f.result(timeout=600) for f in gens]
            per_token.append(tok.result(timeout=600))
            streams += together + [late_f.result(timeout=600)]
        # each stream's tokens fed back per token: the server's own logits
        # (the late prompt's prefill rode chunks cut under load: its rows
        # are rounded otherwise, so it is held to the dense reference only)
        replayed = [_server_logits(model, out, plen) for _, out, plen, _ in streams[:-1]] + [None]
        streams.append(private_stream)
        replayed.append(_server_logits(model, private_stream[1], 64, GEN_PRIVATE_MAX_LENGTH))
        calls = per_call[first_call:]
        return {"streams": streams, "per_token": per_token, "calls": calls, "alone": alone,
                "alone_per_token": alone_per_token, "together": together, "replayed": replayed,
                "walls": walls}

    def after(servers):
        server = servers[0]
        stats = server.batcher.stats
        log(f"{label}: batcher stats {json.dumps(stats)}")
        if not (stats["gen_steps"] > 0 and stats["max_gen_lanes"] >= GEN_SESSIONS):
            raise AssertionError(f"{label}: gen_steps {stats['gen_steps']}, max_gen_lanes {stats['max_gen_lanes']}")

    t0 = time.perf_counter()
    rec, result, launches, params = drive_client(
        label, cut, device, smi,
        [("--first_block", "0", "--num_blocks", str(SPAN), "--quant_type", quant_type, "--batch_lanes",
          str(GEN_LANES), "--attn_cache_tokens", str(GEN_CACHE_TOKENS))],
        runs, place_check=place, after_runs=after,
    )
    calls = result["calls"]
    k5_each = 4 * SPAN if quant_type == "nf4a" else 0
    bad = [c for c in calls if c != (SPAN, k5_each, 0, 1)]
    log(f"{label}: {len(calls)} generation steps during the runs, each (K1, K5 decode nf4a, captures, replays) "
        f"= {(SPAN, k5_each, 0, 1)} but {len(bad)}; launches during the runs {launches}; prefill chunks riding a mixed "
        f"step beside generating lanes: {sum(n > 0 for n in mixed_beside_gen)}")
    if not calls or bad:
        raise AssertionError(f"{label}: generation steps that were not one replay running K1 on every block"
                             f"{' and K5 on every projection' if k5_each else ''}: {bad[:5]}")
    if not any(n > 0 for n in mixed_beside_gen):
        raise AssertionError(f"{label}: no prefill chunk rode a mixed step while lanes generated")
    log(f"{label}: a private session's generation: generate_tokens ran {len(private_calls)} chunks "
        f"({sum(private_calls)} tokens)")
    if not private_calls:
        raise AssertionError(f"{label}: the private session did not generate through generate_tokens")

    # the fast path's time per token: chunks after the first (one fed token, 32 generated)
    def per_token_ms(entries):
        return statistics.median(c["s"] / c["tokens"].shape[1] * 1e3 for e in entries for c in e[0]["gen"][1:])

    alone, together = per_token_ms([result["alone"]]), per_token_ms(result["together"])
    step_ms = [t * 1e3 for t in result["alone_per_token"]["step_s"][1:]]
    gen_walls, dec_walls = result["walls"]
    log(f"{label}: the batcher's step bodies at one session (host wall on the compute thread, inputs built, "
        f"replay, results to the host; median): generation step {statistics.median(gen_walls):.3f} ms over "
        f"{len(gen_walls)}, decode step {statistics.median(dec_walls):.3f} ms over {len(dec_walls)} ({smi})")
    log(f"{label}: client time per generated token on the fast path (a chunk's round trip over its tokens, chunks "
        f"after the first, median): {alone:.3f} ms for 1 session, {together:.3f} ms for {GEN_SESSIONS} concurrent "
        f"sessions; the same server's per-token round trip (session.step, 1 session, {len(step_ms)} steps): median "
        f"{statistics.median(step_ms):.3f} ms ({smi})")
    failed, counts = check_gen_streams(label, result["streams"], result["replayed"], params, cut, device)
    failed += check_client_streams(label + ", per token", result["per_token"], params, cut, device)
    log(f"{label}: {len(result['streams'])} server-generated streams: {counts['own']} tokens held to the server's "
        f"own logits, {counts['own_ties']} ties within float rounding; of {counts['draws']} sampled draws the dense "
        f"reference's noise moved {counts['near']} within its CDF noise and {counts['beyond']} beyond")
    if failed:
        raise AssertionError("; ".join(failed))
    server = held[0]
    check_gen_step_program(server.backend, server.server_gen_params, device, label)
    check_private_gen_program(server.backend, server.server_gen_params, device, label)
    profile_steps(server.backend, device, gen_params=server.server_gen_params, smi=smi)
    log(f"{label}: phase done in {time.perf_counter() - t0:.1f} s")
    held.clear()


async def _prefix_session(client, uids, max_length, steps):
    """One session of ``steps`` ((hidden [1, n, h], extra step fields)).
    Returns its replies, each reply's step_meta and client-side wall."""
    from petals_tpu_torch.rpc.serialization import deserialize_array, serialize_array

    stream = await client.open_stream("ptu.inference")
    await stream.send({"uids": uids, "max_length": max_length, "batch_size": 1})
    if not (await stream.recv(timeout=120))["session_open"]:
        raise AssertionError("session did not open")
    outs, metas, walls, position = [], [], [], 0
    for hidden, extra in steps:
        t0 = time.perf_counter()
        await stream.send({"tensors": {"hidden": serialize_array(hidden)}, **extra})
        reply = await stream.recv(timeout=300)
        walls.append(time.perf_counter() - t0)
        position = extra.get("start_from_position", position) + hidden.shape[1]
        if reply["position"] != position:
            raise AssertionError(f"position {reply['position']}, expected {position}")
        outs.append(deserialize_array(reply["tensors"]["hidden"]))
        metas.append(reply["step_meta"])
    await stream.end()
    return outs, metas, walls


def serve_prefix_and_check(ckpt, device, smi, label, n_blocks, extra_args, private=False):
    """Phase 17: the prefix cache at its defaults. Sessions share a
    PREFIX_SHARED-token prompt with different tails; an exact match decodes;
    a session that hit rolls back into the cached prefix and rewrites it; a
    fresh exact match follows. Each session runs alone, its launches counted
    from 0, and every reply is held to the dense references without a cache.
    ``private`` opens the sessions past the lanes' length (private caches):
    the device tier is dropped after the first, so the second and third hit
    the host tier, which promotes the path, and a fourth hits the device
    tier."""
    from petals_tpu_torch.cli.run_server import build_parser, build_server
    from petals_tpu_torch.data_structures import CHAIN_DELIMITER, make_uid
    from petals_tpu_torch.ops import paged_flash_attention as pfa
    from petals_tpu_torch.rpc import RpcClient

    server = build_server(build_parser().parse_args([
        ckpt, "--first_block", "0", "--num_blocks", str(n_blocks), "--host", "127.0.0.1", *extra_args]))
    hsz = server.cfg.hidden_size
    gen = torch.Generator().manual_seed(SEED + 17)

    def rnd(n):
        return torch.randn(1, n, hsz, generator=gen).to(torch.bfloat16)

    shared = rnd(PREFIX_SHARED)
    p_a, p_b = (torch.cat([shared, rnd(n)], dim=1) for n in PREFIX_TAILS)
    dec = [(rnd(1), {}) for _ in range(PREFIX_EXACT_STEPS)]
    rewrite = [rnd(1) for _ in range(PREFIX_REWRITE)]
    warm = [(rnd(PREFIX_WARMUP), {})] + dec[:2]
    sessions = [("miss", [(p_a, {})] + dec[:PREFIX_STEPS]), ("hit", [(p_b, {})] + dec[:PREFIX_STEPS]),
                ("exact", [(shared, {})] + dec)]
    if private:
        sessions.append(("device hit", [(p_b, {})] + dec[:PREFIX_STEPS]))
    else:
        sessions += [
            ("rollback", [(p_a, {}), (rewrite[0], {"start_from_position": PREFIX_ROLLBACK})]
             + [(r, {}) for r in rewrite[1:]]),
            ("exact after rollback", [(shared, {})] + dec[:2]),
        ]
    uids = CHAIN_DELIMITER.join(make_uid(server.dht_prefix, i) for i in range(n_blocks))

    async def serve():
        await server.start()
        b, pc = server.batcher, server.handler.prefix_cache
        max_length = PREFIX_PRIVATE_MAX_LENGTH if private else b.max_length
        client = await RpcClient.connect("127.0.0.1", server.rpc_server.port)
        try:
            await _prefix_session(client, uids, max_length, warm)
            results = []
            for name, steps in sessions:
                if private and name == "hit":
                    pc._evict_device(0)  # the device tier dropped: the host tier serves
                if private and name == "device hit":
                    for _ in range(1000):  # the host-tier hits promote the path off the reply path
                        if pc.stats["promotions"] >= PREFIX_SHARED // 128:
                            break
                        await asyncio.sleep(0.01)
                forked = b._pages.stats["forked"] if b._pages is not None else 0
                before, cache_before = dict(b.stats), dict(pc.stats)
                _reset_launch_counts()
                outs, metas, walls = await _prefix_session(client, uids, max_length, steps)
                launches = _launch_counts()
                launches["K3 decode"] = dict(pfa.paged_flash_attend.kv_quant_launches)
                launches["K3 prefill"] = dict(pfa.paged_flash_prefill_attend.kv_quant_launches)
                results.append({
                    "outs": outs, "variants": [m["variant"] for m in metas], "server_s": metas[0]["total_s"],
                    "walls": walls, "launches": launches,
                    "stats": {k: v - before[k] for k, v in b.stats.items() if not k.startswith("max")},
                    "cache": {k: v - cache_before.get(k, 0) for k, v in pc.stats.items()},
                    "forked": (b._pages.stats["forked"] if b._pages is not None else 0) - forked,
                })
            info = await client.call("ptu.info", {}, timeout=10)
            pinned = sum(len(e.get("pages", ())) for e in pc._store.values())
            return results, info, pinned
        finally:
            await client.close()
            await server.shutdown()

    results, info, pinned = asyncio.run(serve())
    kvq = server.kv_quant_type
    dense_pool = not private and server.page_size == 0
    by_name = dict(zip((n for n, _ in sessions), results))
    for (name, _), r in zip(sessions, results):
        log(f"{label}: {name}: variants {r['variants']}; walls {[round(w * 1e3, 3) for w in r['walls']]} ms; "
            f"launches {r['launches']}; batcher {r['stats']}; cache {r['cache']}; forks {r['forked']}")
    log(f"{label}: ptu.info prefix_cache {info['prefix_cache']}; pool "
        f"{info['continuous_batching'].get('paged')}; {pinned} pages pinned by the cache")
    # every reply against the dense references without a cache
    params_bf16 = dense_reference_params(server.backend.block_params, torch.bfloat16)
    params_f32 = dense_reference_params(server.backend.block_params, torch.float32)
    failed = []

    def check(got, prompt, steps, what):
        args = (server.family, server.cfg, prompt, steps, device)
        failed.extend(check_session(
            got, None, reference_session(params_bf16, *args, torch.bfloat16, kvq),
            reference_session(params_f32, *args, torch.float32, kvq), f"{label}: {what}", kvq,
        ))

    for (name, steps), r in zip(sessions, results):
        if name == "rollback":
            check(r["outs"][:1], steps[0][0], [], "rollback session's prefill")
            # the rewrite continues the prompt's first PREFIX_ROLLBACK rows
            rows = torch.cat([p_a[:, :PREFIX_ROLLBACK], steps[1][0]], dim=1)
            got = [r["outs"][1]] + r["outs"][2:]
            args = (server.family, server.cfg, rows, [h for h, _ in steps[2:]], device)
            ref_bf16, ref_f32 = (reference_session(p, *args, dt, kvq) for p, dt in
                                 ((params_bf16, torch.bfloat16), (params_f32, torch.float32)))
            # the reference's first reply covers the whole prefix: keep its last row
            cut = [[outs[0][:, -1:]] + outs[1:] for outs in (ref_bf16[0], ref_f32[0])]
            failed.extend(check_session(got, None, (cut[0], ref_bf16[1]), (cut[1], ref_f32[1]),
                                        f"{label}: rewrite after the rollback", kvq))
        else:
            check(r["outs"], steps[0][0], [h for h, _ in steps[1:]], f"{name} session")
    if failed:
        raise AssertionError("; ".join(failed))
    miss, hit, exact = by_name["miss"], by_name["hit"], by_name["exact"]
    tail = PREFIX_TAILS[1]
    problems = []
    if exact["variants"][0] != "cached" or exact["stats"].get("prefill_tokens", 0) or exact["launches"]["K4"]:
        problems.append(f"the exact match ran work: {exact['variants']}, {exact['stats']}, {exact['launches']}")
    if hit["cache"]["hit_tokens"] != PREFIX_SHARED or miss["cache"]["stored_segments"] != PREFIX_SHARED // 128:
        problems.append(f"the hit / the store: {hit['cache']}, {miss['cache']}")
    if private:
        device_hit = by_name["device hit"]
        if hit["cache"].get("device_hits") or exact["cache"].get("device_hits") or \
                device_hit["cache"].get("device_hits") != 1:
            problems.append("the private session must hit the host tier twice, then the device tier")
        for r in (hit, device_hit):
            if r["launches"]["K4"] != n_blocks:  # the tail: one chunk of more than 8 rows a block
                problems.append(f"K4 did not run once a block on a hit's tail: {r['launches']}")
    elif dense_pool:
        if hit["cache"].get("device_hits") != 1 or hit["launches"]["K4"] != n_blocks:
            problems.append(f"the dense pool's hit: {hit['cache']}, {hit['launches']} (K4 once a block)")
    else:
        prefill = hit["launches"]["K2"] if kvq == "none" else hit["launches"]["K3 prefill"].get(kvq, 0)
        decode = hit["launches"]["K1"] if kvq == "none" else hit["launches"]["K3 decode"].get(kvq, 0)
        if hit["cache"].get("page_hits") != 1 or hit["stats"]["prefill_tokens"] != tail \
                or hit["stats"]["mixed_steps"] != 1 or prefill != n_blocks:
            problems.append(f"the page hit's tail did not run alone, on the paged prefill kernel: "
                            f"{hit['cache']}, {hit['stats']}, {hit['launches']}")
        if decode < PREFIX_STEPS * n_blocks:
            problems.append(f"the decode steps over adopted pages did not run the decode kernel: {hit['launches']}")
        if by_name["rollback"]["forked"] != 1:
            problems.append(f"the rollback forked {by_name['rollback']['forked']} pages, not 1")
        # the shared prompt's and the warm-up's segments, every page of each
        if pinned != (PREFIX_SHARED // 128 + PREFIX_WARMUP // 128) * (128 // server.page_size):
            problems.append(f"{pinned} pages pinned")
        if any(r["stats"]["graph_captures"] for r in results):
            problems.append("a step program was captured after the pool's warm-up")
    after = by_name.get("exact after rollback")
    if after is not None and not torch.equal(after["outs"][0], exact["outs"][0]):
        problems.append("the cached prefix changed after the rollback")
    if problems:
        raise AssertionError(f"{label}: " + "; ".join(problems))
    from petals_tpu_torch.server.prefix_cache import segment_keys

    hash_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        segment_keys(p_a, "salt")
        hash_s.append(time.perf_counter() - t0)
    first_step = miss["walls"][1]
    later = statistics.median(miss["walls"][2:])
    log(f"{label}: reply wall of the prefill (the server's own time from receipt to reply in brackets): miss "
        f"{miss['walls'][0] * 1e3:.3f} ms [{miss['server_s'] * 1e3:.3f}] ({PREFIX_SHARED + PREFIX_TAILS[0]} tokens "
        f"computed), hit {hit['walls'][0] * 1e3:.3f} ms [{hit['server_s'] * 1e3:.3f}] ({tail} computed, "
        f"{PREFIX_SHARED} cached), exact {exact['walls'][0] * 1e3:.3f} ms [{exact['server_s'] * 1e3:.3f}] (none "
        f"computed); the first step after the storing prefill {first_step * 1e3:.3f} ms against "
        f"{later * 1e3:.3f} ms for the later ones; hashing the {p_a.shape[1]}-token prompt on the host "
        f"{statistics.median(hash_s) * 1e3:.3f} ms; {smi}")


# phase 17's runs: (what, blocks, CLI arguments, private sessions)
PREFIX_RUNS = (
    ("bf16", SPAN, ("--batch_max_length", str(PREFIX_LANE)), False),
    ("--kv_quant_type nf4a", SHORT_SPAN, ("--batch_max_length", str(PREFIX_LANE), "--kv_quant_type", "nf4a"), False),
    ("--page_size 0", SHORT_SPAN, ("--batch_max_length", str(PREFIX_LANE), "--page_size", "0"), False),
    ("private sessions", SHORT_SPAN, (), True),
)


def serve_prefix_runs(ckpt, device, smi, names=None) -> None:
    """Phase 17's runs (those of ``names``, default all), one server each."""
    for what, n_blocks, args, private in PREFIX_RUNS:
        if names is None or what in names:
            label, t0 = f"prefix cache ({what}, {n_blocks} blocks)", time.perf_counter()
            serve_prefix_and_check(ckpt, device, smi, label, n_blocks, args, private)
            free_card()
            log(f"{label}: phase done in {time.perf_counter() - t0:.1f} s")


def free_card() -> None:
    """Free what a dropped server held on the card before the next one loads
    (its event-loop objects hold reference cycles, so collect them)."""
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # servers measure their throughput at start (--throughput auto) and cache
    # it here, inside the checkout
    os.environ.setdefault("PETALS_TPU_TORCH_CACHE", os.path.join(REPO, "build", "throughput-cache"))
    t_start = time.perf_counter()
    build()
    timer = Timer(device)
    dec_case, pf_case = attention_cases(device)
    kernels = check_attention_kernels(device, timer, dec_case, pf_case)
    # K1/K2 at Qwen2.5-7B's GQA group of 7 (28 query heads over 4), beside
    # Mistral-7B's 4: the same cases, no long ones
    for entry, g7 in zip(kernels, check_attention_kernels(device, timer, *attention_cases(device, 28, 4), long=False)):
        entry["group_7"] = {k: g7[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
    kv_kernels = [e for kind in KV_QUANT_KINDS for e in check_attention_kernels(device, timer, dec_case, pf_case, kind)]
    del dec_case, pf_case
    flash_kernel = check_flash_kernel(device, timer)
    quant_kernels = check_quant_kernels(device, timer)
    # K5 nf4a at Qwen2.5-7B's projections (phase 14's nf4a server runs them)
    for q in check_quant_kernels(device, timer, QWEN_QUANT_SHAPES, QWEN_QUANT_ROWS, ("nf4a",), QWEN_QUANT_REPORT,
                                 time_all=False, model="Qwen2.5-7B"):
        next(e for e in quant_kernels if e["name"] == q["name"])["qwen2_5_7b"] = {
            k: q[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
    log(f"kernel phases done at {time.perf_counter() - t_start:.1f} s")

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke-ckpt-", dir=os.path.join(REPO, "build")) as ckpt:
        t0 = time.perf_counter()
        write_checkpoint(ckpt, device)
        log(f"checkpoint: {SPAN} Mistral-7B-shaped blocks written in {time.perf_counter() - t0:.1f} s")

        # the bf16 span, then the same span quantized to nf4a
        server, bf16_launches = serve_and_check(ckpt, device, "none", SPAN, PROMPTS, DECODE_STEPS, SEED + 4, WARMUP_PROMPTS)
        # phase 15: the step programs against the eager loop, a bf16 pool
        # and both quantized pools over the served bf16 weights
        for kv in ("none",) + KV_QUANT_KINDS:
            check_step_programs(sibling_backend(server.backend, kv), device,
                                f"step programs (--quant_type none --kv_quant_type {kv}, {SPAN} blocks)")
        measure_graph_pool(server.backend, server.batcher, device, f"graph pool (--quant_type none, {SPAN} blocks)")
        profile_steps(server.backend, device)
        del server
        free_card()
        server, nf4a_launches = serve_and_check(ckpt, device, "nf4a", SPAN, PROMPTS, DECODE_STEPS, SEED + 4, WARMUP_PROMPTS)
        check_step_programs(server.backend, device, f"step programs (--quant_type nf4a, {SPAN} blocks)")
        # K5's decode kernel inside a dense graph: the private decode steps on 2 of the nf4a blocks
        check_dense_programs(sub_span_backend(server.backend, SHORT_SPAN), device,
                             f"dense programs (--quant_type nf4a, {SHORT_SPAN} blocks)", full=False)
        measure_graph_pool(server.backend, server.batcher, device, f"graph pool (--quant_type nf4a, {SPAN} blocks)")
        profile_steps(server.backend, device)
        del server
        free_card()
        # the bf16-weight span again, its KV pool quantized to nf4a
        server, kv_nf4a_launches = serve_and_check(
            ckpt, device, "none", SPAN, PROMPTS, DECODE_STEPS, SEED + 4, WARMUP_PROMPTS, "nf4a",
        )
        profile_steps(server.backend, device)
        del server
        free_card()
        log(f"main paths done at {time.perf_counter() - t_start:.1f} s")

        # every other arm, and K6, on the served path: 2 blocks, one session each
        arm_launches = {"nf4a": nf4a_launches}
        for kind in SHORT_KINDS:
            server, launches = serve_and_check(
                ckpt, device, kind, SHORT_SPAN, (SHORT_PROMPT,), SHORT_STEPS, SEED + 8, None,
            )
            check_step_programs(server.backend, device, f"step programs (--quant_type {kind}, {SHORT_SPAN} blocks)")
            del server
            free_card()
            arm_launches.setdefault(kind, launches)
        # K3's int8 arms, and the operator's combined setting
        kv_arm_launches = {"nf4a": kv_nf4a_launches}
        for quant_type, kv_quant_type in SHORT_KV_RUNS:
            server, launches = serve_and_check(
                ckpt, device, quant_type, SHORT_SPAN, (SHORT_PROMPT,), SHORT_STEPS, SEED + 8, None, kv_quant_type,
            )
            del server
            free_card()
            kv_arm_launches.setdefault(kv_quant_type, launches)
        log(f"earlier paths done at {time.perf_counter() - t_start:.1f} s")

        # dense caches: private sessions, then the dense lane pool
        private_launches = serve_private_and_check(ckpt, device, smi)
        free_card()
        serve_dense_pool_and_check(ckpt, device)
        free_card()
        # the swarm: two port servers, placed through the DHT, as one chain
        serve_swarm_and_check(ckpt, device, smi)
        free_card()
        # the port's client over a chain of two port servers
        serve_client_and_check(ckpt, device, smi)
        free_card()
        # Qwen2.5-7B's widths: served in bf16 and nf4a, then the client
        serve_qwen2_and_check(ckpt, device, smi)
        free_card()
        # server-side generation: one port server of the 8-block cut, bf16 then nf4a
        for quant_type in ("none", "nf4a"):
            serve_gen_and_check(ckpt, device, smi, quant_type)
            free_card()
        # the prefix cache at its defaults
        serve_prefix_runs(ckpt, device, smi)
    flash_kernel["launches"] = private_launches["K4"]
    kernels[0]["launches"] = bf16_launches["K1"]
    kernels[1]["launches"] = bf16_launches["K2"]
    for entry in kv_kernels:
        kind = entry["name"].split("[kv_")[1].rstrip("]")
        phase = "K3 decode" if entry["name"].startswith("paged_decode") else "K3 prefill"
        entry["launches"] = kv_arm_launches[kind][phase][kind]
    for entry in quant_kernels:
        phase = "decode" if entry["name"].startswith("quant_decode") else "prefill"
        arm = entry["name"].split("[")[1].rstrip("]")
        entry["launches"] = arm_launches[arm][phase][arm]
    from petals_tpu_torch.telemetry.observatory import get_observatory

    digest = get_observatory().compile_stats()
    log(f"step-program observatory: {digest}; by program {get_observatory().functions()}")
    if digest["anomalies"]:
        raise AssertionError(f"{digest['anomalies']} step-program captures after warm-up")
    log(f"done at {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels + kv_kernels + [flash_kernel] + quant_kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
