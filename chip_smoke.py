"""Drive petals_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

1. Build: compile every CUDA source of the port (csrc/paged_attention.cu,
   csrc/quant_matmul.cu, csrc/flash_attention.cu, csrc/grouped_matmul.cu)
   with nvcc (sm_90a) into build/kernels/, one nvcc
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
   K3 the plain version decodes the pool to float32, as the Pallas kernel
   and the card's kernels do: plain_pool). K1 on a bf16 pool is held tighter,
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
   vocabulary 152064, untied), depth cut to 2 blocks; served by one port
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
   GEN_SPAN-layer cut of the checkpoint served whole by one port server built by
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
18. Preemption to host memory and the wire (serve_swap_and_check,
   serve_relay_and_check; alone: scripts/smoke_swap_wire.py). 18a: one
   port server of the 8-block bf16 cut built by the CLI with --batch_lanes
   4, lanes of SWAP_LANE tokens, --n_pages SWAP_PAGES (half the lanes'
   peak), --swap_host_bytes SWAP_HOST_BYTES (48 pages) and the prefix cache
   off. Four sessions with prompts of 900, 700, 600 and 450 tokens (44
   pages at prefill), then SWAP_STEPS decode steps each in barrier rounds,
   so idle lanes hold their pages, then one more step a session, one
   session at a time (a lane preempted after its last round swaps in
   before it is released); session 0's is a SWAP_CHUNK-token prompt chunk
   right after its lane is swapped out by hand, so K2 reads moved pages.
   Checks: no AllocationFailed; swap_outs >= 1 and swap_ins == swap_outs;
   every reply within phase 3's tolerance of the dense reference; each
   swapped lane's rows, read through paged_lane_gather (and its pages'
   stored leaves) just before the swap-out and just after the swap-in,
   bit-equal; no step program captured after the warm-up; K1 on every block
   of every decode step and K2 on every block of the chunk after the
   swap-in. The same at 2 blocks on an nf4a pool (K3; codes and scales
   bit-equal through the round trip). Prints each swap's pages, MiB, ms
   and GB/s, the host memory kind, the oldest suspension and the peak of
   suspended sessions. 18b: on 18a's bf16 server a session at qint8 and the
   same session uncompressed: every qint8 reply element within
   absmax_block / 254 plus one float32 ulp of the uncompressed reply, which
   is held to the dense reference as phase 3 holds replies; the codec's
   time on a QINT8_REPLY reply. Then a port DHT bootstrap with its relay
   (run_dht's), a port server of the SHORT_SPAN-layer cut behind
   --relay_via, and the port client's greedy stream through the relay,
   equal token for token to its stream from the same server started again
   without the relay.
19. Sessions that move between port servers (serve_migration_and_check;
   alone: scripts/smoke_migration.py). Two servers of the 8-block cut built
   by the CLI (--phase_tier prefill and decode, one announced throughput,
   lanes of MIGRATE_LANE tokens, no server-side generation, the prefix
   cache off) and the port client, each run beside the same session
   unmoved: (c) a MIGRATE_SHORT_PROMPT-token prompt hands off to the
   decode tier after its prefill (ptu.session_handoff, kv_adopt) and
   decodes there; (a) a MIGRATE_PROMPT-token session with MIGRATE_STEPS
   decode steps, then its server drains without migrating, the client
   exports its KV and imports it into the other server (the export's and
   import's bytes and ms, client and server side), then a chat turn of
   MIGRATE_EXTRA tokens (a chunk over the imported pages) and
   MIGRATE_STEPS more; (e) the same for a private batch-2 session (the
   chunk runs K4 on the seeded dense cache); (b) a drain that pushes the
   session to the other server, where the client adopts it (the push's
   bytes and ms; 0 KV bytes over the client's link), again at SHORT_SPAN
   blocks on an nf4a pool, the packed entry on the wire; (d) a chain of
   two 4-block servers with use_server_to_server on and off (pushed
   steps served, copies skipped, per-token walls). Every bf16 stream
   equals its unmoved session's; the nf4a one up to the move, then the
   greedy picks of a reference that re-encodes its rows as the move does
   (ROADMAP C9). After each move, on the receiving server, K1 and K2 (K3's
   nf4a arms, K4) are held against their plain versions on the moved
   cache, and each must have launched on it; every moved session's logits
   are teacher-forced through the dense reference as phase 13 holds the
   client's; no capture after warm-up.
20. Server-side speculative decoding (serve_spec_and_check; alone:
   scripts/smoke_spec_decode.py): see its docstring.
21. The stateless forward, the integrity probe and the telemetry plane
   (serve_forward_telemetry_and_check, last; alone:
   scripts/smoke_forward_telemetry.py), on the 8-block cut with
   fingerprints enabled before any step program is captured. A bf16 server
   of the whole cut built by the CLI with --metrics_port 0 and --trace_dir
   (a torch.profiler capture of its first TRACE_SECONDS), then an nf4a
   server of blocks [4, 8) (a sub-span chain). (a) ``ptu.forward`` over the
   wire from the port's RemoteSequential: FWD_SHAPES (batch 1 x 512, batch
   2 x 300 with 16-row deep prompts, and 3 x 500 = 1500 tokens, which the
   client splits at its 1024-token bound), each shape three times (its
   eager call, its capture, a replay that must capture nothing), every
   output held to a dense bf16 reference as phase 3 holds replies (twice
   the reference's own rounding error from float32); K4 on every block of
   every call; on the nf4a chain K5's prefill kernel on every projection.
   Then FWD_LENGTHS distinct lengths, each twice: the forward program's
   graphs and the memory they keep reserved. (b) ``ptu.probe`` at
   PROBE_TOKENS tokens: a seed gives the same digest twice, bit for bit,
   two seeds give two digests, and each digest's relative gap from the
   float32 reference's and from the bf16 plain path's is printed beside
   ``tolerance_for("none")``; K4 runs on the 16-token probe, not the
   4-token one (a chunk under 8 rows takes plain attention); the nf4a
   chain probes its own span. (c) phase 3's four sessions: every reply's
   ``step_meta["fp"]`` within TOL_TRANSPORT of the digest of the hidden
   state received, an IntegrityMonitor fed every reply records no
   divergence, no capture after warm-up; the replayed bf16 decode step's
   device busy with and without ``with_fp``. (d) ``/metrics`` and
   ``/journal`` scraped over HTTP; the step counters by variant and the
   decode tokens equal the batcher's stats; the announce carries
   telemetry, compile_stats, integrity and metrics_port; the trace names
   K4's kernel. The phase prints its seconds.
22. BLOOM, Falcon and Mixtral (check_family_kernels right after phase 5,
   serve_families_and_check last; alone: scripts/smoke_families.py).
   (a) K1 and K2, with K3's int8 and nf4a arms, at Falcon's GQA groups
   (FAMILY_GROUPS: 71 query heads over 1 kv head, 232 over 8 = 29 and 128
   over 8 = 16, head_dim 64; the wide-group arm cuts a group of more than 16
   into tiles of at most 16 heads), and K1 and K2 with ALiBi at BLOOM-7b1's
   32 heads and BLOOM-176B's 112 (MHA, head_dim 128), each on phase 2's
   cases (8 decode lanes; a 512-row chunk at 0 and its 188-row
   continuation) against its plain version within phase 2's limits, timed
   beside gather + SDPA (ALiBi as an additive mask) and the bound; K4 at
   group 71 and with ALiBi (32 heads) at a 512-row chunk, bf16 and float32;
   K7, the grouped product of Mixtral's sparse experts, at Mixtral-8x7B's
   widths (1024 assignment rows over 8 experts of [4096, 14336] and [14336,
   4096], GROUPED_SIZES: one expert empty, one with half the rows): its
   bf16 arm (wgmma, TMA ring) against its plain version row by row within
   OUT_REL_TOL at every routing of GROUPED_ROUTINGS (skewed, uniform, one
   expert, the tile edges, one row, an 8-row and a 64-row chunk) and after
   in-place rewrites of the group sizes under one captured launch
   (GROUPED_REPLAYS), its float32 arm (CUDA cores) at a narrow case, timed
   beside torch._grouped_mm where the card's torch has it (timed here only)
   and the bound; the weight traffic its block order implies is printed
   as a model (grouped_weight_traffic), not measured. (b) Each family's
   span at a published config's full width (FAMILY_RUNS:
   bigscience/bloom-7b1, tiiuae/falcon-7b and mistralai/Mixtral-8x7B-v0.1 at 2), seeded
   bf16 weights written by the port's writer in HF's layout, served by one
   port server built by the
   CLI with its defaults to 3 sessions (600, 300 and 64 tokens, then 16
   decode steps) and checked as phase 3 checks (replies and K/V rows, K1
   and K2 on every block of every step, K7's bf16 arm on every Mixtral
   chunk's block, check_graph_stats); the references take the plain grouped
   product (plain_grouped_products); the Mixtral span's steps profiled as
   phase 4 profiles Mistral's, with the replayed mixed step's device busy
   split into K7, the MoE glue and the rest (profile_moe_step). Mixtral
   again with --quant_type nf4a at 2 blocks, one session (K5 on every
   projection, each expert's three). One greedy stream a family through
   the port's client, held as phase 13 holds its streams (BLOOM's
   embeddings through their LayerNorm).
23. Gemma, Gemma-2 and Phi-3 (alone: scripts/smoke_gemma_phi3.py). (a)
   check_gemma_phi3_kernels, right after phase 22's kernel cases: K1, K2,
   K3's int8 and nf4a arms and K4 at head_dim 256 and 96 (GEMMA_PHI3_CASES:
   Gemma-7B's 16 / 16 heads, Gemma-2B's 8 / 1, Gemma-2-9B's 16 / 8 with its
   attention softcap of 50 at window 4096 and at none, the same without the
   cap, Phi-3-mini's 32 / 32 of 96), each against its plain version (every
   arm of the capped cases on queries scaled so the cap bends the scores,
   and then also far from the uncapped plain version), timed beside
   its library call (none with a softcap: SDPA has none) and the bound. (b)
   serve_gemma_phi3_and_check: each family's span at its published widths
   (GEMMA_PHI3_RUNS, random bf16 weights, Gemma's zero-centred norms drawn
   small so the (1 + w) fold is exercised, Phi-3's LongRoPE with seeded
   factor lists of the published length) served and checked as phase 22
   serves its families (Gemma-2's 4600-token session crosses its sliding
   window; Phi-3's 4090-token session crosses 4096 while it decodes);
   Gemma-2-9B again at --quant_type nf4a and on an nf4a pool (2 blocks);
   then each family's client: a greedy per-token stream (Phi-3's crossing
   4096 as it decodes), Phi-3's server-side generation of a 4300-token
   prompt (its known length selects the long factors from the first chunk;
   teacher-forced step by step, check_gen_tokens), Gemma-2's stateless
   forward at eight lengths (K4 at head_dim 256 with the softcap; the
   forward's graphs at most one a bucket, C12) and Phi-3's at 3000 and 4200
   tokens (K4 at head_dim 96; LongRoPE's short and long factors), every
   forward held to the dense references.
24. Training and adapters (serve_training_and_check; alone:
   scripts/smoke_training.py). (a) The TRAIN_SPAN-block bf16 span served by the CLI:
   a port client's forward and ptu.backward of TRAIN_BATCH x TRAIN_SEQ
   tokens with TRAIN_PRE deep-prompt rows, grad_hidden and grad_prompts
   held to a float32 autograd reference over the plain blocks on the card
   (check_to_f32: within REPLY_NOISE_FACTOR times the bf16 reference's own
   distance from it); the backward's host wall, device busy (torch.profiler)
   and peak memory, and the shares of its plain pieces, the dequant-
   transpose and the attention backward (profile_backward). (c) Over the
   same server the port's client trains deep_ptune prompts TRAIN_STEPS SGD
   steps (the loss falls at each), its first step's grads held to the
   float32 reference of the whole pipeline, then one step of a classifier
   (a seeded score head of CLS_LABELS labels on the same blocks). (b) A
   TRAIN_SHORT-block cut at --quant_type nf4a and int8: the backward held
   to the dequantized references, K5 / K6 launched inside it, each
   projection's dequant-transpose timed. (d) Two seeded PEFT adapters
   written by the port's writer (rank ADAPTER_RANK on ADAPTER_TARGETS; rank
   8 on other projections) served with --adapters on the TRAIN_SHORT-block
   cut in bf16 and nf4a (QLoRA): the announce lists them, the span loads
   unfused, an adapter's forward and backward held to the references with
   the deltas merged, the other adapter's and the base's replies apart from
   it, switching between them after warm-up captures nothing, and an
   adapter session's greedy stream (server-side generation on a private
   cache, no lane) held as phase 16 holds greedy tokens.
25. Swarm operations (serve_swarm_ops_and_check, last; alone:
   scripts/smoke_swarm_ops.py), servers built by the CLI on one loop
   thread with a port DHT bootstrap. (a) An nf4a server of OPS_SPAN
   blocks started twice over one --cache_dir under build/: the cold start
   quantizes on the card and writes the quantized-block cache, the warm
   start reads it (every block a hit, the same bits); each start's session
   (a 300-token prompt, 8 steps) held to the references over the
   dequantized weights, K5 launched on both; both load walls printed. (b)
   Two bf16 servers at [0, 4) of the 8-block cut, one with
   --mean_balance_check_period: its balance loop must move it to [4, 8)
   (the move is waited for; a failed check only logs), its old span freed,
   its reload wall split into the load and the new pool's step programs; a
   session through the chain held to the references; then a third server
   at [0, 4) and the port's client: a greedy stream whose first server is
   resized to [4, 8) mid-stream (its KV pushed to the replica, the client
   adopting it there), the stream equal to the same prompt's undisturbed
   one (or, where two streams part, each held to the dense references:
   _same_or_tied). (c) A fourth server at [4, 8); a seeded chaos spec
   drops one stream open, fails one step, drops one announce and corrupts
   one replica's probe: the stream equals the unperturbed one, the plane's
   log and petals_chaos_injections_total count each rule once, and the
   quorum over three replicas names the corrupted one. (d) A seeded
   TrafficConfig (two tenants with shared prefixes, the clock time-scaled)
   replayed open-loop by run_schedule against a batched and a --no_batching
   server of the 4-block cut: every session completes, the two servers'
   streams equal (or tied), TTFT p50 / p99 and tokens/s printed beside the
   card. (e) The Autoscaler over HealthMonitor snapshots of (b)'s servers
   with the in-process server_actuator: its decision journal printed, its
   resize carried out by Server.resize. The kernels line carries the
   phase's launches of K1, K2, K4 and K5's nf4a arms (swarm_ops_launches).
26. Tensor parallelism on one card (serve_tensor_parallel_and_check, last;
   alone: scripts/smoke_tensor_parallel.py). (a) K4 at a shard's heads (16
   query over 4 kv heads) and K5 nf4a / K6 at a shard's projections of a
   Llama-3-8B block at tp=2 (TP_QUANT_SHAPES) against their plain versions,
   timed beside their bounds and yardsticks. (b) LLAMA3_8B's config over
   the smoke checkpoint's 8 blocks (linked) and client tensors of its own
   128256-token vocabulary, served by a tp=1 port server (--page_size 0)
   and a ``Server(num_tp_devices=2, tp_devices=[cuda:0, cuda:0])``, in bf16,
   nf4a and int8 at 2 blocks (each cut served whole); each gets
   a private batch-2 session (a 512-token prompt, 4 decode steps), 4 pooled
   sessions at once on the dense lane pool, a stateless forward and a
   ptu.backward of 512 tokens, and the bf16 tp server a server-side greedy
   generation. Every reply, the private cache's K/V rows, the forward and
   the gradient lie within REPLY_NOISE_FACTOR times the tp=1 server's
   distance from the float32 reference (_tp_within); the generation is
   teacher-forced (check_gen_tokens). The tp server pages nothing, keeps every shard on
   the card, captures no step program, reduces twice a block call, and
   launches K4, K5 nf4a and K6; the bf16 servers' decode step and 512-row
   chunk are profiled side by side (profile_tp_steps), and the throughput
   probe times the tp server's own kind of span.
27. Sequence parallelism on one card (serve_sequence_parallel_and_check;
   alone: scripts/smoke_sequence_parallel.py). K4 on the query
   shards' shapes (1024 rows at 1024 of 2048 and 256 at 256 of 512, at 32
   / 8 and 16 / 4 heads) and K5 nf4a / K6 prefill at a rank's 256 rows of a
   tp=2 shard's projections against their plain versions. Phase 26's
   checkpoint served by an unsharded port server beside (a) a
   ``num_sp_devices=2`` one (both ranks on cuda:0) at 4 blocks in bf16: a
   private 2048-token prompt and 8 decode steps, two pooled 1024-token
   prompts, a 4096-token forward (the ring) and a 2048-token ptu.backward;
   (b) a tp=2 x sp=2 one (four shards on cuda:0) at 2 blocks in bf16, nf4a
   and int8: a 512-token private session, forward and backward; (c) a tp=2
   one with a LoRA adapter (ROADMAP A14d) beside an unsharded one with the
   same adapter. Every reply, private K/V row, forward and gradient within
   REPLY_NOISE_FACTOR times the unsharded server's distance from float32;
   on each mesh server the dense lane pool, no step program, every weight
   on the card, tp x sp x sp folds a ring block call and K4 (K5 / K6 on
   quantized weights) launched; (a)'s distinct weight and KV pool bytes
   no more than sp=1's, its eager steps profiled beside sp=1's; a Gemma-2
   server at sp=2 and an sp-only nf4a span refused.
28. Multi-host lockstep on one card (serve_multihost_and_check, last;
   alone: scripts/smoke_multihost.py). Phase 26's checkpoint cut to 2
   blocks, served by an unsharded port server and by a two-process group:
   this process's ``Server(num_hosts=2)`` (the leader) and one ``python -m
   petals_tpu_torch.cli.run_worker --device cuda:0`` process, the data
   group on gloo (two processes on one card), for tp=2 in bf16, nf4a and
   int8 and for sp=2 in bf16: a private 512-token session and 4 decode
   steps (its K/V rows gathered from both processes), 2 pooled sessions
   (tp=2 bf16), a 512-token forward (2048 through the ring at sp=2) and a
   512-token ptu.backward. Every reply, K/V row and gradient within
   REPLY_NOISE_FACTOR times the unsharded server's distance from float32;
   K4, K5 and K6 launched on both processes (the worker's counts read from
   the file it writes after each op); the host wall of a 512-row chunk and
   a decode step on the group beside the unsharded and one-process tp=2
   backends'; then the worker killed, the leader's next op raising
   MultihostDegraded, the leader re-formed single-host, and its private
   session held to the unsharded server's. Each phase prints its seconds
   ("phase seconds: ...") as it ends, and all of them before the kernels
   line.

float32 matmuls run in full float32: TF32 is switched off for matmuls and
convolutions. Exits non-zero on any failure. The last line is the JSON
object ``{"ok": true, "device": {...}}``; the line before it lists the
kernels with their times, bounds and main-path launch counts, each with
``families`` (phase 22's cases and, for K1/K2, launches on each family's
served run) and ``gemma_phi3`` (phase 23's cases and launches), K7 last (its launches from the Mixtral run) (K1/K2 from
the bf16 run, K3's nf4a arms from the nf4a-pool run and its int8 arms from
the short int8-pool run, K5's nf4a arm from the nf4a run, its nf4 and int4
arms and K6 from their short runs, K4 from the private sessions' run), and
``migration_launches``: K1, K2, K3's nf4a arms and K4 on phase 19's moved
caches; ``forward_launches``: K4 and K5's nf4a prefill kernel on phase
21's stateless forwards; ``training``: K4, K5 and K6 on phase 24's
forwards, backwards and adapter sessions (with the backward's profile on
K4's entry and the quantized spans' on K5 nf4a's and K6's prefill entries);
``swarm_ops_launches``: K1, K2, K4 and K5's nf4a arms on phase 25's swarm
operations; ``tp_launches`` and ``tp``: K4, K5's nf4a arms and K6 on phase
26's tensor-parallel servers, and each one's case at a shard's shapes;
``sp_launches`` and ``sp``: the same on phase 27's sequence-parallel
servers, at a query shard's and a rank's rows' shapes; ``mh_launches``:
K4, K5's nf4a arms and K6 on phase 28's groups, on the leader and on the
worker.
Every run prints its lanes, pages and pool bytes.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import gc
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
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
# values cancel. Two roundings, doubled: ROW_REL_TOL. K3 prefill keeps
# KV_ROW_REL_TOL, four roundings with K's twice, from when its plain
# version decoded to bf16 and the kernel rounded nf4a's cubic once: two
# more roundings of every K and V value, K's moving the scores and so
# every probability. The plain version now decodes to float32
# (plain_pool) and the kernel's nf4a K to a bf16 pair (its V rounds
# once, as P does), so the rows sit well inside it. At 4000
# visible positions the outputs are
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
# K3 against its plain version on the same quantized pool, decoded to
# float32 (plain_pool) as the kernels decode it: the same KERNEL_TOL
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

KERNEL_SOURCES = ("paged_attention", "quant_matmul", "flash_attention", "grouped_matmul")

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
QWEN_SPAN = 2  # cut in depth from 4 to keep the smoke inside its limit
QWEN_NEW = 16
# phase 16: server-side generation over one port server of a GEN_SPAN-block cut
GEN_SPAN = 2  # the whole-model cut served (its depth cut from 4 to keep the smoke's time)
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
# no periodic announce inside a phase whose launch counts are exact: each
# announce runs the self-probe, whose forward launches K4 on every block
QUIET_ANNOUNCES = ("--update_period", "600")
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
# phase 18a: preemption to host memory. 4 lanes of SWAP_LANE tokens on
# SWAP_PAGES pages (half the lanes' peak of 64), a swap budget of 48 pages
# of the 8-block bf16 span; prompts of 44 pages at prefill, SWAP_STEPS
# decode steps each in barrier rounds (a lane waiting at the barrier holds
# its pages, idle), then one more step a session, one session at a time;
# session 0's is a SWAP_CHUNK-token prompt chunk after a forced swap-out
SWAP_PROMPTS = (900, 700, 600, 450)
SWAP_STEPS = 32
SWAP_LANE = 1024
SWAP_PAGES = 32
SWAP_HOST_BYTES = 96 * 2**20
SWAP_CHUNK = 64
# phase 18b: the wire. A qint8 session on 18a's server (a QINT8_PROMPT-token
# prompt and QINT8_STEPS steps), the codec timed on a reply of QINT8_REPLY;
# the port's client (RELAY_NEW greedy tokens of a RELAY_PROMPT-token prompt)
# through a relay to a server of the SHORT_SPAN-layer cut, and directly
QINT8_PROMPT = 300
QINT8_STEPS = 4
QINT8_REPLY = (1088, 4096)
RELAY_PROMPT = 64
RELAY_NEW = 16
# phase 19: KV migration between port servers. The 8-layer cut served whole
# by two servers of the CLI (the prefill and the decode tier, one announced
# throughput), lanes of MIGRATE_LANE tokens, 4 lanes in half the budget,
# per-token path (no server-side generation), the prefix cache off
MIGRATE_LANE = 2048
MIGRATE_CACHE_TOKENS = 4 * 2 * MIGRATE_LANE
MIGRATE_PROMPT = 1024  # run a: the session exported over the client's link
MIGRATE_STEPS = 16  # decode steps before and after each move
MIGRATE_EXTRA = 8  # tokens a chat turn appends after the move: a chunk over the moved pages
MIGRATE_SHORT_PROMPT = 300  # runs b and c (>= the client's prefill_tier_tokens)
MIGRATE_PRIVATE = (2, 64)  # run e: a private session's batch and prompt
PUSH_PROMPT, PUSH_NEW = 64, 16  # run d: the push chain of two 4-block servers
MIGRATE_HOLD_ROWS = 8  # the seeded caches' kernel holds: a chunk of this many rows
# phase 20: speculative decoding. Run a serves the 8-layer cut whole with
# the cut itself as an unquantized draft; run b serves a SPEC_DRAFT_BLOCKS-
# layer cut whole on an nf4a pool with that cut as its (default) nf4a draft.
# Each run: SPEC_SESSIONS concurrent sessions of SPEC_PROMPT-token prompts
# and SPEC_NEW generated tokens (two greedy, two sampled at SPEC_SAMPLING
# with fixed seeds), then the same sessions with the draft detached.
# Run a's contexts stay within SPEC_WINDOW, so the draft sees exact
# positions. Run b's sampled streams draw SPEC_SAMPLED_NEW tokens each: the
# rule that at least half of a stream's draws are the float32 reference's
# sits near its mean there (about 62% agree at random nf4a-pool weights,
# ROADMAP C14), so 32 draws fail a correct kernel about one time in
# eighteen (binomial), 128 about one in 550; a wrong uniform stream (about
# one draw in ten) fails more surely.
SPEC_K = 4
SPEC_WINDOW = 64
SPEC_PROMPT = 24
SPEC_NEW = 32
SPEC_SAMPLED_NEW = 128
SPEC_SESSIONS = 4
SPEC_SAMPLING = dict(do_sample=True, temperature=0.8, top_k=10)
SPEC_SEEDS = (11, 12)
SPEC_DRAFT_BLOCKS = 2
SPEC_GREEDY_ACCEPT = 0.9  # run a's greedy acceptance must exceed this
# the verify arm's kernels-line case: 4 lanes of S = SPEC_K + 1 rows at
# these positions on 1024-token tables (Mistral's window)
# phase 21: the stateless forward, the probe and the telemetry plane
FWD_SHAPES = ((1, 512, 0), (2, 300, 16), (3, 500, 0))  # (batch, seq, deep-prompt rows); 1500 tokens split at 1024
FWD_LENGTHS = (96, 160, 224, 288, 352, 416, 480, 544)  # distinct lengths a swarm client may send
FWD_SUB_SPAN = (4, 8)  # the nf4a server's blocks
PROBE_TOKENS = (4, 16)
SELF_PROBE_TOKENS = 4  # a server's self-probe at each announce (server.py _refresh_integrity)
PROBE_SEEDS = (101, 202)
TRACE_SECONDS = 8.0  # the --trace_dir capture's window from startup
SPEC_VERIFY_POSITIONS = (100, 400, 700, 1000)
# phase 22: BLOOM, Falcon and Mixtral. Each published config.json at full
# width, depth cut to the span served (the config says that many layers, so
# the client's model is every block served); random bf16 weights from SEED.
# bigscience/bloom-7b1: ALiBi over 32 heads (MHA), the fused per-head QKV
BLOOM_7B1 = {
    "model_type": "bloom", "architectures": ["BloomForCausalLM"], "hidden_size": 4096, "n_head": 32,
    "n_layer": 30, "layer_norm_epsilon": 1e-5, "vocab_size": 250880, "apply_residual_connection_post_layernorm": False,
    "tie_word_embeddings": True,
}
# tiiuae/falcon-7b: 71 query heads over one kv head (multi_query), parallel
# attention, rotary, no bias, no ALiBi
FALCON_7B = {
    "model_type": "falcon", "architectures": ["FalconForCausalLM"], "hidden_size": 4544, "num_attention_heads": 71,
    "num_hidden_layers": 32, "layer_norm_epsilon": 1e-5, "multi_query": True, "new_decoder_architecture": False,
    "parallel_attn": True, "bias": False, "alibi": False, "vocab_size": 65024,
}
# mistralai/Mixtral-8x7B-v0.1: 32 query heads over 8, 8 experts of 14336,
# top-2, rope_theta 1e6, no sliding window
MIXTRAL_8X7B = {
    "model_type": "mixtral", "architectures": ["MixtralForCausalLM"], "hidden_size": 4096,
    "intermediate_size": 14336, "num_attention_heads": 32, "num_key_value_heads": 8, "num_hidden_layers": 32,
    "num_local_experts": 8, "num_experts_per_tok": 2, "rms_norm_eps": 1e-5, "rope_theta": 1e6,
    "sliding_window": None, "vocab_size": 32000, "hidden_act": "silu", "tie_word_embeddings": False,
}
# Mixtral's seeded experts. A route flips when a token's second and third
# router logits lie within bf16 rounding of each other (~2% of the tokens a
# block at random weights, whatever the router's scale: the rounding is
# relative), so a bf16 network and its float32 twin pick different experts
# for some tokens. With independent random experts whose output outweighs
# the residual stream (HF's std 0.02 at these widths), one flipped decode
# token moves its whole reply, far past REPLY_BF16_MEAN_REL, and no
# comparison could judge the server. So the experts of a block share a base
# weight and differ by MIXTRAL_EXPERT_SPREAD of it, and w2 is drawn at
# MIXTRAL_W2_SCALE of HF's std: a flip then moves a token by ~4% of its
# size, while a row routed to a wrong expert, a wrong combine weight or a
# lost row still moves it past twice the reference's noise. K7 itself is
# held to its plain version on fully independent random experts (phase 22
# (a)).
MIXTRAL_EXPERT_SPREAD = 0.15
MIXTRAL_W2_SCALE = 0.25
# (config, blocks served) of each family's run: the depth cut to 2 blocks
# to keep the smoke's time (4 until phase 26 joined the run)
# depth cut from 2 blocks (4 before that) to keep the smoke inside its limit
FAMILY_RUNS = {"bloom": (BLOOM_7B1, 1), "falcon": (FALCON_7B, 1), "mixtral": (MIXTRAL_8X7B, 1)}
FAMILY_PROMPTS = (600, 300, 64)  # 600 > the 512-token prefill budget: a continuation chunk
FAMILY_STEPS = 16
FAMILY_NEW = 16  # the client's greedy tokens a family
FAMILY_QUANT_BLOCKS = 1  # Mixtral again at --quant_type nf4a: K5 per expert (cut from 2)
# the kernel cases: (query heads, kv heads, head_dim) at Falcon's GQA groups
# (Falcon-7B's 71 over 1, Falcon-180B's 232 over 8 = 29, Falcon-40B's 128
# over 8 = 16), head_dim 64; ALiBi at BLOOM-7b1's 32 heads and BLOOM-176B's
# 112, head_dim 128
FAMILY_GROUPS = {"group_71": (71, 1, 64), "group_29": (232, 8, 64), "group_16": (128, 8, 64)}
FAMILY_ALIBI = {"alibi_32": 32, "alibi_112": 112}
# phase 23: Gemma, Gemma-2 and Phi-3. Each published config.json at full
# width, depth cut to the span served, random bf16 weights from SEED (the
# zero-centred Gemma norms drawn small, so the (1 + w) fold is exercised).
# google/gemma-7b: 16 query heads over 16 at head_dim 256 (16 x 256 = 4096 >
# hidden 3072), the exact GeLU its config.json names, a tied head
GEMMA_7B = {
    "model_type": "gemma", "architectures": ["GemmaForCausalLM"], "hidden_size": 3072, "intermediate_size": 24576,
    "num_attention_heads": 16, "num_key_value_heads": 16, "head_dim": 256, "num_hidden_layers": 28,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "vocab_size": 256000, "hidden_act": "gelu",
    "max_position_embeddings": 8192,
}
# google/gemma-2-9b: 16 over 8 at 256, sliding window 4096 on the even
# layers (its config.json has no layer_types) and full attention on the odd,
# attention / final logit softcaps 50 / 30, query_pre_attn_scalar 256
GEMMA2_9B = {
    "model_type": "gemma2", "architectures": ["Gemma2ForCausalLM"], "hidden_size": 3584, "intermediate_size": 14336,
    "num_attention_heads": 16, "num_key_value_heads": 8, "head_dim": 256, "num_hidden_layers": 42,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "vocab_size": 256000, "hidden_activation": "gelu_pytorch_tanh",
    "sliding_window": 4096, "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
    "query_pre_attn_scalar": 256, "max_position_embeddings": 8192,
}
# microsoft/Phi-3-mini-128k-instruct: 32 over 32 at head_dim 96, fused
# qkv_proj / gate_up_proj, LongRoPE from 4096 to 131072 positions. Its
# published factor lists cannot be carried into the repository (nothing is
# downloaded): these are seeded lists of the published length (48 each),
# short near 1 and long growing along the head dim as the published ones do
_PHI3_RNG = np.random.default_rng(SEED + 23)
PHI3_MINI_128K = {
    "model_type": "phi3", "architectures": ["Phi3ForCausalLM"], "hidden_size": 3072, "intermediate_size": 8192,
    "num_attention_heads": 32, "num_key_value_heads": 32, "num_hidden_layers": 32, "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0, "vocab_size": 32064, "hidden_act": "silu", "max_position_embeddings": 131072,
    "original_max_position_embeddings": 4096, "sliding_window": 262144, "tie_word_embeddings": False,
    "rope_scaling": {"type": "longrope",
                     "short_factor": [float(x) for x in 1.0 + np.sort(_PHI3_RNG.uniform(0.0, 0.1, 48))],
                     "long_factor": [float(x) for x in 1.0 + np.sort(_PHI3_RNG.uniform(0.0, 60.0, 48))]},
}
# (config, blocks served, prompts of serve_and_check) of each family's run.
# Gemma-2's 4600-token prompt, chunked at the 512-token budget, crosses the
# sliding window; Phi-3's 4090-token prompt crosses 4096 during its decode
# steps, so the long factors take over mid-session (cached rows keep theirs)
# depth cut to keep the smoke inside its limit: Gemma-2's 2 blocks still
# hold a sliding and a full layer (cut from 4 / 8 / 4 blocks)
GEMMA_PHI3_RUNS = {"gemma": (GEMMA_7B, 1, (600, 300, 64)), "gemma2": (GEMMA2_9B, 2, (4600, 300, 64)),
                   "phi3": (PHI3_MINI_128K, 1, (4090, 300, 64))}
# lanes past 4600 tokens (an MHA server's sessions stop at 2048 tokens by default)
GEMMA_PHI3_LONG = ("--batch_max_length", "5120", "--attn_cache_tokens", "40960", "--inference_max_length", "8192")
PHI3_GEN_PROMPT = 4300  # server-side generation: chunks of a prompt whose known length crosses 4096
PHI3_DECODE_PROMPT = 4090  # the client's per-token stream crosses 4096 while it decodes
GEMMA_PHI3_QUANT_BLOCKS = 2  # Gemma-2-9B again at --quant_type nf4a, then on an nf4a pool
# the kernel cases: (query heads, kv heads, head_dim, softcap, timed window,
# query scale). Gemma-2-9B's queries are scaled by 8 (scores of std 8, the
# largest ~30) so that its cap of 50 bends them: the uncapped plain version
# is then ~0.5 away from the capped one (the served run holds the published
# scores)
GEMMA_PHI3_CASES = {
    "gemma_7b": (16, 16, 256, None, None, 1.0), "gemma_2b": (8, 1, 256, None, None, 1.0),
    "gemma2_9b_window": (16, 8, 256, 50.0, 4096, 8.0), "gemma2_9b_full": (16, 8, 256, 50.0, None, 8.0),
    "gemma2_9b_uncapped": (16, 8, 256, None, None, 8.0),  # the softcap's cost: the same call without it
    "phi3_mini": (32, 32, 96, None, None, 1.0),
}
GEMMA_PHI3_FWD_LENGTHS = (96, 160, 224, 288, 352, 416, 480, 544)  # C12: eight forward lengths, four buckets
# Phi-3's forwards (K4 at head_dim 96): 3000 tokens pad to the 4096 bucket,
# which LongRoPE counts as short (not past 4096), and 4200 take the long
# factors and pad to 8192. A forward's positions start at 0 and its buckets
# are powers of two up to 4096, so at the published boundary no real length
# on the short factors pads past it: the CPU tests hold n_valid's choice at
# a boundary inside a bucket
PHI3_FWD_LENGTHS = (3000, 4200)
# phase 24: training and adapters on the smoke's Mistral-7B checkpoint. (a)
# ptu.backward on the TRAIN_SPAN-block bf16 span: TRAIN_BATCH x TRAIN_SEQ tokens with
# TRAIN_PRE deep-prompt rows; (b) the same on TRAIN_SHORT blocks with nf4a
# and int8 weights; (c) the port's client trains TRAIN_PRE deep prompts on
# TRAIN_CLIENT_SEQ-token rows for TRAIN_STEPS SGD steps, each moving the
# largest prompt entry by TRAIN_STEP_SIZE, and takes one step of a
# classifier of CLS_LABELS labels; (d) two seeded PEFT adapters (rank
# ADAPTER_RANK on ADAPTER_TARGETS, the second rank 8 on other projections)
# served on TRAIN_SHORT blocks in bf16 and nf4a (QLoRA), an adapter session
# generating ADAPTER_NEW greedy tokens
TRAIN_BATCH, TRAIN_SEQ, TRAIN_PRE = 2, 512, 16
TRAIN_SPAN = 2  # (a) and (c)'s span: depth cut from the 8-block cut to keep the smoke inside its limit
TRAIN_SHORT = 2
TRAIN_CLIENT_SEQ = 128
TRAIN_STEPS = 3
TRAIN_STEP_SIZE = 1e-2
CLS_LABELS = 3
ADAPTER_RANK = 16
ADAPTER_TARGETS = ("self_attn.q_proj", "self_attn.v_proj", "mlp.down_proj")
ADAPTER_NEW = 16
ADAPTER_PROMPT = 64
# phase 25: swarm operations
OPS_SPAN = 4  # each server's blocks: the 8-block cut holds two spans
OPS_PROMPT = 300
OPS_STEPS = 8
OPS_NEW = 12  # the client's greedy tokens a stream
OPS_CUT_AT = 4  # tokens of a stream generated before its server moves
OPS_BALANCE_PERIOD = 1.0  # the moving server's --mean_balance_check_period
OPS_MOVE_WAIT_S = 60.0  # the longest wait for the balance loop's move
OPS_THROUGHPUT = {"A": 10.0, "B": 10.0, "C": 1.0, "D": 10.0, "E": 1.0}
OPS_TRAFFIC = dict(seed=SEED + 25, duration_s=8.0, base_rate=2.0, wave_period_s=8.0, tenants=2, prompt_prefix_len=48,
                   prompt_suffix_len=16, min_new_tokens=4, max_new_tokens=16)  # the model's vocabulary
OPS_TIME_SCALE = 0.5  # the schedule's 8 s replayed in 4 s
OPS_PROBE_SEED = 303
# phase 26: tensor parallelism, two shards of the one card. Meta-Llama-3-8B
# config.json (meta-llama/Meta-Llama-3-8B), depth cut to the TP_SPAN blocks
# served: its blocks are Mistral-7B's widths (the smoke checkpoint's block
# shards are linked), its own vocabulary and rope_theta; weights random
TP_SPAN = 8
LLAMA3_8B = {
    "model_type": "llama", "architectures": ["LlamaForCausalLM"],
    "hidden_size": 4096, "intermediate_size": 14336, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128, "num_hidden_layers": TP_SPAN,
    "rms_norm_eps": 1e-5, "rope_theta": 500000.0, "vocab_size": 128256, "hidden_act": "silu",
    "max_position_embeddings": 8192, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "attention_bias": False, "mlp_bias": False,
}
TP = 2
TP_PROMPT = 512
TP_STEPS = 4  # decode steps after each prompt
TP_LANES = 4
TP_BATCH = 2  # the private session's batch
TP_MAX_LENGTH = 1024
TP_GEN_NEW = 8
# each kind's depth cut, served whole (cut from 8 / 4 / 2 for the smoke's time)
TP_KINDS = (("none", 2), ("nf4a", 2), ("int8", 2))
# K5 / K6 at the shards' shapes of a Llama-3-8B block at tp=2 (unfused:
# the columns of wq / wk / wv / wg / wu and the rows of wo / wd halved)
TP_QUANT_SHAPES = {"wq": (4096, 2048), "wk": (4096, 512), "wo": (2048, 4096), "wg": (4096, 7168),
                   "wd": (7168, 4096)}
TP_QUANT_ROWS = (4, 512)  # the pool's 4 decode lanes, a 512-token prompt
TP_QUANT_REPORT = ("wg", (4, 512))
# phase 27: sequence parallelism on the one card, over phase 26's
# Llama-3-8B checkpoint. (a) sp=2 at SP_SPAN blocks, bf16: a private session
# of an SP_PRIVATE-token prompt and SP_PRIVATE_STEPS decode steps, two pooled
# sessions of SP_LANE_PROMPT tokens, a forward of SP_FORWARD tokens (the
# ring) and a ptu.backward of SP_BACKWARD; (b) tp=2 x sp=2 at SP_GRID_SPAN
# blocks in each of SP_GRID_KINDS: a private session of SP_GRID_PROMPT
# tokens, a forward and a backward of as many; (c) LoRA on a tp=2 span
# (A14d) at SP_LORA_SPAN blocks: an adapter session, forward and backward
SP = 2
SP_SPAN = 4  # (a)'s cut, served whole (cut from 8 for the smoke's time)
SP_PRIVATE = 2048
SP_PRIVATE_STEPS = 8
SP_MAX_LENGTH = 4096  # the private cache, and the servers' inference_max_length
SP_LANES = 2
SP_LANE_PROMPT = 1024
SP_LANE_STEPS = 4
SP_LANE_LENGTH = 2048
SP_FORWARD = 4096
SP_BACKWARD = 2048
SP_GRID_SPAN = 2
SP_GRID_KINDS = ("none", "nf4a", "int8")
SP_GRID_PROMPT = 512
SP_GRID_STEPS = 4
SP_LORA_SPAN = 2
# K4 on a query shard: (rows, offset) of the 2048-token prompt's rank 1 and
# of the 512-token one's, at a whole block's heads and a tp=2 shard's
SP_FLASH_CASES = ((1024, 1024), (256, 256))
SP_FLASH_HEADS = ((32, 8), (16, 4))
SP_QUANT_ROWS = (256,)  # a 512-token chunk's rank rows, on a tp=2 shard's projections
# phase 28: multi-host lockstep serving, a leader (this process) and one
# run_worker process sharing the card over gloo, at 2 blocks of Llama-3-8B:
# tp=2 in bf16 (then the worker killed and the leader re-formed
# single-host), nf4a and int8; sp=2 in bf16
MH_SPAN = 2
MH_PROMPT = 512
MH_STEPS = 4
MH_LANES = 2
MH_SP_FORWARD = 2048
MH_RUNS = (("none", 2, 1), ("nf4a", 2, 1), ("int8", 2, 1), ("none", 1, 2))  # (quant, tp, sp)
MH_TIMING_REPS = 20
# K7's case: a 512-row chunk at top-2 over Mixtral's 8 experts, skewed: one
# expert empty, one taking half the rows
GROUPED_SIZES = (512, 0, 160, 96, 64, 96, 48, 48)
# K7's bf16 arm is held to its plain version at these routings too, at both
# projections: the 512-row chunk's 1024 assignments uniform, all on one
# expert, and at the 128-row tile's edges; one row on one expert; the small
# chunks the sparse dispatch takes (8 rows: 16 assignments; 64 rows: 128)
GROUPED_ROUTINGS = {
    "skewed": GROUPED_SIZES,
    "uniform": (128,) * 8,
    "one expert": (0, 0, 0, 1024, 0, 0, 0, 0),
    "tile edges": (63, 64, 65, 127, 128, 129, 191, 257),
    "one row": (0, 0, 0, 0, 0, 1, 0, 0),
    "8-row chunk": (3, 0, 2, 4, 1, 0, 5, 1),
    "64-row chunk": (40, 7, 0, 21, 18, 9, 33, 0),
}
# one captured launch at the skewed routing, replayed after the group sizes
# were rewritten in place with these
GROUPED_REPLAYS = ("uniform", "tile edges")

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
# the MoE glue of a Mixtral mixed step, by a piece of its kernels' profile
# names (ATen's: sortKeyValueInplace's and cub's sorts, indexSelect*,
# _scatter_gather_elementwise_kernel, indexFunc* for index_add_)
MOE_GLUE = {"sort": ("sort", "Sort"), "gather": ("indexSelect",), "scatter-add": ("scatter_gather",),
            "index_add_": ("indexFunc",)}
# the port's kernels, by the name each has in a profile
PORT_KERNELS = ("paged_decode_kernel", "paged_prefill_wgmma_kernel", "paged_prefill_kernel", "flash_attention_kernel",
                "flash_wgmma_kernel", "quant_decode_ring_kernel", "quant_prefill_kernel", "split_reduce_kernel",
                "grouped_matmul_wgmma_kernel", "grouped_matmul_kernel")
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


def attention_cases(device, hq=32, hkv=8, d=128, q_scale=1.0):
    """The seeded inputs of the attention kernels at Mistral-7B widths (or
    ``hq`` query heads over ``hkv`` kv heads of ``d``): K1's 8 lanes (ragged
    positions up to 1023 on permuted tables with holes past each frontier,
    one lane idle at the sentinel) and K2's lane (a 512-row chunk at 0 and
    its 188-row continuation), bf16 pools; the queries times ``q_scale``
    (scores of that size: a softcap's case, where the cap must bend them)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
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
    q = (torch.randn(n_lanes, 1, hq, d, generator=gen, device=device) * q_scale).to(torch.bfloat16)
    window = MISTRAL_7B["sliding_window"]
    kv_lens = [min(p + 1, max_len) for p in positions.tolist()]
    decode = {
        "q": q, "kp": kp, "vp": vp, "tables": tables.to(device), "positions": positions.to(device),
        "active": slice(0, n_lanes - 1),  # the sentinel lane's output is never read
        "kv_lens": kv_lens,  # each lane's kv rows (the bound counts those its window leaves it)
    }
    max_pages2 = 1024 // PAGE
    n_pages2 = max_pages2 + 8
    perm2 = torch.randperm(n_pages2, generator=torch.Generator().manual_seed(SEED + 3))
    table_row = torch.full((max_pages2,), -1, dtype=torch.int32)
    table_row[: -(-(512 + 188) // PAGE)] = perm2[: -(-(512 + 188) // PAGE)].to(torch.int32)
    kp2 = torch.randn(n_pages2, PAGE, hkv, d, generator=gen, device=device).to(torch.bfloat16)
    vp2 = torch.randn(n_pages2, PAGE, hkv, d, generator=gen, device=device).to(torch.bfloat16)
    chunks = {pos: (torch.randn(1, n, hq, d, generator=gen, device=device) * q_scale).to(torch.bfloat16)
              for pos, n in ((0, 512), (512, 188))}
    prefill = {"kp": kp2, "vp": vp2, "table_row": table_row.to(device), "chunks": chunks}
    return decode, prefill


def _alibi_mask(mask, alibi, kv_pos):
    """A boolean mask [..., q, kv] as SDPA's additive mask in bf16 (the
    yardsticks' queries' type) with the ALiBi bias slopes[h] * j: [..., hq,
    q, kv] (no bias: the mask as it is). A hidden position takes bf16's
    lowest finite value, so a row that sees nothing stays finite, as the
    kernels' rows do."""
    if alibi is None:
        return mask
    bias = (alibi.float()[:, None, None] * kv_pos.float()).to(torch.bfloat16)
    return torch.where(mask.unsqueeze(-3), bias, torch.finfo(torch.bfloat16).min)


def _library_decode(case, kp, vp, window, alibi=None):
    """The yardstick for the decode kernels: the pages gathered (and
    dequantized) into a dense view, then PyTorch's fused attention (ALiBi as
    an additive mask)."""
    from petals_tpu_torch.ops.paged_attention import gather_pages

    q, tables, positions = case["q"], case["tables"], case["positions"]
    k = gather_pages(kp, tables).transpose(1, 2)
    v = gather_pages(vp, tables).transpose(1, 2)
    kv_pos = torch.arange(k.shape[2], device=q.device)
    pos = positions[:, None].long()
    mask = (kv_pos[None, :] <= pos) & (kv_pos[None, :] > pos - (window or k.shape[2]))
    mask = _alibi_mask(mask[:, None, :], alibi, kv_pos)  # [lanes, 1, kv] or [lanes, hq, 1, kv]
    return _sdpa(q.transpose(1, 2), k, v, mask if alibi is not None else mask[:, None]).transpose(1, 2)


def _library_prefill(kp, vp, table_row, qc, chunk_pos, window, alibi=None):
    """The yardstick for the prefill kernels: the lane's pages gathered (and
    dequantized) into a dense view, then PyTorch's fused attention with a
    mask (causal, the window, the chunk's end, holes; ALiBi added)."""
    from petals_tpu_torch.ops.paged_attention import gather_pages, slot_valid

    kv_len = chunk_pos + qc.shape[1]
    k = gather_pages(kp, table_row[None])[:, :kv_len].transpose(1, 2)
    v = gather_pages(vp, table_row[None])[:, :kv_len].transpose(1, 2)
    kv_pos = torch.arange(kv_len, device=qc.device)
    q_pos = chunk_pos + torch.arange(qc.shape[1], device=qc.device)
    mask = (kv_pos[None, :] <= q_pos[:, None]) & (kv_pos[None, :] > q_pos[:, None] - (window or kv_len))
    mask &= slot_valid(kp, table_row[None])[0, :kv_len][None, :]
    return _sdpa(qc.transpose(1, 2), k, v, _alibi_mask(mask, alibi, kv_pos)).transpose(1, 2)


def _prefill_work(table_row, n_pages, chunk_pos, n, window):
    """(kv rows some query row sees, visible (query, kv) pairs) of a chunk of
    ``n`` rows at ``chunk_pos``: slots on a hole are seen by none."""
    valid = (table_row >= 0) & (table_row < n_pages)
    valid = valid.cpu().repeat_interleave(PAGE)[: chunk_pos + n].long()
    seen = torch.cumsum(torch.cat([torch.zeros(1, dtype=torch.long), valid]), 0)  # seen[i] = valid slots < i
    q_pos = chunk_pos + torch.arange(n)
    lo = (q_pos - (window or chunk_pos + n) + 1).clamp_min(0)
    pairs = int((seen[q_pos + 1] - seen[lo]).sum())
    return int(seen[-1] - seen[int(lo[0])]), pairs


def library_yardstick(timer, library, softcap, kernel_ms, what):
    """The library call beside a kernel: (ms, log text) of one PyTorch call
    ``library`` that computes the kernel's function, timed; (None, "no
    library call") where a ``softcap`` is set, since SDPA has none."""
    if softcap is not None:
        return None, "no library call (SDPA has no softcap)"
    ms = timer(library)
    return ms, f"{ms:.4f} ms {what} (kernel {kernel_ms / ms:.3f}x)"


def plain_pool(pool):
    """A pool as the plain versions here read it, in float32: bf16 rows
    widened, a quantized pool decoded to float32 rows as the Pallas kernels
    decode it (``_quant_k_scores``). The plain wrappers decode a quantized
    pool to bfloat16, as petals_tpu's XLA twin does, which rounds each value
    the kernels keep in float32: at a softcap case's scores of ~30 that
    rounding alone moves an output past KERNEL_TOL."""
    from petals_tpu_torch.ops.paged_attention import PagedPool, dequantize_kv

    if isinstance(pool, PagedPool):
        return dequantize_kv(pool.codes, pool.scales, pool.kind, torch.float32)
    return pool.float()


def check_attention_kernels(device, timer, dec, pf, kind="none", long=True, alibi=None,
                            window=MISTRAL_7B["sliding_window"], softcap=None):
    """The decode and prefill kernels at one pool storage, against their
    plain versions in float32 (``plain_pool``): K1/K2 on the cases' bf16
    pools, or K3's ``kind`` arms on pools quantized on the card from them;
    ``long`` adds the long contexts and chunks; ``alibi`` (slopes [hq])
    passes ALiBi slopes to every call; ``window`` (None: full attention)
    is the timed calls' window; ``softcap`` passes Gemma-2's logit
    softcap to every call, and then no library call computes the same
    function (``library_ms`` None), and the kernels (on cases whose queries
    are scaled) must also disagree with the uncapped plain version: the cap
    bends their scores. Returns the two report entries (without main-path
    launch counts)."""
    from petals_tpu_torch.ops import paged_flash_attention as pfa
    from petals_tpu_torch.ops.paged_attention import (
        PagedPool,
        kv_wire_bytes_per_token,
        paged_attend,
        paged_prefill_attend,
        quantize_kv_rows,
    )

    hq, hkv, d = dec["q"].shape[2], dec["kp"].shape[2], dec["kp"].shape[3]
    if kind == "none":
        kp, vp, kp2, vp2 = dec["kp"], dec["vp"], pf["kp"], pf["vp"]
        label, names, where = "", ("K1", "K2"), ("220", "488")
    else:
        kp, vp, kp2, vp2 = (PagedPool(*quantize_kv_rows(p, kind)) for p in (dec["kp"], dec["vp"], pf["kp"], pf["vp"]))
        label, names, where = f"[kv_{kind}]", (f"K3 {kind} decode", f"K3 {kind} prefill"), ("150", "150")
    if hq // hkv != 4:  # not Mistral-7B's group
        names = tuple(f"{name} at group {hq // hkv}" for name in names)
    if alibi is not None:
        names = tuple(f"{name} with ALiBi ({hq} heads, head_dim {d})" for name in names)
    if d not in (64, 128) or softcap is not None:
        names = tuple(f"{name} at {hq} / {hkv} heads of {d}" + (f", softcap {softcap:g}, window {window}"
                                                                  if softcap is not None else "") for name in names)
    ab = dict(alibi_slopes=alibi, softcap=softcap)
    side_bytes = kv_wire_bytes_per_token(hkv, d, kind)  # one token row of k (or v) of one block

    # ---- decode
    q, tables, positions, active = dec["q"], dec["tables"], dec["positions"], dec["active"]
    dec_err = 0.0
    for w in (None, 4096, 200):
        got = pfa.paged_flash_attend(q, kp, vp, tables, positions, sliding_window=w, **ab)
        torch.cuda.synchronize()
        want = paged_attend(q.float(), plain_pool(kp), plain_pool(vp), tables, positions, sliding_window=w, **ab)
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
        if softcap is not None:
            uncapped = paged_attend(q.float(), plain_pool(kp), plain_pool(vp), tables, positions, sliding_window=w,
                                    alibi_slopes=alibi)
            off = (got[active].float() - uncapped[active]).abs().max().item()
            log(f"{names[0]}, window={w}: the uncapped plain version is {off:.3e} away")
            if off <= 10 * KERNEL_TOL:
                raise AssertionError(f"{names[0]} window={w}: the softcap does not bend these scores ({off:.3e})")
    rows = sum(_visible(kl - 1, kl, window) for kl in dec["kv_lens"])
    dec_bytes = 2 * rows * side_bytes + 2 * q.numel() * 2 + tables.numel() * 4 + positions.numel() * 4
    dec_bound, dec_by = bound_ms(dec_bytes, 4 * hq * d * rows)
    decode = {
        "name": f"paged_decode_attention{label}", "route": "cuda",
        "source": "petals_tpu_torch/csrc/paged_attention.cu",
        "replaces": f"petals_tpu/ops/paged_flash_attention.py:{where[0]}",
        "max_abs_err": dec_err,
        "ms": timer(lambda: pfa.paged_flash_attend(q, kp, vp, tables, positions, sliding_window=window, **ab)),
        "plain_ms": timer(lambda: paged_attend(q, kp, vp, tables, positions, sliding_window=window, **ab)),
        "bound_ms": dec_bound, "bound_by": dec_by,
    }
    library = lambda: _library_decode(dec, kp, vp, window, alibi)  # noqa: E731
    lib_err = float("nan") if softcap is not None else (library()[active].float() - paged_attend(
        q.float(), plain_pool(kp), plain_pool(vp), tables, positions, sliding_window=window, **ab)[active]
    ).abs().max().item()
    decode["library_ms"], yardstick = library_yardstick(timer, library, softcap, decode["ms"],
                                                        f"gather+SDPA, its err {lib_err:.3e}")
    decode["library_factor"] = None if softcap is not None else decode["ms"] / decode["library_ms"]
    kv_code = 0 if kind == "none" else pfa._KV_CODES[kind]
    per_sm = pfa.decode_blocks_per_sm(device, q.dtype, kv_code, hq, hkv, d)
    splits = pfa.decode_split_plan(q.shape[0], hkv, tables.shape[1] * PAGE, _sm_count(device), hq // hkv, per_sm)
    log(f"{names[0]} at 8 lanes, window {window}: {decode['ms']:.4f} ms kernel, {decode['plain_ms']:.4f} ms plain, "
        f"{yardstick}, bound {dec_bound:.4f} ms ({dec_by}, {dec_bytes / 1e6:.2f} MB), {splits} splits "
        f"({per_sm} blocks an SM)")
    # the split merge is deterministic: the same bits whichever block merges
    first = pfa.paged_flash_attend(q, kp, vp, tables, positions, sliding_window=window, **ab)
    for _ in range(DECODE_REPEATS):
        if not torch.equal(pfa.paged_flash_attend(q, kp, vp, tables, positions, sliding_window=window, **ab), first):
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
        got = pfa.paged_flash_prefill_attend(qc, kp2, vp2, table_row, cp, nv, sliding_window=window, **ab)
        torch.cuda.synchronize()
        want = paged_prefill_attend(
            qc.float(), plain_pool(kp2), plain_pool(vp2), table_row, chunk_pos, n, sliding_window=window, **ab
        )
        pf_err = max(pf_err, check_rows(f"{names[1]}, chunk_pos={chunk_pos}, {n} rows", got, want, rel_tol))
        if softcap is not None:
            uncapped = paged_prefill_attend(qc.float(), plain_pool(kp2), plain_pool(vp2), table_row, chunk_pos, n,
                                            sliding_window=window, alibi_slopes=alibi)
            off = (got.float() - uncapped).abs().max().item()
            log(f"{names[1]}, chunk_pos={chunk_pos}: the uncapped plain version is {off:.3e} away")
            if off <= 10 * KERNEL_TOL:
                raise AssertionError(f"{names[1]}: the softcap does not bend these scores ({off:.3e})")
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
        "ms": timer(lambda: pfa.paged_flash_prefill_attend(qc, kp2, vp2, table_row, *at0, sliding_window=window, **ab)),
        "plain_ms": timer(lambda: paged_prefill_attend(qc, kp2, vp2, table_row, 0, n, sliding_window=window, **ab)),
        "bound_ms": pf_bound, "bound_by": pf_by,
    }
    prefill["library_ms"], yardstick = library_yardstick(
        timer, lambda: _library_prefill(kp2, vp2, table_row, qc, 0, window, alibi), softcap, prefill["ms"],
        "gather+SDPA")
    prefill["library_factor"] = None if softcap is not None else prefill["ms"] / prefill["library_ms"]
    cont_ms = timer(lambda: pfa.paged_flash_prefill_attend(qc2, kp2, vp2, table_row, *at512, sliding_window=window,
                                                           **ab))
    cont_lib_ms, cont_yard = library_yardstick(
        timer, lambda: _library_prefill(kp2, vp2, table_row, qc2, 512, window, alibi), softcap, cont_ms,
        "gather+SDPA")
    log(f"{names[1]} at a 512-row chunk: {prefill['ms']:.4f} ms kernel, {prefill['plain_ms']:.4f} ms plain, "
        f"{yardstick}, bound {pf_bound:.4f} ms ({pf_by}); 188-row continuation at 512: {cont_ms:.4f} ms kernel, "
        f"{cont_yard}")
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
    plain = (plain_pool(kp), plain_pool(vp))
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


def check_flash_case(device, timer, hq, hkv, d, alibi=None, softcap=None, window=None, q_scale=1.0, q_len=512,
                     q_offset=0):
    """K4 at a ``q_len``-row chunk at ``q_offset`` (default 512 rows at 0)
    over a buffer of at least 1024 rows (a session's cache; a query shard of
    sequence parallelism starts past row 0), bf16 (wgmma) and float32 (CUDA
    cores) on the same values, against
    its plain version (KERNEL_TOL, F32_KERNEL_TOL, as phase 9), timed beside
    SDPA with a mask (ALiBi added) and the bound; returns the timings. With a
    ``softcap`` (the queries times ``q_scale``, so that it bends the scores)
    the kernel must also disagree with the uncapped plain version, and no
    library call computes the function (``library_ms`` None)."""
    from petals_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(SEED + 22)
    kv_length = q_offset + q_len
    buf = max(1024, kv_length)
    q = (torch.randn(1, q_len, hq, d, generator=gen, device=device) * q_scale).to(torch.bfloat16)
    k, v = (torch.randn(1, buf, hkv, d, generator=gen, device=device).to(torch.bfloat16) for _ in range(2))
    scalars = torch.tensor([q_offset, kv_length], dtype=torch.int32, device=device)
    kw = dict(q_offset=q_offset, kv_length=kv_length, alibi_slopes=alibi, softcap=softcap, sliding_window=window)
    kw_dev = dict(q_offset=scalars[0], kv_length=scalars[1], alibi_slopes=alibi, softcap=softcap,
                  sliding_window=window)
    name = f"K4 at group {hq // hkv} ({hq} heads over {hkv}, head_dim {d}){' with ALiBi' if alibi is not None else ''}"
    if q_offset:
        name += f", {q_len} rows at {q_offset} of {kv_length}"
    if softcap is not None:
        name += f", softcap {softcap:g}, window {window}"
    got = fa.flash_attend(q, k, v, **kw_dev)
    torch.cuda.synchronize()
    want = fa.flash_attend_reference(q.float(), k, v, **kw)
    if got.shape != q.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: output {tuple(got.shape)} or non-finite")
    err = (got.float() - want).abs().max().item()
    # float32 on unscaled queries: at q_scale's scores a float32 ulp of the
    # largest one moves a peaked softmax past phase 9's limit (the card
    # tests hold the float32 arm to a cap that bends its scores)
    q32 = q.float() / q_scale
    got32 = fa.flash_attend(q32, k.float(), v.float(), **kw_dev)
    torch.cuda.synchronize()
    err32 = (got32 - fa.flash_attend_reference(q32, k.float(), v.float(), **kw)).abs().max().item()
    # with ALiBi a score reaches slope x j (~255 at 32 heads over a 512-row
    # chunk), where a float32 ulp is ~3e-5: the kernel and its plain version
    # add the bias in another order, so a score may differ by an ulp of the
    # largest one; the limit adds two such ulps to phase 9's
    tol32 = F32_KERNEL_TOL
    if alibi is not None:
        tol32 += 2 * torch.finfo(torch.float32).eps * alibi.abs().max().item() * (kv_length - 1)
    log(f"{name}: max abs err {err:.3e} bf16 (wgmma, tol {KERNEL_TOL}), {err32:.3e} float32 (CUDA cores, "
        f"tol {tol32:.3e})")
    if err > KERNEL_TOL or err32 > tol32:
        raise AssertionError(f"{name} disagrees with its plain version: bf16 {err}, float32 {err32}")
    if softcap is not None:
        off = (got.float() - fa.flash_attend_reference(q.float(), k, v, **dict(kw, softcap=None))).abs().max().item()
        log(f"{name}: the uncapped plain version is {off:.3e} away")
        if off <= 10 * KERNEL_TOL:
            raise AssertionError(f"{name}: the softcap does not bend these scores ({off:.3e})")

    def library():
        kv_pos = torch.arange(kv_length, device=device)
        q_pos = q_offset + torch.arange(q_len, device=device)
        mask = (kv_pos[None, :] <= q_pos[:, None]) & (kv_pos[None, :] > q_pos[:, None] - (window or kv_length))
        mask = _alibi_mask(mask, alibi, kv_pos)
        return _sdpa(q.transpose(1, 2), k[:, :kv_length].transpose(1, 2), v[:, :kv_length].transpose(1, 2), mask)

    nbytes = 2 * q.numel() * 2 + 2 * kv_length * hkv * d * 2
    bound, by = bound_ms(nbytes, 4 * hq * d * _visible_pairs(q_len, q_offset, kv_length, window))
    out = {"ms": timer(lambda: fa.flash_attend(q, k, v, **kw_dev)),
           "plain_ms": timer(lambda: fa.flash_attend_reference(q, k, v, **kw)), "bound_ms": bound, "bound_by": by,
           "max_abs_err": err}
    out["library_ms"], yardstick = library_yardstick(timer, library, softcap, out["ms"], "SDPA with a mask")
    log(f"{name}: {out['ms']:.4f} ms kernel, {out['plain_ms']:.4f} ms plain, {yardstick}, bound {bound:.4f} ms ({by})")
    return out


def grouped_weight_traffic(sizes, k_in: int, k_out: int) -> dict:
    """The weight bytes a K7 launch at these group sizes would move, by
    block order: a model worked out from the group sizes, which assumes the
    L2 reuse each order allows; no byte counter of the card is read. With
    the row tiles fastest (both arms' order: an expert's tiles of one column
    slice are resident together, so its slice would come from HBM once and
    its other tiles read it from L2) and with the column tiles fastest (the
    first kernel's order: each of an expert's 64-row tiles streams the whole
    slice from HBM). "l2_to_sm" is what the bf16 arm's 128-row tiles read
    (one slice a tile). Printed only, never part of the kernels line."""
    from petals_tpu_torch.ops.grouped_matmul import TILE_ROWS

    per_expert = 2 * k_in * k_out
    return {
        "hbm_row_tiles_fastest": per_expert * sum(1 for g in sizes if g),
        "hbm_column_tiles_fastest": per_expert * sum(-(-g // 64) for g in sizes),
        "l2_to_sm": per_expert * sum(-(-g // TILE_ROWS["wgmma"]) for g in sizes),
    }


def check_grouped_matmul(device, timer):
    """K7 at Mixtral-8x7B's widths: a 512-row chunk at top-2 is 1024
    assignment rows over 8 experts, in GROUPED_SIZES (one expert empty, one
    taking half the rows), through w1 [8, 4096, 14336] and w2 [8, 14336,
    4096] (seeded bf16). The bf16 arm (wgmma) against its plain version (the
    same rows through each expert's weight in float32, rounded once to bf16:
    the kernel sums in float32 in another order and rounds once, so row by
    row within OUT_REL_TOL of the row's largest output, as K1's lanes) at
    every routing of GROUPED_ROUTINGS and at both projections, then one
    launch captured in a CUDA graph at GROUPED_SIZES and replayed after the
    sizes were rewritten in place with each of GROUPED_REPLAYS; the float32
    arm (CUDA cores) against its plain version at a narrow case (within
    F32_KERNEL_TOL of each row's largest output). Timed at GROUPED_SIZES
    beside torch._grouped_mm where the card's torch has it (timed here only)
    and the bound, with the weight traffic the block order implies printed
    on its own line (a model, not measured); returns the report entry
    (without main-path launches)."""
    from petals_tpu_torch.ops.grouped_matmul import grouped_matmul, grouped_matmul_reference

    gen = torch.Generator(device=device).manual_seed(SEED + 23)
    h, m = MIXTRAL_8X7B["hidden_size"], MIXTRAL_8X7B["intermediate_size"]
    E, n = len(GROUPED_SIZES), sum(GROUPED_SIZES)
    sizes = torch.tensor(GROUPED_SIZES, dtype=torch.int32, device=device)
    entry = {"name": "grouped_matmul", "route": "cuda", "source": "petals_tpu_torch/csrc/grouped_matmul.cu",
             "replaces": "petals_tpu/models/mixtral/block.py:56 (jax.lax.ragged_dot; no TPU kernel)"}
    worst = 0.0
    for proj, (k_in, k_out) in (("w1", (h, m)), ("w2", (m, h))):
        x = (torch.randn(n, k_in, generator=gen, device=device) * 0.5).to(torch.bfloat16)
        w = (torch.randn(E, k_in, k_out, generator=gen, device=device) * 0.02).to(torch.bfloat16)
        for routing, groups in GROUPED_ROUTINGS.items():
            g = torch.tensor(groups, dtype=torch.int32, device=device)
            xr = x[: sum(groups)]
            got = grouped_matmul(xr, w, g)
            torch.cuda.synchronize()
            err = _check_relative(f"K7 bf16 (wgmma) {proj} [{E}, {k_in}, {k_out}] at {routing} {list(groups)}",
                                  got, grouped_matmul_reference(xr, w, g).float(), OUT_REL_TOL, "row")
            worst = max(worst, err)
        # one captured launch serves any routing of the same rows: the sizes
        # are rewritten in place between replays
        graph_sizes = sizes.clone()
        grouped_matmul(x, w, graph_sizes)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            graph_out = grouped_matmul(x, w, graph_sizes)
        for routing in GROUPED_REPLAYS:
            graph_sizes.copy_(torch.tensor(GROUPED_ROUTINGS[routing], dtype=torch.int32))
            graph.replay()
            torch.cuda.synchronize()
            worst = max(worst, _check_relative(
                f"K7 bf16 {proj}, one launch captured at {list(GROUPED_SIZES)} replayed at {routing}", graph_out,
                grouped_matmul_reference(x, w, graph_sizes).float(), OUT_REL_TOL, "row"))
        del graph, graph_out
        used = sum(1 for g in GROUPED_SIZES if g)
        nbytes = 2 * n * k_in + 2 * used * k_in * k_out + 2 * n * k_out
        bound, by = bound_ms(nbytes, 2 * n * k_in * k_out)
        want = grouped_matmul_reference(x, w, sizes).float()
        offs = torch.cumsum(sizes, 0, dtype=torch.int32)
        library_ms, why = None, "torch._grouped_mm is not in this torch"
        if hasattr(torch, "_grouped_mm"):
            for layout, wl in (("row-major", w), ("column-major", w.transpose(1, 2).contiguous().transpose(1, 2))):
                try:
                    lib = torch._grouped_mm(x, wl, offs=offs)
                    torch.cuda.synchronize()
                    lib_err = (lib.float() - want).abs().max().item()
                    library_ms = timer(lambda wl=wl: torch._grouped_mm(x, wl, offs=offs))
                    why = f"torch._grouped_mm on a {layout} w (its err {lib_err:.3e})"
                    break
                except (RuntimeError, TypeError, ValueError) as e:
                    why = f"torch._grouped_mm refused a {layout} w: {str(e).splitlines()[0][:160]}"
        timed = {"ms": timer(lambda: grouped_matmul(x, w, sizes)),
                 "plain_ms": timer(lambda: grouped_matmul_reference(x, w, sizes)),
                 "library_ms": library_ms, "bound_ms": bound, "bound_by": by}
        log(f"K7 {proj}: {timed['ms']:.4f} ms kernel (bf16, wgmma), {timed['plain_ms']:.4f} ms plain, library "
            f"{'%.4f ms' % library_ms if library_ms is not None else 'none'} ({why}), bound {bound:.4f} ms ({by}, "
            f"{nbytes / 1e6:.1f} MB, {2 * n * k_in * k_out / 1e9:.1f} GFLOP)")
        model = grouped_weight_traffic(GROUPED_SIZES, k_in, k_out)
        traffic = ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in model.items())
        log(f"K7 {proj}: weight traffic the block order implies (a model from the group sizes, not read from the "
            f"card): {traffic}")
        if proj == "w1":
            entry.update(timed, shape=f"x [{n}, {k_in}] over w [{E}, {k_in}, {k_out}], groups {list(GROUPED_SIZES)}")
        else:
            entry["w2"] = timed
        del x, w, want
    # the float32 arm (CUDA cores) at a narrow case
    groups = (70, 0, 130, 56)
    g = torch.tensor(groups, dtype=torch.int32, device=device)
    x = torch.randn(sum(groups), 256, generator=gen, device=device) * 0.5
    w = torch.randn(len(groups), 256, 384, generator=gen, device=device) * 0.02
    got = grouped_matmul(x, w, g)
    torch.cuda.synchronize()
    entry["float32_max_abs_err"] = _check_relative(
        f"K7 float32 (CUDA cores) [{len(groups)}, 256, 384] at {list(groups)}", got,
        grouped_matmul_reference(x, w, g), F32_KERNEL_TOL, "row")
    entry["max_abs_err"] = worst
    return entry


def check_family_kernels(device, timer):
    """Phase 22 (a): the attention kernels' wide-group and ALiBi arms and K7
    at the families' shapes. Returns ({entry name: {case: numbers}} for the
    K1-K4 entries, K7's entry)."""
    from petals_tpu_torch.ops.alibi import build_alibi_slopes

    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")
    families = collections.defaultdict(dict)
    for case, (hq, hkv, d) in FAMILY_GROUPS.items():
        dec, pf = attention_cases(device, hq, hkv, d)
        for kind in ("none",) + KV_QUANT_KINDS:
            for entry in check_attention_kernels(device, timer, dec, pf, kind, long=False):
                families[entry["name"]][case] = {k: entry[k] for k in keys}
        del dec, pf
    for case, hq in FAMILY_ALIBI.items():
        dec, pf = attention_cases(device, hq, hq, 128)
        slopes = build_alibi_slopes(hq, device)
        for entry in check_attention_kernels(device, timer, dec, pf, long=False, alibi=slopes):
            families[entry["name"]][case] = {k: entry[k] for k in keys}
        del dec, pf
    families["flash_attention"]["group_71"] = check_flash_case(device, timer, *FAMILY_GROUPS["group_71"])
    families["flash_attention"]["alibi_32"] = check_flash_case(device, timer, 32, 32, 128,
                                                               build_alibi_slopes(32, device))
    return dict(families), check_grouped_matmul(device, timer)


def check_gemma_phi3_kernels(device, timer):
    """Phase 23 (a): the attention kernels' head_dim 256 and 96 arms and
    Gemma-2's softcap at the families' heads (GEMMA_PHI3_CASES): K1 and K2,
    K3's int8 and nf4a arms (decode and prefill) and K4, each against its
    plain version, timed beside its library call (none with a softcap) and
    the bound. Returns {entry name: {case: numbers}}."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")
    cases = collections.defaultdict(dict)
    for case, (hq, hkv, d, softcap, window, q_scale) in GEMMA_PHI3_CASES.items():
        dec, pf = attention_cases(device, hq, hkv, d, q_scale)
        for kind in ("none",) + KV_QUANT_KINDS:
            for entry in check_attention_kernels(device, timer, dec, pf, kind, long=False, window=window,
                                                 softcap=softcap):
                cases[entry["name"]][case] = {k: entry[k] for k in keys}
        del dec, pf
        cases["flash_attention"][case] = check_flash_case(device, timer, hq, hkv, d, softcap=softcap, window=window,
                                                          q_scale=q_scale)
    return dict(cases)


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
    same index, its shards linked, not copied; one made already is reused."""
    if os.path.isdir(dst):
        return dst
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
    if not hasattr(module, "update_kv_cache"):  # its block writes through ops/attention.py attend_maybe_ring
        module = sys.modules["petals_tpu_torch.models.common"]
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


@contextlib.contextmanager
def plain_grouped_products(family):
    """While active, a Mixtral block's sparse experts take the plain grouped
    product (a loop over the experts on host-read group sizes), not K7: the
    references are independent of the kernels. Other families: no change."""
    module = sys.modules[family.block_apply.__module__]
    original = getattr(module, "grouped_matmul", None)
    if original is None:
        yield
        return
    from petals_tpu_torch.ops.grouped_matmul import grouped_matmul_reference

    module.grouped_matmul = grouped_matmul_reference
    try:
        yield
    finally:
        module.grouped_matmul = original


@torch.no_grad()
def reference_session(block_params, family, cfg, prompt, steps, device, dtype, kv_quant="none", hypo_ids=None,
                      reencode=None):
    """One session alone through the port's block functions over a dense
    cache [batch, length, hkv, d] per block, with plain attention, in
    ``dtype``; with a ``kv_quant`` kind, each row enters the cache as the
    quantized pool would hold it. ``hypo_ids`` (one entry per step, None or
    a [batch] lane order) reorders the caches' lanes before the step, as a
    server does for beam search. ``reencode=(i, times)``: before step i the
    cached rows are encoded and decoded ``times`` times more, as a session
    moved between quantized pools is (its parked rows packed for the wire,
    then encoded again as the adopting pool writes them). Returns the
    replies and the K/V rows as computed (before any quantization), (k, v)
    of [n_blocks * batch, length, hkv, d]."""
    from petals_tpu_torch.models.registry import num_kv_heads

    length = prompt.shape[1] + sum(x.shape[1] for x in steps)
    shape = (prompt.shape[0], length, num_kv_heads(cfg), cfg.head_dim)
    caches = [
        (torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device))
        for _ in block_params
    ]
    written = []
    outs, position = [], 0
    with quantized_kv_writes(family, kv_quant, written) if kv_quant != "none" else contextlib.nullcontext(), \
            plain_grouped_products(family):
        for i, x in enumerate([prompt] + steps):
            if hypo_ids is not None and hypo_ids[i] is not None:
                order = torch.as_tensor(hypo_ids[i], dtype=torch.long, device=device)
                caches = [(k[order], v[order]) for k, v in caches]
            if reencode is not None and reencode[0] == i:
                caches = [tuple(_reencoded(t, position, kv_quant, reencode[1]) for t in kv) for kv in caches]
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


def _reencoded(cache, n, kind, times):
    """``cache`` with its rows [0, n) encoded with ``kind`` and decoded back
    to its dtype ``times`` times."""
    from petals_tpu_torch.ops.paged_attention import dequantize_kv, quantize_kv_rows

    rows = cache[:, :n]
    for _ in range(times):
        rows = dequantize_kv(*quantize_kv_rows(rows.float(), kind), kind, cache.dtype)
    out = cache.clone()
    out[:, :n] = rows
    return out


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
    rows = {label: {k: round(v, 4) for k, v in t.items() if k != "kernels"} for label, t in times.items()}
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


def profile_steps(backend, device, gen_params=None, smi="") -> dict:
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
    return times


def profile_moe_step(backend, device, smi) -> dict:
    """Where a Mixtral mixed step's device time goes (phase 22 (b)): the
    profile phase's steps on the served Mixtral span (profile_steps), then
    the replayed mixed step's device busy split into K7, the MoE glue
    (MOE_GLUE: the kernels of the routing and assignment sorts, the gather
    of the assignment rows, the group sizes' scatter-add and the combine's
    index_add_, by a piece of each kernel's profile name) and the rest.
    Returns {part: ms a step} with the device busy."""
    times = profile_steps(backend, device)
    t = times[f"mixed step ({PROFILE_CHUNK}-token chunk), replayed"]
    busy, kernels = t["device_busy_ms"], t["kernels"]
    parts = {"K7": {k: v for k, v in kernels.items() if "grouped_matmul" in k}}
    for part, pieces in MOE_GLUE.items():
        parts[part] = {k: v for k, v in kernels.items() if any(p in k for p in pieces) and "grouped_matmul" not in k}
    split = {part: sum(found.values()) for part, found in parts.items()}
    glue = sum(v for part, v in split.items() if part != "K7")
    log(f"Mixtral mixed step ({backend.n_blocks} blocks, a {PROFILE_CHUNK}-token chunk + {PROFILE_LANES - 1} decode "
        f"rows, replayed): device busy {busy:.3f} ms; K7 {split['K7']:.3f} ms ({split['K7'] / busy:.3f} of it); MoE glue "
        f"{glue:.3f} ms ({glue / busy:.3f}): " + ", ".join(f"{p} {split[p]:.3f} ms" for p in MOE_GLUE) + f" ({smi})")
    for part, found in parts.items():
        log(f"Mixtral mixed step: {part} kernels: " + "; ".join(f"{k[:90]} {v:.4f} ms" for k, v in found.items()))
    return {"device_busy_ms": busy, **split}


def profile_calls(steps: dict) -> dict:
    """Each of ``steps`` (label: a callable) profiled as the profile phase
    does: the host wall (median of PROFILE_REPS calls, launch to
    synchronize) and the device span (CUDA events around the same calls),
    then from torch.profiler over PROFILE_CALLS further calls the device
    busy time, the kernel and graph launches and the top operations, with
    the idle share 1 - busy / wall. Returns {label: {host_wall_ms,
    device_span_ms, device_busy_ms, idle_share, launches, graph_launches,
    kernels: {device event name: ms a call}}}."""
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
                        "graph_launches": graph_launches / PROFILE_CALLS,
                        "kernels": {e.key: e.self_device_time_total / 1e3 / PROFILE_CALLS for e in events
                                    if e.device_type == DeviceType.CUDA}}
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
    the kernels' weights), then cast to ``dtype``; a leaf the server keeps
    in float32 (Gemma's folded norms) stays float32, and a host int (Gemma-2's
    window) as it is."""
    from petals_tpu_torch.ops.quant import QUANTIZED_TYPES, dequantize

    def leaf(v):
        if isinstance(v, QUANTIZED_TYPES):
            return dequantize(v, torch.bfloat16).to(dtype)
        if not isinstance(v, torch.Tensor):
            return v
        return v if v.dtype == torch.float32 else v.to(dtype)

    return [{k: leaf(v) for k, v in p.items()} for p in block_params]


def serve_and_check(ckpt, device, quant_type, n_blocks, prompts, n_steps, seed, warmup_prompts, kv_quant_type="none",
                    label_model="", extra_args=()):
    """Serve blocks [0, n_blocks) of the checkpoint with ``--quant_type`` and
    ``--kv_quant_type`` through the CLI's build_server, drive concurrent
    sessions (after an optional warm-up), check the launch counters of the
    measured run, every reply and every written K/V row against dense
    references, and return the server (still holding its span) and the
    measured run's launch counts."""
    from petals_tpu_torch.cli.run_server import build_parser, build_server
    from petals_tpu_torch.ops import grouped_matmul as gm
    from petals_tpu_torch.ops import paged_flash_attention as pfa
    from petals_tpu_torch.ops import quant_matmul as qmm

    label = f"server (--quant_type {quant_type} --kv_quant_type {kv_quant_type}, {n_blocks} blocks)"
    if label_model:
        label = f"{label_model} {label}"
    args = build_parser().parse_args([
        ckpt, "--first_block", "0", "--num_blocks", str(n_blocks), "--host", "127.0.0.1", "--quant_type", quant_type,
        "--kv_quant_type", kv_quant_type, *NO_PREFIX_CACHE, *extra_args,
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
            gm.reset_launch_counts()
            result = await drive_server(
                server, prompts, n_steps, seed,
                at_end=lambda: lane_kv_rows(server.batcher, [n + n_steps for n in prompts]),
            )
            launches = {
                "K1": pfa.paged_flash_attend.launches, "K2": pfa.paged_flash_prefill_attend.launches,
                "K3 decode": dict(pfa.paged_flash_attend.kv_quant_launches),
                "K3 prefill": dict(pfa.paged_flash_prefill_attend.kv_quant_launches),
                "decode": dict(qmm.quant_decode_matmul.launches), "prefill": dict(qmm.quant_prefill_matmul.launches),
                "K7": gm.grouped_matmul.launches, "K7 arms": dict(gm.grouped_matmul.arm_launches),
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
        # the quantized projections of a block (Mistral's wqkv, wo, wgu, wd;
        # Mixtral's q, k, v, o and each expert's three, run one expert at a
        # time); every step (batched_steps) runs the lanes' decode rows, a
        # mixed step also its chunk, of more than 32 rows at these prompt
        # lengths
        arm = quant_type[:-2] if quant_type.endswith("+o") else quant_type
        n_proj = quantized_projections(server.backend.block_params[0])
        need_dec = stats["batched_steps"] * n_blocks * n_proj
        need_pf = stats["mixed_steps"] * n_blocks * n_proj
        dec, pf = launches["decode"][arm], launches["prefill"][arm]
        log(f"{label}: launches on the main path: {arm} decode kernel {dec} (>= {need_dec}), "
            f"prefill kernel {pf} (>= {need_pf}); all kinds: decode {launches['decode']}, prefill {launches['prefill']}")
        if dec < need_dec or pf < need_pf:
            raise AssertionError(f"{label}: the main path did not run the dequant-matmul kernels on every projection")
    if server.family.name == "mixtral" and quant_type == "none":
        # K7: a mixed step's chunk (padded to a bucket of >= 8 rows) takes the
        # sparse experts, three grouped products a block, all on the bf16 arm
        # (wgmma): the served weights are bf16
        need = 3 * stats["mixed_steps"] * n_blocks
        arms = launches["K7 arms"]
        log(f"{label}: launches on the main path: K7 {launches['K7']} (>= {need}), by arm {arms}")
        if launches["K7"] < need or arms["wgmma"] != launches["K7"]:
            raise AssertionError(f"{label}: the main path did not run K7's bf16 arm on every chunk's block")
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


def quantized_projections(params) -> int:
    """The dequant-matmul calls one block makes a step: a quantized leaf
    each, an expert stack [E, ...] one per expert."""
    from petals_tpu_torch.ops.quant import QUANTIZED_TYPES

    leaves = [getattr(leaf, "inner", leaf) for leaf in params.values() if isinstance(leaf, QUANTIZED_TYPES)]
    return sum(leaf.data.shape[0] if leaf.data.dim() == 3 else 1 for leaf in leaves)


def _launch_counts():
    from petals_tpu_torch.ops import flash_attention as fa
    from petals_tpu_torch.ops import grouped_matmul as gm
    from petals_tpu_torch.ops import paged_flash_attention as pfa

    return {
        "K7": gm.grouped_matmul.launches,
        "K4": fa.flash_attend.launches, "K1": pfa.paged_flash_attend.launches,
        "K2": pfa.paged_flash_prefill_attend.launches,
        "K3": sum(pfa.paged_flash_attend.kv_quant_launches.values())
        + sum(pfa.paged_flash_prefill_attend.kv_quant_launches.values()),
    }


def _reset_launch_counts():
    from petals_tpu_torch.ops import flash_attention as fa
    from petals_tpu_torch.ops import grouped_matmul as gm
    from petals_tpu_torch.ops import paged_flash_attention as pfa
    from petals_tpu_torch.ops import quant_matmul as qmm

    gm.reset_launch_counts()
    fa.reset_launch_counts()
    pfa.reset_launch_counts()
    qmm.reset_launch_counts()


def _private_kv(server, n_tokens):
    """The K/V rows of the one open private session, read from its cache
    [n_blocks, batch, max_length, hkv, d] (a tensor-parallel server's
    shards joined along the head axis; a multi-host leader's gathered from
    every process by the group's export): (k, v) of [n_blocks * batch,
    n_tokens, hkv, d]."""
    torch.cuda.synchronize()
    if getattr(server.backend, "is_lockstep", False):
        bufs = _private_buffers(server)
        k, v = server.backend.export_kv(bufs, 0, bufs[0].shape[0], n_tokens)
        return tuple(t.flatten(0, 1).to(server.device) for t in (k, v))
    return tuple((buf.join() if hasattr(buf, "join") else buf)[:, :, :n_tokens].flatten(0, 1).clone()
                 for buf in _private_buffers(server))


async def _drive_private(server, blocks, batch, max_length, step_lens, seed, adapter=None):
    """One private session over blocks [blocks[0], blocks[1]) at ``batch``
    (with the LoRA ``adapter`` active, if named): steps of ``step_lens``
    tokens each. Returns the inputs, the replies, each reply's step_meta
    and the cache's K/V rows read before the stream ends."""
    from petals_tpu_torch.data_structures import CHAIN_DELIMITER, make_uid
    from petals_tpu_torch.rpc import RpcClient
    from petals_tpu_torch.rpc.serialization import deserialize_array, serialize_array

    gen = torch.Generator().manual_seed(seed)
    inputs = [torch.randn(batch, n, server.cfg.hidden_size, generator=gen).to(torch.bfloat16) for n in step_lens]
    uids = CHAIN_DELIMITER.join(make_uid(server.dht_prefix, i) for i in range(*blocks))
    client = await RpcClient.connect("127.0.0.1", server.rpc_server.port)
    try:
        stream = await client.open_stream("ptu.inference")
        await stream.send({"uids": uids, "max_length": max_length, "batch_size": batch, "active_adapter": adapter})
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
        [ckpt, "--first_block", "0", "--num_blocks", str(SPAN), "--host", "127.0.0.1", *NO_PREFIX_CACHE,
         *QUIET_ANNOUNCES]))
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
        "--max_chunk_size_bytes", str(DENSE_CHUNK_TOKENS * per_token), *NO_PREFIX_CACHE, *QUIET_ANNOUNCES,
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

        def timed_embed(ids, **kwargs):
            t0 = time.perf_counter()
            out = embed(ids, **kwargs)
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


class _NormedRows:
    """A BLOOM checkpoint's embeddings as its client sends them: rows of the
    table in float32 through word_embeddings_layernorm (the port's
    layer_norm on the card, as the client runs it, call by call), indexed
    like a table; on the host."""

    def __init__(self, table, weight, bias, eps, device):
        self.table, self.eps = table.to(device), eps
        self.weight, self.bias = weight.to(device, torch.float32), bias.to(device, torch.float32)

    def __getitem__(self, ids):
        from petals_tpu_torch.models.common import layer_norm

        rows = self.table[torch.as_tensor(ids).to(self.table.device)].float()
        return layer_norm(rows, self.weight, self.bias, self.eps).cpu()


class _ScaledRows:
    """A Gemma checkpoint's embeddings as its client sends them: rows of the
    table in float32 times sqrt(hidden) (HF's normalizer, rounded to the
    float32 client's dtype), indexed like a table; on the host."""

    def __init__(self, table, hidden: int):
        self.table, self.scale = table, torch.tensor(hidden**0.5, dtype=torch.float32)

    def __getitem__(self, ids):
        return self.table[torch.as_tensor(ids)].float() * self.scale


def _reference_head(ckpt, device):
    """The checkpoint's embeddings (bf16, host; BLOOM's through their
    LayerNorm, _NormedRows), and its final norm then float32 head on the
    card: hidden [b, h] -> logits [b, vocab]. Llama-layout checkpoints
    (Mistral, Qwen2, Mixtral, Phi-3) have an RMSNorm and their own head;
    BLOOM and Falcon ``ln_f`` (a LayerNorm) and the head tied to the
    embeddings; Gemma's a (1 + w) RMSNorm, the tied head and embeddings
    scaled by sqrt(hidden) (_ScaledRows), Gemma-2's head its final logit
    softcap too."""
    from petals_tpu_torch.server.from_pretrained import get_block_config, load_tensors_with_prefixes

    family, cfg = get_block_config(ckpt)
    if family.name in ("bloom", "falcon"):
        from petals_tpu_torch.models.common import layer_norm

        t = load_tensors_with_prefixes(ckpt, ("transformer.",), keep_full_names=True)
        table = t["transformer.word_embeddings.weight"]
        head = table.to(device, torch.float32)
        ln_w, ln_b = (t[f"transformer.ln_f.{k}"].to(device, torch.float32) for k in ("weight", "bias"))

        def ln_logits(h):
            return layer_norm(h.to(device, torch.float32), ln_w, ln_b, cfg.layer_norm_epsilon) @ head.t()

        if family.name == "falcon":
            return table, ln_logits
        emb = _NormedRows(table, t["transformer.word_embeddings_layernorm.weight"],
                          t["transformer.word_embeddings_layernorm.bias"], cfg.layer_norm_epsilon, device)
        return emb, ln_logits
    t = load_tensors_with_prefixes(ckpt, ("model.embed_tokens.", "model.norm.", "lm_head."), keep_full_names=True)
    head = t.get("lm_head.weight", t["model.embed_tokens.weight"]).to(device, torch.float32)
    norm = t["model.norm.weight"].to(device, torch.float32)
    gemma = family.name in ("gemma", "gemma2")
    if gemma:
        norm = norm + 1.0  # HF's Gemma RMSNorm: x * (1 + w)
    cap = getattr(cfg, "final_logit_softcapping", None)

    def logits(h):
        h = h.to(device, torch.float32)
        out = (h * torch.rsqrt((h * h).mean(-1, keepdim=True) + cfg.rms_norm_eps) * norm) @ head.t()
        return torch.tanh(out / cap) * cap if cap else out

    if gemma:
        return _ScaledRows(t["model.embed_tokens.weight"], cfg.hidden_size), logits
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
        # step by step, each over the tokens it carries (as the client
        # embedded them: call by call)
        ids = torch.as_tensor(tokens[:, : tokens.shape[1] - 1])
        sent = sum(step.shape[1] for step in steps)
        ok, start = sent == ids.shape[1], 0
        for step in steps:
            ok = ok and torch.equal(step, embed[ids[:, start : start + step.shape[1]]].float())
            start += step.shape[1]
        if not ok:
            faults.append(f"the client's steps ({sent} tokens) are not the embeddings of its tokens "
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


def check_client_streams(label, entries, block_params, ckpt, device, kv_quant="none", reencode=None):
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
    prompt length[, the columns of the tokens picked greedily from the
    steps' logits, one a step, for a stream that also appends tokens of
    its own]), tag "greedy" or "other". ``kv_quant``: the references
    write each row as a pool of that kind holds it (``reencode``: see
    reference_session). Returns the list of what failed."""
    from petals_tpu_torch.server.from_pretrained import get_block_config

    family, cfg = get_block_config(ckpt)
    embed, ref_logits = _reference_head(ckpt, device)
    params_bf16 = dense_reference_params(block_params, torch.bfloat16)
    params_f32 = dense_reference_params(block_params, torch.float32)
    failed = []
    for n, (session, tag, tokens, prompt_len, *cols) in enumerate(entries):
        steps, hypos, got = session["steps"], session["hypos"], session["logits"]
        name = f"{label}: stream {n} ({tag}, batch {steps[0].shape[0]}, {len(steps)} steps)"
        input_faults = _client_input_faults(tag, steps, hypos, got, tokens, prompt_len, embed)
        failed += [f"{name}: {what}" for what in input_faults]
        args = (family, cfg, steps[0], steps[1:], device)
        want = [[ref_logits(o[:, -1]).cpu()
                 for o in reference_session(p, *args, dtype, kv_quant=kv_quant, hypo_ids=hypos,
                                            reencode=reencode)[0]]
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
        if tag == "greedy" or cols:
            new = torch.as_tensor(tokens[:, cols[0] if cols else slice(prompt_len, None)])
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


def _family_tensors(cfg, block: int, gen, device) -> dict:
    """One block's tensors in its family's HF layout (names with the full
    model's prefix, torch's [out, in]), random bf16 from ``gen``: weights and
    biases std 0.02 (a zero bias would hide a missing one), LayerNorm
    weights 1 and RMSNorm weights 1."""
    def w(*shape, std=0.02):
        return (torch.randn(shape, generator=gen, device=device) * std).to(torch.bfloat16)

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16, device=device)

    h = cfg["hidden_size"]
    if cfg["model_type"] == "bloom":
        p = f"transformer.h.{block}."
        return {
            p + "input_layernorm.weight": ones(h), p + "input_layernorm.bias": w(h),
            p + "self_attention.query_key_value.weight": w(3 * h, h), p + "self_attention.query_key_value.bias": w(3 * h),
            p + "self_attention.dense.weight": w(h, h), p + "self_attention.dense.bias": w(h),
            p + "post_attention_layernorm.weight": ones(h), p + "post_attention_layernorm.bias": w(h),
            p + "mlp.dense_h_to_4h.weight": w(4 * h, h), p + "mlp.dense_h_to_4h.bias": w(4 * h),
            p + "mlp.dense_4h_to_h.weight": w(h, 4 * h), p + "mlp.dense_4h_to_h.bias": w(h),
        }
    if cfg["model_type"] == "falcon":  # falcon-7b: multi-query, parallel attention, no bias
        p, hq = f"transformer.h.{block}.", cfg["num_attention_heads"]
        d = h // hq
        return {
            p + "input_layernorm.weight": ones(h), p + "input_layernorm.bias": w(h),
            p + "self_attention.query_key_value.weight": w((hq + 2) * d, h),
            p + "self_attention.dense.weight": w(h, h),
            p + "mlp.dense_h_to_4h.weight": w(4 * h, h), p + "mlp.dense_4h_to_h.weight": w(h, 4 * h),
        }
    if cfg["model_type"] in ("gemma", "gemma2", "phi3"):
        return _gemma_phi3_tensors(cfg, block, w, ones)
    p, m, E = f"model.layers.{block}.", cfg["intermediate_size"], cfg["num_local_experts"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = h // hq
    out = {
        p + "input_layernorm.weight": ones(h), p + "post_attention_layernorm.weight": ones(h),
        p + "self_attn.q_proj.weight": w(hq * d, h), p + "self_attn.k_proj.weight": w(hkv * d, h),
        p + "self_attn.v_proj.weight": w(hkv * d, h), p + "self_attn.o_proj.weight": w(h, hq * d),
        p + "block_sparse_moe.gate.weight": w(E, h),
    }
    # the experts share a base and differ by MIXTRAL_EXPERT_SPREAD of it;
    # w2 is drawn at MIXTRAL_W2_SCALE of HF's std (see the constants)
    base = {"w1": w(m, h), "w2": w(h, m), "w3": w(m, h)}
    for e in range(E):
        q = f"{p}block_sparse_moe.experts.{e}."
        for name, b in base.items():
            own = b.float() + MIXTRAL_EXPERT_SPREAD * w(*b.shape).float()
            out[q + name + ".weight"] = (own * (MIXTRAL_W2_SCALE if name == "w2" else 1.0)).to(torch.bfloat16)
    return out


def _gemma_phi3_tensors(cfg, block: int, w, ones) -> dict:
    """One Gemma, Gemma-2 or Phi-3 block in its HF layout (``w``, ``ones``:
    _family_tensors' draws). Gemma's RMSNorm weights are zero-centred (the
    block computes x * (1 + w)): drawn at std 0.02 around 0, so the load's
    fold gives weights near 1 and a wrong fold moves every reply; Phi-3's
    are ones and ship its fused qkv_proj and gate_up_proj."""
    h, m = cfg["hidden_size"], cfg["intermediate_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = cfg.get("head_dim") or h // hq
    p = f"model.layers.{block}."
    if cfg["model_type"] == "phi3":
        return {
            p + "input_layernorm.weight": ones(h), p + "post_attention_layernorm.weight": ones(h),
            p + "self_attn.qkv_proj.weight": w((hq + 2 * hkv) * d, h), p + "self_attn.o_proj.weight": w(h, hq * d),
            p + "mlp.gate_up_proj.weight": w(2 * m, h), p + "mlp.down_proj.weight": w(h, m),
        }
    norms = ("input_layernorm", "post_attention_layernorm")
    if cfg["model_type"] == "gemma2":
        norms += ("pre_feedforward_layernorm", "post_feedforward_layernorm")
    out = {p + f"{n}.weight": w(h) for n in norms}
    out.update({
        p + "self_attn.q_proj.weight": w(hq * d, h), p + "self_attn.k_proj.weight": w(hkv * d, h),
        p + "self_attn.v_proj.weight": w(hkv * d, h), p + "self_attn.o_proj.weight": w(h, hq * d),
        p + "mlp.gate_proj.weight": w(m, h), p + "mlp.up_proj.weight": w(m, h), p + "mlp.down_proj.weight": w(h, m),
    })
    return out


def write_family_checkpoint(path: str, device, cfg: dict, n_blocks: int) -> None:
    """A seeded checkpoint of ``n_blocks`` blocks of a BLOOM, Falcon,
    Mixtral, Gemma, Gemma-2 or Phi-3 config at its full width (the config
    says ``n_blocks`` layers),
    one shard a block plus one of the client's tensors, written with the
    port's safetensors writer (write_checkpoint's layout)."""
    from petals_tpu_torch.utils.safetensors_io import save_file

    gen = torch.Generator(device=device).manual_seed(SEED + 22)
    weight_map = {}

    def save(fname, tensors):
        save_file(tensors, os.path.join(path, fname), metadata={"format": "pt"})
        weight_map.update({name: fname for name in tensors})

    for i in range(n_blocks):
        save(f"model-{i + 1:05d}-of-{n_blocks:05d}.safetensors", _family_tensors(cfg, i, gen, device))
    h, vocab = cfg["hidden_size"], cfg["vocab_size"]
    embed = (torch.randn(vocab, h, generator=gen, device=device) * 0.02).to(torch.bfloat16)
    if cfg["model_type"] in ("mixtral", "phi3"):
        client = {"model.embed_tokens.weight": embed, "model.norm.weight": torch.ones(h, dtype=torch.bfloat16),
                  "lm_head.weight": (torch.randn(vocab, h, generator=gen, device=device) * 0.02).to(torch.bfloat16)}
    elif cfg["model_type"] in ("gemma", "gemma2"):  # the head tied to the embeddings; a zero-centred norm
        client = {"model.embed_tokens.weight": embed,
                  "model.norm.weight": (torch.randn(h, generator=gen, device=device) * 0.02).to(torch.bfloat16)}
    else:  # the head tied to the embeddings
        client = {"transformer.word_embeddings.weight": embed,
                  "transformer.ln_f.weight": torch.ones(h, dtype=torch.bfloat16),
                  "transformer.ln_f.bias": (torch.randn(h, generator=gen, device=device) * 0.02).to(torch.bfloat16)}
        if cfg["model_type"] == "bloom":
            client["transformer.word_embeddings_layernorm.weight"] = torch.ones(h, dtype=torch.bfloat16)
            client["transformer.word_embeddings_layernorm.bias"] = (
                torch.randn(h, generator=gen, device=device) * 0.02).to(torch.bfloat16)
    save("model-client.safetensors", client)
    del client, embed
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(cfg, num_hidden_layers=n_blocks, n_layer=n_blocks), f)


def serve_families_and_check(root, device, smi) -> dict:
    """Phase 22 (b): each family's span at a published config's full width,
    served by one port server built by the CLI (its defaults: --quant_type
    none, --page_size 64, --kv_quant_type none) to FAMILY_PROMPTS and
    FAMILY_STEPS decode steps and checked as phase 3 checks (replies and
    K/V rows against the dense references, K1 and K2 on every block of every
    step, K7 on every Mixtral chunk's block, every batched step a replay and
    no capture after warm-up); Mixtral again with --quant_type nf4a at
    FAMILY_QUANT_BLOCKS blocks, one session, as phase 6 checks (K5 on every
    projection, an expert's three each); then one greedy stream a family
    through the port's client (drive_client), held as phase 13 holds its
    streams. Returns the launch counts of each run."""
    counts = {}
    t_phase = time.perf_counter()
    for name, (cfg, n_blocks) in FAMILY_RUNS.items():
        model = f"{cfg['architectures'][0].removesuffix('ForCausalLM')} ({name}, {n_blocks} blocks)"
        ckpt = os.path.join(root, name)
        os.makedirs(ckpt)
        t0 = time.perf_counter()
        write_family_checkpoint(ckpt, device, cfg, n_blocks)
        log(f"checkpoint: {n_blocks} {name} blocks at full width and the client's tensors written in "
            f"{time.perf_counter() - t0:.1f} s")
        server, counts[name] = serve_and_check(ckpt, device, "none", n_blocks, FAMILY_PROMPTS, FAMILY_STEPS,
                                               SEED + 22, None, label_model=model)
        if name == "mixtral":
            counts["mixtral_profile"] = profile_moe_step(server.backend, device, smi)
        del server
        free_card()
        if name == "mixtral":
            server, counts["mixtral_nf4a"] = serve_and_check(
                ckpt, device, "nf4a", FAMILY_QUANT_BLOCKS, FAMILY_PROMPTS[1:2], FAMILY_STEPS, SEED + 23, None,
                label_model=model)
            del server
            free_card()
        label = f"client ({model}, one port server, bf16)"
        gen = torch.Generator().manual_seed(SEED + 24)

        def runs(model, rec, vocab=cfg["vocab_size"]):
            prompt = torch.randint(0, vocab, (1, CLIENT_PROMPT), generator=gen).numpy()
            out = model.generate(prompt, max_new_tokens=FAMILY_NEW)
            return [(rec.sessions[-1], "greedy", out, CLIENT_PROMPT)]

        rec, streams, launches, params = drive_client(
            label, ckpt, device, smi,
            [("--first_block", "0", "--num_blocks", str(n_blocks), "--no_server_side_generation")], runs)
        _client_timing_line(label, rec, streams[0][0], smi)
        log(f"{label}: launches during the client's run {launches}")
        if not (launches["K1"] > 0 and launches["K2"] > 0 and (name != "mixtral" or launches["K7"] > 0)):
            raise AssertionError(f"{label}: K1, K2 (or K7) never ran on the client's path ({launches})")
        failed = check_client_streams(label, streams, params, ckpt, device)
        if failed:
            raise AssertionError("; ".join(failed))
        counts[f"{name}_client"] = launches
        del params
        free_card()
        shutil.rmtree(ckpt)
    log(f"families: phase done in {time.perf_counter() - t_phase:.1f} s")
    return counts


def check_gen_tokens(label, entry, tokens, block_params, ckpt, device) -> list:
    """A server-side greedy generation (one ``generate_remote`` call's
    record: the prompt's hidden states and the tokens the server picked)
    teacher-forced through the dense references STEP BY STEP, as the server
    ran it: the prompt, then each token but the last one row at a time (a
    length-dependent rotary, Phi-3's LongRoPE, then switches where the
    server's did). Each token's float32 reference logit must lie within
    REPLY_NOISE_FACTOR times the bf16 reference's largest logit error of the
    float32 reference's largest logit, as check_client_streams holds greedy
    tokens. Returns the list of what failed."""
    from petals_tpu_torch.server.from_pretrained import get_block_config

    family, cfg = get_block_config(ckpt)
    embed, ref_logits = _reference_head(ckpt, device)
    tokens = torch.as_tensor(tokens).reshape(1, -1)
    steps = [embed[tokens[:, i : i + 1]].float() for i in range(tokens.shape[1] - 1)]
    want = [[ref_logits(o[:, -1]).cpu()
             for o in reference_session(dense_reference_params(block_params, dtype), family, cfg, entry["hidden"],
                                        steps, device, dtype)[0]]
            for dtype in (torch.bfloat16, torch.float32)]
    tol = REPLY_NOISE_FACTOR * max((b - f).abs().max().item() for b, f in zip(*want))
    gap = max((f.max(-1).values - f[:, int(tokens[0, i])]).max().item() for i, f in enumerate(want[1]))
    log(f"{label}: {tokens.shape[1]} server-generated tokens after a {entry['hidden'].shape[1]}-token prompt, "
        f"teacher-forced step by step: each token's float32 reference logit at most {gap:.3e} below its max "
        f"(tol {tol:.3e})")
    return [f"{label}: a generated token's reference logit is {gap:.3e} below the max (> {tol:.3e})"] if gap > tol else []


def serve_gemma_phi3_and_check(root, device, smi) -> dict:
    """Phase 23 (b): Gemma-7B, Gemma-2-9B and Phi-3-mini-128k spans at their
    published widths (GEMMA_PHI3_RUNS), each served by one port server built
    by the CLI to its prompts and FAMILY_STEPS decode steps and checked as
    phase 3 checks (replies and K/V rows against the dense references, K1
    and K2 on every block of every step, every batched step a replay, no
    capture after warm-up); Gemma-2-9B again with --quant_type nf4a and on
    an nf4a pool (GEMMA_PHI3_QUANT_BLOCKS blocks: K5, K3); then each family
    through the port's client: a greedy per-token stream held as phase 13
    holds its streams; Gemma-2-9B's client also runs the stateless forward
    (K4 at head_dim 256 with the softcap) at GEMMA_PHI3_FWD_LENGTHS and
    counts its graphs (C12: at most one a bucket), Phi-3's (K4 at head_dim
    96, LongRoPE) at PHI3_FWD_LENGTHS, every forward held to the dense
    references; Phi-3's client also runs a per-token stream whose decode
    crosses 4096 and a server-side generation whose prompt's known length
    does (check_gen_tokens). Returns the launch counts of each run."""
    from petals_tpu_torch.server.backend import bucket_length

    counts = {}
    t_phase = time.perf_counter()
    fwd_lengths = {"gemma2": GEMMA_PHI3_FWD_LENGTHS, "phi3": PHI3_FWD_LENGTHS}
    for name, (cfg, n_blocks, prompts) in GEMMA_PHI3_RUNS.items():
        model = f"{cfg['architectures'][0].removesuffix('ForCausalLM')} ({name}, {n_blocks} blocks)"
        ckpt = os.path.join(root, name)
        os.makedirs(ckpt)
        t0 = time.perf_counter()
        write_family_checkpoint(ckpt, device, cfg, n_blocks)
        log(f"checkpoint: {n_blocks} {name} blocks at full width and the client's tensors written in "
            f"{time.perf_counter() - t0:.1f} s")
        long = GEMMA_PHI3_LONG if max(prompts) > 1024 else ()
        server, counts[name] = serve_and_check(ckpt, device, "none", n_blocks, prompts, FAMILY_STEPS, SEED + 30,
                                               None, label_model=model, extra_args=long)
        del server
        free_card()
        if name == "gemma2":
            for quant_type, kv in (("nf4a", "none"), ("none", "nf4a")):
                server, counts[f"gemma2_{quant_type}_{kv}"] = serve_and_check(
                    ckpt, device, quant_type, GEMMA_PHI3_QUANT_BLOCKS, FAMILY_PROMPTS[:2], FAMILY_STEPS, SEED + 31,
                    None, kv, label_model=model)
                del server
                free_card()
        label = f"client ({model}, one port server, bf16)"
        gen = torch.Generator().manual_seed(SEED + 32)
        vocab, entries, extra = cfg["vocab_size"], [], {}

        def runs(model, rec):
            passthrough = [lambda ids, scores: scores]  # keeps the per-token path on a server-gen server
            n = PHI3_DECODE_PROMPT if name == "phi3" else CLIENT_PROMPT
            prompt = torch.randint(0, vocab, (1, n), generator=gen).numpy()
            out = model.generate(prompt, max_new_tokens=FAMILY_NEW, logits_processor=passthrough)
            streams = [(rec.sessions[-1], "greedy", out, n)]
            if name == "phi3":
                prompt = torch.randint(0, vocab, (1, PHI3_GEN_PROMPT), generator=gen).numpy()
                out = model.generate(prompt, max_new_tokens=FAMILY_NEW)
                session = rec.sessions[-1]
                if not session["gen"] or session["steps"]:
                    raise AssertionError(f"{label}: the {PHI3_GEN_PROMPT}-token generation did not run on the server")
                extra["gen"] = (session["gen"][0], out[0, PHI3_GEN_PROMPT:])
            extra["forward"] = []
            for n in fwd_lengths.get(name, ()):
                hidden = torch.randn(1, n, cfg["hidden_size"], generator=gen).to(torch.bfloat16)
                extra["forward"].append((hidden, model.remote.forward(hidden), model.remote.forward(hidden)))
            return streams

        def after(servers):
            if name == "gemma2":
                prog = servers[0].backend._forward_program  # None on the CPU (a rehearsal): no graphs
                # and the self-probe's bucket: a server probes itself at every
                # announce, through the same forward program
                buckets = {bucket_length(n) for n in GEMMA_PHI3_FWD_LENGTHS} | {bucket_length(SELF_PROBE_TOKENS)}
                extra["graphs"] = (len(getattr(prog, "_entries", ())), len(buckets))

        server_args = ["--first_block", "0", "--num_blocks", str(n_blocks), *long]
        if name != "phi3":
            server_args.append("--no_server_side_generation")
        rec, streams, launches, params = drive_client(label, ckpt, device, smi, [tuple(server_args)], runs,
                                                      after_runs=after)
        _client_timing_line(label, rec, streams[0][0], smi)
        log(f"{label}: launches during the client's runs {launches}")
        if not (launches["K1"] > 0 and launches["K2"] > 0 and (name not in fwd_lengths or launches["K4"] > 0)):
            raise AssertionError(f"{label}: K1, K2 (or K4) never ran on the client's path ({launches})")
        failed = check_client_streams(label, streams, params, ckpt, device)
        if name == "phi3":
            failed += check_gen_tokens(f"{label}: server-side generation", *extra["gen"], params, ckpt, device)
        if extra["forward"]:
            from petals_tpu_torch.server.from_pretrained import get_block_config

            family, fcfg = get_block_config(ckpt)
            params_bf16 = dense_reference_params(params, torch.bfloat16)
            params_f32 = dense_reference_params(params, torch.float32)
            for hidden, first, second in extra["forward"]:
                if not torch.equal(first, second):
                    failed.append(f"{label}: two forwards of {hidden.shape[1]} tokens differ")
                refs = [reference_forward(p, family, fcfg, hidden, None, device, dt)
                        for p, dt in ((params_bf16, torch.bfloat16), (params_f32, torch.float32))]
                failed += check_session([second], None, ([refs[0]], ()), ([refs[1]], ()),
                                        f"{label}: forward of {hidden.shape[1]} tokens")
            del params_bf16, params_f32
        if name == "gemma2":
            graphs, n_buckets = extra["graphs"]
            log(f"{label}: C12: {graphs} forward graphs over {len(GEMMA_PHI3_FWD_LENGTHS)} distinct lengths "
                f"and the self-probe's ({n_buckets} buckets)")
            counts["forward_graphs"] = {"graphs": graphs, "lengths": len(GEMMA_PHI3_FWD_LENGTHS),
                                        "buckets": n_buckets}
            if graphs > n_buckets:
                failed.append(f"{label}: {graphs} forward graphs for {n_buckets} buckets")
        if failed:
            raise AssertionError("; ".join(failed))
        counts[f"{name}_client"] = launches
        del params
        free_card()
        shutil.rmtree(ckpt)
    log(f"gemma and phi3: phase done in {time.perf_counter() - t_phase:.1f} s")
    return counts


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


def check_gen_streams(label, entries, replayed, block_params, ckpt, device, kv_quant="none"):
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
    kwargs). ``kv_quant``: the served pool's kind, whose rows the dense
    references write as the pool holds them. Returns (what failed, counts: tokens held to the server's own
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
            out = reference_session(p, family, cfg, x, [], device, dt, kv_quant)[0][0]
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
    by the CLI serves every block of the GEN_SPAN-layer cut of the checkpoint (a
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

    label = f"server-side generation (one port server, --quant_type {quant_type}, {GEN_SPAN} Mistral-7B blocks)"
    dst = os.path.join(ckpt, f"mistral-7b-{GEN_SPAN}-layers-gen-{quant_type}")
    cut = cut_checkpoint(ckpt, dst, GEN_SPAN)
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
        [("--first_block", "0", "--num_blocks", str(GEN_SPAN), "--quant_type", quant_type, "--batch_lanes",
          str(GEN_LANES), "--attn_cache_tokens", str(GEN_CACHE_TOKENS))],
        runs, place_check=place, after_runs=after,
    )
    calls = result["calls"]
    k5_each = 4 * GEN_SPAN if quant_type == "nf4a" else 0
    bad = [c for c in calls if c != (GEN_SPAN, k5_each, 0, 1)]
    log(f"{label}: {len(calls)} generation steps during the runs, each (K1, K5 decode nf4a, captures, replays) "
        f"= {(GEN_SPAN, k5_each, 0, 1)} but {len(bad)}; launches during the runs {launches}; prefill chunks riding a mixed "
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
        ckpt, "--first_block", "0", "--num_blocks", str(n_blocks), "--host", "127.0.0.1", *QUIET_ANNOUNCES,
        *extra_args]))
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


async def _swap_session(client, uids, steps, barrier=None, turn=None, release=None, comp="none", peer=None):
    """One session of phase 18 (billed to ``peer``): its prompt, then each
    decode step after ``barrier(k)`` for round k, then (``turn``: awaited
    first) its last step and its end, after which ``release()`` waits for
    the server to free the lane. Returns the replies, each reply's
    step_meta and each reply's wire dict."""
    from petals_tpu_torch.rpc.serialization import deserialize_array, serialize_array

    stream = await client.open_stream("ptu.inference")
    await stream.send({"uids": uids, "max_length": SWAP_LANE, "batch_size": 1, "compression": comp,
                       "peer_hint": peer})
    if not (await stream.recv(timeout=120))["session_open"]:
        raise AssertionError("session did not open")
    outs, metas, wires = [], [], []
    for k, hidden in enumerate(steps):
        if k == len(steps) - 1 and turn is not None:
            await turn()
        elif k and barrier is not None:
            await barrier(k)
        await stream.send({"tensors": {"hidden": serialize_array(hidden)}})
        reply = await stream.recv(timeout=300)
        wire = reply["tensors"]["hidden"]
        wires.append(wire)
        outs.append(deserialize_array(wire))
        metas.append(reply["step_meta"])
    await stream.end()
    if release is not None:
        await release()
    return outs, metas, wires


def serve_swap_and_check(ckpt, device, smi, label, n_blocks, extra_args, wire=False):
    """Phase 18a (and, with ``wire``, 18b's qint8 session) on one server."""
    from petals_tpu_torch.cli.run_server import build_parser, build_server
    from petals_tpu_torch.data_structures import CHAIN_DELIMITER, make_uid
    from petals_tpu_torch.ops import paged_flash_attention as pfa
    from petals_tpu_torch.rpc import RpcClient

    server = build_server(build_parser().parse_args([
        ckpt, "--first_block", "0", "--num_blocks", str(n_blocks), "--host", "127.0.0.1", *NO_PREFIX_CACHE,
        "--batch_lanes", "4", "--batch_max_length", str(SWAP_LANE), "--n_pages", str(SWAP_PAGES),
        "--swap_host_bytes", str(SWAP_HOST_BYTES), *extra_args]))
    kvq = server.kv_quant_type
    hsz = server.cfg.hidden_size
    gen = torch.Generator().manual_seed(SEED + 18)

    def rnd(n):
        return torch.randn(1, n, hsz, generator=gen).to(torch.bfloat16)

    sessions = [[rnd(n)] + [rnd(1) for _ in range(SWAP_STEPS)] for n in SWAP_PROMPTS]
    sessions[0].append(rnd(SWAP_CHUNK))
    for steps in sessions[1:]:
        steps.append(rnd(1))
    warm = [rnd(64), rnd(1), rnd(1)]
    qint8_steps = [rnd(QINT8_PROMPT)] + [rnd(1) for _ in range(QINT8_STEPS)]
    uids = CHAIN_DELIMITER.join(make_uid(server.dht_prefix, i) for i in range(n_blocks))
    watch = {"pairs": 0, "bad": [], "peak_suspended": 0, "oldest_s": 0.0, "chunk_launches": {}}

    def hook(b):
        """Each swapped lane's gathered rows and its pages' stored leaves,
        read on the compute thread just before the copy out and just after
        the write back, must be bit-equal; the peak of suspended sessions."""
        pending = {}
        out_body, in_body, occupancy_body = b._swap_out_device, b._swap_in_device, b._note_occupancy

        def read(lane, pages):
            pools = b._buffers()
            rows = b.backend.paged_lane_gather(*pools, b._tables[lane].copy())
            idx = torch.as_tensor(pages, dtype=torch.long, device=device)
            return [*rows, *(t.index_select(1, idx) for t in _pool_tensors(pools))]

        def swap_out(lane, pages):
            before = read(lane, pages)
            result = out_body(lane, pages)
            pending[lane] = before
            return result

        def swap_in(lane, entry, pages):
            in_body(lane, entry, pages)
            after = read(lane, pages)
            before = pending.pop(lane)
            watch["pairs"] += 1
            if not all(torch.equal(x, y) for x, y in zip(before, after)):
                watch["bad"].append(lane)

        def note_occupancy():
            occupancy_body()
            watch["peak_suspended"] = max(watch["peak_suspended"], b._scheduler.suspended_count)
            watch["oldest_s"] = max(watch["oldest_s"], b._scheduler.oldest_swap_age())

        b._swap_out_device, b._swap_in_device, b._note_occupancy = swap_out, swap_in, note_occupancy

    async def serve():
        await server.start()
        b = server.batcher
        hook(b)
        client = await RpcClient.connect("127.0.0.1", server.rpc_server.port)
        try:
            await _swap_session(client, uids, warm)
            before = dict(b.stats)
            arrived = [0] * (SWAP_STEPS + 1)
            gates = [asyncio.Event() for _ in range(SWAP_STEPS + 1)]
            turns = [asyncio.Event() for _ in range(len(sessions) + 1)]
            turns[0].set()

            async def barrier(k):
                arrived[k] += 1
                if arrived[k] == len(sessions):
                    gates[k].set()
                await asyncio.wait_for(gates[k].wait(), 300)

            def session_fns(s):
                async def turn():
                    await asyncio.wait_for(turns[s].wait(), 300)
                    if s == 0:
                        # the chunk runs on moved pages: the lane swapped out
                        # (by hand, unless a round preempted it already)
                        lane, slot = next((l, sl) for l, sl in b._scheduler.lanes.items() if sl.peer_id == "session-0")
                        if not slot.suspended and not await b._swap_out_lane(lane):
                            raise AssertionError("the forced swap-out did not happen")
                        _reset_launch_counts()

                async def release():
                    if s == 0:
                        watch["chunk_launches"] = dict(_launch_counts(), K3=dict(
                            pfa.paged_flash_prefill_attend.kv_quant_launches))
                    for _ in range(30000):
                        if b.occupancy_hint()["busy_lanes"] < len(sessions) - s:
                            break
                        await asyncio.sleep(0.001)
                    turns[s + 1].set()

                return turn, release

            _reset_launch_counts()
            t0 = time.perf_counter()
            runs = await asyncio.gather(*(
                _swap_session(client, uids, steps, barrier, *session_fns(s), peer=f"session-{s}")
                for s, steps in enumerate(sessions)))
            wall = time.perf_counter() - t0
            stats = {k: v - before[k] for k, v in b.stats.items() if not k.startswith("max")}
            summary = b._scheduler.summary()
            qint8 = None
            if wire:
                plain = await _swap_session(client, uids, qint8_steps)
                comp = await _swap_session(client, uids, qint8_steps, comp="qint8")
                qint8 = (plain, comp)
            events = list(b.swap_events)
            return runs, stats, summary, wall, qint8, events, b.swap_host_memory, b.page_nbytes
        finally:
            await client.close()
            await server.shutdown()

    t0 = time.perf_counter()
    runs, stats, summary, wall, qint8, events, memory_kind, page_bytes = asyncio.run(serve())
    log(f"{label}: {len(sessions)} sessions ({SWAP_PROMPTS} + {SWAP_STEPS} + 1 tokens) on {SWAP_PAGES} pages "
        f"of {page_bytes} B in {wall:.2f} s; scheduler {summary}; batcher {stats}")
    failed = []
    params_bf16 = dense_reference_params(server.backend.block_params, torch.bfloat16)
    params_f32 = dense_reference_params(server.backend.block_params, torch.float32)
    for s, (steps, (outs, metas, _)) in enumerate(zip(sessions, runs)):
        args = (server.family, server.cfg, steps[0], steps[1:], device)
        failed.extend(check_session(
            outs, None, reference_session(params_bf16, *args, torch.bfloat16, kvq),
            reference_session(params_f32, *args, torch.float32, kvq), f"{label}: session {s}", kvq))
        if not {"busy_lanes", "lane_waiters", "usage"} <= set(metas[-1]):
            failed.append(f"{label}: session {s}'s reply lacks the load hint or its bill: {sorted(metas[-1])}")
    if summary["swap_outs"] < 1 or summary["swap_ins"] != summary["swap_outs"]:
        failed.append(f"{label}: swaps out {summary['swap_outs']}, in {summary['swap_ins']}")
    if watch["bad"] or watch["pairs"] != summary["swap_ins"]:
        failed.append(f"{label}: {len(watch['bad'])} of {watch['pairs']} swapped lanes came back changed "
                      f"(lanes {watch['bad']})")
    if stats["graph_captures"] or stats["graph_anomalies"]:
        failed.append(f"{label}: a step program was captured after the warm-up: {stats}")
    launches = watch["chunk_launches"]
    chunk_kernel = launches["K2"] if kvq == "none" else launches["K3"].get(kvq, 0)
    if chunk_kernel != n_blocks:
        failed.append(f"{label}: the chunk on moved pages ran the prefill kernel {chunk_kernel} times: {launches}")
    if failed:
        raise AssertionError("; ".join(failed))
    swaps = [f"{e['dir']} {e['pages']}p {e['bytes'] / 2**20:.1f} MiB {e['seconds'] * 1e3:.3f} ms "
             f"{e['bytes'] / e['seconds'] / 1e9:.2f} GB/s" for e in events]
    for direction in ("out", "in"):
        rates = [e["bytes"] / e["seconds"] / 1e9 for e in events if e["dir"] == direction]
        ms = [e["seconds"] * 1e3 for e in events if e["dir"] == direction]
        log(f"{label}: swap-{direction}: {len(rates)} swaps, median {statistics.median(ms):.3f} ms, "
            f"median {statistics.median(rates):.2f} GB/s, max {max(rates):.2f} GB/s ({memory_kind} host memory; {smi})")
    log(f"{label}: every swap: {'; '.join(swaps)}")
    log(f"{label}: {watch['pairs']} round trips bit-equal (rows through paged_lane_gather, pages' stored leaves); "
        f"peak suspended {watch['peak_suspended']}; oldest suspension {watch['oldest_s']:.3f} s; chunk on moved "
        f"pages: {launches}")
    if qint8 is not None:
        check_qint8(label, qint8, qint8_steps, server, params_bf16, params_f32, device, smi)
    log(f"{label}: phase done in {time.perf_counter() - t0:.1f} s")


def check_qint8(label, runs, steps, server, params_bf16, params_f32, device, smi) -> None:
    """18b's qint8 session: each reply's float32 decode within a code step
    (absmax_block / 254) plus one float32 ulp of the same reply
    uncompressed, which is held to the dense reference; then the codec's
    time on a QINT8_REPLY reply."""
    import numpy as np

    from petals_tpu_torch.rpc.serialization import deserialize_array, qint8_dequantize, serialize_array

    (plain, _, _), (_, _, wires) = runs
    worst = 0.0
    for exact, wire in zip(plain, wires):
        if wire["compression"] != "qint8":
            raise AssertionError(f"{label}: a reply came back as {wire['compression']}, not qint8")
        got = qint8_dequantize(np.frombuffer(wire["data"], np.int8), np.frombuffer(wire["scales"], np.float32))
        want = exact.float().numpy().reshape(-1)
        n_blocks = -(-want.size // 1024)
        padded = np.zeros(n_blocks * 1024, np.float32)
        padded[: want.size] = np.abs(want)
        absmax = np.maximum(padded.reshape(n_blocks, 1024).max(1), np.float32(1e-8))
        bound = np.repeat(absmax / np.float32(254) + np.spacing(absmax), 1024)[: want.size]
        worst = max(worst, float((np.abs(got - want) / bound).max()))
    args = (server.family, server.cfg, steps[0], steps[1:], device)
    failed = check_session(plain, None, reference_session(params_bf16, *args, torch.bfloat16),
                           reference_session(params_f32, *args, torch.float32), f"{label}: the uncompressed session")
    if failed or worst > 1:
        raise AssertionError(f"{label}: qint8 replies off by {worst:.3f} of their bound; {failed}")
    reply = torch.randn(QINT8_REPLY, generator=torch.Generator().manual_seed(SEED + 181)).to(torch.bfloat16)
    enc, dec = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        w = serialize_array(reply, "qint8")
        t1 = time.perf_counter()
        deserialize_array(w)
        enc.append(t1 - t0)
        dec.append(time.perf_counter() - t1)
    log(f"{label}: qint8 replies within {worst:.6f} of absmax_block / 254 + 1 ulp of the uncompressed ones; "
        f"the codec on a {QINT8_REPLY[0]} x {QINT8_REPLY[1]} bf16 reply on the host: encode "
        f"{statistics.median(enc) * 1e3:.3f} ms, decode {statistics.median(dec) * 1e3:.3f} ms (medians of 5; "
        f"{len(w['data']) + len(w['scales'])} wire bytes against {reply.numel() * 2}; {smi})")


def serve_relay_and_check(ckpt, device, smi) -> None:
    """18b: a port DHT bootstrap with its relay (run_dht's), a port server of
    the SHORT_SPAN-layer cut behind --relay_via, the port client's greedy
    stream through the relay; then the same server started again without
    the relay, and the same stream from it directly."""
    from petals_tpu_torch.cli.run_dht import build_parser as dht_parser
    from petals_tpu_torch.cli.run_dht import start_node, start_relay
    from petals_tpu_torch.cli.run_server import build_parser, build_server
    from petals_tpu_torch.client import AutoDistributedModelForCausalLM
    from petals_tpu_torch.client.runtime import SwarmRuntime

    label = f"relay (port bootstrap and relay, a port server of {SHORT_SPAN} blocks)"
    t_phase = time.perf_counter()
    cut = cut_checkpoint(ckpt, os.path.join(ckpt, f"mistral-7b-{SHORT_SPAN}-layers"), SHORT_SPAN)
    prompt = torch.randint(0, MISTRAL_7B["vocab_size"], (1, RELAY_PROMPT),
                           generator=torch.Generator().manual_seed(SEED + 182)).numpy()
    loop = SwarmRuntime()
    streams = {}
    try:
        args = dht_parser().parse_args(["--host", "127.0.0.1"])
        boot = loop.run(start_node(args), LOOP_TIMEOUT_S)
        relay = loop.run(start_relay(args, boot), LOOP_TIMEOUT_S)
        peers = [boot.own_addr.to_string()]
        try:
            for how, extra in (("relay", ["--relay_via", f"127.0.0.1:{relay.port}"]), ("direct", [])):
                server = build_server(build_parser().parse_args([
                    cut, "--host", "127.0.0.1", "--initial_peers", *peers, "--first_block", "0", "--num_blocks",
                    str(SHORT_SPAN), "--no_server_side_generation", *NO_PREFIX_CACHE, *extra]))
                loop.run(server.start(), LOOP_TIMEOUT_S)
                try:
                    addr = server.contact_addr
                    if (how == "relay") != bool(addr.relayed) or (how == "relay") != server.dht.client_mode:
                        raise AssertionError(f"{label}: {how} server announces {addr.to_string()}")
                    model = AutoDistributedModelForCausalLM.from_pretrained(cut, initial_peers=peers)
                    try:
                        t0 = time.perf_counter()
                        streams[how] = model.generate(prompt, max_new_tokens=RELAY_NEW)
                        log(f"{label}: {how}: {RELAY_NEW} greedy tokens in {time.perf_counter() - t0:.3f} s "
                            f"from {addr.to_string()} ({smi})")
                    finally:
                        model.close()
                finally:
                    loop.run(server.shutdown(), LOOP_TIMEOUT_S)
                    del server
                    free_card()
        finally:
            loop.run(relay.stop(), LOOP_TIMEOUT_S)
            loop.run(boot.shutdown(), LOOP_TIMEOUT_S)
    finally:
        loop.shutdown()
    relayed, direct = (torch.as_tensor(streams[k]) for k in ("relay", "direct"))
    if relayed.shape != (1, RELAY_PROMPT + RELAY_NEW) or not torch.equal(relayed, direct):
        raise AssertionError(f"{label}: the stream through the relay {relayed.tolist()} differs from the direct "
                             f"one {direct.tolist()}")
    log(f"{label}: the stream through the relay equals the direct one, token for token; phase done in "
        f"{time.perf_counter() - t_phase:.1f} s")


# phase 18a's runs: (what, blocks, CLI arguments, 18b's qint8 session on it)
SWAP_RUNS = (
    ("bf16", SPAN, (), True),
    ("--kv_quant_type nf4a", SHORT_SPAN, ("--kv_quant_type", "nf4a"), False),
)


def serve_swap_runs(ckpt, device, smi) -> None:
    """Phase 18: preemption on both runs, then the relay."""
    for what, n_blocks, args, wire in SWAP_RUNS:
        serve_swap_and_check(ckpt, device, smi, f"swap ({what}, {n_blocks} blocks)", n_blocks, args, wire)
        free_card()
    serve_relay_and_check(ckpt, device, smi)
    free_card()


class MigrationSpy:
    """The KV bytes and seconds of the port client's exports (received) and
    imports (sent), over its own link."""

    def __init__(self):
        from petals_tpu_torch.client.inference_session import InferenceSession, _ServerInferenceSession

        self.export_bytes = self.import_bytes = 0
        self.export_s, self.import_s = [], []
        self._patched = [(InferenceSession, "_export_from"), (_ServerInferenceSession, "import_kv")]
        self._orig = [getattr(cls, name) for cls, name in self._patched]
        export_from, import_kv = self._orig
        spy = self

        async def timed_export(session, *args):
            t0 = time.perf_counter()
            got = await export_from(session, *args)
            spy.export_s.append(time.perf_counter() - t0)
            if isinstance(got, tuple):
                spy.export_bytes += sum(t.numel() * t.element_size() for t in got[:2])
            return got

        async def timed_import(session, k, v, position):
            t0 = time.perf_counter()
            await import_kv(session, k, v, position)
            spy.import_s.append(time.perf_counter() - t0)
            spy.import_bytes += sum(t.numel() * t.element_size() for t in (k, v))

        InferenceSession._export_from, _ServerInferenceSession.import_kv = timed_export, timed_import

    def close(self):
        for (cls, name), orig in zip(self._patched, self._orig):
            setattr(cls, name, orig)


def _lane_of(server):
    """The one busy lane of a server's pool."""
    batcher = server.batcher
    busy = [lane for lane in range(batcher.n_lanes) if lane not in batcher._free_lanes]
    if len(busy) != 1:
        raise AssertionError(f"expected one busy lane, found {busy}")
    return busy[0]


def hold_seeded_kernels(label, server, position, device, *, private_batch=None):
    """The kernels held against their plain versions on the cache a moved
    session now reads on ``server`` (block 0, its rows [0, position)): on a
    paged lane K1 (a query at position - 1) and K2 (a MIGRATE_HOLD_ROWS-row
    chunk ending at position), K3's arms on a quantized pool; on a private
    cache (``private_batch`` rows) K4 on the same chunk. Called after the
    main path's launch counts were read: these launches do not count."""
    from petals_tpu_torch.ops import flash_attention as fa
    from petals_tpu_torch.ops import paged_flash_attention as pfa
    from petals_tpu_torch.ops.paged_attention import PagedPool, paged_attend, paged_prefill_attend, pool_block

    torch.cuda.synchronize()
    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    hq, d, window = MISTRAL_7B["num_attention_heads"], MISTRAL_7B["head_dim"], MISTRAL_7B["sliding_window"]
    n, chunk_pos = MIGRATE_HOLD_ROWS, position - MIGRATE_HOLD_ROWS
    if private_batch is not None:
        k, v = (buf[0, :private_batch] for buf in _private_buffers(server))
        q = torch.randn(private_batch, n, hq, d, generator=gen, device=device).to(k.dtype)
        kw = dict(q_offset=chunk_pos, kv_length=position, sliding_window=window)
        got = fa.flash_attend(q, k, v, **kw)
        err = (got.float() - fa.flash_attend_reference(q.float(), k, v, **kw)).abs().max().item()
        log(f"{label}: K4 on the seeded private cache ({private_batch} rows, {n} queries at {chunk_pos}): "
            f"max abs err {err:.3e} (tol {KERNEL_TOL})")
        if not torch.isfinite(got).all() or err > KERNEL_TOL:
            raise AssertionError(f"{label}: K4 disagrees with its plain version on the seeded cache ({err})")
        return
    batcher = server.batcher
    row = torch.as_tensor(batcher._tables[_lane_of(server)].copy(), device=device)
    kp, vp = (pool_block(pool, 0) for pool in batcher._buffers())
    quantized = isinstance(kp, PagedPool)
    plain = (lambda pool: pool) if quantized else (lambda pool: pool.float())  # noqa: E731
    names = (f"K3 {kp.kind} decode", f"K3 {kp.kind} prefill") if quantized else ("K1", "K2")
    q = torch.randn(1, 1, hq, d, generator=gen, device=device).to(torch.bfloat16)
    pos = torch.tensor([position - 1], dtype=torch.int32, device=device)
    got = pfa.paged_flash_attend(q, kp, vp, row[None], pos, sliding_window=window)
    want = paged_attend(q.float(), plain(kp), plain(vp), row[None], pos, sliding_window=window)
    if quantized:
        err = (got.float() - want).abs().max().item()
        log(f"{label}: {names[0]} on the moved pages: max abs err {err:.3e} (tol {KERNEL_TOL})")
        if not torch.isfinite(got).all() or err > KERNEL_TOL:
            raise AssertionError(f"{label}: {names[0]} disagrees with its plain version on the moved pages ({err})")
    else:
        check_lanes(f"{label}: {names[0]} on the moved pages", got, want)
    qc = torch.randn(1, n, hq, d, generator=gen, device=device).to(torch.bfloat16)
    got = pfa.paged_flash_prefill_attend(qc, kp, vp, row, *pfa.chunk_scalars(chunk_pos, n, device),
                                         sliding_window=window)
    want = paged_prefill_attend(qc.float(), plain(kp), plain(vp), row, chunk_pos, n, sliding_window=window)
    check_rows(f"{label}: {names[1]} on the moved pages, {n} rows at {chunk_pos}", got, want,
               KV_ROW_REL_TOL if quantized else ROW_REL_TOL)


def _private_buffers(server):
    """The (k, v) cache of the one open private session of ``server``."""
    cache = server.memory_cache
    pool_handles = set(server.batcher._handles or ())
    # the newest allocation: an earlier session's cache may not be freed yet
    handles = sorted(h for h in cache._allocated if h not in pool_handles)[-2:]
    if len(handles) != 2:
        raise AssertionError(f"expected a private cache (2 buffers), found handles {handles}")
    return cache.get_buffers(*handles)


async def _undrain(server):
    """A drained server serving again (the smoke reuses its pair): steps and
    sessions taken, its parked sessions and redirects dropped, ONLINE."""
    from petals_tpu_torch.data_structures import ServerState

    handler = server.handler
    handler.draining = False
    handler._parked.clear()
    handler._migrated_away.clear()
    server._state = ServerState.ONLINE
    await server._announce(ServerState.ONLINE)


def serve_migration_and_check(ckpt, device, smi) -> dict:
    """Phase 19: a session's KV moved between port servers (runs a-e), each
    against the same session unmoved. Returns the launches on the moved
    caches by kernel."""
    from petals_tpu_torch.cli.run_server import build_parser, build_server
    from petals_tpu_torch.client import AutoDistributedModelForCausalLM
    from petals_tpu_torch.client.runtime import SwarmRuntime
    from petals_tpu_torch.dht import DHTNode

    import numpy as np

    t_phase = time.perf_counter()
    cut, short_cut = (cut_checkpoint(ckpt, os.path.join(ckpt, f"mistral-7b-{n}-layers"), n) for n in (SPAN, SHORT_SPAN))
    gen = torch.Generator().manual_seed(SEED + 19)
    vocab = MISTRAL_7B["vocab_size"]

    def ids(shape):
        return torch.randint(0, vocab, shape, generator=gen).numpy()

    loop = SwarmRuntime()
    boot, servers = None, []
    launches = {"K1": 0, "K2": 0, "K3 decode": 0, "K3 prefill": 0, "K4": 0}
    # (label, recorded session, tag, tokens, prompt length, block params, kv kind, reencode)
    entries = []
    try:
        boot = loop.run(DHTNode.create(host="127.0.0.1"), LOOP_TIMEOUT_S)
        peers = [boot.own_addr.to_string()]

        def start(path, *args):
            server = build_server(build_parser().parse_args([
                path, "--host", "127.0.0.1", "--initial_peers", *peers, "--update_period", str(SWARM_UPDATE_PERIOD),
                "--no_server_side_generation", *NO_PREFIX_CACHE, "--batch_max_length", str(MIGRATE_LANE),
                "--attn_cache_tokens", str(MIGRATE_CACHE_TOKENS), *args]))
            t0 = time.perf_counter()
            loop.run(server.start(), LOOP_TIMEOUT_S)
            servers.append(server)
            log(f"migration: server at [{server.first_block}, {server.first_block + server.num_blocks}) "
                f"(--phase_tier {server.phase_tier}, --kv_quant_type {server.kv_quant_type}) started in "
                f"{time.perf_counter() - t0:.1f} s")
            return server

        def stop(*which):
            for server in which:
                check_graph_stats(f"migration: server at [{server.first_block}, "
                                  f"{server.first_block + server.num_blocks}) {server.phase_tier}",
                                  server.batcher.stats)
                loop.run(server.shutdown(), LOOP_TIMEOUT_S)
                servers.remove(server)
            free_card()

        def client(path):
            model = AutoDistributedModelForCausalLM.from_pretrained(
                path, initial_peers=peers, min_backoff=0.1, ban_timeout=1.0, disagg_handoff=False,
            )
            return model, ClientRecorder(model)

        def on(model, session):
            (span,) = [s.span for s in session._session._sessions]
            return span.peer_id.to_string()

        def peer(server):
            return server.dht.peer_id.to_string()

        def counted(fn, moved=True):
            """Run ``fn`` with the kernels' launch counters at 0; what ran
            counts as launches on a moved cache when ``moved``."""
            _reset_launch_counts()
            out = fn()
            torch.cuda.synchronize()
            from petals_tpu_torch.ops import flash_attention as fa
            from petals_tpu_torch.ops import paged_flash_attention as pfa

            got = {"K1": pfa.paged_flash_attend.launches, "K2": pfa.paged_flash_prefill_attend.launches,
                   "K3 decode": sum(pfa.paged_flash_attend.kv_quant_launches.values()),
                   "K3 prefill": sum(pfa.paged_flash_prefill_attend.kv_quant_launches.values()),
                   "K4": fa.flash_attend.launches}
            for k, n in got.items():
                launches[k] += n if moved else 0
            return out, got

        def turn(model, session, tokens, extra, new_tokens):
            """A chat turn: the ``extra`` tokens after ``tokens``, then
            ``new_tokens`` greedy ones."""
            return model.generate(np.concatenate([tokens, extra], axis=1), max_new_tokens=new_tokens, session=session)

        def moved_run(label, model, rec, prompt, move, target_of, *, private=False, kv="none", params=None):
            """One session: the prompt and MIGRATE_STEPS greedy tokens, then
            ``move(source)`` (the source is where the session runs), then a
            chat turn of MIGRATE_EXTRA tokens and MIGRATE_STEPS greedy ones;
            the same session unmoved first, whose stream the moved one must
            equal. On a quantized pool (``kv``) the move encodes the rows
            twice more (ROADMAP C9: 0.9697 of the scale each time, as
            petals_tpu does), so there the tokens up to the move must be
            equal and the later ones the greedy picks of a reference that
            re-encodes as the move does (check_client_streams). Returns
            (stream, launches after the move)."""
            max_length = prompt.shape[1] + 2 * MIGRATE_STEPS + MIGRATE_EXTRA
            extra = ids((prompt.shape[0], MIGRATE_EXTRA))
            streams = {}
            for moved in (False, True):
                with model.inference_session(max_length=max_length, batch_size=prompt.shape[0]) as session:
                    first = model.generate(prompt, max_new_tokens=MIGRATE_STEPS, session=session)
                    source = next(s for s in servers if peer(s) == on(model, session))
                    target = target_of(source)
                    if moved:
                        move_at = len(rec.sessions[-1]["steps"])  # the first step after the move
                        move(source)
                    out, got = counted(lambda: turn(model, session, first, extra, MIGRATE_STEPS), moved)
                    now = on(model, session)
                    if now != peer(target if moved else source):
                        raise AssertionError(f"{label}: the session runs on {now[:8]}, not on the "
                                             f"{'target' if moved else 'source'}")
                    if moved:
                        hold_seeded_kernels(label, target, session.position, device,
                                            private_batch=prompt.shape[0] if private else None)
                streams[moved] = out
                if moved:
                    # a quantized pool's rows are encoded twice more on the way: the
                    # park's pack for the wire, and the adopting pool's write
                    p0 = prompt.shape[1]
                    cols = list(range(p0, p0 + MIGRATE_STEPS)) + list(
                        range(p0 + MIGRATE_STEPS + MIGRATE_EXTRA, p0 + 2 * MIGRATE_STEPS + MIGRATE_EXTRA))
                    entries.append((label, rec.sessions[-1], "other", out, p0, params, kv,
                                    None if kv == "none" else (move_at, 2), cols))
            n_new = streams[True].shape[1] - prompt.shape[1]
            before = prompt.shape[1] + MIGRATE_STEPS  # the tokens up to the move
            if kv == "none" and not np.array_equal(streams[True], streams[False]):
                raise AssertionError(f"{label}: the moved session's stream {streams[True][0, -24:].tolist()} differs "
                                     f"from the unmoved one's {streams[False][0, -24:].tolist()}")
            if not np.array_equal(streams[True][:, :before], streams[False][:, :before]):
                raise AssertionError(f"{label}: the streams differ before the move")
            same = int((streams[True] == streams[False]).all(0).cumprod(0).sum()) - prompt.shape[1]
            log(f"{label}: the moved session's first {same} of {n_new} tokens equal the unmoved session's"
                + ("" if same == n_new else " (the rest are held to a reference that re-encodes as the move does)")
                + f"; launches after the move {got}")
            return streams[True], got

        # ---- the 8-block pair: A the prefill tier, B the decode tier
        a = start(cut, "--throughput", "1000", "--phase_tier", "prefill")
        b = start(cut, "--throughput", "1000", "--phase_tier", "decode")
        params = a.backend.block_params
        model, rec = client(cut)
        spy = MigrationSpy()
        try:
            model.generate(ids((1, MIGRATE_SHORT_PROMPT)), max_new_tokens=2)  # warm-up: the pools open
            other = {peer(a): b, peer(b): a}

            def target_of(source):
                return other[peer(source)]

            # run c: the prefill-to-decode handoff
            label = "migration c (handoff, prefill tier to decode tier, bf16)"
            prompt = ids((1, MIGRATE_SHORT_PROMPT))
            streams = {}
            for handoff in (False, True):
                model.remote.sequence_manager.config.disagg_handoff = handoff
                pushed0 = a.handler.migration_stats["push_bytes"]
                with model.inference_session(max_length=MIGRATE_SHORT_PROMPT + MIGRATE_STEPS) as session:
                    first = model.generate(prompt, max_new_tokens=1, session=session)
                    out, got = counted(lambda: model.generate(first, max_new_tokens=MIGRATE_STEPS - 1, session=session),
                                       handoff)
                    stats = session._session._handoff_stats
                    if handoff:
                        if stats != {"adopted": 1, "fallback": 0, "replayed": 0} or on(model, session) != peer(b):
                            raise AssertionError(f"{label}: no clean handoff to the decode tier ({stats})")
                        if not got["K1"]:
                            raise AssertionError(f"{label}: K1 never ran on the adopted pages ({got})")
                        hold_seeded_kernels(label, b, session.position, device)
                        entries.append((label, rec.sessions[-1], "greedy", out, MIGRATE_SHORT_PROMPT, params, "none",
                                        None))
                        log(f"{label}: {a.handler.migration_stats['push_bytes'] - pushed0} bytes pushed A -> B; "
                            f"launches after the handoff {got}")
                    elif on(model, session) != peer(a):
                        raise AssertionError(f"{label}: without the handoff the session left the prefill tier")
                streams[handoff] = out
            model.remote.sequence_manager.config.disagg_handoff = False
            if not np.array_equal(streams[True], streams[False]):
                raise AssertionError(f"{label}: the handed-off stream differs from the colocated one")
            log(f"{label}: the handed-off session's {MIGRATE_STEPS} tokens equal the colocated session's")

            # run a: export over the client's link, import on the other server
            def drain_export(source):
                loop.run(source.drain(migrate=False), LOOP_TIMEOUT_S)

            def undrain():
                for server in (a, b):
                    loop.run(_undrain(server), LOOP_TIMEOUT_S)
                time.sleep(1.5)  # the client's ban of the drained server lapses
                model.remote.update_routing()

            label = "migration a (export -> kv_import, bf16)"
            stats0 = {n: dict(s.handler.migration_stats) for n, s in (("a", a), ("b", b))}
            _, got = moved_run(label, model, rec, ids((1, MIGRATE_PROMPT)), drain_export, target_of, params=params)
            if not (got["K1"] and got["K2"]):
                raise AssertionError(f"{label}: K1 or K2 never ran on the imported pages ({got})")
            exp = {k: a.handler.migration_stats[k] - stats0["a"][k] for k in ("exports", "export_bytes", "export_s")}
            imp = {k: b.handler.migration_stats[k] - stats0["b"][k] for k in ("imports", "import_bytes", "import_s")}
            if exp["exports"] != 1 or imp["imports"] != 1 or spy.export_bytes == 0:
                raise AssertionError(f"{label}: expected one export and one import ({exp}, {imp})")
            log(f"{label}: export {spy.export_bytes} bytes received by the client in {spy.export_s[-1] * 1e3:.1f} ms "
                f"(server: {exp['export_bytes']} wire bytes, {exp['export_s'] * 1e3:.1f} ms); import "
                f"{spy.import_bytes} bytes sent in {spy.import_s[-1] * 1e3:.1f} ms (server: {imp['import_bytes']} "
                f"wire bytes, {imp['import_s'] * 1e3:.1f} ms) ({smi})")
            undrain()

            # run e: a private batch-2 session, exported and imported; the
            # chat turn's chunk runs K4 on the seeded cache
            label = f"migration e (a private batch-{MIGRATE_PRIVATE[0]} session, export -> kv_import)"
            _, got = moved_run(label, model, rec, ids(MIGRATE_PRIVATE), drain_export, target_of, private=True,
                               params=params)
            if got["K4"] < SPAN or got["K1"] or got["K2"]:
                raise AssertionError(f"{label}: K4 did not run on every block of the seeded cache ({got})")
            undrain()

            # run b: drain-to-migrate, the client adopting at the target
            label = "migration b (drain -> push -> kv_adopt, bf16)"
            spy.export_bytes = spy.import_bytes = 0
            push0 = {k: a.handler.migration_stats[k] for k in ("pushes", "push_bytes", "push_s")}
            adopt0 = {k: b.handler.migration_stats[k] for k in ("adopts", "adopt_bytes", "adopt_s")}
            _, got = moved_run(label, model, rec, ids((1, MIGRATE_SHORT_PROMPT)),
                               lambda source: loop.run(source.drain(migrate=True), LOOP_TIMEOUT_S),
                               target_of, params=params)
            push = {k: a.handler.migration_stats[k] - push0[k] for k in push0}
            adopt = {k: b.handler.migration_stats[k] - adopt0[k] for k in adopt0}
            if push["pushes"] != 1 or adopt["adopts"] != 1:
                raise AssertionError(f"{label}: expected one push and one adopt ({push}, {adopt})")
            if spy.export_bytes or spy.import_bytes:
                raise AssertionError(f"{label}: KV crossed the client's link ({spy.export_bytes} bytes received, "
                                     f"{spy.import_bytes} sent)")
            if not (got["K1"] and got["K2"]):
                raise AssertionError(f"{label}: K1 or K2 never ran on the adopted pages ({got})")
            log(f"{label}: push {push['push_bytes']} bytes in {push['push_s'] * 1e3:.1f} ms server to server, "
                f"adopted ({adopt['adopt_bytes']} bytes) in {adopt['adopt_s'] * 1e3:.1f} ms; the client received 0 KV "
                f"bytes and sent 0 ({smi})")
        finally:
            spy.close()
            model.close()
        stop(a, b)

        # run b again on an nf4a pool (SHORT_SPAN blocks): the packed entry crosses the wire
        a2 = start(short_cut, "--throughput", "1000", "--kv_quant_type", "nf4a")
        b2 = start(short_cut, "--throughput", "1", "--kv_quant_type", "nf4a")
        model, rec = client(short_cut)
        try:
            model.generate(ids((1, 64)), max_new_tokens=2)  # warm-up
            label = f"migration b (drain -> push -> kv_adopt, --kv_quant_type nf4a, {SHORT_SPAN} blocks)"
            push0 = a2.handler.migration_stats["push_bytes"]
            _, got = moved_run(label, model, rec, ids((1, MIGRATE_SHORT_PROMPT)),
                               lambda source: loop.run(source.drain(migrate=True), LOOP_TIMEOUT_S),
                               lambda source: b2, kv="nf4a", params=a2.backend.block_params)
            if not (got["K3 decode"] and got["K3 prefill"]) or got["K1"] or got["K2"]:
                raise AssertionError(f"{label}: K3's nf4a arms did not run (alone) on the adopted pages ({got})")
            log(f"{label}: packed push {a2.handler.migration_stats['push_bytes'] - push0} bytes")
        finally:
            model.close()
        stop(a2, b2)

        # run d: the push chain of two 4-block servers, pushes on and off
        label = f"migration d (push chain [0, {SWARM_HALF}) -> [{SWARM_HALF}, {SPAN}), bf16)"
        c = start(cut, "--first_block", "0", "--num_blocks", str(SWARM_HALF), "--throughput", "1000")
        d = start(cut, "--first_block", str(SWARM_HALF), "--num_blocks", str(SWARM_HALF), "--throughput", "1000")
        prompt, streams = ids((1, PUSH_PROMPT)), {}
        for push in (True, False):
            model = AutoDistributedModelForCausalLM.from_pretrained(cut, initial_peers=peers,
                                                                    use_server_to_server=push)
            rec = ClientRecorder(model)
            try:
                model.generate(ids((1, 64)), max_new_tokens=2)  # warm-up
                stats0 = dict(d.handler.migration_stats)
                streams[push], got = counted(lambda: model.generate(prompt, max_new_tokens=PUSH_NEW), False)
                st = {k: d.handler.migration_stats[k] - stats0[k]
                      for k in ("pushed_steps_served", "client_copies_skipped", "pushed_copies_skipped")}
                walls = [t * 1e3 for t in rec.sessions[-1]["step_s"][1:]]
                log(f"{label}: use_server_to_server={push}: {st['pushed_steps_served']} pushed steps served, "
                    f"{st['client_copies_skipped']} client copies and {st['pushed_copies_skipped']} pushed copies "
                    f"skipped; per-token wall median {statistics.median(walls):.3f} ms ({smi})")
                skipped = st["client_copies_skipped"] + st["pushed_copies_skipped"]
                # the last step's second copy may meet a closed session
                if push and (skipped < PUSH_NEW - 1 or st["pushed_steps_served"] + st["client_copies_skipped"] < 1):
                    raise AssertionError(f"{label}: every step should reach [{SWARM_HALF}, {SPAN}) twice ({st})")
                if not push and (skipped or st["pushed_steps_served"]):
                    raise AssertionError(f"{label}: pushes without use_server_to_server ({st})")
                if push:
                    entries.append((label, rec.sessions[-1], "greedy", streams[push], PUSH_PROMPT,
                                    c.backend.block_params + d.backend.block_params, "none", None))
            finally:
                model.close()
        if not np.array_equal(streams[True], streams[False]):
            raise AssertionError(f"{label}: the pushed chain's stream differs from the relayed one")
        log(f"{label}: the streams with and without pushes are equal; launches {got}")
        stop(c, d)

        # every moved session held to the dense reference, as phase 13 holds the client's
        failed = []
        for label, session, tag, tokens, prompt_len, block_params, kv, reencode, *cols in entries:
            failed += check_client_streams(label, [(session, tag, tokens, prompt_len, *cols)], block_params,
                                           short_cut if kv != "none" else cut, device, kv_quant=kv,
                                           reencode=reencode)
        if failed:
            raise AssertionError("; ".join(failed))
    finally:
        for server in list(servers):
            loop.run(server.shutdown(), LOOP_TIMEOUT_S)
        if boot is not None:
            loop.run(boot.shutdown(), LOOP_TIMEOUT_S)
        loop.shutdown()
    log(f"migration: launches on the moved caches {launches}; phase done in {time.perf_counter() - t_phase:.1f} s")
    return launches


def _verify_case(device, kind):
    """The verify arm's timed case at Mistral-7B widths: SPEC_VERIFY_POSITIONS
    lanes of SPEC_K + 1 query rows on permuted 1024-token tables over seeded
    bf16 pools (quantized on the card for ``kind``)."""
    from petals_tpu_torch.ops.paged_attention import PagedPool, quantize_kv_rows

    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    (hq, hkv, d), S = (MISTRAL_7B[k] for k in ("num_attention_heads", "num_key_value_heads", "head_dim")), SPEC_K + 1
    n_lanes, max_pages = len(SPEC_VERIFY_POSITIONS), 1024 // PAGE
    n_pages = n_lanes * max_pages + 8
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(SEED + 21)).to(torch.int32)
    tables = perm[: n_lanes * max_pages].reshape(n_lanes, max_pages).to(device)
    pools = [torch.randn(n_pages, PAGE, hkv, d, generator=gen, device=device).to(torch.bfloat16) for _ in range(2)]
    if kind != "none":
        pools = [PagedPool(*quantize_kv_rows(p, kind)) for p in pools]
    q = torch.randn(n_lanes, S, hq, d, generator=gen, device=device).to(torch.bfloat16)
    positions = torch.tensor(SPEC_VERIFY_POSITIONS, dtype=torch.int32, device=device)
    return q, pools[0], pools[1], tables, positions


def _library_verify(q, kp, vp, tables, positions, window):
    """The verify arm's yardstick: the pages gathered (and dequantized) into
    a dense view, then PyTorch's fused attention with each row's causal and
    window mask."""
    from petals_tpu_torch.ops.paged_attention import gather_pages

    k = gather_pages(kp, tables).transpose(1, 2)
    v = gather_pages(vp, tables).transpose(1, 2)
    kv_pos = torch.arange(k.shape[2], device=q.device)
    q_pos = positions[:, None].long() + torch.arange(q.shape[1], device=q.device)
    mask = (kv_pos[None, None, :] <= q_pos[:, :, None]) & (kv_pos[None, None, :] > q_pos[:, :, None] - window)
    return _sdpa(q.transpose(1, 2), k, v, mask[:, None]).transpose(1, 2)


def check_verify_arm(device, timer, kind) -> dict:
    """K1 (``kind`` "none") or K3's ``kind`` arm in the verify step's shape,
    4 lanes x SPEC_K + 1 rows at Mistral-7B widths, held against the plain
    per-row causal ``paged_attend`` (each lane within KERNEL_TOL), timed
    beside the plain version, gather + SDPA, the one-row decode of the same
    lanes and the bound. Returns the kernels line's ``verify_arm`` entry
    (without its launches)."""
    from petals_tpu_torch.ops import paged_flash_attention as pfa
    from petals_tpu_torch.ops.paged_attention import kv_wire_bytes_per_token, paged_attend

    q, kp, vp, tables, positions = _verify_case(device, kind)
    window = MISTRAL_7B["sliding_window"]
    n_lanes, S, hq, d = q.shape
    plain = (lambda p: p.float()) if kind == "none" else (lambda p: p)
    got = pfa.paged_flash_attend(q, kp, vp, tables, positions, sliding_window=window)
    torch.cuda.synchronize()
    want = paged_attend(q.float(), plain(kp), plain(vp), tables, positions, sliding_window=window)
    name = "K1 verify arm" if kind == "none" else f"K3 {kind} verify arm"
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got.float() - want).abs().max().item()
    log(f"{name} ({n_lanes} lanes x {S} rows): max abs err {err:.3e} (tol {KERNEL_TOL})")
    if err > KERNEL_TOL:
        raise AssertionError(f"{name} disagrees with its plain version: {err} > {KERNEL_TOL}")
    hkv = kp.shape[2]
    rows_read = sum(min(p + S, window) for p in SPEC_VERIFY_POSITIONS)  # each lane's union of rows
    pairs = sum(_visible(p + j, p + S, window) for p in SPEC_VERIFY_POSITIONS for j in range(S))
    nbytes = (2 * rows_read * kv_wire_bytes_per_token(hkv, d, kind) + 2 * q.numel() * 2 + tables.numel() * 4
              + positions.numel() * 4)
    bound, by = bound_ms(nbytes, 4 * hq * d * pairs)
    one = q[:, :1].contiguous()
    entry = {
        "shape": f"{n_lanes} lanes x {S} rows at {list(SPEC_VERIFY_POSITIONS)}, window {window}",
        "max_abs_err": err,
        "ms": timer(lambda: pfa.paged_flash_attend(q, kp, vp, tables, positions, sliding_window=window)),
        "plain_ms": timer(lambda: paged_attend(q, kp, vp, tables, positions, sliding_window=window)),
        "bound_ms": bound, "bound_by": by,
        "library_ms": timer(lambda: _library_verify(q, kp, vp, tables, positions, window)),
        "one_row_ms": timer(lambda: pfa.paged_flash_attend(one, kp, vp, tables, positions, sliding_window=window)),
    }
    log(f"{name}: {entry['ms']:.4f} ms kernel ({n_lanes * S} virtual lanes, one launch), {entry['plain_ms']:.4f} ms "
        f"plain, {entry['library_ms']:.4f} ms gather+SDPA, {entry['one_row_ms']:.4f} ms for one row a lane; bound "
        f"{bound:.4f} ms ({by}, {nbytes / 1e6:.2f} MB)")
    return entry


def _spec_run(label, ckpt, n_blocks, device, smi, server_args, kv_quant, sampled_new=SPEC_NEW):
    """One run of phase 20: a whole-model port server of ``ckpt`` built by
    the CLI with ``server_args`` (its draft among them) and the port client;
    SPEC_SESSIONS concurrent generate() calls with the draft, then the same
    with the draft detached; the greedy streams generate SPEC_NEW tokens,
    the sampled ones ``sampled_new``. Returns what the phase checks and
    prints."""
    import concurrent.futures

    import numpy as np

    from petals_tpu_torch.data_structures import ServerState
    from petals_tpu_torch.ops import paged_flash_attention as pfa
    from petals_tpu_torch.ops import quant_matmul as qmm
    from petals_tpu_torch.ops.paged_attention import PagedPool, paged_attend, pool_block

    held, calls, accept, walls = [], [], {False: [0, 0], True: [0, 0]}, {"spec": [], "gen": []}
    last_verify, emitted = {}, [0, 0]  # emitted tokens, spec ticks

    def place(servers):
        (server,) = servers
        held.append(server)
        backend, batcher = server.backend, server.batcher
        announced = server._server_info(ServerState.ONLINE).spec_k
        if batcher.draft is None or announced != SPEC_K:
            raise AssertionError(f"{label}: the draft did not load (batcher draft {batcher.draft}, announced "
                                 f"spec_k {announced}): the server would serve plain decode")
        verify, commit = backend.paged_spec_verify_step, batcher._commit_spec_results

        def counted(*args, **kwargs):
            before = (pfa.paged_flash_attend.launches, pfa.paged_flash_attend.kv_quant_launches.get(kv_quant, 0),
                      backend._spec_program.counts.captures, backend._spec_program.counts.replays)
            out = verify(*args, **kwargs)
            after = (pfa.paged_flash_attend.launches, pfa.paged_flash_attend.kv_quant_launches.get(kv_quant, 0),
                     backend._spec_program.counts.captures, backend._spec_program.counts.replays)
            calls.append(tuple(b - a for a, b in zip(before, after)))
            last_verify.update(positions=torch.as_tensor(args[3]).clone(), tables=torch.as_tensor(args[4]).clone())
            return out

        def committed(spec_states, g_hat, n_emit):
            for lane, st in spec_states.items():
                accept[st.do_sample][0] += batcher.spec_k
                accept[st.do_sample][1] += int(n_emit[lane]) - 1
                emitted[0] += int(n_emit[lane])
            emitted[1] += 1
            return commit(spec_states, g_hat, n_emit)

        backend.paged_spec_verify_step, batcher._commit_spec_results = counted, committed
        for name, key in (("_run_batch_spec", "spec"), ("_run_batch_gen", "gen")):
            def timed(*args, _body=getattr(batcher, name), _walls=walls[key]):
                t0 = time.perf_counter()
                out = _body(*args)
                _walls.append((time.perf_counter() - t0) * 1e3)
                return out

            setattr(batcher, name, timed)

    gen = torch.Generator().manual_seed(SEED + 20)
    prompts = [torch.randint(0, MISTRAL_7B["vocab_size"], (1, SPEC_PROMPT), generator=gen).numpy()
               for _ in range(SPEC_SESSIONS)]
    kwargs = [{}, {}] + [dict(SPEC_SAMPLING, seed=s) for s in SPEC_SEEDS]
    new_tokens = [sampled_new if kw.get("do_sample") else SPEC_NEW for kw in kwargs]

    def runs(model, rec):
        def own_session():
            return [e for e in rec.sessions if e["thread"] == threading.get_ident()][-1]

        def stream(i):
            t0 = time.perf_counter()
            out = model.generate(prompts[i], max_new_tokens=new_tokens[i], **kwargs[i])
            return (own_session(), out, SPEC_PROMPT, kwargs[i]), time.perf_counter() - t0

        def together():
            with concurrent.futures.ThreadPoolExecutor(SPEC_SESSIONS) as pool:
                return [f.result(timeout=600) for f in [pool.submit(stream, i) for i in range(SPEC_SESSIONS)]]

        batcher = held[0].batcher
        # one spec stream first, off the clock: the first spec tick warms
        # (captures) the draft's buckets
        model.generate(torch.randint(0, MISTRAL_7B["vocab_size"], (1, SPEC_PROMPT), generator=gen).numpy(),
                       max_new_tokens=SPEC_NEW)
        for counts in (*accept.values(), emitted):
            counts[:] = [0, 0]
        for w in walls.values():
            w.clear()
        n_calls = len(calls)
        spec = together()
        spec_calls = calls[n_calls:]
        draft, batcher.draft = batcher.draft, None  # the reference stream: plain decode on the same server
        try:
            plain = together()
        finally:
            batcher.draft = draft
        return {"spec": spec, "plain": plain, "spec_calls": spec_calls}

    k5 = {}

    def after(servers):
        server = servers[0]
        stats, draft = server.batcher.stats, server.batcher.draft
        k5.update(decode=sum(qmm.quant_decode_matmul.launches.values()),
                  prefill=sum(qmm.quant_prefill_matmul.launches.values()))
        counts = draft._program.counts
        buckets = len(draft._buckets(server.batcher.n_lanes))
        log(f"{label}: batcher stats {json.dumps(stats)}; draft programs: {counts.captures} captures for "
            f"{buckets} buckets, {counts.replays} replays, {counts.anomalies} captures after warm-up")
        if not (stats["spec_steps"] > 0 and stats["max_spec_lanes"] >= 1):
            raise AssertionError(f"{label}: spec_steps {stats['spec_steps']}, max_spec_lanes "
                                 f"{stats['max_spec_lanes']}: the draft never speculated")
        if counts.captures != buckets or counts.anomalies or not counts.replays:
            raise AssertionError(f"{label}: the draft's programs did not capture each bucket once and replay")
        # the verify arm on the step's real pools (block 0), at the last
        # verify step's positions and tables
        kp, vp = (pool_block(p, 0) for p in server.batcher._buffers())
        positions, tables = (last_verify[k].to(device) for k in ("positions", "tables"))
        q = torch.randn(positions.shape[0], SPEC_K + 1, MISTRAL_7B["num_attention_heads"], MISTRAL_7B["head_dim"],
                        generator=torch.Generator(device=device).manual_seed(SEED + 22), device=device)
        q = q.to(kp.dtype)  # a PagedPool answers bfloat16
        window = MISTRAL_7B["sliding_window"]
        got = pfa.paged_flash_attend(q, kp, vp, tables, positions, sliding_window=window)
        plain = (lambda p: p) if isinstance(kp, PagedPool) else (lambda p: p.float())
        want = paged_attend(q.float(), plain(kp), plain(vp), tables, positions, sliding_window=window)
        active = positions < server.batcher.max_length
        err = (got.float() - want)[active].abs().max().item()
        log(f"{label}: the verify arm on the served pool's block 0 at the last verify step's "
            f"{int(active.sum())} speculating lanes: max abs err {err:.3e} from the plain paged_attend "
            f"(tol {KERNEL_TOL})")
        if not torch.isfinite(got).all() or err > KERNEL_TOL:
            raise AssertionError(f"{label}: the verify arm disagrees with its plain version on the served pool")

    t0 = time.perf_counter()
    rec, result, launches, params = drive_client(label, ckpt, device, smi, [server_args], runs, place_check=place,
                                                 after_runs=after)
    want_call = (n_blocks if kv_quant == "none" else 0, n_blocks if kv_quant != "none" else 0, 0, 1)
    bad = [c for c in result["spec_calls"] if c != want_call]
    log(f"{label}: {len(result['spec_calls'])} verify steps during the spec runs, each (K1, K3 {kv_quant}, "
        f"captures, replays) = {want_call} but {len(bad)}; launches during the runs {launches}; K5 in the draft: "
        f"{k5['decode']} decode and {k5['prefill']} prefill launches")
    if not result["spec_calls"] or bad:
        raise AssertionError(f"{label}: verify steps that were not one replay running the k+1-row arm on every "
                             f"block: {bad[:5]}")
    g_prop, g_acc = accept[False]
    s_prop, s_acc = accept[True]
    log(f"{label}: proposed / accepted drafts: greedy lanes {g_acc} of {g_prop} "
        f"({g_acc / max(g_prop, 1):.3f}), sampled lanes {s_acc} of {s_prop} ({s_acc / max(s_prop, 1):.3f}); "
        f"{emitted[0]} tokens over {emitted[1]} verify ticks ({emitted[0] / max(emitted[1], 1):.3f} a tick)")
    failed, counts = check_gen_streams(label, [e for e, _ in result["spec"]], [None] * SPEC_SESSIONS, params, ckpt,
                                       device, kv_quant)
    # each spec stream beside its plain one: where they part, the step and
    # the dense float32 reference's logit gap of each pick
    embed, ref_logits = _reference_head(ckpt, device)
    from petals_tpu_torch.server.from_pretrained import get_block_config

    family, cfg = get_block_config(ckpt)
    params32 = dense_reference_params(params, torch.float32)
    parted = 0
    for i, ((spec_e, _), (plain_e, _)) in enumerate(zip(result["spec"], result["plain"])):
        a, b = (np.asarray(e[1])[0, SPEC_PROMPT:] for e in (spec_e, plain_e))
        if (a == b).all():
            continue
        parted += 1
        at = int(np.flatnonzero(a != b)[0])
        x = embed[torch.as_tensor(spec_e[1][:, : SPEC_PROMPT + at])].float()
        out = reference_session(params32, family, cfg, x, [], device, torch.float32, kv_quant)[0][0]
        z = ref_logits(out[0, -1:])[0].double().cpu()
        log(f"{label}: stream {i} ({kwargs[i] or 'greedy'}) parts from its plain stream at new token {at}: spec "
            f"{int(a[at])}, plain {int(b[at])}; float32 reference logits {float(z[int(a[at])]):.4f} and "
            f"{float(z[int(b[at])]):.4f} (max {float(z.max()):.4f})")
    log(f"{label}: {SPEC_SESSIONS - parted} of {SPEC_SESSIONS} spec streams equal their plain streams token for "
        f"token")

    def per_token(entries):
        return statistics.median(s / (e[1].shape[1] - SPEC_PROMPT) * 1e3 for e, s in entries)

    log(f"{label}: client time per generated token ({SPEC_SESSIONS} concurrent sessions, a generate() call's wall "
        f"over its {'/'.join(map(str, sorted(set(new_tokens))))} tokens, median): {per_token(result['spec']):.3f} ms "
        f"with the draft, "
        f"{per_token(result['plain']):.3f} ms without; the batcher's step bodies (host wall on the compute thread, "
        f"median): spec tick {statistics.median(walls['spec']):.3f} ms over {len(walls['spec'])}, generation "
        f"step {statistics.median(walls['gen']) if walls['gen'] else float('nan'):.3f} ms over "
        f"{len(walls['gen'])} ({smi})")
    if failed:
        raise AssertionError("; ".join(failed))
    log(f"{label}: done in {time.perf_counter() - t0:.1f} s")
    return {"server": held[0], "accept": accept, "launches": launches, "k5": k5,
            "verify_launches": sum(c[0] + c[1] for c in result["spec_calls"])}


def profile_spec_steps(server, device, smi) -> None:
    """The verify step's device busy beside a generation step's, on a
    sibling of the served backend (its weights, fresh pools, PROFILE_LANES
    lanes at the profile's positions, all sampled), and the draft's propose
    at PROFILE_LANES lanes, each a replayed program (profile_calls)."""
    sib = sibling_backend(server.backend)
    gen_params, draft = server.server_gen_params, server.batcher.draft
    cfg, max_len, S = sib.cfg, 1024, SPEC_K + 1
    max_pages = max_len // PAGE
    pools = _random_pools(sib, device, PROFILE_LANES * max_pages, SEED + 23)
    tables = torch.arange(PROFILE_LANES * max_pages, dtype=torch.int32).reshape(PROFILE_LANES, max_pages)
    positions = torch.linspace(64, max_len - 64, PROFILE_LANES).to(torch.int32)
    vec, tokens, use_token = _gen_vectors(cfg.vocab_size, PROFILE_LANES, [True] * PROFILE_LANES, SEED + 23)
    hidden = torch.zeros(PROFILE_LANES, 1, cfg.hidden_size)
    spec_tokens = torch.randint(0, cfg.vocab_size, (PROFILE_LANES, S), generator=torch.Generator().manual_seed(SEED))
    contexts = [list(range(SPEC_WINDOW))] * PROFILE_LANES
    times = profile_calls({
        "generation step, replayed": lambda: sib.paged_gen_decode_step(
            gen_params, hidden, tokens, use_token, pools, positions, tables, sampling_vecs=vec),
        f"verify step ({S} rows a lane), replayed": lambda: sib.paged_spec_verify_step(
            gen_params, spec_tokens, pools, positions, tables, sampling_vecs=vec),
        f"draft propose ({PROFILE_LANES} lanes, window {draft.window}, k {draft.spec_k}), replayed":
            lambda: draft.propose(contexts),
    })
    ver, gen_t = times[f"verify step ({S} rows a lane), replayed"], times["generation step, replayed"]
    prop = times[f"draft propose ({PROFILE_LANES} lanes, window {draft.window}, k {draft.spec_k}), replayed"]
    log(f"profile (speculative decoding, {sib.n_blocks} blocks, --kv_quant_type {sib.kv_quant_type}): the replayed "
        f"verify step's device busy {ver['device_busy_ms']:.3f} ms for {PROFILE_LANES} x {S} rows beside the "
        f"generation step's {gen_t['device_busy_ms']:.3f} ms for {PROFILE_LANES} rows "
        f"({ver['device_busy_ms'] / gen_t['device_busy_ms']:.3f}x); the draft's propose "
        f"{prop['device_busy_ms']:.3f} ms; host wall {ver['host_wall_ms']:.3f}, {gen_t['host_wall_ms']:.3f} and "
        f"{prop['host_wall_ms']:.3f} ms ({smi})")


def serve_spec_and_check(ckpt, device, smi, timer) -> dict:
    """Phase 20: server-side speculative decoding on the card (alone:
    scripts/smoke_spec_decode.py). Run a: the 8-layer cut served whole by
    the CLI with ``--draft_model <the cut> --draft_quant_type none --spec_k
    SPEC_K --draft_window SPEC_WINDOW`` (a cooperative draft: K1's k+1-row
    arm in the verify step). Run b: a SPEC_DRAFT_BLOCKS-layer cut of the
    same weights served whole with ``--kv_quant_type nf4a`` and itself as
    the default nf4a draft (K3's nf4a k+1-row arm in the verify step, K5 in
    the draft). Each: SPEC_SESSIONS concurrent sessions, two greedy and two
    sampled, then the same sessions with the draft detached
    (``batcher.draft = None``, as the reference's test does). Checks: the
    draft loaded and the announce says spec_k; spec_steps > 0 and
    max_spec_lanes >= 1; run a's greedy acceptance > SPEC_GREEDY_ACCEPT;
    every verify step one replay with the k+1-row arm on every block;
    each draft bucket captured once, then replayed; every spec token held
    to the dense float32 reference as phase 16 holds generated tokens (run
    b's reference writing its rows as the nf4a pool holds them); the verify
    arm held against the plain paged_attend on the served pool. Prints
    each spec stream beside its plain one (where they part, the step and
    the reference's logit gap: on the card the verify step's M = lanes x
    (k+1) rows and K1's split plan differ from a decode step's, so bit
    identity is not promised), the acceptance, tokens per verify tick, the
    time per generated token with and without the draft, and the verify
    step's device busy beside a generation step's. Then the verify arm at
    Mistral-7B widths for the kernels line (K1, and K3's nf4a arm)."""
    t0 = time.perf_counter()
    cut = cut_checkpoint(ckpt, os.path.join(ckpt, f"mistral-7b-{SPAN}-layers-spec"), SPAN)
    small = cut_checkpoint(ckpt, os.path.join(ckpt, f"mistral-7b-{SPEC_DRAFT_BLOCKS}-layers-spec"),
                           SPEC_DRAFT_BLOCKS)
    common = ("--batch_lanes", str(SPEC_SESSIONS), "--spec_k", str(SPEC_K), "--draft_window", str(SPEC_WINDOW))
    a = _spec_run(f"speculative decoding a (cooperative draft, {SPAN} Mistral-7B blocks)", cut, SPAN, device, smi,
                  ("--draft_model", cut, "--draft_quant_type", "none", *common), "none")
    g_prop, g_acc = a["accept"][False]
    if not g_prop or g_acc / g_prop <= SPEC_GREEDY_ACCEPT:
        raise AssertionError(f"speculative decoding a: greedy acceptance {g_acc} of {g_prop} is not above "
                             f"{SPEC_GREEDY_ACCEPT}")
    profile_spec_steps(a.pop("server"), device, smi)
    free_card()
    b = _spec_run(f"speculative decoding b (nf4a self-draft, {SPEC_DRAFT_BLOCKS} Mistral-7B blocks, nf4a pool)",
                  small, SPEC_DRAFT_BLOCKS, device, smi,
                  ("--draft_model", small, "--kv_quant_type", "nf4a", *common), "nf4a", SPEC_SAMPLED_NEW)
    b.pop("server")
    free_card()
    if not (b["k5"]["decode"] and b["k5"]["prefill"]):
        raise AssertionError(f"speculative decoding b: K5 did not run in the nf4a draft: {b['k5']}")
    arms = {"none": check_verify_arm(device, timer, "none"), "nf4a": check_verify_arm(device, timer, "nf4a")}
    arms["none"]["launches"] = a["verify_launches"]
    arms["nf4a"]["launches"] = b["verify_launches"]
    log(f"speculative decoding: phase done in {time.perf_counter() - t0:.1f} s")
    return {"verify_arm": arms, "k5": b["k5"]}


def reference_forward(block_params, family, cfg, hidden, prompts, device, dtype):
    """The stateless forward alone through the port's block functions, plain
    attention over a dense K/V buffer of the input's length, in ``dtype``:
    deep prompts are added to block i's input over positions [0, pre_seq),
    as the server adds them. Returns the output on the host in float32."""
    h = hidden.to(device, dtype)
    shape = (h.shape[0], h.shape[1], cfg.num_key_value_heads, cfg.head_dim)
    kv = (torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device))
    for i, params in enumerate(block_params):
        if prompts is not None:
            pre = prompts.shape[2]
            h = torch.cat([h[:, :pre] + prompts[i].to(device, dtype), h[:, pre:]], dim=1)
        h, _ = family.block_apply(params, h, kv, 0, cfg)
    return h.float().cpu()


def _http_get(port: int, path: str) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read().decode()


def _digest_gap(fp, ref) -> float:
    fp, ref = torch.as_tensor(fp, dtype=torch.float64), torch.as_tensor(ref, dtype=torch.float64)
    return ((fp - ref).abs().max() / ref.abs().max()).item()


def _check_forwards(label, server, remote, blocks, device, prompts_rows=True):
    """Phase 21 (a) on one server: FWD_SHAPES through ``remote`` (the port
    client's RemoteSequential over ``blocks``), three calls a shape, each
    output held to the dense references; returns (server-side forward
    calls, the forward program's captures in the shapes' last calls)."""
    from petals_tpu_torch.client.sequential_autograd import MAX_TOKENS_IN_BATCH, _split_batch

    params_bf16 = dense_reference_params(server.backend.block_params, torch.bfloat16)
    params_f32 = dense_reference_params(server.backend.block_params, torch.float32)
    prog = server.backend._forward_program
    gen = torch.Generator().manual_seed(SEED + 21)
    n_calls, late_captures, failed = 0, 0, []
    for batch, seq, pre in FWD_SHAPES:
        hidden = torch.randn(batch, seq, server.cfg.hidden_size, generator=gen).to(torch.bfloat16)
        prompts = None
        if pre and prompts_rows:
            prompts = torch.randn(blocks[1] - blocks[0], batch, pre, server.cfg.hidden_size,
                                  generator=gen).to(torch.bfloat16)
        parts = len(_split_batch(hidden))
        if batch * seq > MAX_TOKENS_IN_BATCH and parts < 2:
            raise AssertionError(f"{label}: a batch of {batch * seq} tokens did not split")
        outs, walls = [], []
        for call in range(3):
            before = prog.counts.captures
            t0 = time.perf_counter()
            outs.append(remote.forward(hidden, prompts))
            walls.append(time.perf_counter() - t0)
            if call == 2:
                late_captures += prog.counts.captures - before
        n_calls += 3 * parts
        if not torch.equal(outs[1], outs[2]):
            failed.append(f"{label}: two replays of {batch} x {seq} differ")
        args = (server.family, server.cfg, hidden, prompts, device)
        ref_bf16 = reference_forward(params_bf16, *args, torch.bfloat16)
        ref_f32 = reference_forward(params_f32, *args, torch.float32)
        what = f"forward {batch} x {seq}" + (f" (+{pre}-row prompts)" if prompts is not None else "") + (
            f", split into {parts}" if parts > 1 else "")
        failed += check_session([outs[2]], None, ([ref_bf16], ()), ([ref_f32], ()), f"{label}: {what}")
        log(f"{label}: {what}: client walls {', '.join(f'{w * 1e3:.1f}' for w in walls)} ms "
            f"(eager, capture, replay); eager vs replay max abs {(outs[0].float() - outs[2].float()).abs().max():.3e}")
    if failed:
        raise AssertionError("; ".join(failed))
    return n_calls, late_captures


def serve_forward_telemetry_and_check(ckpt, device, smi) -> dict:
    """Phase 21 (see the module docstring; alone:
    scripts/smoke_forward_telemetry.py). Returns the launches of K4 and of
    K5's nf4a prefill kernel on the phase's forwards."""
    import numpy as np

    from petals_tpu_torch.cli.run_server import build_parser, build_server
    from petals_tpu_torch.client.config import ClientConfig
    from petals_tpu_torch.client.remote_sequential import RemoteSequential
    from petals_tpu_torch.client.runtime import SwarmRuntime
    from petals_tpu_torch.data_structures import ServerState, make_uid
    from petals_tpu_torch.ops import fingerprint as fp_ops
    from petals_tpu_torch.ops import flash_attention as fa
    from petals_tpu_torch.ops import quant_matmul as qmm
    from petals_tpu_torch.rpc import RpcClient
    from petals_tpu_torch.telemetry import instruments as tm
    from petals_tpu_torch.telemetry.integrity import IntegrityMonitor
    from petals_tpu_torch.telemetry.observatory import get_observatory

    t_phase = time.perf_counter()
    label = f"forward and telemetry (bf16, {SPAN} Mistral-7B blocks)"
    cut = cut_checkpoint(ckpt, os.path.join(ckpt, f"mistral-7b-{SPAN}-layers-forward"), SPAN)
    trace_dir = os.path.join(REPO, "build", "forward-trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    tol = fp_ops.tolerance_for("none")
    hsz = MISTRAL_7B["hidden_size"]
    # before any step program is captured: the pool's warm-up captures the
    # programs with the fused digest
    fp_ops.set_enabled(True)
    os.environ["PETALS_TPU_TRACE_SECONDS"] = str(TRACE_SECONDS)
    loop = SwarmRuntime()
    servers, remotes, result = [], [], {}

    async def probe(srv, seed, tokens):
        client = await RpcClient.connect("127.0.0.1", srv.rpc_server.port)
        try:
            return await client.call("ptu.probe", {"seed": seed, "tokens": tokens}, timeout=120)
        finally:
            await client.close()

    def check_probes(what, srv, blocks):
        params_f32 = dense_reference_params(srv.backend.block_params, torch.float32)
        params_bf16 = dense_reference_params(srv.backend.block_params, torch.bfloat16)
        for tokens in PROBE_TOKENS:
            k4 = fa.flash_attend.launches
            first, again, other = (loop.run(probe(srv, seed, tokens), LOOP_TIMEOUT_S)
                                   for seed in (PROBE_SEEDS[0], PROBE_SEEDS[0], PROBE_SEEDS[1]))
            k4 = fa.flash_attend.launches - k4
            if (first["first_block"], first["n_blocks"]) != (blocks[0], blocks[1] - blocks[0]):
                raise AssertionError(f"{what}: the probe answered span {first['first_block']} + {first['n_blocks']}")
            if first["fp"] != again["fp"] or first["fp"] == other["fp"] or first["tokens"] != tokens:
                raise AssertionError(f"{what}: probe digests {first['fp']}, {again['fp']} (same seed), "
                                     f"{other['fp']} (another)")
            golden = torch.from_numpy(
                (np.random.RandomState(PROBE_SEEDS[0] & 0x7FFFFFFF).standard_normal((1, tokens, hsz)) * 0.02)
                .astype(np.float32))
            refs = {
                "float32 reference": reference_forward(params_f32, srv.family, srv.cfg, golden, None, device,
                                                       torch.float32),
                "bf16 plain path": reference_forward(params_bf16, srv.family, srv.cfg, golden, None, device,
                                                     torch.bfloat16),
            }
            gaps = {name: _digest_gap(first["fp"], fp_ops.fingerprint_output(ref.numpy(), hsz))
                    for name, ref in refs.items()}
            # every forward is padded to its bucket (>= 8 rows, C12), so even
            # a 4-token probe runs K4 on every block
            want_k4 = 3 * (blocks[1] - blocks[0])
            log(f"{what}: probe of {tokens} tokens: digest gap from the float32 reference "
                f"{gaps['float32 reference']:.3e}, from the bf16 plain path {gaps['bf16 plain path']:.3e}; "
                f"tolerance_for('none') {tol:g}; K4 launches {k4} (want {want_k4}); same seed twice: bit-equal ({smi})")
            if k4 != want_k4:
                raise AssertionError(f"{what}: {k4} K4 launches for three probes of {tokens} tokens")

    try:
        server = build_server(build_parser().parse_args([
            cut, "--host", "127.0.0.1", "--first_block", "0", "--num_blocks", str(SPAN), "--metrics_port", "0",
            "--trace_dir", trace_dir, *NO_PREFIX_CACHE,
        ]))
        t0 = time.perf_counter()
        loop.run(server.start(), LOOP_TIMEOUT_S)
        servers.append(server)
        log(f"{label}: started in {time.perf_counter() - t0:.1f} s, /metrics on {server._metrics_server.port}, "
            f"tracing to {trace_dir} for {TRACE_SECONDS:g} s")
        peers = [server.dht.own_addr.to_string()]
        uids = [make_uid(server.dht_prefix, i) for i in range(SPAN)]
        remote = RemoteSequential(ClientConfig(initial_peers=peers), uids)
        remotes.append(remote)
        # (d) the trace: one forward inside its window, then the written file
        remote.forward(torch.randn(1, 256, hsz).to(torch.bfloat16))
        deadline = time.perf_counter() + TRACE_SECONDS + 120
        while not (os.path.isdir(trace_dir) and any(n.endswith(".json") for n in os.listdir(trace_dir))):
            if time.perf_counter() > deadline:
                raise AssertionError(f"{label}: no trace was written under {trace_dir}")
            time.sleep(0.5)
        time.sleep(1.0)  # the file is complete once stop_trace returns; allow its write to land
        trace_file = next(os.path.join(trace_dir, n) for n in os.listdir(trace_dir) if n.endswith(".json"))
        with open(trace_file) as tf:
            trace_text = tf.read()
        if "flash_wgmma_kernel" not in trace_text:
            raise AssertionError(f"{label}: the trace {trace_file} does not name K4's kernel")
        log(f"{label}: the --trace_dir capture wrote {trace_file} ({len(trace_text) / 2**20:.1f} MiB), "
            f"naming flash_wgmma_kernel {trace_text.count('flash_wgmma_kernel')} times")

        # (a) the stateless forward over the wire
        _reset_launch_counts()
        n_calls, late = _check_forwards(label, server, remote, (0, SPAN), device)
        k4 = fa.flash_attend.launches
        log(f"{label}: K4 launches {k4} for {n_calls} server-side forward calls of {SPAN} blocks "
            f"(want >= {n_calls * SPAN}); captures in the shapes' third calls: {late}")
        if k4 < n_calls * SPAN or late:
            raise AssertionError(f"{label}: K4 did not run on every block of every forward, or a repeat captured")
        result["K4"] = k4
        # forward programs without bound: distinct lengths, each captured
        prog = server.backend._forward_program
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0, graphs0 = torch.cuda.memory_reserved(device), len(prog._entries)
        for n in FWD_LENGTHS:
            x = torch.randn(1, n, hsz).to(torch.bfloat16)
            remote.forward(x)
            remote.forward(x)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        grown = torch.cuda.memory_reserved(device) - reserved0
        log(f"{label}: forward programs: {len(prog._entries)} graphs held ({len(prog._entries) - graphs0} more "
            f"after {len(FWD_LENGTHS)} distinct lengths), {grown / 2**20:.1f} MiB more reserved; counts "
            f"captures {prog.counts.captures}, replays {prog.counts.replays}, eager {prog.counts.eager_calls}; "
            f"compile_stats {get_observatory().compile_stats()}")
        result["forward_programs"] = {"graphs": len(prog._entries), "lengths": len(FWD_LENGTHS),
                                      "added_graphs": len(prog._entries) - graphs0, "reserved_bytes": grown}

        # (b) the probe
        check_probes(label, server, (0, SPAN))

        # (c) fused fingerprints on phase 3's sessions, (d) the counters
        loop.run(drive_server(server, WARMUP_PROMPTS, 2, SEED + 5), LOOP_TIMEOUT_S)
        before = dict(server.batcher.stats)
        reg_before = {v: tm.BATCHED_STEPS.labels(variant=v).value for v in ("dense", "paged", "mixed", "gen", "spec")}
        tokens_before = tm.DECODE_TOKENS.value
        inputs, replies, metas, _, _ = loop.run(drive_server(server, PROMPTS, DECODE_STEPS, SEED + 4), LOOP_TIMEOUT_S)
        stats = {k: v - before[k] if not k.startswith("max") else v for k, v in server.batcher.stats.items()}
        check_graph_stats(label, stats)
        if stats["graph_captures"]:
            raise AssertionError(f"{label}: a step program was captured after the warm-up: {stats}")
        monitor = IntegrityMonitor(trace_id="phase21")
        worst, n_fp = 0.0, 0
        for (prompt, _), outs, ms in zip(inputs, replies, metas):
            for i, (out, meta) in enumerate(zip(outs, ms)):
                if meta.get("fp") is None:
                    raise AssertionError(f"{label}: a {meta.get('variant')} reply carries no fused digest")
                twin = fp_ops.fingerprint_output(out.float().numpy(), hsz)
                worst = max(worst, _digest_gap(meta["fp"], twin))
                monitor.verify_step("server", meta["fp"], out.float().numpy(), start=0, end=SPAN,
                                    position=prompt.shape[1] + i)
                n_fp += 1
        log(f"{label}: fused digests of {n_fp} replies: worst relative gap from the client's digest of the "
            f"hidden received {worst:.3e} (TOL_TRANSPORT {fp_ops.TOL_TRANSPORT:g}); the IntegrityMonitor "
            f"checked {monitor.checked}, divergences {monitor.divergences}")
        if worst > fp_ops.TOL_TRANSPORT or monitor.divergences or monitor.checked != n_fp:
            raise AssertionError(f"{label}: a fused digest disagrees with the reply it rides")
        steps = {v: tm.BATCHED_STEPS.labels(variant=v).value - reg_before[v] for v in reg_before}
        tokens = tm.DECODE_TOKENS.value - tokens_before
        log(f"{label}: petals_batched_steps_total by variant {steps}, petals_decode_tokens_total {tokens:g}; the "
            f"batcher's stats: batched_steps {stats['batched_steps']}, mixed_steps {stats['mixed_steps']}, "
            f"batched_tokens {stats['batched_tokens']}")
        if (sum(steps.values()) != stats["batched_steps"] or steps["mixed"] != stats["mixed_steps"]
                or tokens != stats["batched_tokens"]):
            raise AssertionError(f"{label}: the step counters disagree with the batcher's stats")
        mport = server._metrics_server.port
        metrics, journal = _http_get(mport, "/metrics"), _http_get(mport, "/journal")
        want_line = f'petals_batched_steps_total{{variant="mixed"}} {int(tm.BATCHED_STEPS.labels(variant="mixed").value)}'
        kinds = collections.Counter(json.loads(line)["kind"] for line in journal.splitlines() if line.strip())
        log(f"{label}: /metrics {len(metrics)} bytes, /journal {sum(kinds.values())} events {dict(kinds)}")
        if want_line not in metrics or kinds["admission"] < len(PROMPTS):
            raise AssertionError(f"{label}: /metrics lacks {want_line!r}, or /journal its admissions")
        info = server._server_info(ServerState.ONLINE)
        announce = {k: getattr(info, k) for k in ("telemetry", "compile_stats", "integrity", "metrics_port")}
        log(f"{label}: the announce's telemetry plane: {json.dumps(announce, default=str)}")
        if any(v is None for v in announce.values()) or announce["metrics_port"] != mport:
            raise AssertionError(f"{label}: the announce lacks a telemetry field: {announce}")
        # the fused digest's device cost on the replayed bf16 decode step:
        # a sibling backend each way, so each captures its one graph during
        # its own warm-up (a flip on one backend after its warm-up would
        # capture again, which the observatory counts as an anomaly)
        sibs = {flag: sibling_backend(server.backend) for flag in (False, True)}
        max_pages = 1024 // PAGE
        pools = _random_pools(sibs[False], device, PROFILE_LANES * max_pages, SEED + 21)
        tables = torch.arange(PROFILE_LANES * max_pages, dtype=torch.int32).reshape(PROFILE_LANES, max_pages)
        positions = torch.linspace(64, 960, PROFILE_LANES).to(torch.int32)
        hidden = torch.randn(PROFILE_LANES, 1, hsz)

        def decode(with_fp):
            fp_ops.set_enabled(with_fp)
            sibs[with_fp].paged_decode_step(hidden, pools, positions, tables)
            sibs[with_fp].pop_step_fp()

        times = profile_calls({"decode step, replayed, without with_fp": lambda: decode(False),
                               "decode step, replayed, with with_fp": lambda: decode(True)})
        off, on = times["decode step, replayed, without with_fp"], times["decode step, replayed, with with_fp"]
        log(f"{label}: the fused digest's cost: replayed decode step device busy {on['device_busy_ms']:.4f} ms with "
            f"with_fp, {off['device_busy_ms']:.4f} ms without ({PROFILE_LANES} lanes, {SPAN} blocks; {smi})")
        result["with_fp_busy_ms"] = (on["device_busy_ms"], off["device_busy_ms"])
        fp_ops.set_enabled(True)
        if any(b.step_program_stats()["graph_anomalies"] for b in sibs.values()):
            raise AssertionError(f"{label}: the digest's cost measurement captured after a warm-up")
        del sibs, pools
        remote.close()
        remotes.remove(remote)
        loop.run(server.shutdown(), LOOP_TIMEOUT_S)
        servers.remove(server)
        del server
        free_card()

        # (a) and (b) again on nf4a weights, over a sub-span chain
        label = f"forward (nf4a, blocks [{FWD_SUB_SPAN[0]}, {FWD_SUB_SPAN[1]}) of the cut)"
        server = build_server(build_parser().parse_args([
            cut, "--host", "127.0.0.1", "--first_block", str(FWD_SUB_SPAN[0]),
            "--num_blocks", str(FWD_SUB_SPAN[1] - FWD_SUB_SPAN[0]), "--quant_type", "nf4a", *NO_PREFIX_CACHE,
        ]))
        loop.run(server.start(), LOOP_TIMEOUT_S)
        servers.append(server)
        remote = RemoteSequential(ClientConfig(initial_peers=[server.dht.own_addr.to_string()]),
                                  uids[FWD_SUB_SPAN[0]:FWD_SUB_SPAN[1]])
        remotes.append(remote)
        _reset_launch_counts()
        n_calls, late = _check_forwards(label, server, remote, FWD_SUB_SPAN, device)
        n_blocks = FWD_SUB_SPAN[1] - FWD_SUB_SPAN[0]
        k5 = qmm.quant_prefill_matmul.launches["nf4a"]
        k4 = fa.flash_attend.launches
        log(f"{label}: K5 nf4a prefill launches {k5} (want >= {n_calls * n_blocks * 4}), K4 {k4} "
            f"(want >= {n_calls * n_blocks}), for {n_calls} server-side calls; captures in third calls: {late}")
        if k5 < n_calls * n_blocks * 4 or k4 < n_calls * n_blocks or late:
            raise AssertionError(f"{label}: K5's prefill kernel or K4 did not run on every block of every forward")
        result["K5 prefill"] = k5
        check_probes(label, server, FWD_SUB_SPAN)
    finally:
        fp_ops.set_enabled(False)
        os.environ.pop("PETALS_TPU_TRACE_SECONDS", None)
        for remote in remotes:
            remote.close()
        for server in servers:
            loop.run(server.shutdown(), LOOP_TIMEOUT_S)
        loop.shutdown()
    log(f"forward and telemetry: phase done in {time.perf_counter() - t_phase:.1f} s")
    return result


def reference_backward(block_params, family, cfg, hidden, prompts, grad, device, dtype):
    """The gradients of the span at its input and at the deep prompts, by
    autograd through the port's block functions over the whole span at
    once, plain attention over a fresh dense K/V buffer per block, in
    ``dtype`` (the server recomputes block by block instead). Returns a
    list of float32 tensors on the host: [grad_hidden] or [grad_hidden,
    grad_prompts]."""
    h0 = hidden.to(device, dtype).requires_grad_(True)
    p0 = prompts.to(device, dtype).requires_grad_(True) if prompts is not None else None
    shape = (h0.shape[0], h0.shape[1], cfg.num_key_value_heads, cfg.head_dim)
    with torch.enable_grad():
        h = h0
        for i, params in enumerate(block_params):
            if p0 is not None:
                pre = p0.shape[2]
                h = torch.cat([h[:, :pre] + p0[i], h[:, pre:]], dim=1)
            kv = (torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device))
            h, _ = family.block_apply(params, h, kv, 0, cfg)
        grads = torch.autograd.grad(h, [h0] if p0 is None else [h0, p0], grad.to(device, dtype))
    return [g.float().cpu() for g in grads]


def merged_reference_params(block_params, adapter, dtype):
    """The served blocks dequantized as ``dense_reference_params`` gives
    them, with a LoRA adapter's deltas (its per-block (A, B) as the server
    holds them, and its scaling) merged into the weights in float32, then
    cast to ``dtype``: the dense reference of an adapter's replies."""
    per_block, scaling = adapter
    merged = dense_reference_params(block_params, torch.float32)
    for params, deltas in zip(merged, per_block):
        for leaf, (a, b) in deltas.items():
            params[leaf] = params[leaf] + (a.float() @ b.float()) * scaling
    return [{k: v.to(dtype) if isinstance(v, torch.Tensor) else v for k, v in p.items()} for p in merged]


def check_to_f32(label, got, ref_bf16, ref_f32):
    """Phase 24's rule: each of ``got`` within REPLY_NOISE_FACTOR times the
    bf16 reference's own distance from the float32 reference (max-rel and
    mean-rel, the worst over the list). Returns what failed."""
    srv, noise = _rel_errors(got, ref_f32), _rel_errors(ref_bf16, ref_f32)
    log(f"{label}: vs float32 reference max-rel {srv[0]:.3e} mean-rel {srv[1]:.3e}; bf16 reference vs float32 "
        f"max-rel {noise[0]:.3e} mean-rel {noise[1]:.3e} (bound {REPLY_NOISE_FACTOR:g}x)")
    if srv[0] > REPLY_NOISE_FACTOR * noise[0] or srv[1] > REPLY_NOISE_FACTOR * noise[1]:
        return [f"{label}: beyond {REPLY_NOISE_FACTOR:g}x the bf16 reference's distance from float32"]
    return []


def write_adapter(root, name, seed, device, rank=ADAPTER_RANK, targets=ADAPTER_TARGETS, n_blocks=SPAN):
    """A seeded PEFT checkpoint at Mistral-7B's widths, written with the
    port's safetensors writer: lora_A [rank, in] and lora_B [out, rank] of
    ``targets`` in every block (std 0.02 each: at Mistral-7B's widths a
    delta about a fifth of the base projection, so a reply moves beyond
    rounding), alpha 2 x rank."""
    from petals_tpu_torch.utils.safetensors_io import save_file

    h, m, hq, hkv, d = (MISTRAL_7B[k] for k in ("hidden_size", "intermediate_size", "num_attention_heads",
                                                "num_key_value_heads", "head_dim"))
    dims = {"self_attn.q_proj": (h, hq * d), "self_attn.k_proj": (h, hkv * d), "self_attn.v_proj": (h, hkv * d),
            "self_attn.o_proj": (hq * d, h), "mlp.gate_proj": (h, m), "mlp.up_proj": (h, m), "mlp.down_proj": (m, h)}
    gen = torch.Generator(device=device).manual_seed(seed)
    tensors = {}
    for i in range(n_blocks):
        for proj in targets:
            n_in, n_out = dims[proj]
            base = f"base_model.model.model.layers.{i}.{proj}"
            tensors[f"{base}.lora_A.weight"] = (torch.randn(rank, n_in, generator=gen, device=device) * 0.02).cpu()
            tensors[f"{base}.lora_B.weight"] = (torch.randn(n_out, rank, generator=gen, device=device) * 0.02).cpu()
    path = os.path.join(root, name)
    os.makedirs(path, exist_ok=True)
    save_file(tensors, os.path.join(path, "adapter_model.safetensors"))
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": rank, "lora_alpha": 2 * rank, "peft_type": "LORA",
                   "target_modules": [t.split(".")[-1] for t in targets]}, f)
    return path


def write_cls_checkpoint(src, dst, device, n_layers=SPAN):
    """A Mistral-7B sequence-classification checkpoint of ``n_layers``
    layers beside ``src``: its shards linked, a seeded ``score.weight``
    [CLS_LABELS, hidden] in a shard of its own, and config.json naming the
    labels and the pad token."""
    from petals_tpu_torch.utils.safetensors_io import save_file

    cut_checkpoint(src, dst, n_layers)
    gen = torch.Generator(device=device).manual_seed(SEED + 24)
    score = (torch.randn(CLS_LABELS, MISTRAL_7B["hidden_size"], generator=gen, device=device) * 0.02)
    save_file({"score.weight": score.to(torch.bfloat16).cpu()}, os.path.join(dst, "model-score.safetensors"))
    index_path = os.path.join(dst, "model.safetensors.index.json")
    with open(index_path) as f:
        index = json.load(f)
    index["weight_map"]["score.weight"] = "model-score.safetensors"
    with open(index_path, "w") as f:
        json.dump(index, f)
    with open(os.path.join(dst, "config.json")) as f:
        cfg = json.load(f)
    cfg.update(architectures=["MistralForSequenceClassification"], pad_token_id=0,
               id2label={str(i): f"LABEL_{i}" for i in range(CLS_LABELS)})
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(cfg, f)
    return dst


def _quant_counts():
    """K5/K6 launches so far: {"<decode|prefill> <kind>": n}."""
    from petals_tpu_torch.ops import quant_matmul as qmm

    return {f"{phase} {kind}": n
            for phase, fn in (("decode", qmm.quant_decode_matmul), ("prefill", qmm.quant_prefill_matmul))
            for kind, n in fn.launches.items()}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] - before.get(k, 0)}


def _train_inputs(hsz, n_blocks, seed, pre):
    """Seeded bf16 (hidden, grad at the output, deep prompts or None) of
    TRAIN_BATCH x TRAIN_SEQ tokens."""
    gen = torch.Generator().manual_seed(seed)
    hidden = torch.randn(TRAIN_BATCH, TRAIN_SEQ, hsz, generator=gen).to(torch.bfloat16)
    grad = (torch.randn(TRAIN_BATCH, TRAIN_SEQ, hsz, generator=gen) * 1e-2).to(torch.bfloat16)
    prompts = (torch.randn(n_blocks, TRAIN_BATCH, pre, hsz, generator=gen) * 0.1).to(torch.bfloat16) if pre else None
    return hidden, grad, prompts


def check_wire_backward(label, server, remote, device, seed, adapter=None, pre=None):
    """A forward and ptu.backward through ``remote`` (the port client's
    RemoteSequential over ``server``'s blocks), the gradients held to the
    float32 autograd reference over the served blocks (dequantized; with
    ``adapter``'s deltas merged) by ``check_to_f32``. Returns (what failed,
    the backward's client wall in seconds, the K5/K6 launches inside it, the
    inputs)."""
    backend = server.backend
    n = backend.n_blocks
    pre = TRAIN_PRE if pre is None else pre
    hidden, grad, prompts = _train_inputs(server.cfg.hidden_size, n, seed, pre)
    out, histories, spans = remote.forward_with_state(hidden, prompts)
    before = _quant_counts()
    t0 = time.perf_counter()
    got = remote.backward(grad, histories, spans, prompts=prompts)
    wall = time.perf_counter() - t0
    quant = _delta(_quant_counts(), before)
    got = [g for g in got if g is not None]
    if adapter is None:
        refs = {dt: dense_reference_params(backend.block_params, dt) for dt in (torch.bfloat16, torch.float32)}
    else:
        refs = {dt: merged_reference_params(backend.block_params, backend.adapters[adapter], dt)
                for dt in (torch.bfloat16, torch.float32)}
    want = {dt: reference_backward(p, server.family, server.cfg, hidden, prompts, grad, device, dt)
            for dt, p in refs.items()}
    del refs
    if len(got) != len(want[torch.float32]):
        return [f"{label}: {len(got)} gradients came back for {len(want[torch.float32])}"], wall, quant, None
    failed = []
    for name, g, w16, w32 in zip(("grad_hidden", "grad_prompts"), got, want[torch.bfloat16], want[torch.float32]):
        if tuple(g.shape) != tuple(w32.shape) or not torch.isfinite(g.float()).all():
            failed.append(f"{label}: {name} {tuple(g.shape)} (want {tuple(w32.shape)}) or non-finite")
            continue
        failed += check_to_f32(f"{label}: {name} {tuple(g.shape)}", [g], [w16], [w32])
    log(f"{label}: ptu.backward of {TRAIN_BATCH} x {TRAIN_SEQ} tokens"
        + (f" (+{pre}-row deep prompts)" if pre else "") + f" over {n} blocks: client wall {wall * 1e3:.1f} ms; "
        f"K5/K6 launches inside it {quant or 'none'}")
    return failed, wall, quant, (hidden, grad, prompts)


def _events_ms(fn, reps: int = 20) -> float:
    """The device time of ``fn`` a call between CUDA events around ``reps``
    back-to-back calls, after three warm-up calls (not ``Timer``: the plain
    pieces of the backward copy small tensors from the host, a sync that
    outlasts ``Timer``'s spin)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profile_backward(label, server, device, inputs, smi):
    """The backward's device busy (torch.profiler), peak memory above what
    was allocated before it, and the shares of its two plain pieces: the
    quantized products' dequant-transpose (each quantized leaf of the span
    at the recompute's rows) and the attention
    backward (plain attention's forward and backward on one block's q, k, v
    minus its forward, times the blocks), each timed with CUDA events
    (``_events_ms``). Returns the numbers."""
    from petals_tpu_torch.ops.attention import attend_reference
    from petals_tpu_torch.ops.quant import QUANTIZED_TYPES, OutlierQuantLinear, dequant_transpose_matmul

    backend = server.backend
    hidden, grad, prompts = inputs
    rows = hidden.shape[0] * hidden.shape[1]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    backend.backward(hidden, grad, prompts)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) - base
    times = profile_calls({f"{label}: backend.backward": lambda: backend.backward(hidden, grad, prompts)})
    t = next(iter(times.values()))
    dq_ms = 0.0  # every block's leaves are block 0's shapes
    for name, leaf in backend.block_params[0].items():
        if isinstance(leaf, QUANTIZED_TYPES):
            inner = leaf.inner if isinstance(leaf, OutlierQuantLinear) else leaf
            g = torch.randn(rows, inner.out_features, device=device).to(torch.bfloat16)
            ms = _events_ms(lambda: dequant_transpose_matmul(g, inner))
            log(f"{label}: dequant-transpose of {name} ({inner.kind}) [{rows}, {inner.out_features}] x "
                f"[{inner.out_features}, {inner.in_features}]: {ms:.4f} ms ({smi})")
            dq_ms += ms * backend.n_blocks
    cfg = server.cfg
    q = torch.randn(hidden.shape[0], hidden.shape[1], cfg.num_attention_heads, cfg.head_dim, device=device)
    k = torch.randn(hidden.shape[0], hidden.shape[1], cfg.num_key_value_heads, cfg.head_dim, device=device)
    q, k = q.to(torch.bfloat16).requires_grad_(True), k.to(torch.bfloat16).requires_grad_(True)
    v = k.detach().clone().requires_grad_(True)
    go = torch.randn_like(q)

    def attn_fwd():
        with torch.no_grad():
            attend_reference(q, k, v, sliding_window=cfg.sliding_window)

    def attn_fwd_bwd():
        out = attend_reference(q, k, v, sliding_window=cfg.sliding_window)
        torch.autograd.grad(out, (q, k, v), go)

    attn_ms = max(_events_ms(attn_fwd_bwd) - _events_ms(attn_fwd), 0.0) * backend.n_blocks
    busy = t["device_busy_ms"]
    result = {"host_wall_ms": t["host_wall_ms"], "device_busy_ms": busy, "idle_share": t["idle_share"],
              "peak_bytes": peak, "dequant_transpose_ms": dq_ms, "attention_backward_ms": attn_ms}
    log(f"{label}: backward host wall {t['host_wall_ms']:.3f} ms, device busy {busy:.3f} ms (idle share "
        f"{t['idle_share']:.3f}), peak {peak / 2**30:.3f} GiB above the resident {base / 2**30:.3f} GiB; plain pieces: "
        f"dequant-transpose {dq_ms:.3f} ms ({dq_ms / busy:.3f} of busy), attention backward {attn_ms:.3f} ms "
        f"({attn_ms / busy:.3f} of busy) ({smi})")
    return result


def _greedy_against(label, tokens, prompt_len, ref_params, ckpt, device):
    """A greedy stream held to the dense references: each new token's
    float32 reference logit within REPLY_NOISE_FACTOR times the stream's
    largest |bf16 - float32| reference logit gap of the maximum (phase 16's
    rule). Returns what failed."""
    from petals_tpu_torch.server.from_pretrained import get_block_config

    family, cfg = get_block_config(ckpt)
    embed, ref_logits = _reference_head(ckpt, device)
    x = embed[torch.as_tensor(tokens[:, :-1])].float()
    logits = {dt: ref_logits(reference_forward(p, family, cfg, x, None, device, dt)[0, prompt_len - 1:]).double().cpu()
              for dt, p in ref_params.items()}
    eps = REPLY_NOISE_FACTOR * (logits[torch.bfloat16] - logits[torch.float32]).abs().max().item()
    z = logits[torch.float32]
    new = torch.as_tensor(tokens[0, prompt_len:]).long()
    gap = (z.max(dim=-1).values - z[torch.arange(len(new)), new]).max().item()
    log(f"{label}: {len(new)} greedy tokens: each float32 reference logit at most {gap:.3e} below the max "
        f"(tol {eps:.3e})")
    return [f"{label}: a greedy token's reference logit is {gap:.3e} below the max"] if gap > eps else []


def serve_training_and_check(ckpt, device, smi) -> dict:
    """Phase 24: training and adapters on the card (alone:
    scripts/smoke_training.py). Returns the K4 / K5 / K6 launches of the
    phase's forwards, backwards and adapter sessions, and its backward
    profiles."""
    from petals_tpu_torch.cli.run_server import build_parser, build_server
    from petals_tpu_torch.client import PTuneConfig
    from petals_tpu_torch.client.config import ClientConfig
    from petals_tpu_torch.client.model import (
        AutoDistributedModelForCausalLM,
        AutoDistributedModelForSequenceClassification,
    )
    from petals_tpu_torch.client.remote_sequential import RemoteSequential
    from petals_tpu_torch.client.runtime import SwarmRuntime
    from petals_tpu_torch.client.training import compute_cls_loss_and_grads, compute_loss_and_grads, sgd_step
    from petals_tpu_torch.data_structures import ServerState, make_uid
    from petals_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    cut = cut_checkpoint(ckpt, os.path.join(ckpt, f"mistral-7b-{TRAIN_SPAN}-layers-train"), TRAIN_SPAN)
    short = cut_checkpoint(ckpt, os.path.join(ckpt, f"mistral-7b-{TRAIN_SHORT}-layers-train"), TRAIN_SHORT)
    cls_ckpt = write_cls_checkpoint(ckpt, os.path.join(ckpt, f"mistral-7b-{TRAIN_SPAN}-layers-cls"), device,
                                    TRAIN_SPAN)
    adapter_root = os.path.join(ckpt, "adapters")
    adapters = (write_adapter(adapter_root, "lora-a", SEED + 31, device),
                write_adapter(adapter_root, "lora-b", SEED + 32, device, rank=8,
                              targets=("self_attn.k_proj", "self_attn.o_proj", "mlp.up_proj")))
    loop = SwarmRuntime()
    failed, result, live = [], {"K4": 0, "quant": {}}, []

    def start(path, *args):
        server = build_server(build_parser().parse_args([
            path, "--host", "127.0.0.1", "--throughput", "1", *NO_PREFIX_CACHE, *args]))
        t0 = time.perf_counter()
        loop.run(server.start(), LOOP_TIMEOUT_S)
        live.append(server)
        log(f"training: server of {path.rsplit('/', 1)[-1]} (--quant_type {server.quant_type}"
            f"{', adapters ' + str(sorted(server.backend.adapters)) if server.backend.adapters else ''}) started in "
            f"{time.perf_counter() - t0:.1f} s")
        return server

    def stop(server):
        loop.run(server.shutdown(), LOOP_TIMEOUT_S)
        live.remove(server)
        free_card()

    def peers(server):
        return [server.dht.own_addr.to_string()]

    def count(k4_before, quant_before):
        result["K4"] += fa.flash_attend.launches - k4_before
        for key, n in _delta(_quant_counts(), quant_before).items():
            result["quant"][key] = result["quant"].get(key, 0) + n

    try:
        # (a) the backward on the 8-block bf16 span, over the wire
        server = start(cut, "--first_block", "0", "--num_blocks", str(TRAIN_SPAN))
        uids = [make_uid(server.dht_prefix, i) for i in range(TRAIN_SPAN)]
        remote = RemoteSequential(ClientConfig(initial_peers=peers(server)), uids)
        k4, q0 = fa.flash_attend.launches, _quant_counts()
        label = f"training a (bf16, {TRAIN_SPAN} Mistral-7B blocks)"
        bad, wall, _, inputs = check_wire_backward(label, server, remote, device, SEED + 24)
        failed += bad
        count(k4, q0)
        remote.close()
        result["backward_bf16"] = dict(profile_backward(label, server, device, inputs, smi), client_wall_ms=wall * 1e3)

        # (c) the port's client trains deep prompts over the same server, then a classifier
        label = f"training c (the port's client, deep_ptune, {TRAIN_SPAN} blocks)"
        k4, q0 = fa.flash_attend.launches, _quant_counts()
        model = AutoDistributedModelForCausalLM.from_pretrained(cut, initial_peers=peers(server),
                                                                ptune=PTuneConfig(TRAIN_PRE, "deep_ptune"))
        try:
            gen = torch.Generator().manual_seed(SEED + 25)
            ids = torch.randint(0, MISTRAL_7B["vocab_size"], (TRAIN_BATCH, TRAIN_CLIENT_SEQ), generator=gen).numpy()
            start_params = {k: v.detach().clone() for k, v in model.trainable_params().items()}
            losses, first = [], None
            for step in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                loss, grads = compute_loss_and_grads(model, ids, ids)
                wall = time.perf_counter() - t0
                first = first or grads
                top = max(float(g.abs().max()) for g in grads.values())
                if not (np.isfinite(loss) and top > 0 and all(torch.isfinite(g).all() for g in grads.values())):
                    failed.append(f"{label}: step {step}: loss {loss} or non-finite / zero grads")
                    break
                losses.append(loss)
                sgd_step(model, grads, TRAIN_STEP_SIZE / top)
                log(f"{label}: step {step}: loss {loss:.6f}, largest grad {top:.3e}, client wall {wall * 1e3:.1f} ms")
            losses.append(compute_loss_and_grads(model, ids, ids)[0])
            log(f"{label}: losses {', '.join(f'{x:.6f}' for x in losses)}")
            if not all(b < a for a, b in zip(losses, losses[1:])):
                failed.append(f"{label}: the loss did not fall at every step: {losses}")
            # the first step's grads against the float32 reference: the same
            # client pieces, the blocks dense on the card, autograd end to end
            backend = server.backend
            refs = {}
            for dt in (torch.bfloat16, torch.float32):
                params = dense_reference_params(backend.block_params, dt)
                prompt = start_params["prompt_embeddings"].requires_grad_(True)
                deep = start_params["deep_prompt_embeddings"].requires_grad_(True)
                with torch.enable_grad():
                    x = model.family.client_embed(model.client_params, torch.as_tensor(ids, device=device), model.cfg)
                    h = torch.cat([prompt[None].expand(TRAIN_BATCH, -1, -1), x], dim=1).to(dt)
                    shape = (TRAIN_BATCH, h.shape[1], backend.num_kv_heads, backend.head_dim)
                    for i, p in enumerate(params):
                        h = torch.cat([h[:, :TRAIN_PRE] + deep[i].to(dt)[None], h[:, TRAIN_PRE:]], dim=1)
                        kv = (torch.zeros(shape, dtype=dt, device=device), torch.zeros(shape, dtype=dt, device=device))
                        h, _ = model.family.block_apply(p, h, kv, 0, model.cfg)
                    logits = model.family.client_head(model.client_params, h.float(), model.cfg)
                    labels = np.concatenate([np.full((TRAIN_BATCH, TRAIN_PRE), -100), ids], axis=1)
                    from petals_tpu_torch.client.training import cross_entropy

                    ref_loss = cross_entropy(logits[:, :-1], labels[:, 1:])
                    refs[dt] = [g.float().cpu() for g in torch.autograd.grad(ref_loss, [prompt, deep])]
                del params
            got = [first["prompt_embeddings"].float().cpu(), first["deep_prompt_embeddings"].float().cpu()]
            failed += check_to_f32(f"{label}: the first step's grads", got, refs[torch.bfloat16], refs[torch.float32])
        finally:
            model.close()
        # one classification step (the same blocks, a score head of CLS_LABELS)
        label = f"training c (classification, {CLS_LABELS} labels, {TRAIN_SPAN} blocks)"
        cls_model = AutoDistributedModelForSequenceClassification.from_pretrained(
            cls_ckpt, initial_peers=peers(server), dht_prefix=server.dht_prefix,
            ptune=PTuneConfig(TRAIN_PRE, "deep_ptune"))
        try:
            cls_ids = ids.copy()
            cls_ids[0, -8:] = 0  # a padded tail: row 0 pools before it
            labels = np.array([1, 2])
            loss, grads = compute_cls_loss_and_grads(cls_model, cls_ids, labels)
            top = max(float(g.abs().max()) for g in grads.values())
            sgd_step(cls_model, grads, TRAIN_STEP_SIZE / max(top, 1e-30))
            after, _ = compute_cls_loss_and_grads(cls_model, cls_ids, labels)
            logits = cls_model.forward(cls_ids)
            log(f"{label}: loss {loss:.6f} -> {after:.6f} after one step; pooled at {cls_model.pool_positions(cls_ids)}; "
                f"logits {tuple(logits.shape)}")
            if not (np.isfinite(loss) and after < loss and tuple(logits.shape) == (TRAIN_BATCH, CLS_LABELS)):
                failed.append(f"{label}: loss {loss} -> {after} or logits {tuple(logits.shape)}")
        finally:
            cls_model.close()
        count(k4, q0)
        stop(server)
        del server

        # (b) and (d): TRAIN_SHORT blocks, bf16 and nf4a hosting two adapters, then int8
        for quant in ("none", "nf4a", "int8"):
            with_adapters = quant != "int8"
            server = start(short, "--first_block", "0", "--num_blocks", str(TRAIN_SHORT), "--quant_type", quant,
                           *(("--adapters", *adapters) if with_adapters else ()))
            uids = [make_uid(server.dht_prefix, i) for i in range(TRAIN_SHORT)]
            k4, q0 = fa.flash_attend.launches, _quant_counts()
            tag = f"--quant_type {quant}, {TRAIN_SHORT} blocks"
            if with_adapters and server._server_info(ServerState.ONLINE).adapters != ("lora-a", "lora-b"):
                failed.append(f"training ({tag}): the announce lists {server._server_info(ServerState.ONLINE).adapters}")
            if with_adapters and any(k in p for p in server.backend.block_params for k in ("wqkv", "wgu")):
                failed.append(f"training ({tag}): a span with adapters loaded fused leaves")
            remote = RemoteSequential(ClientConfig(initial_peers=peers(server)), uids)
            label = f"training b ({tag})"
            bad, wall, quant_in, inputs = check_wire_backward(label, server, remote, device, SEED + 26)
            failed += bad
            if quant != "none":
                n = sum(quant_in.values())
                if not n:
                    failed.append(f"{label}: no K5/K6 launch inside the backward")
                result[f"backward_{quant}"] = dict(profile_backward(label, server, device, inputs, smi),
                                                   client_wall_ms=wall * 1e3, launches=quant_in)
            remote.close()
            if with_adapters:
                label = f"training d (adapters, {tag})"
                remotes = {name: RemoteSequential(ClientConfig(initial_peers=peers(server), active_adapter=name), uids)
                           for name in ("lora-a", "lora-b", None)}
                try:
                    bad, _, _, _ = check_wire_backward(f"{label}: lora-a", server, remotes["lora-a"], device,
                                                       SEED + 27, adapter="lora-a", pre=0)
                    failed += bad
                    gen = torch.Generator().manual_seed(SEED + 28)
                    x = torch.randn(TRAIN_BATCH, 256, server.cfg.hidden_size, generator=gen).to(torch.bfloat16)
                    prog = server.backend._forward_program
                    outs = {}
                    for name, r in remotes.items():  # each twice: the eager call, then the capture
                        r.forward(x)
                        outs[name] = r.forward(x)
                    captures = prog.counts.captures
                    for name in ("lora-b", None, "lora-a"):  # switching back: replays
                        if not torch.equal(remotes[name].forward(x), outs[name]):
                            failed.append(f"{label}: a replay of {name or 'the base'}'s forward differs")
                    late = prog.counts.captures - captures
                    refs = {dt: merged_reference_params(server.backend.block_params, server.backend.adapters["lora-a"],
                                                        dt) for dt in (torch.bfloat16, torch.float32)}
                    want = {dt: reference_forward(p, server.family, server.cfg, x, None, device, dt)
                            for dt, p in refs.items()}
                    failed += check_to_f32(f"{label}: lora-a's forward {tuple(x.shape)}", [outs["lora-a"]],
                                           [want[torch.bfloat16]], [want[torch.float32]])
                    # apart by the span's contribution (output - input): the
                    # residual's rounding would swamp a reply's difference
                    xf = x.float()
                    noise = _rel_errors([want[torch.bfloat16] - xf], [want[torch.float32] - xf])[1]
                    apart = {name: _rel_errors([outs[name].float() - xf], [outs["lora-a"].float() - xf])[1]
                             for name in ("lora-b", None)}
                    log(f"{label}: the span's contribution, mean-rel from lora-a's: lora-b {apart['lora-b']:.3e}, the "
                        f"base {apart[None]:.3e} (the references' noise {noise:.3e}); forward captures after switching "
                        f"back: {late}")
                    if late or min(apart.values()) <= REPLY_NOISE_FACTOR * noise:
                        failed.append(f"{label}: {late} captures after warm-up, or adapters' replies not apart")
                    # an adapter session's greedy stream (server-side generation on a private cache)
                    model = AutoDistributedModelForCausalLM.from_pretrained(short, initial_peers=peers(server),
                                                                            active_adapter="lora-a")
                    acquire, acquired = server.batcher.acquire_lane, []

                    async def counted_acquire(*args, **kwargs):
                        acquired.append(1)
                        return await acquire(*args, **kwargs)

                    try:
                        prompt = torch.randint(0, MISTRAL_7B["vocab_size"], (1, ADAPTER_PROMPT), generator=gen).numpy()
                        server.batcher.acquire_lane = counted_acquire
                        tokens = model.generate(prompt, max_new_tokens=ADAPTER_NEW)
                        failed += _greedy_against(f"{label}: lora-a's session", tokens, ADAPTER_PROMPT, refs, short,
                                                  device)
                        if acquired:
                            failed.append(f"{label}: the adapter session asked for a lane")
                    finally:
                        server.batcher.acquire_lane = acquire
                        model.close()
                    del refs, want
                finally:
                    for r in remotes.values():
                        r.close()
            count(k4, q0)
            stop(server)
            del server
    finally:
        for server in list(live):
            loop.run(server.shutdown(), LOOP_TIMEOUT_S)
        loop.shutdown()
    log(f"training: K4 launches {result['K4']}, K5/K6 launches {result['quant']} on the phase's forwards, "
        f"backwards and adapter sessions")
    if failed:
        raise AssertionError("; ".join(failed))
    if not result["K4"] or not any(k.endswith(" nf4a") for k in result["quant"]) or not any(
            k.endswith(" int8") for k in result["quant"]):
        raise AssertionError(f"training: K4, K5 nf4a or K6 never launched: {result}")
    log(f"training: phase done in {time.perf_counter() - t_phase:.1f} s")
    return result


class _FirstTokenClock:
    """An HF streamer that notes the time from its creation to the first
    put() after the prompt's: the client's time to its first new token."""

    def __init__(self):
        self.t0, self.first, self._puts = time.perf_counter(), None, 0

    def put(self, value) -> None:
        self._puts += 1
        if self._puts == 2:
            self.first = time.perf_counter() - self.t0

    def end(self) -> None:
        pass


def _tensor_leaves(x) -> list:
    """The tensors of a parameter leaf, a quantized one's pieces included."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x) for t in _tensor_leaves(getattr(x, f.name))]
    return []


def _same_bits(params_a, params_b) -> bool:
    """Whether two spans' parameters hold the same dtypes and bits."""
    if len(params_a) != len(params_b):
        return False
    for pa, pb in zip(params_a, params_b):
        for name in pa:
            la, lb = _tensor_leaves(pa[name]), _tensor_leaves(pb[name])
            if len(la) != len(lb) or not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(la, lb)):
                return False
    return True


def _same_or_tied(label, got, want, prompt_len, block_params, ckpt, device):
    """Two greedy streams of one prompt: equal, or, where they part, each
    held to the dense references (_greedy_against: a near-tie both ways).
    Returns what failed."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape == want.shape and (got == want).all():
        return []
    part = int(np.argmax(got[0] != want[0])) if got.shape == want.shape else -1
    log(f"{label}: the streams part at position {part}: holding both to the dense references")
    ref = {dt: dense_reference_params(block_params, dt) for dt in (torch.bfloat16, torch.float32)}
    return (_greedy_against(f"{label} (this stream)", got, prompt_len, ref, ckpt, device)
            + _greedy_against(f"{label} (the other)", want, prompt_len, ref, ckpt, device))


async def _announced_online(peers, server, n_blocks) -> bool:
    """Whether the directory reads ``server`` ONLINE on each block of its span."""
    from petals_tpu_torch.data_structures import ServerState

    infos, _ = await _read_directory(peers, server.dht_prefix, n_blocks)
    return all(
        infos[i] is not None and server.dht.peer_id in infos[i].servers
        and infos[i].servers[server.dht.peer_id].state == ServerState.ONLINE
        for i in range(server.first_block, server.first_block + server.num_blocks)
    )


async def _cancel_task(task) -> None:
    task.cancel()
    with contextlib.suppress(asyncio.CancelledError):
        await task


def serve_swarm_ops_and_check(ckpt, device, smi) -> dict:
    """Phase 25: swarm operations on the card (alone: scripts/smoke_swarm_ops.py).
    (a) an nf4a server started twice over one --cache_dir: the cold start
    quantizes and writes the cache, the warm start reads it (the same bits),
    each start's session held to the references; (b) two bf16 servers at
    [0, 4) of the 8-block cut, the balance loop of one moving it to [4, 8),
    a session through the chain held to the references, then a resize of a
    server under a live client session (its KV pushed to a replica, the
    stream going on equal); (c) the chaos plane: a dropped stream open, a
    failed step, a dropped announce and one replica's corrupted probe, the
    stream equal to the unperturbed one, each firing counted once and the
    quorum naming the corrupted replica; (d) a seeded traffic schedule
    against a batched and a --no_batching server of the 4-block cut,
    every session completed, the streams equal, TTFT and tokens/s printed;
    (e) the autoscaler over HealthMonitor snapshots of (b)'s servers, its
    resize carried out by Server.resize. Returns the phase's launches of K1,
    K2, K4 and K5's nf4a arms (the counters set to 0 as it starts)."""
    import weakref

    from petals_tpu_torch import chaos
    from petals_tpu_torch.cli.run_server import build_parser, build_server
    from petals_tpu_torch.client import AutoDistributedModelForCausalLM
    from petals_tpu_torch.client.runtime import SwarmRuntime
    from petals_tpu_torch.data_structures import CHAIN_DELIMITER, ServerState, make_uid
    from petals_tpu_torch.dht import DHTNode
    from petals_tpu_torch.ops import flash_attention as fa
    from petals_tpu_torch.ops import fingerprint as fp_ops
    from petals_tpu_torch.ops import paged_flash_attention as pfa
    from petals_tpu_torch.rpc import RpcClient
    from petals_tpu_torch.swarm import Autoscaler, PolicyConfig, server_actuator
    from petals_tpu_torch.swarm.policy import snapshot_from_health
    from petals_tpu_torch.telemetry import instruments as tm
    from petals_tpu_torch.telemetry.integrity import quorum_outliers
    from petals_tpu_torch.traffic import TrafficConfig, TrafficGenerator, run_schedule
    from petals_tpu_torch.utils.health import HealthMonitor

    t_phase = time.perf_counter()
    cut = cut_checkpoint(ckpt, os.path.join(ckpt, f"mistral-7b-{SPAN}-layers-ops"), SPAN)
    whole = cut_checkpoint(ckpt, os.path.join(ckpt, f"mistral-7b-{OPS_SPAN}-layers-ops"), OPS_SPAN)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    cache_dir = tempfile.mkdtemp(prefix="quant-cache-", dir=os.path.join(REPO, "build"))
    loop = SwarmRuntime()  # the servers' loop thread; the client runs its own
    failed, live, models = [], [], []
    boot = loop.run(DHTNode.create(host="127.0.0.1"), LOOP_TIMEOUT_S)
    peers = [boot.own_addr.to_string()]

    def start(path, *args):
        server = build_server(build_parser().parse_args([
            # every announce inside the phase is the phase's own
            path, "--host", "127.0.0.1", "--initial_peers", *peers, *QUIET_ANNOUNCES, *NO_PREFIX_CACHE, *args]))
        t0 = time.perf_counter()
        loop.run(server.start(), LOOP_TIMEOUT_S)
        live.append(server)
        return server, time.perf_counter() - t0

    def stop(server):
        loop.run(server.shutdown(), LOOP_TIMEOUT_S)
        live.remove(server)

    def client(path):
        # short bans and backoffs: a faulted hop is retried within the phase's time
        model = AutoDistributedModelForCausalLM.from_pretrained(path, initial_peers=peers, min_backoff=0.1,
                                                                max_backoff=1.0, ban_timeout=1.0)
        models.append(model)
        return model

    def span_of(server):
        return f"[{server.first_block}, {server.first_block + server.num_blocks})"

    def reload_line(server):
        st = server.load_stats
        return (f"reload wall {st['load_s'] + st['warm_s']:.2f} s: the span's load {st['load_s']:.2f} s, the new "
                f"pool's step programs {st['warm_s']:.2f} s")

    _reset_launch_counts()  # the phase's main path: every launch from here on
    try:
        # (a) the quantized-block cache: the cold start writes it, the warm start reads it
        label = f"swarm ops a (--quant_type nf4a, {OPS_SPAN} blocks, --cache_dir)"
        runs = {}
        for kind in ("cold", "warm"):
            q0 = _quant_counts()
            server, start_s = start(cut, "--block_indices", f"0:{OPS_SPAN}", "--quant_type", "nf4a",
                                    "--cache_dir", cache_dir, "--throughput", "1")
            inputs, replies, _, _, _ = loop.run(
                drive_server(server, (OPS_PROMPT,), OPS_STEPS, SEED + 25), LOOP_TIMEOUT_S)
            runs[kind] = dict(start_s=start_s, replies=replies[0], params=server.backend.block_params,
                              stats=dict(server.load_stats), k5=_delta(_quant_counts(), q0), family=server.family,
                              cfg=server.cfg)
            st = runs[kind]["stats"]
            log(f"{label}: {kind} start {start_s:.2f} s, of which the span's load {st['load_s']:.2f} s "
                f"({st['cache_hits']} cache hits, {st['cache_misses']} misses); K5 launches {runs[kind]['k5']} ({smi})")
            stop(server)
            del server
            free_card()
        cold, warm = runs["cold"], runs["warm"]
        if cold["stats"]["cache_misses"] != OPS_SPAN or warm["stats"]["cache_hits"] != OPS_SPAN:
            failed.append(f"{label}: cache misses / hits {cold['stats']} / {warm['stats']}")
        if not all(r["k5"].get("decode nf4a") and r["k5"].get("prefill nf4a") for r in runs.values()):
            failed.append(f"{label}: K5's nf4a kernels did not run on both starts: {cold['k5']} / {warm['k5']}")
        if not _same_bits(cold["params"], warm["params"]):
            failed.append(f"{label}: the warm start's weights are not the cold start's bits")
        (prompt, steps), = inputs
        refs = [reference_session(dense_reference_params(warm["params"], dt), warm["family"], warm["cfg"], prompt,
                                  steps, device, dt) for dt in (torch.bfloat16, torch.float32)]
        for kind, run in runs.items():
            failed += check_session(run["replies"], None, *refs, f"{label}: the {kind} start's session")
        gap = max((a - b).abs().max().item() for a, b in zip(cold["replies"], warm["replies"]))
        log(f"{label}: warm against cold start: load {warm['stats']['load_s']:.2f} s against "
            f"{cold['stats']['load_s']:.2f} s; replies' largest difference {gap:.3e} ({smi})")
        del runs, cold, warm, refs
        free_card()

        # (b) the balance loop moves one of two servers, then a resize under a live session
        label = f"swarm ops b (bf16, two servers at [0, {OPS_SPAN}) of the {SPAN}-block cut)"
        a, _ = start(cut, "--block_indices", f"0:{OPS_SPAN}", "--throughput", str(OPS_THROUGHPUT["A"]))
        t_b = time.perf_counter()
        b, _ = start(cut, "--block_indices", f"0:{OPS_SPAN}", "--throughput", str(OPS_THROUGHPUT["B"]),
                     "--mean_balance_check_period", str(OPS_BALANCE_PERIOD))
        old_backend = weakref.ref(b.backend)
        deadline = time.perf_counter() + OPS_MOVE_WAIT_S
        while not (b.first_block == OPS_SPAN and loop.run(_announced_online(peers, b, SPAN), LOOP_TIMEOUT_S)):
            if time.perf_counter() > deadline:
                raise AssertionError(f"{label}: B's balance loop did not move it in {OPS_MOVE_WAIT_S} s "
                                     f"(it serves {span_of(b)}; the loop logs a failed check)")
            time.sleep(0.1)
        loop.run(_cancel_task(b._balancer_task), LOOP_TIMEOUT_S)  # no further move while the sessions run
        log(f"{label}: B moved itself to {span_of(b)} {time.perf_counter() - t_b:.1f} s after its start; "
            f"{reload_line(b)} ({smi})")
        gc.collect()
        if old_backend() is not None:
            failed.append(f"{label}: B's old span (its backend and weights) outlived the move")
        if device.type == "cuda":
            torch.cuda.synchronize()
            log(f"{label}: {torch.cuda.memory_allocated(device) / 2**30:.2f} GiB allocated on the card after "
                f"B's move (servers A and B, {OPS_SPAN} bf16 blocks each)")
        if a.first_block != 0 or b.batcher._handles is None:
            failed.append(f"{label}: A at {span_of(a)}, B's new pool open: {b.batcher._handles is not None}")
        stubs = [loop.run(RpcClient.connect("127.0.0.1", s.rpc_server.port), LOOP_TIMEOUT_S) for s in (a, b)]
        chain = [(stub, CHAIN_DELIMITER.join(make_uid(s.dht_prefix, i) for i in range(s.first_block,
                                                                                           s.first_block + s.num_blocks)))
                 for stub, s in zip(stubs, (a, b))]
        before = _launch_counts()
        inputs, outs, _ = loop.run(_drive_chain(chain, (OPS_PROMPT,), OPS_STEPS, SEED + 26, a.cfg.hidden_size),
                                   LOOP_TIMEOUT_S)
        launches = _delta(_launch_counts(), before)
        for stub in stubs:
            loop.run(stub.close(), LOOP_TIMEOUT_S)
        log(f"{label}: a session through A {span_of(a)} -> B {span_of(b)}: launches {launches}")
        if launches.get("K1", 0) < OPS_STEPS * SPAN or launches.get("K2", 0) < SPAN:
            failed.append(f"{label}: the chain did not run K1 / K2 on every block: {launches}")
        (prompt, steps), = inputs
        block_params = a.backend.block_params + b.backend.block_params
        refs = [reference_session(dense_reference_params(block_params, dt), a.family, a.cfg, prompt, steps, device, dt)
                for dt in (torch.bfloat16, torch.float32)]
        failed += check_session(outs[0], None, *refs, f"{label}: the session over B's new span")
        del refs

        label = f"swarm ops b (resize under a live session, {SPAN}-block cut)"
        c, _ = start(cut, "--block_indices", f"0:{OPS_SPAN}", "--throughput", str(OPS_THROUGHPUT["C"]))
        model = client(cut)
        gen = torch.Generator().manual_seed(SEED + 27)
        vocab = a.cfg.vocab_size
        ids = torch.randint(0, vocab, (1, 64), generator=gen).numpy()
        expected = model.generate(ids, max_new_tokens=OPS_NEW)
        with model.remote.inference_session(max_length=ids.shape[1] + OPS_NEW, batch_size=1) as session:
            first = model.generate(ids, max_new_tokens=OPS_CUT_AT, session=session)
            front = session._session._sessions[0].span.peer_id.to_string()
            if front != a.identity.peer_id.to_string():
                raise AssertionError(f"{label}: the session did not start on A (throughput {OPS_THROUGHPUT['A']})")
            if not loop.run(a.resize(OPS_SPAN), LOOP_TIMEOUT_S):
                raise AssertionError(f"{label}: A's resize to [{OPS_SPAN}, {SPAN}) did nothing")
            final = model.generate(first, max_new_tokens=OPS_NEW - OPS_CUT_AT, session=session)
            after = session._session._sessions[0].span.peer_id.to_string()
        pushes = a.handler.migration_stats["pushes"]
        log(f"{label}: A resized to {span_of(a)} with a live session: {reload_line(a)}; KV pushes {pushes}, the "
            f"session's first hop now {'C' if after == c.identity.peer_id.to_string() else after} ({smi})")
        if a.first_block != OPS_SPAN or pushes != 1 or after != c.identity.peer_id.to_string():
            failed.append(f"{label}: A at {span_of(a)}, {pushes} pushes, the session's first hop {after}")
        ref_params = c.backend.block_params + b.backend.block_params
        failed += _same_or_tied(label, final, expected, ids.shape[1], ref_params, cut, device)

        # (c) chaos: each fault once, the stream as without them
        label = "swarm ops c (chaos: a stream open, a step, an announce, a probe)"
        # three replicas of [4, 8) for the quorum, two of [0, 4) so that a
        # dropped stream open leaves the client a route
        d, _ = start(cut, "--block_indices", f"{OPS_SPAN}:{SPAN}", "--throughput", str(OPS_THROUGHPUT["D"]))
        e, _ = start(cut, "--block_indices", f"0:{OPS_SPAN}", "--throughput", str(OPS_THROUGHPUT["E"]))
        ids = torch.randint(0, vocab, (1, 64), generator=gen).numpy()
        unperturbed = model.generate(ids, max_new_tokens=OPS_NEW)
        a_peer = a.identity.peer_id.to_string()
        rules = [chaos.ChaosRule(chaos.SITE_RPC_STREAM, "drop", max_count=1),
                 chaos.ChaosRule(chaos.SITE_HANDLER_STEP, "drop", max_count=1),
                 chaos.ChaosRule(chaos.SITE_ANNOUNCE, "drop", max_count=1),
                 chaos.ChaosRule(chaos.SITE_INTEGRITY_CORRUPT, "corrupt", match=f"{a_peer}:probe", max_count=1)]
        counters = [tm.CHAOS_INJECTIONS.labels(site=r.site, action=r.action) for r in rules]
        counted = [ctr.value for ctr in counters]
        plane = chaos.configure(seed=SEED + 25, rules=rules)
        try:
            perturbed = model.generate(ids, max_new_tokens=OPS_NEW)
            loop.run(d._announce(ServerState.ONLINE), LOOP_TIMEOUT_S)  # the announce the plane drops
            digests = {name: np.asarray(loop.run(s.handler.rpc_probe({"seed": OPS_PROBE_SEED, "tokens": 4}, None),
                                                 LOOP_TIMEOUT_S)["fp"], np.float32)
                       for name, s in (("A", a), ("B", b), ("D", d))}
            fired = plane.fired()
        finally:
            chaos.disable()
        counted = [ctr.value - n for ctr, n in zip(counters, counted)]
        outliers, majority = quorum_outliers(digests, rtol=fp_ops.tolerance_for("none", "none"))
        clean = np.asarray(loop.run(a.handler.rpc_probe({"seed": OPS_PROBE_SEED, "tokens": 4}, None),
                                    LOOP_TIMEOUT_S)["fp"], np.float32)
        log(f"{label}: fired {[(e['site'], e['action']) for e in fired]}; petals_chaos_injections_total by rule "
            f"{counted}; quorum over [{OPS_SPAN}, {SPAN}): outliers {outliers}, majority {majority}; A's probe after "
            f"the plane is off agrees with B's: {fp_ops.fp_close(clean, digests['B'], rtol=fp_ops.tolerance_for('none', 'none'))}")
        if sorted(e["site"] for e in fired) != sorted(r.site for r in rules) or counted != [1] * len(rules):
            failed.append(f"{label}: the plane fired {fired}, counted {counted}: not each rule once")
        if outliers != ["A"]:
            failed.append(f"{label}: the quorum named {outliers}, not the corrupted replica A")
        failed += _same_or_tied(label, perturbed, unperturbed, ids.shape[1], ref_params, cut, device)

        # (d) seeded traffic against a batched and a --no_batching server
        label = f"swarm ops d (traffic, the {OPS_SPAN}-block cut served whole)"
        plans = TrafficGenerator(TrafficConfig(**dict(OPS_TRAFFIC, vocab_size=a.cfg.vocab_size))).schedule()
        streams, whole_params = {}, None
        for mode, args in (("batched", ()), ("--no_batching", ("--no_batching",))):
            server, _ = start(whole, "--throughput", "1", *args)
            whole_params = server.backend.block_params
            m = client(whole)
            m.generate(np.asarray([plans[0].prompt]), max_new_tokens=2)  # warm-up

            def session_fn(plan, m=m):
                clock = _FirstTokenClock()
                out = m.generate(np.asarray([plan.prompt]), max_new_tokens=plan.new_tokens, streamer=clock)
                return out, clock.first

            before = _launch_counts()
            t0 = time.perf_counter()
            results = run_schedule(plans, session_fn, time_scale=OPS_TIME_SCALE, join_timeout_s=LOOP_TIMEOUT_S)
            wall = time.perf_counter() - t0
            launches = _delta(_launch_counts(), before)
            lost = [r for r in results if not r.ok]
            ttft = [r.value[1] * 1e3 for r in results if r.ok and r.value[1] is not None]
            new = sum(p.new_tokens for p in plans)
            log(f"{label}, {mode}: {len(plans)} sessions of {len({p.tenant for p in plans})} tenants, "
                f"{len(results) - len(lost)} completed; TTFT p50 {np.percentile(ttft, 50):.1f} ms, p99 "
                f"{np.percentile(ttft, 99):.1f} ms; {new / wall:.1f} new tokens/s over {wall:.2f} s; launches "
                f"{launches} ({smi})")
            if lost or len(ttft) != len(plans):
                failed.append(f"{label}, {mode}: sessions lost {[r.error for r in lost]}")
            need = ("K4",) if args else ("K1", "K2")
            if not all(launches.get(k) for k in need):
                failed.append(f"{label}, {mode}: {need} did not run: {launches}")
            streams[mode] = [r.value[0] if r.ok else None for r in results]
            models.remove(m)
            m.close()
            stop(server)
        for plan, got, want in zip(plans, streams["--no_batching"], streams["batched"]):
            if got is not None and want is not None:
                failed += _same_or_tied(f"{label}: session {plan.index}", got, want, len(plan.prompt), whole_params,
                                        whole, device)

        # (e) the autoscaler over HealthMonitor snapshots, its resize carried out
        label = "swarm ops e (the autoscaler over (b)'s servers)"
        monitor = HealthMonitor(peers)
        monitor.dht = loop.run(DHTNode.create(initial_peers=peers, client_mode=True), LOOP_TIMEOUT_S)
        try:
            async def snapshot(tick):
                await monitor.refresh()
                return snapshot_from_health(monitor._state["models"][a.dht_prefix], tick=tick)

            config = PolicyConfig(ttft_p99_ms=1e9, sustain_in=100, cooldown_resize=0)
            scaler = Autoscaler(snapshot, actuator=server_actuator(live), config=config, interval_s=0.0)
            spans_before = {s.identity.peer_id.to_string(): span_of(s) for s in (a, b, c, d, e)}
            for _ in range(3):
                loop.run(scaler.run_once(), LOOP_TIMEOUT_S)
                if scaler.decisions:
                    break
        finally:
            loop.run(monitor.dht.shutdown(), LOOP_TIMEOUT_S)
        log(f"{label}: spans {spans_before}; decision journal: {scaler.policy.journal_jsonl() or '(empty)'}")
        resized = [(dec, ok) for dec, ok in scaler.applied if dec.action == "resize"]
        if not resized or not resized[0][1]:
            failed.append(f"{label}: no resize decision carried out: {scaler.applied}")
        else:
            dec = resized[0][0]
            mover = next(s for s in (a, b, c, d, e) if s.identity.peer_id.to_string() == dec.target)
            log(f"{label}: {dec.target[:12]}... moved {dec.evidence['old_span']} -> {span_of(mover)}; "
                f"{reload_line(mover)} ({smi})")
            if (mover.first_block, mover.first_block + mover.num_blocks) != tuple(dec.span):
                failed.append(f"{label}: the resize decision {dec.span} was not carried out ({span_of(mover)})")
    finally:
        chaos.disable()
        for model in models:
            model.close()
        for server in list(live):
            stop(server)
        loop.run(boot.shutdown(), LOOP_TIMEOUT_S)
        loop.shutdown()
        shutil.rmtree(cache_dir, ignore_errors=True)
    counts = _launch_counts()
    result = {"K1": counts["K1"], "K2": counts["K2"], "K4": counts["K4"],
              **{k: n for k, n in _quant_counts().items() if k.endswith("nf4a")}}
    log(f"swarm ops: phase launches {result}; phase done in {time.perf_counter() - t_phase:.1f} s")
    if not all(result.get(k) for k in ("K1", "K2", "K4", "decode nf4a", "prefill nf4a")):
        failed.append(f"swarm ops: a kernel of the path never launched: {result}")
    if failed:
        raise AssertionError("; ".join(failed))
    return result


def llama3_checkpoint(src: str, dst: str, device) -> str:
    """A checkpoint of LLAMA3_8B's config beside ``src`` (write_checkpoint's
    8 Mistral-7B-width blocks, which are a Llama-3-8B block's widths): the
    block shards linked, not copied, and the client's tensors at Llama-3's
    128256-token vocabulary, random bf16 from SEED + 26. One made already is
    reused."""
    from petals_tpu_torch.utils.safetensors_io import save_file

    if os.path.isdir(dst):
        return dst
    os.makedirs(dst)
    with open(os.path.join(src, "model.safetensors.index.json")) as f:
        blocks = {name: fname for name, fname in json.load(f)["weight_map"].items() if name.startswith("model.layers.")}
    for fname in set(blocks.values()):
        os.symlink(os.path.join(src, fname), os.path.join(dst, fname))
    h, vocab = LLAMA3_8B["hidden_size"], LLAMA3_8B["vocab_size"]
    gen = torch.Generator(device=device).manual_seed(SEED + 26)
    client = {name: (torch.randn(vocab, h, generator=gen, device=device) * 0.02).to(torch.bfloat16)
              for name in ("model.embed_tokens.weight", "lm_head.weight")}
    client["model.norm.weight"] = torch.ones(h, dtype=torch.bfloat16)
    save_file(client, os.path.join(dst, "model-client.safetensors"), metadata={"format": "pt"})
    weight_map = dict(blocks, **{name: "model-client.safetensors" for name in client})
    del client
    with open(os.path.join(dst, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(LLAMA3_8B, f)
    return dst


def _tp_server(root, device, quant_type, tp, throughput=1.0, generate=False):
    """A port server of the whole of ``root`` on the dense lane pool: tp=1
    on ``device`` (``--page_size 0``), or ``tp`` shards all on ``device``
    (``num_tp_devices`` with ``tp_devices``, the keyword for callers: the
    CLI takes the host's first devices, and this host has one card), with
    server-side generation when ``generate`` (its client leaves take 4.2 GB
    in float32 at Llama-3's vocabulary). The tp server asks for the default
    paged pool, which tensor parallelism turns into the dense lane pool."""
    from petals_tpu_torch.server.server import Server

    return Server(
        root, first_block=0, host="127.0.0.1", device=device,
        num_tp_devices=tp if tp > 1 else None, tp_devices=[device] * tp if tp > 1 else None,
        quant_type=quant_type, page_size=PAGE if tp > 1 else 0, batch_lanes=TP_LANES,
        batch_max_length=TP_MAX_LENGTH, inference_max_length=2 * TP_MAX_LENGTH, attn_cache_bytes=2 << 30,
        prefix_cache_bytes=0, update_period=600.0, throughput=throughput, quant_weight_cache=False,
        server_side_generation=generate,
    )


async def _drive_tp(server, n_blocks, seed, embed):
    """One server's phase-26 traffic, the same seeded inputs for every
    server: a private TP_BATCH-row session (a TP_PROMPT-token prompt, then
    TP_STEPS decode steps) with its cache's K/V rows, TP_LANES pooled
    sessions of the same shape at once, a stateless forward and a
    ptu.backward of TP_PROMPT tokens, and on a server that generates a
    server-side greedy generation of TP_GEN_NEW tokens after a
    TP_PROMPT-token prompt (``embed``: the checkpoint's embeddings)."""
    from petals_tpu_torch.data_structures import CHAIN_DELIMITER, make_uid
    from petals_tpu_torch.rpc import RpcClient
    from petals_tpu_torch.rpc.serialization import deserialize_array, serialize_array

    out = {"private": await _drive_private(server, (0, n_blocks), TP_BATCH, TP_MAX_LENGTH,
                                           (TP_PROMPT,) + (1,) * TP_STEPS, seed)}
    inputs, outs, metas, _, _ = await drive_server(server, (TP_PROMPT,) * TP_LANES, TP_STEPS, seed + 1)
    out["lanes"] = (inputs, outs, metas)
    gen = torch.Generator().manual_seed(seed + 2)
    hsz = server.cfg.hidden_size
    hidden = torch.randn(1, TP_PROMPT, hsz, generator=gen).to(torch.bfloat16)
    grad = (torch.randn(1, TP_PROMPT, hsz, generator=gen) * 1e-2).to(torch.bfloat16)
    uids = CHAIN_DELIMITER.join(make_uid(server.dht_prefix, i) for i in range(n_blocks))
    client = await RpcClient.connect("127.0.0.1", server.rpc_server.port)
    try:
        fwd = await client.call("ptu.forward", {"uids": uids, "tensors": {"hidden": serialize_array(hidden)}},
                                timeout=300)
        bwd = await client.call("ptu.backward", {"uids": uids, "tensors": {
            "hidden": serialize_array(hidden), "grad_out": serialize_array(grad)}}, timeout=300)
        out["forward"] = (hidden, deserialize_array(fwd["tensors"]["hidden"]))
        out["backward"] = (hidden, grad, deserialize_array(bwd["tensors"]["grad_hidden"]))
        if server.server_gen_params is not None:
            ids = torch.randint(0, server.cfg.vocab_size, (1, TP_PROMPT), generator=gen)
            prompt = embed[ids].to(torch.bfloat16)
            stream = await client.open_stream("ptu.inference")
            await stream.send({"uids": uids, "max_length": TP_MAX_LENGTH, "batch_size": 1})
            if not (await stream.recv(timeout=120))["session_open"]:
                raise AssertionError("the generating session did not open")
            await stream.send({"tensors": {"hidden": serialize_array(prompt)}, "gen_tokens": TP_GEN_NEW})
            reply = await stream.recv(timeout=300)
            out["gen"] = ({"hidden": prompt}, torch.as_tensor(reply["tokens"]))
            await stream.end()
    finally:
        await client.close()
    return out


def _tp_within(label, got_tp, got_one, want_f32, base="tp=1") -> list:
    """The mesh server's replies against the unsharded (``base``) server's,
    both measured from the float32 reference: each of ``_rel_errors``' two
    distances (the worst max-rel and mean-rel over the replies) within
    REPLY_NOISE_FACTOR times the unsharded one's. Returns what failed."""
    tp, one = _rel_errors(got_tp, want_f32), _rel_errors(got_one, want_f32)
    log(f"{label}: vs float32 max-rel {tp[0]:.3e} mean-rel {tp[1]:.3e}; {base} {one[0]:.3e} / {one[1]:.3e} "
        f"(ratio {tp[0] / one[0]:.3f} / {tp[1] / one[1]:.3f}, tol {REPLY_NOISE_FACTOR:g})")
    if tp[0] > REPLY_NOISE_FACTOR * one[0] or tp[1] > REPLY_NOISE_FACTOR * one[1]:
        return [f"{label}: further from the float32 reference than {REPLY_NOISE_FACTOR:g}x {base}'s"]
    return []


def _shard_bytes(backend) -> list:
    """Each shard's weight bytes across the span (a leaf both shards share,
    a replicated norm on one device, counted once a shard)."""
    from petals_tpu_torch.ops.quant import QUANTIZED_TYPES

    def nbytes(leaf):
        if isinstance(leaf, QUANTIZED_TYPES):
            return leaf.nbytes
        return leaf.numel() * leaf.element_size() if isinstance(leaf, torch.Tensor) else 0

    return [sum(nbytes(leaf) for block in backend.block_params for leaf in block[s].values())
            for s in range(backend.tp_size)]


def _grid_name(backend) -> str:
    """tp=2, sp=2 or tp=2 x sp=2: the grid a backend spans."""
    tp, sp = backend.tp_size, getattr(backend, "sp_size", 1)
    return " x ".join(part for part in (f"tp={tp}" if tp > 1 else "", f"sp={sp}" if sp > 1 else "") if part)


def profile_tp_steps(one, two, device, smi, lanes=TP_LANES, max_length=TP_MAX_LENGTH, rows=TP_PROMPT,
                     what="tensor-parallel") -> dict:
    """Where a step over a mesh spends its time beside the unsharded one's,
    by ``profile_calls``: the dense pool's decode step at ``lanes`` lanes of
    ``max_length`` tokens (positions spread over the lanes, as the dense
    profile's) and a ``rows``-row chunk on a private cache of
    ``max_length`` tokens: tp=1 eager (an ``eager_sibling``) and replayed (a
    sibling whose programs warm first), and the mesh server eager, the only
    way its steps run."""
    sib, ref = sibling_backend(one), eager_sibling(one)
    gen = torch.Generator().manual_seed(SEED + 27)
    hsz = one.hidden_size
    h_pool = torch.randn(lanes, 1, hsz, generator=gen).to(torch.bfloat16)
    chunk = torch.randn(1, rows, hsz, generator=gen).to(torch.bfloat16)
    positions = torch.linspace(64, max_length - 64, lanes).to(torch.int32)

    def zeros(b, batch):
        return tuple(d.make_zeros() for d in b.cache_descriptors(batch, max_length, 0, b.n_blocks))

    pools = {b: zeros(b, lanes) for b in (sib, ref, two)}
    caches = {b: zeros(b, 1) for b in (sib, ref, two)}
    sib.warm_dense_programs(pools[sib], lanes, max_length, 8)
    pooled = f"dense pool decode step ({lanes} lanes of {max_length} tokens)"
    private = f"{rows}-row chunk on a private cache"
    grid = f"{_grid_name(two)} eager"
    steps = {}
    for name, b in (("tp=1 eager", ref), ("tp=1 replayed", sib), (grid, two)):
        steps[f"{pooled}, {name}"] = lambda b=b: b.batched_decode_step(h_pool, pools[b], positions)
        steps[f"{private}, {name}"] = lambda b=b: b.inference_step(chunk, caches[b], 0)
    log(f"{what} profile (--quant_type {one.quant_type}): {one.n_blocks} blocks ({smi})")
    times = profile_calls(steps)
    for what_step in (pooled, private):
        rows_ = {name: times[f"{what_step}, {name}"] for name in ("tp=1 eager", "tp=1 replayed", grid)}
        log(f"{what} profile: {what_step}: " + "; ".join(
            f"{name} host wall {t['host_wall_ms']:.3f} ms, device busy {t['device_busy_ms']:.3f} ms, idle "
            f"{t['idle_share']:.3f}, {t['launches']:g} launches" for name, t in rows_.items()) + f" ({smi})")
    return {label: {k: round(v, 4) for k, v in t.items() if k != "kernels"} for label, t in times.items()}


def serve_tensor_parallel_and_check(ckpt, device, smi, timer=None) -> dict:
    """Phase 26: tensor parallelism on the one card (alone:
    scripts/smoke_tensor_parallel.py). (a) With a ``timer`` (the card), K4
    at a shard's heads (16 query over 4 kv heads of 128) and K5 nf4a / K6
    at a shard's projections (TP_QUANT_SHAPES) against their plain
    versions. (b) A Llama-3-8B-config checkpoint of TP_SPAN blocks
    (``llama3_checkpoint``) served by a tp=1 port server and by a tp=TP one
    whose shards all lie on ``device``, in bf16 at 4 blocks, nf4a and int8
    at 2 (TP_KINDS; ``cut_checkpoint``: each cut served whole), each
    driven by ``_drive_tp`` with the same inputs. Every reply, the private session's K/V rows (joined across the
    shards), the forward and the backward's gradient are held to the
    float32 reference over the served weights (dequantized) with
    ``_tp_within``: the tp server's distance from it within
    REPLY_NOISE_FACTOR times the tp=1 server's. The bf16 tp server's greedy
    generation is teacher-forced (``check_gen_tokens``): summing two bf16
    partials rounds otherwise than one product, so its stream may part from
    a tp=1 server's. On the tp server: paging off, every shard on the card, no step
    program captured, two reductions a block call (llama), and K4, K5 nf4a
    and K6 launched. The bf16 servers' steps profiled side by side
    (``profile_tp_steps``). Returns the tp servers' launches (K4, and K5 /
    K6 by arm), the reductions, the kernel cases and the profile."""
    from petals_tpu_torch.models.llama import block as llama_block
    from petals_tpu_torch.parallel import collectives

    label = f"tensor parallel (Llama-3-8B, tp={TP} on one card)"
    t_phase = time.perf_counter()
    result = {"K4": 0, "quant": {}, "reductions": 0}
    if timer is not None:
        heads = (LLAMA3_8B["num_attention_heads"] // TP, LLAMA3_8B["num_key_value_heads"] // TP)
        result["flash_tp"] = check_flash_case(device, timer, *heads, LLAMA3_8B["head_dim"])
        result["quant_tp"] = check_quant_kernels(device, timer, TP_QUANT_SHAPES, TP_QUANT_ROWS, ("nf4a", "int8"),
                                                 TP_QUANT_REPORT, time_all=False, model=f"Llama-3-8B shard (tp={TP})")
    t0 = time.perf_counter()
    root = llama3_checkpoint(ckpt, os.path.join(ckpt, "llama3-8b"), device)
    log(f"{label}: checkpoint (the blocks linked, the client's tensors written) in {time.perf_counter() - t0:.1f} s")
    embed, _ = _reference_head(root, device)
    calls = [0]
    block_grid = llama_block.block_grid

    def counting(params, kv):
        calls[0] += isinstance(params, (list, tuple))
        return block_grid(params, kv)

    failed = []
    for quant_type, n_blocks in TP_KINDS:
        kind = f"--quant_type {quant_type}, {n_blocks} blocks"
        cut = root if n_blocks == TP_SPAN else cut_checkpoint(root, f"{root}-{n_blocks}", n_blocks)
        runs, servers = {}, {}
        for tp in (1, TP):
            bf16_tp = tp > 1 and quant_type == "none"  # the probe's TP arm and the generation
            server = _tp_server(cut, device, quant_type, tp, throughput="auto" if bf16_tp else 1.0, generate=bf16_tp)

            async def serve():
                await server.start()
                # counted from here: the start's probes are not the traffic
                _reset_launch_counts()
                t_start, before, reductions = time.perf_counter(), _quant_counts(), collectives.reduction_count()
                calls[0] = 0
                llama_block.block_grid = counting
                try:
                    out = await _drive_tp(server, n_blocks, SEED + 40, embed)
                    n_red = collectives.reduction_count() - reductions
                finally:
                    llama_block.block_grid = block_grid
                    await server.shutdown()
                return out, time.perf_counter() - t_start, _delta(_quant_counts(), before), n_red

            t0 = time.perf_counter()
            runs[tp], wall, quant, n_red = asyncio.run(serve())
            servers[tp] = server
            backend, batcher = server.backend, server.batcher
            launches = _launch_counts()
            log(f"{label}: tp={tp} ({kind}): started and served in {time.perf_counter() - t0:.1f} s (traffic "
                f"{wall:.1f} s); launches K4 {launches['K4']}, K5/K6 {quant or 'none'}; pool "
                f"{'paged' if batcher.page_size else 'dense'}, {batcher.n_lanes} lanes of {batcher.max_length}"
                + (f"; throughput {server._rps_info}" if server._rps_info else ""))
            if tp == 1:
                continue
            log(f"{label}: tp={tp} ({kind}): {calls[0]} sharded block calls, {n_red} reductions (2 a call); shard "
                f"weight bytes {_shard_bytes(backend)}; step programs {backend.step_program_stats()}")
            # every shard's weights on the card: no path runs on the host
            for shard in (shard for block in backend.block_params for shard in block):
                for leaf in shard.values():
                    where = (leaf.data if hasattr(leaf, "kind") else leaf).device
                    if where != device:
                        raise AssertionError(f"{label}: a shard's weight lies on {where}")
            if batcher.page_size is not None or backend.tp_size != TP:
                raise AssertionError(f"{label}: the tp server pages ({batcher.page_size}) or is not split in {TP}")
            if backend.step_program_stats()["graph_captures"]:
                raise AssertionError(f"{label}: the tp server captured step programs")
            if not calls[0] or n_red != 2 * calls[0]:
                raise AssertionError(f"{label}: {n_red} reductions over {calls[0]} sharded block calls, not 2 each")
            result["reductions"] += n_red
            result["K4"] += launches["K4"]
            for key, n in quant.items():
                result["quant"][key] = result["quant"].get(key, 0) + n
            if not launches["K4"] or (quant_type != "none" and not (
                    quant.get(f"decode {quant_type}") and quant.get(f"prefill {quant_type}"))):
                raise AssertionError(f"{label}: tp={tp} ({kind}): a kernel never ran (K4 {launches['K4']}, {quant})")
        one, two = runs[1], runs[TP]
        params = dense_reference_params(servers[1].backend.block_params, torch.float32)
        family, cfg = servers[1].family, servers[1].cfg
        inputs = one["private"][0]
        ref_out, ref_kv = reference_session(params, family, cfg, inputs[0], inputs[1:], device, torch.float32)
        failed += _tp_within(f"{label}: private batch-{TP_BATCH} session ({kind})", two["private"][1],
                             one["private"][1], ref_out)
        for name, got_tp, got_one, want in zip("KV", two["private"][3], one["private"][3], ref_kv):
            err_tp, err_one = _row_rel_error(got_tp, want), _row_rel_error(got_one, want)
            log(f"{label}: private session's written {name} rows ({kind}), worst row max-rel vs float32 "
                f"{err_tp:.3e}; tp=1 {err_one:.3e}")
            if err_tp > REPLY_NOISE_FACTOR * err_one:
                failed.append(f"{label}: written {name} rows ({kind}) further from float32 than 2x tp=1's")
        variants = sorted({m["variant"] for metas in two["lanes"][2] for m in metas})
        if variants != ["decode", "dense_prefill"]:
            raise AssertionError(f"{label}: pooled sessions took {variants}, not the dense lane pool's steps")
        for i, (prompt, steps) in enumerate(one["lanes"][0]):
            want, _ = reference_session(params, family, cfg, prompt, steps, device, torch.float32)
            failed += _tp_within(f"{label}: pooled session {i} ({kind})", two["lanes"][1][i], one["lanes"][1][i], want)
        hidden = one["forward"][0]
        failed += _tp_within(f"{label}: stateless forward of {TP_PROMPT} tokens ({kind})", [two["forward"][1]],
                             [one["forward"][1]], [reference_forward(params, family, cfg, hidden, None, device,
                                                                     torch.float32)])
        hidden, grad, _ = one["backward"]
        (want,) = reference_backward(params, family, cfg, hidden, None, grad, device, torch.float32)
        failed += _tp_within(f"{label}: ptu.backward's grad_hidden ({kind})", [two["backward"][2]],
                             [one["backward"][2]], [want])
        del params
        if "gen" in two:
            failed += check_gen_tokens(f"{label}: tp={TP} server-side generation ({kind})", *two["gen"],
                                       servers[1].backend.block_params, cut, device)
        if quant_type == "none" and timer is not None:
            result["profile"] = profile_tp_steps(servers[1].backend, servers[TP].backend, device, smi)
        del runs, servers, one, two
        free_card()
    if failed:
        raise AssertionError("; ".join(failed))
    log(f"{label}: launches on the tp servers K4 {result['K4']}, K5/K6 {result['quant']}; "
        f"{result['reductions']} reductions; phase 26 took {time.perf_counter() - t_phase:.1f} s")
    return result


def _sp_server(root, device, quant_type, tp, sp, adapters=()):
    """A port server of the whole of ``root`` for phase 27: unsharded on
    ``device`` with the dense lane pool (``--page_size 0``), or over a tp x
    sp grid whose every entry is ``device`` (``num_tp_devices`` /
    ``num_sp_devices`` with ``tp_devices``, the caller's keyword: this host
    has one card), which asks for the default paged pool and gets the
    dense lane pool, as any mesh does."""
    from petals_tpu_torch.server.server import Server

    mesh = tp * sp > 1
    return Server(
        root, first_block=0, host="127.0.0.1", device=device, num_tp_devices=tp if tp > 1 else None,
        num_sp_devices=sp if sp > 1 else None, tp_devices=[device] * (tp * sp) if mesh else None,
        quant_type=quant_type, page_size=PAGE if mesh else 0, batch_lanes=SP_LANES, batch_max_length=SP_LANE_LENGTH,
        inference_max_length=SP_MAX_LENGTH, attn_cache_bytes=2 << 30, prefix_cache_bytes=0, update_period=600.0,
        throughput=1.0, quant_weight_cache=False, server_side_generation=False, adapters=list(adapters),
    )


async def _drive_mesh(server, n_blocks, seed, private, lanes, n_forward, n_backward, adapter=None):
    """One server's phase-27 traffic, the same seeded inputs for every
    server: a private batch-1 session (``private``: its max length and step
    lengths) with its cache's K/V rows, ``lanes`` (prompt lengths) pooled
    sessions at once with SP_LANE_STEPS decode steps, a stateless forward
    of ``n_forward`` tokens and a ptu.backward of ``n_backward``, all with
    the LoRA ``adapter`` active if one is named."""
    from petals_tpu_torch.data_structures import CHAIN_DELIMITER, make_uid
    from petals_tpu_torch.rpc import RpcClient
    from petals_tpu_torch.rpc.serialization import deserialize_array, serialize_array

    max_length, steps = private
    out = {"private": await _drive_private(server, (0, n_blocks), 1, max_length, steps, seed, adapter=adapter)}
    if lanes:
        inputs, outs, metas, _, _ = await drive_server(server, lanes, SP_LANE_STEPS, seed + 1)
        out["lanes"] = (inputs, outs, metas)
    gen = torch.Generator().manual_seed(seed + 2)
    hsz = server.cfg.hidden_size
    fwd_hidden = torch.randn(1, n_forward, hsz, generator=gen).to(torch.bfloat16)
    hidden = torch.randn(1, n_backward, hsz, generator=gen).to(torch.bfloat16)
    grad = (torch.randn(1, n_backward, hsz, generator=gen) * 1e-2).to(torch.bfloat16)
    uids = CHAIN_DELIMITER.join(make_uid(server.dht_prefix, i) for i in range(n_blocks))
    client = await RpcClient.connect("127.0.0.1", server.rpc_server.port)
    try:
        fwd = await client.call("ptu.forward", {"uids": uids, "active_adapter": adapter,
                                                "tensors": {"hidden": serialize_array(fwd_hidden)}}, timeout=600)
        bwd = await client.call("ptu.backward", {"uids": uids, "active_adapter": adapter, "tensors": {
            "hidden": serialize_array(hidden), "grad_out": serialize_array(grad)}}, timeout=600)
        out["forward"] = (fwd_hidden, deserialize_array(fwd["tensors"]["hidden"]))
        out["backward"] = (hidden, grad, deserialize_array(bwd["tensors"]["grad_hidden"]))
    finally:
        await client.close()
    return out


def _distinct_bytes(x) -> int:
    """The bytes of the distinct tensors under ``x`` (a backend's block
    parameters, a ShardedCache pool or a tensor): what the device holds,
    each storage counted once however many shards or ranks share it."""
    from petals_tpu_torch.ops.quant import QuantizedLinear
    from petals_tpu_torch.parallel.sp import GridParams
    from petals_tpu_torch.parallel.tp import ShardedCache

    seen = {}

    def walk(v):
        if isinstance(v, torch.Tensor):
            seen[(v.device, v.data_ptr())] = v.numel() * v.element_size()
        elif isinstance(v, QuantizedLinear):
            walk(v.data)
            walk(v.scales)
        elif isinstance(v, ShardedCache):
            for t in v.distinct():
                walk(t)
        elif isinstance(v, GridParams):
            walk(v.distinct())
        elif isinstance(v, dict):
            for leaf in v.values():
                walk(leaf)
        elif isinstance(v, (list, tuple)):
            for item in v:
                walk(item)

    walk(x)
    return sum(seen.values())


def _check_mesh_runs(label, runs, servers, mesh_key, kind, failed):
    """Phase 27's rule for one pair of servers (the unsharded one under key
    1, the mesh one under ``mesh_key``): every reply of the private session
    and its K/V rows, every pooled session's, the forward and the
    backward's gradient, within REPLY_NOISE_FACTOR times the unsharded
    server's distance from the float32 reference over the served weights
    (dequantized; an adapter's deltas merged)."""
    one, two = runs[1], runs[mesh_key]
    backend = servers[1].backend
    adapter = next(iter(backend.adapters.values()), None)
    params = (dense_reference_params(backend.block_params, torch.float32) if adapter is None
              else merged_reference_params(backend.block_params, adapter, torch.float32))
    family, cfg = servers[1].family, servers[1].cfg
    base = "unsharded"
    inputs = one["private"][0]
    ref_out, ref_kv = reference_session(params, family, cfg, inputs[0], inputs[1:], servers[1].device, torch.float32)
    failed += _tp_within(f"{label}: private session ({kind})", two["private"][1], one["private"][1], ref_out, base)
    for name, got_two, got_one, want in zip("KV", two["private"][3], one["private"][3], ref_kv):
        err_two, err_one = _row_rel_error(got_two, want), _row_rel_error(got_one, want)
        log(f"{label}: private session's written {name} rows ({kind}), worst row max-rel vs float32 "
            f"{err_two:.3e}; {base} {err_one:.3e}")
        if err_two > REPLY_NOISE_FACTOR * err_one:
            failed.append(f"{label}: written {name} rows ({kind}) further from float32 than 2x {base}'s")
    del ref_out, ref_kv
    if "lanes" in two:
        variants = sorted({m["variant"] for metas in two["lanes"][2] for m in metas})
        if variants != ["decode", "dense_prefill"]:
            raise AssertionError(f"{label}: pooled sessions took {variants}, not the dense lane pool's steps")
        for i, (prompt, steps) in enumerate(one["lanes"][0]):
            want, _ = reference_session(params, family, cfg, prompt, steps, servers[1].device, torch.float32)
            failed += _tp_within(f"{label}: pooled session {i} ({kind})", two["lanes"][1][i], one["lanes"][1][i],
                                 want, base)
    hidden = one["forward"][0]
    failed += _tp_within(f"{label}: stateless forward of {hidden.shape[1]} tokens ({kind})", [two["forward"][1]],
                         [one["forward"][1]], [reference_forward(params, family, cfg, hidden, None, servers[1].device,
                                                                 torch.float32)], base)
    hidden, grad, _ = one["backward"]
    (want,) = reference_backward(params, family, cfg, hidden, None, grad, servers[1].device, torch.float32)
    failed += _tp_within(f"{label}: ptu.backward's grad_hidden of {hidden.shape[1]} tokens ({kind})",
                         [two["backward"][2]], [one["backward"][2]], [want], base)
    del params


def _serve_mesh_pair(label, root, device, quant_type, grid, plan, calls, result, adapters=(), on_pair=None):
    """Phase 27's two servers of ``root`` (unsharded, then over ``grid`` =
    (tp, sp) on ``device``), each started, driven by ``_drive_mesh`` with
    ``plan`` and shut down; on the mesh server the launches, the ring's
    folds and its block calls are counted from after its start. Returns
    (runs, servers, the mesh server's counts)."""
    from petals_tpu_torch.models.llama import block as llama_block
    from petals_tpu_torch.ops import ring_attention

    runs, servers, counts, pool_bytes = {}, {}, {}, {}
    block_grid = llama_block.block_grid

    def counting(params, kv):
        calls["ring" if kv is None else "cached"] += 1
        return block_grid(params, kv)

    for key, (tp, sp) in ((1, (1, 1)), (grid, grid)):
        server = _sp_server(root, device, quant_type, tp, sp, adapters)

        async def serve():
            await server.start()
            _reset_launch_counts()
            ring_attention.reset_fold_count()
            t_start, before = time.perf_counter(), _quant_counts()
            calls.update(ring=0, cached=0)
            llama_block.block_grid = counting
            try:
                out = await _drive_mesh(server, server.num_blocks, SEED + 41, **plan)
                if plan["lanes"]:  # the lane pool opened
                    pool_bytes[key] = _distinct_bytes(server.batcher._buffers())
            finally:
                llama_block.block_grid = block_grid
                await server.shutdown()
            return out, time.perf_counter() - t_start, _delta(_quant_counts(), before)

        t0 = time.perf_counter()
        runs[key], wall, quant = asyncio.run(serve())
        servers[key] = server
        launches = _launch_counts()
        name = "unsharded" if key == 1 else _grid_name(server.backend)
        log(f"{label}: {name} (--quant_type {quant_type}, {server.num_blocks} blocks): started and served in "
            f"{time.perf_counter() - t0:.1f} s (traffic {wall:.1f} s); launches K4 {launches['K4']}, K5/K6 "
            f"{quant or 'none'}; pool {'paged' if server.batcher.page_size else 'dense'}, {server.batcher.n_lanes} "
            f"lanes of {server.batcher.max_length}")
        if key == 1:
            continue
        backend = server.backend
        folds = ring_attention.fold_count()
        counts = {"K4": launches["K4"], "quant": quant, "folds": folds, "ring_calls": calls["ring"],
                  "cached_calls": calls["cached"]}
        want_folds = backend.tp_size * backend.sp_size * backend.sp_size
        log(f"{label}: {name}: {calls['ring']} ring block calls, {folds} folds ({folds / max(calls['ring'], 1):g} a "
            f"call, {want_folds} wanted), {calls['cached']} cached block calls; step programs "
            f"{backend.step_program_stats()}")
        for params in backend.block_params:
            for shard in params.distinct() if hasattr(params, "distinct") else params:
                for leaf in shard.values():
                    where = getattr(leaf, "data", leaf).device
                    if where != device:
                        raise AssertionError(f"{label}: a shard's weight lies on {where}")
        if server.batcher.page_size is not None or (backend.tp_size, backend.sp_size) != grid:
            raise AssertionError(f"{label}: the mesh server pages ({server.batcher.page_size}) or is not {grid}")
        if backend.step_program_stats()["graph_captures"]:
            raise AssertionError(f"{label}: the mesh server captured step programs")
        if not calls["ring"] or folds != want_folds * calls["ring"]:
            raise AssertionError(f"{label}: {folds} folds over {calls['ring']} ring block calls, not {want_folds} each")
        if not launches["K4"] or (quant_type != "none" and not (
                quant.get(f"decode {quant_type}") and quant.get(f"prefill {quant_type}"))):
            raise AssertionError(f"{label}: {name} ({quant_type}): a kernel never ran (K4 {launches['K4']}, {quant})")
        result["K4"] += launches["K4"]
        for k, n in quant.items():
            result["quant"][k] = result["quant"].get(k, 0) + n
    if on_pair is not None:
        on_pair(servers, pool_bytes)
    return runs, servers, counts


def serve_sequence_parallel_and_check(ckpt, device, smi, timer=None) -> dict:
    """Phase 27: sequence parallelism on the one card (alone:
    scripts/smoke_sequence_parallel.py). With a ``timer`` (the card), K4 at
    the query shards' shapes (SP_FLASH_CASES: a query block past row 0 of
    its cache, at 32 / 8 and 16 / 4 heads) and K5 nf4a / K6 prefill at
    SP_QUANT_ROWS rows of a tp=2 shard's projections, against their plain
    versions. Then phase 26's Llama-3-8B checkpoint served by an unsharded
    port server and a mesh server whose every shard and rank lies on
    ``device``, the same seeded traffic for both (``_drive_mesh``): (a) sp=2
    at SP_SPAN blocks, bf16; (b) tp=2 x sp=2 at SP_GRID_SPAN blocks in
    bf16, nf4a and int8; (c) a tp=2 span with a LoRA adapter (A14d), held
    to an unsharded server with the same adapter. Every reply, private K/V
    row, forward and gradient within REPLY_NOISE_FACTOR times the unsharded
    server's distance from the float32 reference (``_check_mesh_runs``).
    On each mesh server: the dense lane pool, no step program, every
    weight on the card, the ring's folds tp x sp x sp a ring block call,
    and K4 (and K5 / K6 on quantized weights) launched. Prints (a)'s
    distinct weight and KV pool bytes beside sp=1's (one card: equal) and
    its eager steps' host wall and busy beside sp=1's
    (``profile_tp_steps``). Gemma-2 and an sp-only nf4a span are refused.
    Returns the mesh servers' launches (K4; K5 / K6 by arm, on (a) and
    (b)), the kernel cases and the profile."""
    label = f"sequence parallel (Llama-3-8B, sp={SP} on one card)"
    t_phase = time.perf_counter()
    result = {"K4": 0, "quant": {}}
    if timer is not None:
        result["flash_sp"] = {}
        for (rows, offset), (hq, hkv) in itertools.product(SP_FLASH_CASES, SP_FLASH_HEADS):
            case = f"{rows} rows at {offset} of {rows + offset}, {hq} / {hkv} heads of {LLAMA3_8B['head_dim']}"
            result["flash_sp"][case] = check_flash_case(device, timer, hq, hkv, LLAMA3_8B["head_dim"], q_len=rows,
                                                        q_offset=offset)
        result["quant_sp"] = check_quant_kernels(device, timer, TP_QUANT_SHAPES, SP_QUANT_ROWS, ("nf4a", "int8"),
                                                 ("wg", SP_QUANT_ROWS), time_all=False,
                                                 model=f"Llama-3-8B shard (tp={TP}), a rank's rows (sp={SP})")
    t0 = time.perf_counter()
    root = llama3_checkpoint(ckpt, os.path.join(ckpt, "llama3-8b"), device)
    log(f"{label}: checkpoint in {time.perf_counter() - t0:.1f} s")
    calls = {"ring": 0, "cached": 0}
    failed = []

    # (a) sp=2, bf16, the whole cut
    private = (SP_MAX_LENGTH, (SP_PRIVATE,) + (1,) * SP_PRIVATE_STEPS)
    plan = dict(private=private, lanes=(SP_LANE_PROMPT,) * SP_LANES, n_forward=SP_FORWARD, n_backward=SP_BACKWARD)

    def bytes_and_profile(servers, pool_bytes):
        one, two = servers[1].backend, servers[(1, SP)].backend
        weights = (_distinct_bytes(one.block_params), _distinct_bytes(two.block_params))
        pools = (pool_bytes[1], pool_bytes[(1, SP)])
        log(f"{label}: bytes on {device} (the one distinct device): weights sp=1 {weights[0]} / sp={SP} "
            f"{weights[1]}; KV lane pool sp=1 {pools[0]} / sp={SP} {pools[1]}")
        if weights[1] > weights[0] or pools[1] > pools[0]:
            raise AssertionError(f"{label}: sp={SP} holds more bytes on the card than sp=1 ({weights}, {pools})")
        result["bytes"] = {"weights": weights, "kv_pool": pools}
        if timer is not None:
            result["profile"] = profile_tp_steps(one, two, device, smi, lanes=SP_LANES, max_length=SP_MAX_LENGTH,
                                                 rows=SP_PRIVATE, what="sequence-parallel")

    span_root = root if SP_SPAN == TP_SPAN else cut_checkpoint(root, f"{root}-{SP_SPAN}", SP_SPAN)
    runs, servers, counts = _serve_mesh_pair(label, span_root, device, "none", (1, SP), plan, calls, result,
                                             on_pair=bytes_and_profile)
    result["sp"] = counts
    _check_mesh_runs(label, runs, servers, (1, SP), f"--quant_type none, {SP_SPAN} blocks", failed)
    del runs, servers
    free_card()

    # (b) tp=2 x sp=2 at 2 blocks: bf16, nf4a, int8
    cut = cut_checkpoint(root, f"{root}-{SP_GRID_SPAN}", SP_GRID_SPAN)
    grid_plan = dict(private=(SP_MAX_LENGTH, (SP_GRID_PROMPT,) + (1,) * SP_GRID_STEPS), lanes=(),
                     n_forward=SP_GRID_PROMPT, n_backward=SP_GRID_PROMPT)
    grid_label = f"sequence parallel (Llama-3-8B, tp={TP} x sp={SP} on one card)"
    for quant_type in SP_GRID_KINDS:
        runs, servers, _ = _serve_mesh_pair(grid_label, cut, device, quant_type, (TP, SP), grid_plan, calls, result)
        _check_mesh_runs(grid_label, runs, servers, (TP, SP), f"--quant_type {quant_type}, {SP_GRID_SPAN} blocks",
                         failed)
        del runs, servers
        free_card()

    # (c) A14d: a LoRA adapter on a tp=2 span
    lora_root = os.path.join(ckpt, "sp-adapters")
    adapter = write_adapter(lora_root, "lora-tp", SEED + 33, device, n_blocks=SP_LORA_SPAN)
    lora_label = f"LoRA on a tensor-parallel span (Llama-3-8B, tp={TP})"
    lora_plan = dict(grid_plan, adapter="lora-tp")
    runs, servers = {}, {}
    for key, tp in ((1, 1), ((TP, 1), TP)):
        server = _sp_server(cut, device, "none", tp, 1, adapters=(adapter,))

        async def serve():
            await server.start()
            try:
                return await _drive_mesh(server, server.num_blocks, SEED + 42, **lora_plan)
            finally:
                await server.shutdown()

        runs[key] = asyncio.run(serve())
        servers[key] = server
    if servers[(TP, 1)].backend.tp_size != TP or sorted(servers[(TP, 1)].backend.adapters) != ["lora-tp"]:
        raise AssertionError(f"{lora_label}: the tp server is not split in {TP} or lacks the adapter")
    _check_mesh_runs(lora_label, runs, servers, (TP, 1), f"adapter lora-tp, {SP_LORA_SPAN} blocks", failed)
    del runs, servers
    free_card()

    # the refusals
    from petals_tpu_torch.server.server import Server

    gemma2 = os.path.join(ckpt, "gemma-2-9b-config")
    os.makedirs(gemma2, exist_ok=True)
    with open(os.path.join(gemma2, "config.json"), "w") as f:
        json.dump(dict(GEMMA2_9B, num_hidden_layers=2), f)
    try:
        Server(gemma2, first_block=0, num_blocks=2, device=device, num_sp_devices=SP, tp_devices=[device] * SP)
    except ValueError as e:
        log(f"{label}: Gemma-2 at sp={SP} refused: {e}")
    else:
        raise AssertionError(f"{label}: a Gemma-2 server at sp={SP} was not refused")
    refused = Server(cut, first_block=0, num_blocks=SP_GRID_SPAN, device=device, num_sp_devices=SP,
                     tp_devices=[device] * SP, quant_type="nf4a", quant_weight_cache=False)
    try:
        refused._load_span_params(0, 1)
    except KeyError as e:
        log(f"{label}: an nf4a span at sp={SP} alone (fused) refused at load: KeyError {e}")
    else:
        raise AssertionError(f"{label}: an nf4a span at sp={SP} alone loaded")
    del refused
    free_card()
    if failed:
        raise AssertionError("; ".join(failed))
    log(f"{label}: launches on the mesh servers K4 {result['K4']}, K5/K6 {result['quant']}; phase 27 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return result


def _mh_leader(root, device, quant_type, tp, sp, coord):
    """Phase 28's leader: a port server of the whole of ``root`` over a tp x
    sp grid of two processes (this one and one run_worker), each holding
    its entries on ``device``; the pool and budgets of ``_sp_server``."""
    from petals_tpu_torch.server.server import Server

    return Server(
        root, first_block=0, num_blocks=MH_SPAN, host="127.0.0.1", device=device, tp_devices=[device],
        num_tp_devices=tp if tp > 1 else None, num_sp_devices=sp if sp > 1 else None, num_hosts=2,
        coordinator_address=coord, quant_type=quant_type, page_size=PAGE, batch_lanes=SP_LANES,
        batch_max_length=SP_LANE_LENGTH, inference_max_length=SP_MAX_LENGTH, attn_cache_bytes=2 << 30,
        prefix_cache_bytes=0, update_period=600.0, throughput=1.0, quant_weight_cache=False,
        server_side_generation=False,
    )


# the worker's command before its flags (scripts/smoke_multihost.py's CPU
# rehearsal puts its own wrapper here)
MH_WORKER_CMD = [sys.executable, "-m", "petals_tpu_torch.cli.run_worker"]


def _mh_worker(root, device, quant_type, tp, sp, coord, counts_path, log_path):
    """``python -m petals_tpu_torch.cli.run_worker`` as process 1 of the
    group on ``device``, writing its kernel launch counts to
    ``counts_path`` after every op."""
    env = dict(os.environ, PYTHONPATH=REPO, PETALS_TPU_WORKER_COUNTS=counts_path)
    cmd = [*MH_WORKER_CMD, root, "--coordinator_address", coord,
           "--num_hosts", "2", "--host_index", "1", "--first_block", "0", "--num_blocks", str(MH_SPAN),
           "--num_tp_devices", str(tp), "--num_sp_devices", str(sp), "--quant_type", quant_type,
           "--torch_dtype", "bfloat16", "--device", str(device), "--no_quant_weight_cache"]
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=open(log_path, "w"), stderr=subprocess.STDOUT)


def _worker_counts(path, timeout: float = 60.0) -> dict:
    """The worker's launch counts once it has finished every op this
    process (its leader) has sent: it writes them after each op with the
    number of op headers it has received (cli/run_worker.py)."""
    from petals_tpu_torch.parallel.multihost import ops_broadcast

    sent, deadline = ops_broadcast(), time.monotonic() + timeout
    while True:
        try:
            with open(path) as f:
                got = json.load(f)
            if got["ops"] >= sent:
                return got["launches"]
        except (OSError, ValueError):
            pass  # not written yet
        if time.monotonic() > deadline:
            raise AssertionError(f"phase 28: the worker's counts did not reach op {sent} in {timeout} s")
        time.sleep(0.01)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _time_ops(backend, kv, hsz) -> dict:
    """The host wall (median of ``reps``, launch to synchronize) of a
    MH_PROMPT-row chunk at position 0 and of one decode step after it on
    the private cache ``kv``, through ``backend`` (a lockstep one broadcasts
    and its worker mirrors every call), MH_TIMING_REPS calls each."""
    gen = torch.Generator().manual_seed(SEED + 28)
    chunk = torch.randn(1, MH_PROMPT, hsz, generator=gen).to(torch.bfloat16)
    token = torch.randn(1, 1, hsz, generator=gen).to(torch.bfloat16)
    out = {}
    for name, fn in ((f"{MH_PROMPT}-row chunk", lambda: backend.inference_step(chunk, kv, 0)),
                     ("decode step", lambda: backend.inference_step(token, kv, MH_PROMPT))):
        fn()
        walls = []
        for _ in range(MH_TIMING_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(walls)
    return out


def serve_multihost_and_check(ckpt, device, smi) -> dict:
    """Phase 28: multi-host lockstep serving on the one card (alone:
    scripts/smoke_multihost.py). Phase 26's Llama-3-8B checkpoint cut to
    MH_SPAN blocks, served for each of MH_RUNS by an unsharded port server
    and by a two-process group: this process's ``Server(num_hosts=2)``
    (the leader) and a ``cli/run_worker`` process, both on ``device``, the
    data group on gloo, the same seeded traffic for both (``_drive_mesh``):
    a private MH_PROMPT-token session with MH_STEPS decode steps (its K/V
    rows gathered from both processes), MH_LANES pooled sessions on the
    tp=2 bf16 run, a MH_PROMPT-token forward (MH_SP_FORWARD through the
    ring at sp=2) and a backward. Every reply, K/V row and gradient within
    REPLY_NOISE_FACTOR times the unsharded server's distance from the
    float32 reference (``_check_mesh_runs``). K4, K5 and K6 launches are
    counted on both processes (the worker's from its counts file), and a
    kernel that never launched on either fails the phase. On the bf16 tp=2
    run the host wall of a MH_PROMPT-row chunk and of a decode step on the
    group is timed beside an unsharded and a one-process tp=2 backend's;
    then the worker is killed, the leader's next op must raise
    MultihostDegraded, its health check re-forms it single-host, and the
    re-formed server's private session is held to the unsharded server's.
    Returns the launches on both processes, the timings and the
    degradation's seconds."""
    from petals_tpu_torch.ops import ring_attention
    from petals_tpu_torch.parallel import collectives, multihost
    from petals_tpu_torch.server.backend import TransformerBackend

    label = "multi-host lockstep (Llama-3-8B, 2 processes on one card, gloo)"
    t_phase = time.perf_counter()
    result = {"leader": {"K4": 0, "quant": {}}, "worker": {"K4": 0, "quant": {}}, "timing": {}}
    root = llama3_checkpoint(ckpt, os.path.join(ckpt, "llama3-8b"), device)
    cut = cut_checkpoint(root, f"{root}-{MH_SPAN}", MH_SPAN)
    logs = os.path.join(REPO, "build", "multihost")
    os.makedirs(logs, exist_ok=True)
    failed = []
    private = (SP_MAX_LENGTH, (MH_PROMPT,) + (1,) * MH_STEPS)
    for quant_type, tp, sp in MH_RUNS:
        grid = f"tp={tp}" if sp == 1 else f"sp={sp}"
        kind = f"--quant_type {quant_type}, {grid}, {MH_SPAN} blocks"
        main_run = (quant_type, tp, sp) == MH_RUNS[0]
        plan = dict(private=private, lanes=(MH_PROMPT,) * MH_LANES if main_run else (),
                    n_forward=MH_SP_FORWARD if sp > 1 else MH_PROMPT, n_backward=MH_PROMPT)
        runs, servers = {}, {}
        coord = f"127.0.0.1:{_free_port()}"
        counts_path = os.path.join(logs, f"worker-counts-{quant_type}-{grid}.json")
        log_path = os.path.join(logs, f"worker-{quant_type}-{grid}.log")
        # the worker starts first: it imports, reaches the card and waits to
        # join while the unsharded server runs
        worker = _mh_worker(cut, device, quant_type, tp, sp, coord, counts_path, log_path)
        try:
            one = _sp_server(cut, device, quant_type, 1, 1)

            async def serve_one():
                await one.start()
                try:
                    out = await _drive_mesh(one, MH_SPAN, SEED + 43, **plan)
                    if main_run:
                        async with one.memory_cache.allocate_cache(*one.backend.cache_descriptors(
                                1, SP_MAX_LENGTH, 0, MH_SPAN)) as handles:
                            kv = tuple(one.memory_cache.get_buffers(*handles))
                            result["timing"]["unsharded (one process, step programs)"] = _time_ops(
                                one.backend, kv, one.cfg.hidden_size)
                            tp2 = TransformerBackend(one.family, one.cfg, one.backend.block_params, first_block=0,
                                                     n_blocks=MH_SPAN, device=device, tp_devices=[device] * 2)
                            kv2 = tuple(d.make_zeros() for d in tp2.cache_descriptors(1, SP_MAX_LENGTH, 0, MH_SPAN))
                            result["timing"]["tp=2 one process (phase 26's arm, eager)"] = _time_ops(
                                tp2, kv2, one.cfg.hidden_size)
                            del tp2, kv2
                    return out
                finally:
                    await one.shutdown()

            runs[1] = asyncio.run(serve_one())
            servers[1] = one
            free_card()
            if worker.poll() is not None:
                raise AssertionError(f"{label}: the worker exited ({worker.returncode}) before the group formed: "
                                     + open(log_path).read()[-2000:])
            t0 = time.perf_counter()
            leader = _mh_leader(cut, device, quant_type, tp, sp, coord)
            stamps = {"built": time.perf_counter() - t0}
            started = {}

            async def serve_group():
                await leader.start()
                stamps["started"] = time.perf_counter() - t0
                started["backend"] = leader.backend
                _reset_launch_counts()
                ring_attention.reset_fold_count()
                collectives.reset_reduction_count()
                before, w_before = _quant_counts(), _worker_counts(counts_path)
                t_start = time.perf_counter()
                out = await _drive_mesh(leader, MH_SPAN, SEED + 43, **plan)
                wall = time.perf_counter() - t_start
                counts = {"K4": _launch_counts()["K4"], "quant": _delta(_quant_counts(), before),
                          "folds": ring_attention.fold_count(), "crossings": dict(collectives.CROSSINGS),
                          "backend": multihost.data_backend()}
                w_after = _worker_counts(counts_path)
                w_counts = {"K4": w_after["K4"] - w_before["K4"],
                            "quant": _delta({k: v for k, v in w_after.items() if k != "K4"}, w_before)}
                extra = {}
                if main_run:
                    async with leader.memory_cache.allocate_cache(*leader.backend.cache_descriptors(
                            1, SP_MAX_LENGTH, 0, MH_SPAN)) as handles:
                        kv = tuple(leader.memory_cache.get_buffers(*handles))
                        result["timing"]["tp=2 two processes (gloo)"] = \
                            _time_ops(leader.backend, kv, leader.cfg.hidden_size)
                    extra = await _degrade_and_reform(leader, worker, plan)
                stamps["served"] = time.perf_counter() - t0
                await leader.shutdown()
                stamps["shut down"] = time.perf_counter() - t0
                return out, wall, counts, w_counts, extra

            runs[(tp, sp)], wall, counts, w_counts, extra = asyncio.run(serve_group())
        finally:
            if worker.poll() is None:
                worker.kill()
            worker.wait(timeout=60)
            multihost.shutdown_multihost()
        stamps["worker gone"] = time.perf_counter() - t0
        servers[(tp, sp)] = leader
        backend = started["backend"]
        log(f"{label}: {kind}: group started and served in {time.perf_counter() - t0:.1f} s (traffic {wall:.1f} s; "
            + ", ".join(f"{k} at {v:.1f} s" for k, v in stamps.items()) + "); "
            f"leader launches K4 {counts['K4']}, K5/K6 {counts['quant'] or 'none'}; worker K4 {w_counts['K4']}, "
            f"K5/K6 {w_counts['quant'] or 'none'}; ring folds on the leader {counts['folds']}; data-group "
            f"collectives on the leader {counts['crossings']} (data group on {counts['backend']})")
        if (backend.tp_size, backend.sp_size) != (tp, sp) or leader.batcher is None:
            raise AssertionError(f"{label}: the leader's backend is not tp={tp} x sp={sp}")
        for side, c in (("leader", counts), ("worker", w_counts)):
            if not c["K4"] or (quant_type != "none" and not (
                    c["quant"].get(f"decode {quant_type}") and c["quant"].get(f"prefill {quant_type}"))):
                raise AssertionError(f"{label}: {kind}: a kernel never ran on the {side} (K4 {c['K4']}, "
                                     f"{c['quant']})")
            result[side]["K4"] += c["K4"]
            for k, n in c["quant"].items():
                result[side]["quant"][k] = result[side]["quant"].get(k, 0) + n
        if sp > 1 and not counts["crossings"]["ring"]:
            raise AssertionError(f"{label}: {kind}: no K/V block crossed the processes on the ring")
        _check_mesh_runs(label, runs, servers, (tp, sp), kind, failed)
        if extra:
            result["degraded_s"], result["reform_s"] = extra["degraded_s"], extra["reform_s"]
            ref_private = runs[1]["private"]
            inputs = ref_private[0]
            params = dense_reference_params(one.backend.block_params, torch.float32)
            ref_out, _ = reference_session(params, one.family, one.cfg, inputs[0], inputs[1:], device, torch.float32)
            del params
            failed += _tp_within(f"{label}: the re-formed single-host server's private session", extra["private"][1],
                                 ref_private[1], ref_out, "unsharded")
            same = all(torch.equal(a, b) for a, b in zip(extra["private"][1], ref_private[1]))
            log(f"{label}: re-formed single-host replies {'bit-equal to' if same else 'differ from'} the unsharded "
                f"server's")
        del runs, servers
        free_card()
    for name, t in result["timing"].items():
        log(f"{label}: host wall, {name}: " + "; ".join(f"{k} {v:.3f} ms" for k, v in t.items()) + f" ({smi})")
    if failed:
        raise AssertionError("; ".join(failed))
    log(f"{label}: launches on the leader K4 {result['leader']['K4']}, K5/K6 {result['leader']['quant']}; on the "
        f"worker K4 {result['worker']['K4']}, K5/K6 {result['worker']['quant']}; phase 28 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return result


async def _degrade_and_reform(leader, worker, plan) -> dict:
    """Phase 28 (d): the worker killed, the leader's next op raising
    MultihostDegraded (its seconds), the health check's single-host
    re-formation (its seconds), then a private session on the re-formed
    server (``plan``'s, the same seed as the unsharded server's)."""
    from petals_tpu_torch.parallel.multihost import MultihostDegraded

    worker.kill()
    worker.wait(timeout=60)
    hidden = torch.zeros(1, 8, leader.cfg.hidden_size, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    try:
        leader.backend.forward(hidden)
    except MultihostDegraded as e:
        degraded_s = time.perf_counter() - t0
        log(f"phase 28: the leader's op after the worker died raised MultihostDegraded in {degraded_s:.3f} s: "
            f"{str(e)[:200]}")
    else:
        raise AssertionError("phase 28: the leader's op after the worker died did not raise MultihostDegraded")
    t0 = time.perf_counter()
    if await leader._check_group_health() or leader.num_hosts != 1 or leader.backend.mesh_size != 1:
        raise AssertionError("phase 28: the leader did not re-form single-host")
    reform_s = time.perf_counter() - t0
    log(f"phase 28: re-formed single-host in {reform_s:.1f} s: blocks [{leader.first_block}, "
        f"{leader.first_block + leader.num_blocks}) on {leader.device}, throughput {leader.throughput}")
    private = await _drive_private(leader, (0, MH_SPAN), 1, *plan["private"], SEED + 43)
    return {"degraded_s": degraded_s, "reform_s": reform_s, "private": private}


class PhaseClock:
    """Each phase's seconds since the one before, printed on a line of its
    own as the phase ends (``lap``), and all of them at the end."""

    def __init__(self):
        self.seconds = {}
        self._t = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now
        log(f"phase seconds: {name}: {self.seconds[name]:.1f} s")


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
    clock = PhaseClock()
    build()
    clock.lap("1 build")
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
    # phase 22 (a): the wide-group and ALiBi arms of K1-K4 at the families'
    # shapes, and K7
    family_kernels, grouped_kernel = check_family_kernels(device, timer)
    # phase 23 (a): K1-K4 at head_dim 256 and 96 and with Gemma-2's softcap
    gemma_phi3_kernels = check_gemma_phi3_kernels(device, timer)
    log(f"kernel phases done at {time.perf_counter() - t_start:.1f} s")
    clock.lap("2, 9, 22a, 23a kernels")

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke-ckpt-", dir=os.path.join(REPO, "build")) as ckpt:
        t0 = time.perf_counter()
        write_checkpoint(ckpt, device)
        log(f"checkpoint: {SPAN} Mistral-7B-shaped blocks written in {time.perf_counter() - t0:.1f} s")

        # the bf16 span, then the same span quantized to nf4a
        server, bf16_launches = serve_and_check(ckpt, device, "none", SPAN, PROMPTS, DECODE_STEPS, SEED + 4, WARMUP_PROMPTS)
        # phase 15: the step programs against the eager loop, a bf16 pool
        # and both quantized pools over the served bf16 weights
        # (the quantized pools on SHORT_SPAN of the blocks: a depth cut that
        # keeps the smoke inside its limit)
        check_step_programs(sibling_backend(server.backend), device,
                            f"step programs (--quant_type none --kv_quant_type none, {SPAN} blocks)")
        for kv in KV_QUANT_KINDS:
            check_step_programs(sibling_backend(sub_span_backend(server.backend, SHORT_SPAN), kv), device,
                                f"step programs (--quant_type none --kv_quant_type {kv}, {SHORT_SPAN} blocks)")
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
        clock.lap("3-8, 15 main paths (bf16, nf4a, nf4a pool)")

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
        clock.lap("3, 15 the other arms at 2 blocks")

        # dense caches: private sessions, then the dense lane pool
        private_launches = serve_private_and_check(ckpt, device, smi)
        free_card()
        clock.lap("10 private sessions")
        serve_dense_pool_and_check(ckpt, device)
        free_card()
        clock.lap("11 dense lane pool")
        # the swarm: two port servers, placed through the DHT, as one chain
        serve_swarm_and_check(ckpt, device, smi)
        free_card()
        clock.lap("12 swarm")
        # the port's client over a chain of two port servers
        serve_client_and_check(ckpt, device, smi)
        free_card()
        clock.lap("13 client")
        # Qwen2.5-7B's widths: served in bf16 and nf4a, then the client
        serve_qwen2_and_check(ckpt, device, smi)
        free_card()
        clock.lap("14 Qwen2.5-7B")
        # server-side generation: one port server of the GEN_SPAN-block cut, bf16 then nf4a
        for quant_type in ("none", "nf4a"):
            serve_gen_and_check(ckpt, device, smi, quant_type)
            free_card()
            clock.lap(f"16 server-side generation ({quant_type})")
        # the prefix cache at its defaults
        serve_prefix_runs(ckpt, device, smi)
        free_card()
        clock.lap("17 prefix cache")
        # preemption to host memory, qint8 replies and the relay
        serve_swap_runs(ckpt, device, smi)
        free_card()
        clock.lap("18 swap, qint8, relay")
        # KV migration: export/import, drain-to-migrate, the handoff, the push chain
        moved = serve_migration_and_check(ckpt, device, smi)
        free_card()
        clock.lap("19 migration")
        # speculative decoding: a cooperative draft, then an nf4a self-draft on an nf4a pool
        spec = serve_spec_and_check(ckpt, device, smi, timer)
        free_card()
        clock.lap("20 speculative decoding")
        # the stateless forward, the probe and the telemetry plane
        fwd = serve_forward_telemetry_and_check(ckpt, device, smi)
        free_card()
        clock.lap("21 forward and telemetry")
        # phase 22 (b): BLOOM, Falcon and Mixtral served at full width
        fam = serve_families_and_check(ckpt, device, smi)
        free_card()
        clock.lap("22b families")
        # phase 23 (b): Gemma-7B, Gemma-2-9B and Phi-3-mini served at full width
        gp = serve_gemma_phi3_and_check(ckpt, device, smi)
        free_card()
        clock.lap("23b Gemma, Gemma-2, Phi-3")
        # phase 24: training and adapters (the backward, the client's training, LoRA)
        train = serve_training_and_check(ckpt, device, smi)
        free_card()
        clock.lap("24 training and adapters")
        # phase 25: swarm operations (the quant cache, the span moves, chaos, traffic, the autoscaler)
        ops = serve_swarm_ops_and_check(ckpt, device, smi)
        free_card()
        clock.lap("25 swarm operations")
        # phase 26: tensor parallelism, two shards of the one card (Llama-3-8B widths)
        tp = serve_tensor_parallel_and_check(ckpt, device, smi, timer)
        free_card()
        clock.lap("26 tensor parallelism")
        # phase 27: sequence parallelism, two ranks of the one card (and tp=2 x sp=2, and A14d)
        sp = serve_sequence_parallel_and_check(ckpt, device, smi, timer)
        free_card()
        clock.lap("27 sequence parallelism")
        # phase 28: multi-host lockstep, a leader and a run_worker process sharing the card
        mh = serve_multihost_and_check(ckpt, device, smi)
        free_card()
        clock.lap("28 multi-host lockstep")
    flash_kernel["launches"] = private_launches["K4"]
    # the launches on moved (imported, adopted) caches, phase 19
    kernels[0]["migration_launches"], kernels[1]["migration_launches"] = moved["K1"], moved["K2"]
    flash_kernel["migration_launches"] = moved["K4"]
    flash_kernel["forward_launches"] = fwd["K4"]
    for entry in kv_kernels:
        if entry["name"].endswith("[kv_nf4a]"):
            entry["migration_launches"] = moved["K3 decode" if entry["name"].startswith("paged_decode") else "K3 prefill"]
    kernels[0]["launches"] = bf16_launches["K1"]
    # the speculative verify step's k+1-row arm (phase 20): its time at 4
    # lanes x SPEC_K + 1 rows, bound and launches on the phase's verify steps
    kernels[0]["verify_arm"] = spec["verify_arm"]["none"]
    next(e for e in kv_kernels if e["name"] == "paged_decode_attention[kv_nf4a]")["verify_arm"] = \
        spec["verify_arm"]["nf4a"]
    kernels[1]["launches"] = bf16_launches["K2"]
    for entry in kv_kernels:
        kind = entry["name"].split("[kv_")[1].rstrip("]")
        phase = "K3 decode" if entry["name"].startswith("paged_decode") else "K3 prefill"
        entry["launches"] = kv_arm_launches[kind][phase][kind]
    for entry in quant_kernels:
        phase = "decode" if entry["name"].startswith("quant_decode") else "prefill"
        arm = entry["name"].split("[")[1].rstrip("]")
        entry["launches"] = arm_launches[arm][phase][arm]
        if arm == "nf4a":  # the nf4a draft's launches (phase 20 run b)
            entry["draft_launches"] = spec["k5"][phase]
            if phase == "prefill":  # phase 21's nf4a forwards
                entry["forward_launches"] = fwd["K5 prefill"]
    # phase 22: each kernel's cases at the families' shapes, and its
    # launches on their served runs (K4 runs on none of them: the paged pool)
    for entry in kernels + kv_kernels + [flash_kernel]:
        entry["families"] = dict(family_kernels[entry["name"]])
    for entry, k in zip(kernels, ("K1", "K2")):
        entry["families"]["launches"] = {name: fam[name][k] for name in FAMILY_RUNS}
    grouped_kernel["launches"] = fam["mixtral"]["K7"]
    grouped_kernel["arm_launches"] = fam["mixtral"]["K7 arms"]
    grouped_kernel["client_launches"] = fam["mixtral_client"]["K7"]
    grouped_kernel["mixtral_mixed_step"] = fam["mixtral_profile"]
    for entry in quant_kernels:
        if entry["name"].endswith("[nf4a]"):
            phase = "decode" if entry["name"].startswith("quant_decode") else "prefill"
            entry["families"] = {"mixtral_launches": fam["mixtral_nf4a"][phase]["nf4a"]}
    # phase 23: each kernel's cases at Gemma's and Phi-3's heads, and its
    # launches on their served runs (K3's nf4a arms on Gemma-2's nf4a pool,
    # K4 on Gemma-2's and Phi-3's clients' forwards, K5 nf4a on its nf4a
    # weights)
    for entry in kernels + kv_kernels + [flash_kernel]:
        entry["gemma_phi3"] = dict(gemma_phi3_kernels[entry["name"]])
    for entry, k in zip(kernels, ("K1", "K2")):
        entry["gemma_phi3"]["launches"] = {name: gp[name][k] for name in GEMMA_PHI3_RUNS}
    for entry in kv_kernels:
        if entry["name"].endswith("[kv_nf4a]"):
            phase = "K3 decode" if entry["name"].startswith("paged_decode") else "K3 prefill"
            entry["gemma_phi3"]["launches"] = {"gemma2": gp["gemma2_none_nf4a"][phase]["nf4a"]}
    flash_kernel["gemma_phi3"]["launches"] = {name: gp[name]["K4"] for name in ("gemma2_client", "phi3_client")}
    for entry in quant_kernels:
        if entry["name"].endswith("[nf4a]"):
            phase = "decode" if entry["name"].startswith("quant_decode") else "prefill"
            entry["gemma_phi3"] = {"gemma2_launches": gp["gemma2_nf4a_none"][phase]["nf4a"]}
    log(f"phase 23 launches: K1 {kernels[0]['gemma_phi3']['launches']}, K2 {kernels[1]['gemma_phi3']['launches']}, "
        f"K3 nf4a decode / prefill {gp['gemma2_none_nf4a']['K3 decode']['nf4a']} / "
        f"{gp['gemma2_none_nf4a']['K3 prefill']['nf4a']}, K4 {flash_kernel['gemma_phi3']['launches']}, K5 nf4a decode / prefill "
        f"{gp['gemma2_nf4a_none']['decode']['nf4a']} / {gp['gemma2_nf4a_none']['prefill']['nf4a']}; C12 "
        f"{gp['forward_graphs']}")
    # phase 24: K4 / K5 / K6 launches on the training phase's forwards,
    # backwards and adapter sessions, and the backward's profile beside them
    flash_kernel["training"] = {"launches": train["K4"], "backward_bf16": train["backward_bf16"]}
    for entry in quant_kernels:
        phase = "decode" if entry["name"].startswith("quant_decode") else "prefill"
        arm = entry["name"].split("[")[1].rstrip("]")
        entry["training"] = {"launches": train["quant"].get(f"{phase} {arm}", 0)}
        if phase == "prefill" and f"backward_{arm}" in train:
            entry["training"]["backward"] = train[f"backward_{arm}"]
    # phase 25: the launches of the swarm operations' main path
    kernels[0]["swarm_ops_launches"], kernels[1]["swarm_ops_launches"] = ops["K1"], ops["K2"]
    flash_kernel["swarm_ops_launches"] = ops["K4"]
    for entry in quant_kernels:
        if entry["name"].endswith("[nf4a]"):
            phase = "decode" if entry["name"].startswith("quant_decode") else "prefill"
            entry["swarm_ops_launches"] = ops[f"{phase} nf4a"]
    # phase 26: the launches on the tensor-parallel servers' shards and
    # each kernel's case at a shard's shapes
    case_keys = ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")
    flash_kernel["tp_launches"] = tp["K4"]
    flash_kernel["tp"] = dict({k: tp["flash_tp"][k] for k in case_keys[1:]},
                              shape=f"{TP_PROMPT} rows, 16 / 4 heads of 128 (a shard at tp={TP})")
    for entry in quant_kernels:
        phase = "decode" if entry["name"].startswith("quant_decode") else "prefill"
        arm = entry["name"].split("[")[1].rstrip("]")
        shard_case = next((q for q in tp["quant_tp"] if q["name"] == entry["name"]), None)
        if shard_case is not None:
            entry["tp_launches"] = tp["quant"].get(f"{phase} {arm}", 0)
            entry["tp"] = {k: shard_case[k] for k in case_keys}
    # phase 27: the launches on the sequence-parallel servers' shards and
    # ranks, and each kernel's case at a query shard's shapes
    flash_kernel["sp_launches"] = sp["K4"]
    flash_kernel["sp"] = {name: {k: case[k] for k in case_keys[1:]} for name, case in sp["flash_sp"].items()}
    for entry in quant_kernels:
        phase = "decode" if entry["name"].startswith("quant_decode") else "prefill"
        arm = entry["name"].split("[")[1].rstrip("]")
        if arm in ("nf4a", "int8"):
            entry["sp_launches"] = sp["quant"].get(f"{phase} {arm}", 0)
        shard_case = next((q for q in sp["quant_sp"] if q["name"] == entry["name"]), None)
        if shard_case is not None:
            entry["sp"] = {k: shard_case[k] for k in case_keys}
    if not flash_kernel["sp_launches"] or not all(
            entry.get("sp_launches") for entry in quant_kernels if entry["name"].endswith(("[nf4a]", "[int8]"))):
        raise AssertionError("phase 27: K4, K5 nf4a or K6 never launched on the sequence-parallel shards")
    log(f"phase 27 launches on the sp shards: K4 {flash_kernel['sp_launches']}, K5/K6 {sp['quant']}")
    # phase 28: the launches on both processes of the multi-host groups
    flash_kernel["mh_launches"] = {side: mh[side]["K4"] for side in ("leader", "worker")}
    for entry in quant_kernels:
        phase = "decode" if entry["name"].startswith("quant_decode") else "prefill"
        arm = entry["name"].split("[")[1].rstrip("]")
        if arm in ("nf4a", "int8"):
            entry["mh_launches"] = {side: mh[side]["quant"].get(f"{phase} {arm}", 0) for side in ("leader", "worker")}
    if not all(flash_kernel["mh_launches"].values()) or not all(
            all(entry["mh_launches"].values()) for entry in quant_kernels if "mh_launches" in entry):
        raise AssertionError("phase 28: K4, K5 nf4a or K6 never launched on one of the multi-host processes")
    log(f"phase 28 launches: K4 {flash_kernel['mh_launches']}, K5/K6 leader {mh['leader']['quant']}, worker "
        f"{mh['worker']['quant']}; op host walls {mh['timing']}")
    from petals_tpu_torch.telemetry.observatory import get_observatory

    digest = get_observatory().compile_stats()
    log(f"step-program observatory: {digest}; by program {get_observatory().functions()}")
    if digest["anomalies"]:
        raise AssertionError(f"{digest['anomalies']} step-program captures after warm-up")
    log("phase seconds, all: " + json.dumps({name: round(t, 1) for name, t in clock.seconds.items()}))
    log(f"done at {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels + kv_kernels + [flash_kernel] + quant_kernels + [grouped_kernel]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
