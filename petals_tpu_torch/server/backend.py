"""TransformerBackend: the compute engine for a span of blocks: paged
decode and mixed prefill+decode steps, the dense-cache steps of private
sessions and the dense lane pool, server-side generation, and the
stateless forward the throughput probe times, the speculative-decoding
verify step, the training backward and per-request LoRA adapters
(petals_tpu/server/backend.py without the meshes).

Where the JAX backend runs the span as one jitted ``lax.scan`` over stacked
parameters and donated pools, this one is a Python loop over blocks that
mutates the page pools IN PLACE. The pool layout stays [n_blocks, n_pages,
page_size, hkv, d]; block i's page pool is ``pool_block(pool, i)``. With
``kv_quant_type`` int8 or nf4a each side of the pool is a ``PagedPool`` of
codes and float32 scales (ops/paged_attention.py): rows are encoded as they
are written and decoded as attention reads them. Attention on a ``PagedKV``
goes to the CUDA paged-attention kernels for tensors on the card and to
their plain versions for tensors on the CPU (ops/paged_flash_attention.py).

Dense caches are [n_blocks, batch, max_length, hkv, d] buffers, written IN
PLACE too; block i attends over the view ``k_stack[i]``. ``inference_step``
pads each chunk of more than one token to its bucket (``bucket_length``, as
the JAX package's ``_step_once`` does) and passes its position and real
length as device scalars; chunks of 8 rows and more go to the
flash-attention kernel when ``use_flash`` is set (ops/flash_attention.py;
the default on a CUDA device), which reads both scalars on the card; decode
tokens and the dense pool's batched step (per-lane positions) take plain
attention, as they take XLA's in the JAX package.

The step programs. Where the JAX package jits ``paged_decode_step`` and
``paged_mixed_step`` into one program per shape, on a CUDA device this
backend replays each as a CUDA graph (telemetry/observatory.py
``TrackedGraph``): one graph per ``step_program_key`` (the step kind, lanes,
table width, chunk bucket, weight and pool encodings and the pools'
addresses), captured on first use after a warm-up on the capture stream;
the inputs are copied into the graph's static buffers before each replay
and the outputs returned as clones. A mixed step pads its prefill chunk to
a power-of-two bucket (``PREFILL_BUCKETS``, the JAX package's) and passes
the chunk lane, its position and its real length as device scalars, so one
graph serves every chunk of a bucket. On the CPU the same methods run the
block loop eagerly (``_paged_decode_eager``, ``_paged_mixed_eager``) with the
plain kernels, padding alike. On the card nothing falls back to the eager
loop: a capture that fails raises.

The dense programs, each keyed by ``dense_program_key`` (the kind, the
cache's batch and length, the bucket, the weight encoding, the cache's
addresses; a private step adds whether it carries hypo_ids and its deep
prompts' pre_seq; ``forward`` is keyed by (batch, seq, pre_seq) alone):

- steady, captured when a dense lane pool opens (``warm_dense_programs``):
  ``batched_decode_step`` (the JAX package's ``batched_decode``), the
  generation step ``batched_gen_decode_step`` when the batcher generates,
  and on each lane's view of the pool (``dense_lane_view``, whose address
  never changes) the plain chunk at every bucket the batcher can hand it;
- not steady (``TrackedGraph(steady=False)``, as the JAX package's
  ``inference_step``, ``server_gen`` and ``forward`` are): a private
  session's step, its generation step (``generate_tokens``) and the
  stateless ``forward``. A key's first call runs the block loop eagerly
  on the capture stream, its second captures it, later calls replay, so a
  prefill chunk that runs once never pays a capture and a decode step
  replays from the session's second step on. hypo_ids reorder the cache
  inside the first chunk's graph; deep prompts take the JAX package's
  masked form, so no position reaches the host. A cache's programs are
  dropped when it is freed (``drop_cache_programs``: the handler at a
  private session's end, the batcher after a paged lane's check-in and at
  pool close).

The prefix cache writes pools and caches in place too, so every buffer
keeps the address its programs are keyed by: ``copy_page`` (a
copy-on-write fork of a page shared with the cache) and ``seed_cache`` (a
hit's prefix rows written into a dense cache or a lane's session-shaped
copy). So does preemption to host memory: ``swap_out_pages`` copies a list
of pages of every block to the host (pinned memory when the pool is on the
card), and ``swap_in_pages`` writes them back onto other page ids with
``index_copy_`` into the pool tensors the step programs address; a
quantized pool moves its codes and scales as they are stored.

Server-side generation (a whole-model span holding the client's float32
embeddings, norm and head, ``gen_params``): ``paged_gen_decode_step`` is a
third step program, the decode step with generating lanes embedding their
previous token on the card and every lane's next token sampled after the
head (ops/sampling.py); its sampling settings, seen-token masks and
uniforms (ops/threefry.py, computed on the host) are graph inputs.
``sample_from_hidden`` picks a stream's first token from the span output
before it; ``batched_gen_decode_step`` is the dense pool's step and
``generate_tokens`` a private session's loop of generation steps, each a
program too.

Speculative decoding (server/spec_decode.py): ``paged_spec_verify_step``
feeds each speculating lane's last committed token and its k drafts, S =
k + 1 rows at positions p..p+k, through the span in ONE step: the block
loop writes all S K/V rows a lane (``scatter_lane_chunk_rows``) and attends
S query rows a lane (the decode kernel over S virtual lanes a lane,
ops/paged_flash_attention.py); the float32 head then samples the target's
own token on every row with the lane's uniform for draw ``draw_idx + j``,
and the leading matches of drafts and sampled tokens decide how many
tokens a lane emits. A fourth paged program ("paged_spec_verify", keyed by
``step_program_key("spec_verify", ...)`` with S as its bucket), captured
when the pool opens on a batcher that holds a draft.

LoRA adapters (utils/peft.py): ``adapters`` maps a name to the span's
per-block (A, B) pairs and the scaling; ``params_for(name)`` is the span's
parameters with those leaves wrapped in ``LoraLinear``, which
``models.common.mm`` applies. ``forward``, ``backward``,
``inference_step`` and ``generate_tokens`` take ``active_adapter``; the
adapter's name is part of each program's key (the graph addresses the
adapter's tensors), so one adapter never replays another's graph, and an
adapter seen before replays its own. Adapter sessions never reach the
batched steps: the handler gives them private caches.

The backward (petals_tpu/server/backend.py:1725-1744): ``backward(hidden,
grad_out, prompts)`` returns the gradients at the span's input and at the
deep prompts. A no-grad pass keeps each block's input; then, block by
block in reverse, one block is recomputed from its input under
``enable_grad`` and ``torch.autograd.grad`` gives the gradient at that
input (after the deep prompt's add, which is the prompt's gradient over
its rows). The peak holds one block's graph; the products are those of
the JAX package's whole-span ``jax.vjp``. Attention in the recompute is
``attend(..., use_flash=False)`` on a fresh dense K/V buffer (plain
attention: the JAX training path never uses its flash kernel); quantized
products go through ``ops/quant.py QuantMatmulFn`` (K5/K6 forward on the
card, dequant-transpose backward). The backward runs eagerly, on the card
too.

Tensor parallelism (petals_tpu's backend under a ("tp",) mesh):
``tp_devices`` lists one device a shard (parallel/mesh.py). Each block's
parameters are split Megatron-style (parallel/tp.py shard_span_params) and
its block function runs the shards in turn and sums their partial outputs
(parallel/collectives.py); a dense cache is a ``ShardedCache`` a side, its
kv heads split over the shards, built from ``cache_descriptors`` and
joined along the head axis wherever it is read out, so its bytes are an
unsharded server's. Only the dense paths serve such a span, as in the JAX
package: the batcher keeps the dense lane pool (no paging, so no quantized
pool), and its steps run eagerly, block by block, with no step program
(``step_program_stats`` stays at zero). The flash-attention kernel runs on
each shard's heads, and quantized products on each shard's slice. A LoRA
adapter's pairs are split with the leaves they wrap (utils/peft.py
``shard_adapter``).

Sequence parallelism (petals_tpu's backend under a ("tp", "sp") mesh):
``num_sp_devices`` sp ranks over a tp x sp grid (``tp_devices`` lists the
grid, ``mesh_devices``); each block's shards are replicated over the
ranks (``GridParams``, one copy a distinct device) and so is the dense
cache (a ShardedCache with ranks). A stateless ``forward`` or
``backward`` whose rows divide over the ranks runs the ring (each block
with no cache, ops/ring_attention.py; eagerly, float32 attention, never
the flash kernel), other lengths the tp-only path; a cached chunk of more
than one row that divides (a padded bucket too) splits its queries over
the ranks, each attending through the flash kernel against its copy of
the cache with its own offset; decode steps and chunks that do not
divide run on rank 0 and write every copy. The steps run eagerly, as
under tensor parallelism.

Fused fingerprints (ops/fingerprint.py), built only when
``fingerprint.enabled()``: the batched steps (paged decode, mixed,
generation, verify, and the dense pool's decode and generation steps) then
also return the digest of each lane's last row, ``rows.float() @ proj`` on
a float32 projection held on the device, as one more output of the same
graph (a mixed step adds its chunk's last valid row; the verify step
digests each lane's last emitted row). ``with_fp`` is the last element of
every such step's program key, as it is a static jit argument in the JAX
package: flipping the switch after warm-up captures each program once
more, and a graph built without the digest never serves a step that wants
one. The step stashes the digests on the device; ``pop_step_fp`` hands
them to the batcher after the step.
"""

from __future__ import annotations

import inspect
import logging
import math
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from petals_tpu_torch.models.registry import ModelFamily, num_kv_heads
from petals_tpu_torch.ops import fingerprint as fp_ops
from petals_tpu_torch.ops.paged_attention import (
    KV_QUANT_KINDS,
    PagedKV,
    PagedPool,
    dequantize_kv,
    kv_wire_bytes_per_token,
    pool_block,
    scatter_lane_pages,
)
from petals_tpu_torch.ops.quant import OutlierQuantLinear, QuantizedLinear
from petals_tpu_torch.ops.sampling import sample_tokens, sampling_tensors, sampling_uniforms, sampling_vectors
from petals_tpu_torch.ops.threefry import uniform_for_draw
from petals_tpu_torch.parallel.sp import GridParams, replicate_over_sp
from petals_tpu_torch.parallel.tp import ShardedDescriptor, is_sharded, shard_span_params, span_param_specs
from petals_tpu_torch.server.memory_cache import TensorDescriptor
from petals_tpu_torch.telemetry.observatory import CudaGraphCapture, TrackedGraph

logger = logging.getLogger(__name__)

# a prefill chunk is padded to the smallest bucket that holds it, so a step
# program serves every chunk length of its bucket (petals_tpu's buckets)
PREFILL_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def bucket_length(n: int) -> int:
    """The padded length of an ``n``-token prefill chunk: the smallest
    bucket that holds it; past the last bucket, a multiple of it."""
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    return -(-n // PREFILL_BUCKETS[-1]) * PREFILL_BUCKETS[-1]


def chunk_buckets(max_chunk: int) -> List[int]:
    """Every bucket a chunk of 1..``max_chunk`` tokens pads to: the
    ``PREFILL_BUCKETS`` up to ``bucket_length(max_chunk)``, then the
    multiples of the last bucket up to it."""
    top = bucket_length(max(1, int(max_chunk)))
    last = PREFILL_BUCKETS[-1]
    return [b for b in PREFILL_BUCKETS if b <= top] + list(range(2 * last, top + 1, last))


def _pool_tensors(pool_kv):
    for pool in pool_kv:
        yield from (pool if isinstance(pool, PagedPool) else (pool,))


def step_program_key(kind: str, n_lanes: int, max_pages: int, bucket: int, quant_type: str,
                     kv_quant_type: str, pool_kv, extra: Sequence[torch.Tensor] = ()) -> tuple:
    """What a captured step bakes in, so that two calls share a graph only
    where all of it agrees: the step kind, its lanes and table width (its
    inputs' shapes), the prefill chunk's bucket (0 for a decode step), the
    weight and pool encodings, and each pool tensor's address, shape and
    dtype, and those of the ``extra`` tensors the step reads (a generation
    step's client parameters). A pool reset zeroes the pool in place and
    keeps its key; a fresh pool never replays a graph that addresses another
    pool's memory."""
    tensors = (*_pool_tensors(pool_kv), *extra)
    pools = tuple((t.data_ptr(), tuple(t.shape), str(t.dtype)) for t in tensors)
    return (kind, int(n_lanes), int(max_pages), int(bucket), quant_type, kv_quant_type, pools)


def dense_program_key(kind: str, bucket: int, quant_type: str, kv, *flags, extra: Sequence[torch.Tensor] = ()) -> tuple:
    """``step_program_key`` of a dense step: the step kind, the cache's
    batch (the pool's lanes) and length, the chunk's bucket (0: a decode
    token), the weight encoding, each cache tensor's address, shape and
    dtype and those of ``extra`` (a generation step's client parameters),
    then ``flags`` (a private step's: whether it carries hypo_ids, and its
    deep prompts' pre_seq, 0 without). A private cache is allocated per
    session, so its keys are dropped when it is freed
    (``TransformerBackend.drop_cache_programs``)."""
    k = kv[0]
    return step_program_key(kind, k.shape[-4], k.shape[-3], bucket, quant_type, "none", kv, extra) + tuple(flags)


def _replay(program: Optional[TrackedGraph], key, step, inputs) -> tuple:
    """``step(*inputs)``: a replay of ``program``'s graph for ``key`` on a
    card, the eager call on the CPU (no program)."""
    return step(*inputs) if program is None else program.run(key, step, inputs)


# sample_tokens' per-lane inputs, in the order a generation step takes them
SAMPLING_INPUTS = ("do_sample", "temperature", "top_k", "top_p", "repetition_penalty", "seen_mask", "u")


def _block_view(leaf, i: int):
    """Block ``i`` of a span-stacked leaf; a quantized leaf is indexed
    piece by piece."""
    if isinstance(leaf, OutlierQuantLinear):
        return OutlierQuantLinear(_block_view(leaf.inner, i), leaf.idx[i], leaf.w_out[i])
    if isinstance(leaf, QuantizedLinear):
        return QuantizedLinear(leaf.kind, leaf.data[i], leaf.scales[i], leaf.in_features, leaf.out_features)
    return leaf[i]


def _as_tensor(x, device: Optional[torch.device], dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` (a tensor or an array) as a tensor on ``device`` (None: where
    it lies) of ``dtype``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype if dtype is not None else x.dtype)


def _pool_device(pool) -> torch.device:
    """The device a pool (a tensor or a PagedPool) lies on."""
    return (pool.codes if isinstance(pool, PagedPool) else pool).device


class TransformerBackend:
    """Serves blocks [first_block, first_block + n_blocks) of one model."""

    def __init__(
        self,
        family: ModelFamily,
        cfg,
        params: Union[Dict[str, torch.Tensor], Sequence[Dict[str, torch.Tensor]]],
        *,
        first_block: int,
        n_blocks: int,
        device: torch.device,
        compute_dtype: torch.dtype = torch.bfloat16,
        max_chunk_size_bytes: int = 256 * 1024 * 1024,
        quant_type: str = "none",
        kv_quant_type: str = "none",
        use_flash: Optional[bool] = None,
        tp_devices: Optional[Sequence] = None,
        num_sp_devices: int = 1,
        layout=None,
    ):
        """``params`` is a list of per-block dicts, or one dict whose leaves
        are stacked along a leading block axis (utils/convert.py
        stacked_from_numpy); the stacked form is viewed per block, a
        quantized leaf piece by piece. Hidden states and a floating-point KV
        pool are kept in ``compute_dtype``. ``quant_type`` records how the
        weights were quantized (utils/convert_block.py QuantType);
        ``kv_quant_type`` (none, int8, nf4a) how the KV pool stores rows.
        ``use_flash`` sends dense-cache chunks to the flash-attention kernel
        (None: on when the device is a CUDA card). ``tp_devices`` (more than
        one) makes the span tensor parallel, one shard a listed device:
        unsharded blocks are split here (or come split, a list of shard
        dicts a block), and ``device`` is then the first entry. With
        ``num_sp_devices`` > 1 it lists the tp x sp grid in
        ``parallel.mesh.serving_devices``' order (entry t * sp + r: shard t
        of sp rank r), and the shards are replicated over the ranks
        (``GridParams``, one copy a distinct device). Across processes
        (parallel/multihost.py) ``layout`` (a ``GroupLayout``) places this
        process's entries in the global grid: ``tp_devices`` then lists this
        process's n_t x n_s entries in the same order, ``num_sp_devices`` is
        its n_s, unsharded blocks keep its shards only, and ``tp_size`` /
        ``sp_size`` / ``mesh_size`` are the global grid's."""
        if kv_quant_type not in KV_QUANT_KINDS:
            raise ValueError(f"kv_quant_type must be one of {KV_QUANT_KINDS}, got {kv_quant_type!r}")
        mesh = [torch.device(d) for d in tp_devices] if tp_devices else [torch.device(device)]
        num_sp = int(num_sp_devices or 1)
        if num_sp < 1 or len(mesh) % num_sp:
            raise ValueError(f"{len(mesh)} devices do not form a grid of {num_sp} sp ranks")
        if layout is not None and (layout.n_t * layout.n_s, layout.n_s) != (len(mesh), num_sp):
            raise ValueError(f"{len(mesh)} devices of {num_sp} sp ranks are not the layout's "
                             f"{layout.n_t} x {layout.n_s} entries")
        if kv_quant_type != "none" and (len(mesh) > 1 or layout is not None):
            raise ValueError("kv_quant_type requires a mesh-less server (paged pool only)")
        if kv_quant_type == "nf4a" and cfg.head_dim % 2:
            raise ValueError(f"nf4a KV packing needs an even head_dim, got {cfg.head_dim}")
        self.family = family
        self.cfg = cfg
        self.quant_type = quant_type
        self.kv_quant_type = kv_quant_type
        if isinstance(params, dict):
            params = [{name: _block_view(t, i) for name, t in params.items()} for i in range(n_blocks)]
        if len(params) != n_blocks:
            raise ValueError(f"got parameters for {len(params)} blocks, expected {n_blocks}")
        # the whole grid, rank 0's shards' devices, and its sizes
        # (across processes: this process's entries, the global sizes)
        self.layout = layout
        self.mesh_devices: List[torch.device] = mesh
        self.tp_devices: List[torch.device] = mesh[::num_sp]
        self.sp_size = num_sp if layout is None else layout.sp
        self.tp_size = len(self.tp_devices) if layout is None else layout.tp
        self.mesh_size = self.tp_size * self.sp_size
        if self.mesh_size > 1:
            device = mesh[0]
            # any mesh splits the parameters (petals_tpu's span_param_pspecs):
            # a family without a spec, or a fused leaf, raises KeyError at sp
            # alone too
            if not (is_sharded(params[0]) or isinstance(params[0], GridParams)):
                params = shard_span_params(params, self.tp_devices, family.name, cfg, n_shards=self.tp_size,
                                           first=0 if layout is None else layout.t0)
            if num_sp > 1 and not isinstance(params[0], GridParams):
                params = [replicate_over_sp(shards, mesh, num_sp) for shards in params]
            if layout is not None:
                params = [GridParams(p.ranks if isinstance(p, GridParams) else [p], layout) for p in params]
        # a block's parameters: one dict, under tensor parallelism a list of
        # one dict a shard, under sequence parallelism GridParams
        self.block_params: List[object] = list(params)
        # adapter name -> (per-block {leaf: (A, B)}, scaling); see utils/peft.py
        self.adapters: Dict[str, tuple] = {}
        self.first_block = first_block
        self.n_blocks = n_blocks
        self.device = torch.device(device)
        self.use_flash = self.device.type == "cuda" if use_flash is None else bool(use_flash)
        self.compute_dtype = compute_dtype
        self.max_chunk_size_bytes = max_chunk_size_bytes
        self.num_kv_heads = num_kv_heads(cfg)
        # a block whose rotary tables depend on the final length (phi3's
        # longrope, through the llama block) takes n_total; others are not
        # passed it (petals_tpu's backend checks the same signature)
        self._takes_n_total = "n_total" in inspect.signature(family.block_apply).parameters
        self.head_dim = cfg.head_dim
        self.hidden_size = cfg.hidden_size
        # the step programs (CUDA graphs, on a card only); every graph of
        # this backend shares one memory pool: steps never run at once
        self._decode_program = self._mixed_program = self._gen_program = self._spec_program = None
        self._dense_decode_program = self._dense_gen_program = self._lane_program = None
        self._private_program = self._private_gen_program = self._forward_program = None
        # (k, v) addresses of the dense pool's lane views, whose plain chunks
        # replay the lane programs captured when the pool opened
        self._lane_views: set = set()
        # the last batched step's fused fingerprints, on the device
        self._last_step_fp: Optional[torch.Tensor] = None  # [n_lanes, FP_DIM]
        self._last_chunk_fp: Optional[torch.Tensor] = None  # [FP_DIM], a mixed step's chunk
        # a span over a mesh steps eagerly (no step programs)
        if self.device.type == "cuda" and self.mesh_size == 1:
            capture = CudaGraphCapture(self.device)
            self._decode_program = TrackedGraph("paged_decode", capture)
            self._mixed_program = TrackedGraph("paged_mixed_step", capture)
            self._gen_program = TrackedGraph("paged_gen_decode", capture)
            self._spec_program = TrackedGraph("paged_spec_verify", capture)
            self._dense_decode_program = TrackedGraph("batched_decode", capture)
            self._dense_gen_program = TrackedGraph("batched_gen_decode", capture)
            self._lane_program = TrackedGraph("dense_lane_step", capture)
            self._private_program = TrackedGraph("inference_step", capture, steady=False)
            self._private_gen_program = TrackedGraph("server_gen", capture, steady=False)
            self._forward_program = TrackedGraph("forward", capture, steady=False)

    # ------------------------------------------------------------- cache descriptors

    def cache_descriptors(self, batch_size: int, max_length: int, start: int, end: int):
        """(k, v) descriptors of a DENSE cache for blocks [start, end): each
        [n, batch_size, max_length, hkv, d] in compute_dtype on the backend's
        device (a private session's cache, or the dense lane pool with
        batch_size = n_lanes)."""
        shape = (end - start, batch_size, max_length, self.num_kv_heads, self.head_dim)
        if self.mesh_size > 1:  # one part of the kv heads a shard, one copy a distinct device over sp
            local_sp = len(self.mesh_devices) // len(self.tp_devices)
            return tuple(ShardedDescriptor(shape, self.compute_dtype, self.mesh_devices, local_sp,
                                           **self._head_split(self.sp_size)) for _ in "kv")
        return (
            TensorDescriptor(shape, self.compute_dtype, self.device),
            TensorDescriptor(shape, self.compute_dtype, self.device),
        )

    def paged_cache_descriptors(self, n_pages: int, page_size: int, start: int, end: int):
        """Descriptors of the paged pool of blocks [start, end) on the
        backend's device. Unquantized: (k, v), each [n, n_pages, page_size,
        hkv, d] in compute_dtype. Quantized: (k_codes, v_codes, k_scales,
        v_scales), the codes int8 [..., d] or uint8 [..., d // 2] (two
        split-half codes a byte, nf4a) and float32 scales [n, n_pages,
        page_size, hkv]."""
        if self.mesh_size > 1:
            raise ValueError("a span over a mesh serves the dense lane pool, not a paged one")
        n = end - start
        shape = (n, n_pages, page_size, self.num_kv_heads, self.head_dim)
        if self.kv_quant_type == "none":
            return (
                TensorDescriptor(shape, self.compute_dtype, self.device),
                TensorDescriptor(shape, self.compute_dtype, self.device),
            )
        if self.kv_quant_type == "int8":
            codes = TensorDescriptor(shape, torch.int8, self.device)
        else:
            codes = TensorDescriptor((*shape[:-1], self.head_dim // 2), torch.uint8, self.device)
        scales = TensorDescriptor(shape[:-1], torch.float32, self.device)
        return codes, codes, scales, scales

    def cache_bytes_per_token(self) -> int:
        """LOGICAL (floating-point) KV bytes per token across the span."""
        return 2 * self.n_blocks * self.num_kv_heads * self.head_dim * self.compute_dtype.itemsize

    def kv_bytes_per_token(self) -> int:
        """STORED KV bytes per token across the span: what the paged pool
        holds per token. Equals cache_bytes_per_token when unquantized."""
        return 2 * self.n_blocks * kv_wire_bytes_per_token(
            self.num_kv_heads, self.head_dim, self.kv_quant_type, self.compute_dtype.itemsize
        )

    def _slice_params(self, start: int, end: int) -> List[Dict[str, object]]:
        """The parameters of blocks [start, end) of this span (views, no copy)."""
        return self.block_params[start:end]

    def params_for(self, active_adapter: Optional[str]) -> List[Dict[str, object]]:
        """The span's per-block parameters with the requested LoRA adapter
        applied (the same base tensors); the plain ones without. Raises
        KeyError for an adapter this backend does not hold."""
        if not active_adapter:
            return self.block_params
        if active_adapter not in self.adapters:
            raise KeyError(f"Adapter {active_adapter!r} is not loaded on this server")
        from petals_tpu_torch.utils.peft import apply_adapter

        per_block, scaling = self.adapters[active_adapter]
        # under a mesh each shard takes its part of A or B (utils/peft.py
        # shard_adapter): its leaves' split axes
        specs = span_param_specs(self.family.name, self.cfg) if self.mesh_size > 1 else None
        return apply_adapter(self.block_params, per_block, scaling, specs=specs, n_shards=self.tp_size)

    # ------------------------------------------------------------- dense steps

    @torch.no_grad()
    def inference_step(self, hidden, kv, position: int, *, prompts=None, hypo_ids=None,
                       n_total: Optional[int] = None, active_adapter: Optional[str] = None):
        """One (chunked-as-needed) inference step over the whole span on a
        DENSE cache: each chunk is one call of the dense step (``_dense_chunk``:
        on a CUDA device a step program, on the CPU the block loop).

        Args:
          hidden: [batch, seq, hidden], real tokens, unpadded.
          kv: (k_stack, v_stack), each [n_blocks, batch, max_length, hkv, d],
            updated IN PLACE (rows [position, position + seq)).
          position: tokens already cached (shared by the batch).
          prompts: deep prompts [n_blocks, batch, pre_seq, hidden], added to
            each block's input over absolute positions [0, pre_seq).
          hypo_ids: [batch] beam reorder: cache row b continues row
            hypo_ids[b]; applied in place by the first chunk.
          n_total: the final sequence length, for callers that already
            chunked the prompt (default: this step's own end); every chunk
            passes it to the blocks, so longrope (phi3) picks its factors
            from the whole prompt's length, as one forward over it would.
          active_adapter: a LoRA adapter of ``adapters`` to apply.

        Returns (out [batch, seq, hidden] on the device, kv).
        """
        self.params_for(active_adapter)  # an unknown adapter fails before any write
        k_stack, v_stack = kv
        max_length = k_stack.shape[2]
        h = _as_tensor(hidden, None, self.compute_dtype)
        batch, total_seq, _ = h.shape
        position = int(position)
        if k_stack.shape[0] != self.n_blocks or k_stack.shape[1] != batch:
            raise ValueError(
                f"cache {tuple(k_stack.shape)} does not match {self.n_blocks} blocks x batch {batch}"
            )
        if position + total_seq > max_length:
            raise ValueError(
                f"Step of {total_seq} tokens at position {position} overflows the "
                f"allocated cache ({max_length} tokens)"
            )
        if n_total is not None and n_total < position + total_seq:
            raise ValueError(
                f"n_total={n_total} is shorter than this step's own end ({position} + {total_seq})"
            )
        if prompts is not None:
            prompts = _as_tensor(prompts, None, self.compute_dtype)
            if prompts.shape[2] == 0:
                prompts = None
        hypo = None
        if hypo_ids is not None:
            hypo = _as_tensor(hypo_ids, None, torch.long)
            # a bad row index would fault the card inside a replay: checked
            # here, where the ids still lie on the host
            if hypo.device.type == "cpu" and bool(((hypo < 0) | (hypo >= batch)).any()):
                raise ValueError(f"hypo_ids {hypo.tolist()} out of range for batch {batch}")
        if n_total is None:
            n_total = position + total_seq
        outputs, offset = [], 0
        for chunk_len in self.chunk_plan(batch, total_seq):
            outputs.append(self._dense_chunk(
                h[:, offset : offset + chunk_len], (k_stack, v_stack), position + offset, prompts,
                hypo if offset == 0 else None, n_total=n_total, active_adapter=active_adapter,
            ))
            offset += chunk_len
        out = outputs[0] if len(outputs) == 1 else torch.cat(outputs, dim=1)
        return out, (k_stack, v_stack)

    def _dense_chunk(self, chunk, kv, position: int, prompts=None, hypo=None, n_valid: Optional[int] = None,
                     n_total: Optional[int] = None, active_adapter: Optional[str] = None):
        """One chunk of a dense step through every block: the JAX package's
        ``_step_once``. A chunk of more than one token is padded to
        ``bucket_length(seq)`` rows with ``n_valid = seq`` (a decode token is
        bucket 0, unpadded); position and n_valid ride as int32 scalars read
        on the device, so one graph serves every chunk of a bucket. On a CUDA
        device the call replays the dense pool's lane program (a plain chunk
        on a lane view) or a private step program, keyed by
        ``dense_program_key``; on the CPU it runs the block loop.
        ``n_valid`` overrides the real length (the pool's warm-up writes
        nothing); ``n_total`` (default: the chunk's own end) rides beside
        position and n_valid; ``active_adapter`` names the LoRA adapter
        applied (part of the key). Returns [batch, seq, hidden] on the
        device."""
        k_stack, v_stack = kv
        batch, seq = chunk.shape[:2]
        bucket = 0 if seq == 1 else bucket_length(seq)
        if bucket > seq:
            chunk = F.pad(chunk, (0, 0, 0, bucket - seq))
        n_valid = seq if n_valid is None else n_valid
        scalars = torch.tensor([position, n_valid, position + n_valid if n_total is None else n_total],
                               dtype=torch.int32)
        extra = tuple(x for x in (hypo, prompts) if x is not None)
        with_hypo = hypo is not None

        def step(h, sc, *extra):
            return self._dense_step_eager(h, k_stack, v_stack, sc[0], sc[1], extra[0] if with_hypo else None,
                                          extra[-1] if prompts is not None else None, n_total=sc[2],
                                          params=self.params_for(active_adapter))

        plain = not extra and active_adapter is None and (k_stack.data_ptr(), v_stack.data_ptr()) in self._lane_views
        key = dense_program_key("dense", bucket, self.quant_type, kv, with_hypo,
                                0 if prompts is None else prompts.shape[2], active_adapter)
        (out,) = _replay(self._lane_program if plain else self._private_program, key, step, (chunk, scalars, *extra))
        return out[:, :seq]

    def _dense_step_eager(self, hidden, k_stack, v_stack, position, n_valid, hypo=None, prompts=None, n_total=None,
                          params=None):
        """The dense step's block loop, launched op by op: what the CPU
        runs, and what a step program captures. ``hidden`` [batch, bucket,
        hidden] is already padded; ``position``, ``n_valid`` and ``n_total``
        (None: the chunk's own end) are 0-dim integer tensors (or host
        integers), read on the device. ``hypo``
        reorders the caches' rows in place first; ``prompts`` are added in
        the JAX package's masked form (each row's prompt row gathered at its
        clipped position, kept where the position lies under ``pre_seq``),
        so no value of the position reaches the host. ``params``: the
        per-block parameters (default: the span's own). Returns (out,)."""
        h = _as_tensor(hidden, self.device, self.compute_dtype)
        position = torch.as_tensor(position).to(self.device, torch.int32)
        if hypo is not None:
            # index_select copies the reordered rows out before copy_ writes
            # them back, so rows may swap
            hypo = _as_tensor(hypo, self.device, torch.long)
            k_stack.copy_(k_stack.index_select(1, hypo))
            v_stack.copy_(v_stack.index_select(1, hypo))
        if prompts is not None:
            prompts = _as_tensor(prompts, self.device, self.compute_dtype)
            pre_seq = prompts.shape[2]
            pos_in_chunk = position + torch.arange(h.shape[1], dtype=torch.int32, device=self.device)
            prompt_mask = (pos_in_chunk < pre_seq)[None, :, None]
            idx = pos_in_chunk.clamp(0, pre_seq - 1).long()
        for i, p_block in enumerate(self.block_params if params is None else params):
            if prompts is not None:
                h = h + torch.where(prompt_mask, prompts[i].index_select(1, idx), 0).to(h.dtype)
            h, _ = self.family.block_apply(
                p_block, h, (k_stack[i], v_stack[i]), position, self.cfg, n_valid=n_valid,
                use_flash=self.use_flash, **self._n_total_arg(n_total),
            )
        return (h,)

    def _n_total_arg(self, n_total) -> dict:
        """``block_apply``'s n_total keyword, for a block that takes it."""
        return {"n_total": n_total} if self._takes_n_total and n_total is not None else {}

    @torch.no_grad()
    def forward(self, hidden, prompts=None, active_adapter: Optional[str] = None) -> torch.Tensor:
        """A stateless forward over the span, with no KV cache (petals_tpu's
        backend ``forward``): each block attends causally over the chunk
        itself, through a K/V buffer that block after block overwrites. The
        chunk is padded to ``bucket_length(seq)`` rows, as the mixed and
        dense steps pad theirs, with ``n_valid = seq``: the padded rows' K/V
        writes drop and their outputs are cut off, and attention is causal,
        so no real row sees them (and longrope picks its factors from the
        real length). Attention goes through the flash-attention wrapper
        (ops/flash_attention.py): the CUDA kernel on the card, its plain
        version on the CPU. On a CUDA device a step program, one graph per
        (batch, bucket, pre_seq): its K/V buffer comes from the graph's
        pool, and the real length rides as an int32 read on the device.

        Args:
          hidden: [batch, seq, hidden].
          prompts: deep prompts [n_blocks, batch, pre_seq, hidden], added to
            each block's input over positions [0, pre_seq).
          active_adapter: a LoRA adapter of ``adapters`` to apply (part of
            the program's key).

        Returns out [batch, seq, hidden] on the device."""
        params = self.params_for(active_adapter)
        h = _as_tensor(hidden, None, self.compute_dtype)
        if prompts is not None:
            prompts = _as_tensor(prompts, None, self.compute_dtype)
            if prompts.shape[2] == 0:
                prompts = None
        batch, seq = h.shape[:2]
        if self._rides_ring(seq):
            return self._ring_forward(h, prompts, params)
        bucket = bucket_length(seq)
        h = F.pad(h, (0, 0, 0, bucket - seq))
        n_valid = torch.tensor(seq, dtype=torch.int32)  # read on the device by the step
        inputs = (h, n_valid) if prompts is None else (h, n_valid, prompts)

        def step(h, n, *p):
            return self._forward_eager(h, n, p[0] if p else None, params=params)

        # step_program_key's layout, with no cache: (batch, bucket, pre_seq), then the adapter
        key = ("forward", batch, bucket, 0 if prompts is None else prompts.shape[2], self.quant_type, "none", (),
               active_adapter)
        (out,) = _replay(self._forward_program, key, step, inputs)
        return out[:, :seq]

    def _forward_eager(self, hidden, n_valid, prompts=None, params=None):
        """The stateless forward's block loop (what the CPU runs, and what
        its program captures) over a chunk padded to its bucket, of which
        ``n_valid`` (a 0-dim integer tensor or an int) rows are real. The
        buffer's position and n_valid ride as 0-dim tensors on the device,
        as a captured step needs them. The K/V buffer starts at zeros: the
        padded rows' slots are never written, and a zero row is finite.
        ``params``: the per-block parameters (default: the span's own).
        Returns (out,)."""
        h = _as_tensor(hidden, self.device, self.compute_dtype)
        batch, bucket, _ = h.shape
        if prompts is not None:
            prompts = _as_tensor(prompts, self.device, self.compute_dtype)
        kv_buf = self._scratch_kv(batch, bucket)
        position = torch.zeros((), dtype=torch.int32, device=self.device)
        n_valid = torch.as_tensor(n_valid).to(self.device, torch.int32)
        for i, p_block in enumerate(self.block_params if params is None else params):
            if prompts is not None:
                pre = prompts.shape[2]
                h = torch.cat([h[:, :pre] + prompts[i], h[:, pre:]], dim=1)
            h, _ = self.family.block_apply(p_block, h, kv_buf, position, self.cfg, n_valid=n_valid, use_flash=True)
        return (h,)

    def _rides_ring(self, seq: int) -> bool:
        """Whether a stateless pass of ``seq`` rows runs the ring: sequence
        parallel, and the rows split over the sp ranks (petals_tpu's
        ``_forward_fn``: other lengths take the tp-only path)."""
        return self.sp_size > 1 and seq % self.sp_size == 0

    def _ring_forward(self, h, prompts, params):
        """The stateless forward under sequence parallelism: each block's
        rows split over the sp ranks, attention a ring over them (no cache,
        no padding, no flash kernel: petals_tpu's ``_forward_fn`` under an
        "sp" mesh), eager. Returns out [batch, seq, hidden] on the device."""
        h = _as_tensor(h, self.device, self.compute_dtype)
        pre = 0 if prompts is None else prompts.shape[2]
        for i, p_block in enumerate(params):
            if pre:
                h = torch.cat([h[:, :pre] + prompts[i].to(h.device), h[:, pre:]], dim=1)
            h, _ = self.family.block_apply(p_block, h, None, 0, self.cfg, use_flash=False)
        return h

    def backward(self, hidden, grad_out, prompts=None, active_adapter: Optional[str] = None):
        """The gradients of the span's output, weighted by ``grad_out``, at
        its input and at the deep prompts (petals_tpu's ``backward``): a
        no-grad pass keeps each block's input (after its prompt's add), then
        each block, last first, is recomputed from its input under autograd
        (``_train_block``) and ``torch.autograd.grad`` carries the gradient
        back through it. Weights get no gradient.

        Args:
          hidden: [batch, seq, hidden], the span's input.
          grad_out: [batch, seq, hidden], the gradient at its output.
          prompts: deep prompts [n_blocks, batch, pre_seq, hidden], added to
            each block's input over positions [0, pre_seq).
          active_adapter: a LoRA adapter of ``adapters`` to apply.

        Returns (grad_hidden [batch, seq, hidden], grad_prompts [n_blocks,
        batch, pre_seq, hidden] or None), in the compute dtype on the
        device."""
        params = self.params_for(active_adapter)
        h = _as_tensor(hidden, self.device, self.compute_dtype)
        g = _as_tensor(grad_out, self.device, self.compute_dtype)
        if tuple(g.shape) != tuple(h.shape):
            raise ValueError(f"grad_out {tuple(g.shape)} does not match hidden {tuple(h.shape)}")
        pre = 0
        if prompts is not None:
            prompts = _as_tensor(prompts, self.device, self.compute_dtype)
            pre = prompts.shape[2]
        inputs = []
        with torch.no_grad():
            for i, p_block in enumerate(params):
                if pre:
                    h = torch.cat([h[:, :pre] + prompts[i], h[:, pre:]], dim=1)
                inputs.append(h)
                h = self._train_block(p_block, h)
        grad_prompts = torch.zeros_like(prompts) if prompts is not None else None
        for i in reversed(range(len(params))):
            x = inputs[i].detach().requires_grad_(True)
            with torch.enable_grad():
                out = self._train_block(params[i], x)
                (g,) = torch.autograd.grad(out, x, g)
            g = self._sp_rows_joined(g)
            inputs[i] = None  # the block's input is spent: free it
            if pre:
                grad_prompts[i] = g[:, :pre]
        return g, grad_prompts

    def _train_block(self, p_block: dict, h: torch.Tensor) -> torch.Tensor:
        """One block on the training path, as the JAX package's ``_forward_fn``
        runs it: causal attention over the chunk itself, in plain attention
        (``use_flash=False``) on a fresh dense K/V buffer, position 0; under
        sequence parallelism with rows that split, the ring (no buffer)."""
        kv = None if self._rides_ring(h.shape[1]) else self._scratch_kv(h.shape[0], h.shape[1])
        out, _ = self.family.block_apply(p_block, h, kv, 0, self.cfg, use_flash=False)
        return out

    def _scratch_kv(self, batch: int, length: int):
        """A fresh zero (k, v) buffer [batch, length, hkv, d] for one block
        of a pass with no cache (a ShardedCache pair under a mesh, on sp
        rank 0 alone: a pass that does not ride the ring is tp-only)."""
        if self.mesh_size == 1:
            return tuple(d.make_zeros()[0] for d in self.cache_descriptors(batch, length, 0, 1))
        shape = (1, batch, length, self.num_kv_heads, self.head_dim)
        return tuple(ShardedDescriptor(shape, self.compute_dtype, self.tp_devices, **self._head_split(1))
                     .make_zeros()[0] for _ in "kv")

    def _head_split(self, n_sp: int) -> dict:
        """A ShardedDescriptor's split across processes: this process's
        shards of the global tp split of the kv heads, replicated over
        ``n_sp`` ranks of the global grid."""
        if self.layout is None:
            return {}
        return {"n_shards": self.tp_size, "first": self.layout.t0, "total_sp": n_sp}

    def sub_backend(self, start: int, end: int) -> "TransformerBackend":
        """A backend over blocks [start, end) of this span: the same weights
        (views, no copy), devices, settings and layout; no adapters."""
        return TransformerBackend(
            self.family, self.cfg, self._slice_params(start, end),
            first_block=self.first_block + start, n_blocks=end - start, device=self.device,
            compute_dtype=self.compute_dtype, max_chunk_size_bytes=self.max_chunk_size_bytes,
            quant_type=self.quant_type, use_flash=self.use_flash, tp_devices=self.mesh_devices,
            num_sp_devices=len(self.mesh_devices) // len(self.tp_devices), layout=self.layout,
        )

    def _sp_rows_joined(self, g: torch.Tensor) -> torch.Tensor:
        """A block input's gradient on the ring across processes holds this
        process's rows only (every other row's part reached its own
        process round the ring): the rows of every process, gathered."""
        lay = self.layout
        if lay is None or lay.sp_group is None or not self._rides_ring(g.shape[1]):
            return g
        from petals_tpu_torch.parallel.collectives import gather_rows, own_rows

        return gather_rows(own_rows(g, lay), lay)

    @torch.no_grad()
    def batched_decode_step(self, hidden, pool_kv, positions):
        """One coalesced decode step over the whole DENSE lane pool: on a
        CUDA device a replay of its step program (captured when the pool
        opens, ``warm_dense_programs``), on the CPU the block loop.

        Args:
          hidden: [n_lanes, 1, hidden] (idle lanes: any finite filler).
          pool_kv: (k, v) pool buffers [n_blocks, n_lanes, max_len, hkv, d],
            updated IN PLACE.
          positions: int32 [n_lanes]; idle lanes hold max_len (the sentinel:
            their writes drop and their outputs are never read).

        Returns (out [n_lanes, 1, hidden] on the device, pool_kv).
        """
        inputs = (_as_tensor(hidden, None, self.compute_dtype), _as_tensor(positions, None, torch.int32))

        with_fp = fp_ops.enabled()
        proj = self._fp_proj(with_fp)

        def step(h, pos):
            out = self._dense_decode_eager(h, pool_kv, pos)[0]
            return (out,) if proj is None else (out, fp_ops.fingerprint_rows_torch(out[:, -1], proj))

        key = dense_program_key("batched_decode", 0, self.quant_type, pool_kv, with_fp)
        (out,) = self._keep_fp(_replay(self._dense_decode_program, key, step, inputs), 1)
        return out, pool_kv

    def _dense_decode_eager(self, hidden, pool_kv, positions):
        """The dense pool's decode block loop (what the CPU runs, and what
        its step program captures): per-lane positions, plain attention, as
        in the JAX package."""
        k_pool, v_pool = pool_kv
        h = _as_tensor(hidden, self.device, k_pool.dtype)
        positions = _as_tensor(positions, self.device, torch.int32)
        for i, p_block in enumerate(self.block_params):
            h, _ = self.family.block_apply(
                p_block, h, (k_pool[i], v_pool[i]), positions, self.cfg, use_flash=False
            )
        return h, (k_pool, v_pool)

    def longest_chunk(self, batch: int) -> int:
        """The longest chunk ``chunk_plan`` hands a dense step at ``batch``
        rows (what the dense pool warms its lane programs up to)."""
        if self.device.type == "cuda" and self.use_flash:
            return self._linear_max_chunk(batch)
        # quadratic sizing: a chunk of n tokens of an n-token prompt costs
        # batch * heads * n * n * 4 bytes
        return max(math.isqrt(self.max_chunk_size_bytes // max(batch * self.cfg.num_attention_heads * 4, 1)), 1)

    def dense_lane_view(self, k_pool, v_pool, lane: int):
        """One lane of the dense pool as a session-shaped [n_blocks, 1,
        max_len, hkv, d] pair of VIEWS: work the batched step does not cover
        (a prefill, deep prompts, hypo_ids) runs on it in place. Its address
        is the lane's for as long as the pool lives, so its graphs stay
        valid; ``lane_extract`` is the copying form."""
        lane = int(lane)
        return k_pool[:, lane : lane + 1], v_pool[:, lane : lane + 1]

    def warm_dense_programs(self, pool_kv, n_lanes: int, max_length: int, max_chunk: int,
                            gen_params: Optional[dict] = None) -> None:
        """Capture every step program a dense lane pool of ``n_lanes`` lanes
        of ``max_length`` tokens replays on ``pool_kv``: the batched decode
        step, the generation step when the batcher holds ``gen_params``, and
        on each lane's view the plain chunk at bucket 0 (one token) and at
        every bucket of a chunk of at most ``max_chunk`` tokens. Run when
        the pool opens, so that serving captures nothing. Every lane rides
        at the idle sentinel and every chunk has no real row: nothing is
        written. A no-op on the CPU."""
        if self._dense_decode_program is None:
            return
        hidden = torch.zeros(n_lanes, 1, self.hidden_size, dtype=self.compute_dtype)
        positions = np.full((n_lanes,), max_length, np.int32)
        self.batched_decode_step(hidden, pool_kv, positions)
        if gen_params is not None:
            idle = np.zeros((n_lanes,), np.int64)
            self.batched_gen_decode_step(
                gen_params, hidden, idle, idle.astype(bool), pool_kv, positions,
                sampling_vecs=sampling_vectors(n_lanes, self.cfg.vocab_size),
            )
        longest = min(max_chunk, max_length)
        for lane in range(n_lanes):
            view = self.dense_lane_view(*pool_kv, lane)
            self._lane_views.add((view[0].data_ptr(), view[1].data_ptr()))
            for bucket in [1] + chunk_buckets(longest):
                chunk = torch.zeros(1, min(bucket, longest), self.hidden_size, dtype=self.compute_dtype)
                self._dense_chunk(chunk, view, 0, n_valid=0)

    def drop_cache_programs(self, buffers: Sequence[torch.Tensor]) -> int:
        """Forget every step program that writes or reads memory of
        ``buffers`` (a cache or pool about to be freed): a graph must never
        outlive the tensors it addresses. Returns how many graphs went."""
        spans = [(t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()) for t in buffers]

        def inside(ptr: int) -> bool:
            return any(lo <= ptr < hi for lo, hi in spans)

        def hits(key) -> bool:
            return any(inside(ptr) for ptr, *_ in key[6])

        self._lane_views = {v for v in self._lane_views if not inside(v[0])}
        return sum(p.drop(hits) for p in self._programs() if p is not None)

    # ------------------------------------------------------------- lane check-out / check-in

    def lane_extract(self, k_pool, v_pool, lane: int):
        """Copy one lane out of the dense pool as a session-shaped
        [n_blocks, 1, max_len, hkv, d] pair (for work the batched step does
        not cover: prefill, deep prompts)."""
        lane = int(lane)
        return k_pool[:, lane : lane + 1].clone(), v_pool[:, lane : lane + 1].clone()

    def lane_insert(self, k_pool, v_pool, k, v, lane: int):
        """Write a session-shaped lane pair back into the dense pool, in place."""
        lane = int(lane)
        k_pool[:, lane : lane + 1].copy_(k)
        v_pool[:, lane : lane + 1].copy_(v)
        return k_pool, v_pool

    def paged_lane_gather(self, k_pool, v_pool, table_row):
        """One lane's dense session-shaped view [n_blocks, 1, max_pages *
        page_size, hkv, d] assembled from its block-table row: the paged
        stand-in for ``lane_extract``. Unallocated slots read as ZEROS, never
        as another tenant's page; a quantized pool is decoded here."""
        row = _as_tensor(table_row, self.device, torch.long)
        n_blocks, n_pages, page_size = k_pool.shape[:3]
        safe = row.clamp(0, n_pages - 1)

        def leaf(arr):
            hole = (row < 0).view(1, -1, *([1] * (arr.dim() - 2)))
            return arr.index_select(1, safe).masked_fill_(hole, 0)

        def one(pool):
            if isinstance(pool, PagedPool):
                rows = dequantize_kv(leaf(pool.codes), leaf(pool.scales), pool.kind, pool.dtype)
            else:
                rows = leaf(pool)
            return rows.reshape(n_blocks, 1, row.shape[0] * page_size, *pool.shape[3:])

        return one(k_pool), one(v_pool)

    def paged_lane_scatter(self, k_pool, v_pool, k, v, table_row):
        """Write a session-shaped lane pair back into its pages, in place:
        the paged stand-in for ``lane_insert``. Unallocated slots drop; a
        quantized pool re-encodes the buffer row by row."""
        n_blocks, _, page_size = k_pool.shape[:3]
        for pool, buf in ((k_pool, k), (v_pool, v)):
            pages = buf.reshape(n_blocks, -1, page_size, *pool.shape[3:])
            scatter_lane_pages(pool, pages, table_row)
        return k_pool, v_pool

    def copy_page(self, k_pool, v_pool, src: int, dst: int) -> None:
        """Copy page ``src`` into page ``dst`` across every block of both
        pools, IN PLACE (the copy-on-write fork: a shared page is copied
        before a lane writes into it; petals_tpu's ``_copy_page_fn``). A
        quantized pool copies its codes and scales verbatim. The pools keep
        their addresses, so the step programs that address them stay
        valid."""
        for t in _pool_tensors((k_pool, v_pool)):
            t[:, int(dst)].copy_(t[:, int(src)])

    def swap_out_pages(self, k_pool, v_pool, pages):
        """Copy pages ``pages`` (an int array of page ids) of every block of
        both pools to the host, for the swap tier (petals_tpu's
        ``_swap_out_pages_fn`` and the host copy after it). Returns (k, v):
        [n_blocks, len(pages), page_size, hkv, d] tensors on the CPU, or
        PagedPool pairs of the stored codes and scales for a quantized pool
        (wire bytes: never decoded). From a pool on the card the copies land
        in pinned memory, and the call returns once they have landed: only
        then may the batcher free the pages. The pools are only read."""
        idx = _as_tensor(np.asarray(pages, np.int64), _pool_device(k_pool))

        def leaf(t):
            g = t.index_select(1, idx)
            if g.device.type != "cuda":
                return g  # index_select copies
            host = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
            host.copy_(g, non_blocking=True)
            return host

        def one(pool):
            return PagedPool(leaf(pool.codes), leaf(pool.scales)) if isinstance(pool, PagedPool) else leaf(pool)

        out = one(k_pool), one(v_pool)
        if idx.device.type == "cuda":
            torch.cuda.current_stream(idx.device).synchronize()
        return out

    def swap_in_pages(self, k_pool, v_pool, k_pages, v_pages, pages) -> None:
        """Write swapped-out pages back into the pools IN PLACE, onto page
        ids ``pages`` (petals_tpu's ``_swap_in_pages_fn``): entry i of the
        host copies lands on page ``pages[i]``, a negative entry drops. The
        pools keep their addresses, so the step programs stay valid; the
        call returns once the writes are done."""
        pages = np.asarray(pages, np.int64)
        keep = np.flatnonzero(pages >= 0)
        device = _pool_device(k_pool)
        idx = torch.from_numpy(pages[keep]).to(device)
        sel = None if keep.size == pages.size else torch.from_numpy(keep)
        for pool, host in ((k_pool, k_pages), (v_pool, v_pages)):
            pairs = zip(pool, host) if isinstance(pool, PagedPool) else ((pool, host),)
            for dst, src in pairs:
                if sel is not None:
                    src = src.index_select(1, sel)
                dst.index_copy_(1, idx, src.to(device=dst.device, dtype=dst.dtype, non_blocking=True))
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()

    @staticmethod
    def seed_cache(kv, k_rows, v_rows) -> None:
        """Write a prefix into a session-shaped cache IN PLACE: rows [0, n)
        of ``kv`` (k, v) [n_blocks, batch, max_len, hkv, d] become ``k_rows``
        / ``v_rows`` [n_blocks, batch, n, hkv, d] (cast to the cache's type)
        and the rows past n zeros, as petals_tpu's seed leaves them. Where
        the JAX package replaces the buffers, this keeps their addresses, by
        which the dense step programs are keyed."""
        for buf, rows in zip(kv, (k_rows, v_rows)):
            n = rows.shape[2]
            buf[:, :, :n].copy_(rows.to(buf.device, buf.dtype))
            buf[:, :, n:].zero_()

    # ------------------------------------------------------------- paged steps

    @torch.no_grad()
    def paged_decode_step(self, hidden, pool_kv, positions, tables):
        """One coalesced decode step over a set of lanes, PAGED layout: on a
        CUDA device a replay of its step program, on the CPU the block loop.

        Args:
          hidden: [n_lanes, 1, hidden] (idle lanes: any finite filler).
          pool_kv: (k, v) page pools [n_blocks, n_pages, page_size, hkv, d]
            (tensors, or PagedPools of that logical shape), updated IN PLACE.
          positions: int32 [n_lanes]; idle sentinel = max_pages * page_size.
          tables: int32 [n_lanes, max_pages] block tables (-1 unallocated).

        Returns (out [n_lanes, 1, hidden] on the device, pool_kv).
        """
        # the inputs where they lie; the program copies them into its buffers
        inputs = (_as_tensor(hidden, None, self.compute_dtype), _as_tensor(positions, None, torch.int32),
                  _as_tensor(tables, None, torch.int32))
        n_lanes, max_pages = inputs[2].shape
        with_fp = fp_ops.enabled()
        proj = self._fp_proj(with_fp)
        key = step_program_key("decode", n_lanes, max_pages, 0, self.quant_type, self.kv_quant_type,
                               pool_kv) + (with_fp,)

        def step(h, pos, tab):
            out = self._paged_decode_eager(h, pool_kv, pos, tab)[0]
            return (out,) if proj is None else (out, fp_ops.fingerprint_rows_torch(out[:, -1], proj))

        (out,) = self._keep_fp(_replay(self._decode_program, key, step, inputs), 1)
        return out, pool_kv

    def _paged_decode_eager(self, hidden, pool_kv, positions, tables):
        """The decode step's block loop, launched op by op: what the CPU
        runs, and what a step program captures."""
        k_pool, v_pool = pool_kv
        h = _as_tensor(hidden, self.device, self.compute_dtype)
        positions = _as_tensor(positions, self.device, torch.int32)
        tables = _as_tensor(tables, self.device, torch.int32)
        for i, p_block in enumerate(self.block_params):
            kv = (PagedKV(pool_block(k_pool, i), tables), PagedKV(pool_block(v_pool, i), tables))
            h, _ = self.family.block_apply(p_block, h, kv, positions, self.cfg)
        return h, (k_pool, v_pool)

    @torch.no_grad()
    def paged_mixed_step(self, hidden, pool_kv, positions, tables,
                         chunk_hidden, chunk_lane: int, chunk_pos: int, *, n_total: Optional[int] = None):
        """One mixed step: every decode lane (one token each) plus ONE
        prefill chunk for ``chunk_lane``, block by block. The chunk is padded
        to ``bucket_length(seq)`` rows with ``n_valid = seq``, as the JAX
        package pads it: the padded rows' K/V writes drop and their outputs
        are cut off. On a CUDA device a replay of the bucket's step program,
        on the CPU the block loop.

        Args:
          hidden: [n_lanes, 1, hidden] (idle lanes: any finite filler).
          pool_kv: (k, v) page pools, updated IN PLACE.
          positions / tables: as in ``paged_decode_step``. The chunk lane
            must carry the idle sentinel in ``positions`` (its decode-side
            write drops); its table row is ``tables[chunk_lane]``.
          chunk_hidden: [1, seq, hidden], unpadded.
          chunk_lane / chunk_pos: which lane, and the chunk's first absolute
            token position (host integers, checked here: the step reads them
            on the device).
          n_total: the lane's final sequence length when known up front (a
            prompt prefilled chunk by chunk; longrope's factor choice);
            defaults to chunk_pos + seq. Read on the device too.

        Returns (decode_out [n_lanes, 1, h], chunk_out [1, seq, h], pool_kv).
        """
        chunk = _as_tensor(chunk_hidden, None, self.compute_dtype)
        seq = chunk.shape[1]
        tables_t = _as_tensor(tables, None, torch.int32)
        n_lanes, max_pages = tables_t.shape
        lane, pos = int(chunk_lane), int(chunk_pos)
        max_length = max_pages * pool_kv[0].shape[2]
        if not 0 <= lane < n_lanes or pos < 0 or seq < 1 or pos + seq > max_length:
            raise ValueError(
                f"bad prefill chunk: lane {lane} of {n_lanes}, {seq} tokens at position {pos} "
                f"(lane capacity {max_length})"
            )
        bucket = bucket_length(seq)
        chunk = F.pad(chunk, (0, 0, 0, bucket - seq))
        # {chunk_lane, chunk_pos, n_valid, n_total}: read on the device by the step
        scalars = torch.tensor([lane, pos, seq, pos + seq if n_total is None else int(n_total)], dtype=torch.int32)
        inputs = (_as_tensor(hidden, None, self.compute_dtype), _as_tensor(positions, None, torch.int32), tables_t,
                  chunk, scalars)

        with_fp = fp_ops.enabled()
        proj = self._fp_proj(with_fp)

        def step(h, pos_t, tab, c, sc):
            dec, chunk_out = self._paged_mixed_eager(h, pool_kv, pos_t, tab, c, sc[0:1], sc[1], sc[2], sc[3])[:2]
            if proj is None:
                return dec, chunk_out
            # the chunk's digest is of its LAST VALID row, the last one the
            # client receives for this chunk
            last = chunk_out[0].index_select(0, (sc[2:3] - 1).clamp(min=0).long())
            return (dec, chunk_out, fp_ops.fingerprint_rows_torch(dec[:, -1], proj),
                    fp_ops.fingerprint_rows_torch(last, proj)[0])

        key = step_program_key("mixed", n_lanes, max_pages, bucket, self.quant_type, self.kv_quant_type,
                               pool_kv) + (with_fp,)
        dec, chunk_out = self._keep_fp(_replay(self._mixed_program, key, step, inputs), 2, chunk=True)
        return dec, chunk_out[:, :seq], pool_kv

    def _paged_mixed_eager(self, hidden, pool_kv, positions, tables, chunk_hidden, chunk_lane, chunk_pos, n_valid,
                           n_total=None):
        """The mixed step's block loop, launched op by op (what the CPU runs,
        and what a step program captures). ``chunk_hidden`` [1, bucket,
        hidden] is already padded; ``chunk_lane`` ([1] or a scalar),
        ``chunk_pos``, ``n_valid`` and ``n_total`` (None: the chunk's own
        end) are integer tensors on the device (or host integers), read
        there: no value of theirs reaches the host."""
        k_pool, v_pool = pool_kv
        h_dec = _as_tensor(hidden, self.device, self.compute_dtype)
        h_pf = _as_tensor(chunk_hidden, self.device, self.compute_dtype)
        positions = _as_tensor(positions, self.device, torch.int32)
        tables = _as_tensor(tables, self.device, torch.int32)
        lane = torch.as_tensor(chunk_lane, device=self.device).reshape(1)
        table_row = tables.index_select(0, lane)
        for i, p_block in enumerate(self.block_params):
            k_blk, v_blk = pool_block(k_pool, i), pool_block(v_pool, i)
            kv = (PagedKV(k_blk, tables), PagedKV(v_blk, tables))
            h_dec, _ = self.family.block_apply(p_block, h_dec, kv, positions, self.cfg)
            kv_pf = (PagedKV(k_blk, table_row), PagedKV(v_blk, table_row))
            h_pf, _ = self.family.block_apply(
                p_block, h_pf, kv_pf, chunk_pos, self.cfg, n_valid=n_valid, **self._n_total_arg(n_total)
            )
        return h_dec, h_pf, (k_pool, v_pool)

    def warm_step_programs(self, pool_kv, n_lanes: int, max_pages: int, max_chunk: int,
                           gen_params: Optional[dict] = None, spec_k: int = 0) -> None:
        """Capture every step program a batcher of ``n_lanes`` lanes and
        ``max_pages`` table slots will replay on ``pool_kv``: the decode
        step, the generation step when the batcher holds ``gen_params`` (and
        the verify step of ``spec_k`` drafts when it also holds a draft),
        and the mixed step at every bucket of a chunk of at most
        ``max_chunk`` tokens (``chunk_buckets``; a lane caps it). Run when
        the pool opens, so that serving captures nothing. Every lane rides
        at the idle sentinel on a table of holes: nothing is written and no
        row is read. A no-op on the CPU."""
        if self._decode_program is None:
            return
        max_length = max_pages * pool_kv[0].shape[2]
        hidden = torch.zeros(n_lanes, 1, self.hidden_size, dtype=self.compute_dtype)
        positions = np.full((n_lanes,), max_length, np.int32)
        tables = np.full((n_lanes, max_pages), -1, np.int32)
        self.paged_decode_step(hidden, pool_kv, positions, tables)
        if gen_params is not None:
            idle = np.zeros((n_lanes,), np.int64)
            self.paged_gen_decode_step(
                gen_params, hidden, idle, idle.astype(bool), pool_kv, positions, tables,
                sampling_vecs=sampling_vectors(n_lanes, self.cfg.vocab_size),
            )
            if spec_k:
                self.paged_spec_verify_step(
                    gen_params, np.zeros((n_lanes, spec_k + 1), np.int64), pool_kv, positions, tables,
                    sampling_vecs=sampling_vectors(n_lanes, self.cfg.vocab_size),
                )
        longest = min(max_chunk, max_length)
        for bucket in chunk_buckets(longest):
            # the top bucket's chunk is the longest one (a lane may be
            # shorter than the bucket)
            chunk = torch.zeros(1, min(bucket, longest), self.hidden_size, dtype=self.compute_dtype)
            self.paged_mixed_step(hidden, pool_kv, positions, tables, chunk, 0, 0)

    # ------------------------------------------------------------- fingerprints

    def _fp_proj(self, with_fp: bool) -> Optional[torch.Tensor]:
        """The device projection a step with ``with_fp`` reads (uploaded
        before any capture), else None."""
        return fp_ops.device_projection(self.hidden_size, self.device) if with_fp else None

    def _keep_fp(self, res: tuple, n: int, chunk: bool = False) -> tuple:
        """Split a step's outputs: its first ``n`` and, behind them, the
        fused digests the step added when it ran with a projection, which
        are stashed for ``pop_step_fp`` (None when it ran without)."""
        extra = res[n:]
        self._last_step_fp = extra[0] if extra else None
        self._last_chunk_fp = extra[1] if chunk and extra else None
        return res[:n]

    def pop_step_fp(self) -> tuple:
        """Take (and clear) the last batched step's fused fingerprints:
        (lane digests [n_lanes, FP_DIM], chunk digest [FP_DIM]) tensors on
        the device, or Nones."""
        fp, chunk = self._last_step_fp, self._last_chunk_fp
        self._last_step_fp = self._last_chunk_fp = None
        return fp, chunk

    def _programs(self) -> tuple:
        """Every step program of this backend (Nones on the CPU)."""
        return (self._decode_program, self._mixed_program, self._gen_program, self._spec_program,
                self._dense_decode_program, self._dense_gen_program, self._lane_program, self._private_program,
                self._private_gen_program, self._forward_program)

    def step_program_stats(self) -> dict:
        """Captures, replays and post-warm-up captures (anomalies) of this
        backend's step programs, summed (zeros on the CPU)."""
        stats = {"graph_captures": 0, "graph_replays": 0, "graph_anomalies": 0}
        for prog in self._programs():
            if prog is not None:
                stats["graph_captures"] += prog.counts.captures
                stats["graph_replays"] += prog.counts.replays
                stats["graph_anomalies"] += prog.counts.anomalies
        return stats

    # ------------------------------------------------------------- server-side generation

    def _gen_embed(self, gen_params: dict, hidden, tokens, use_token) -> torch.Tensor:
        """Each lane's step input [n, 1, hidden] in compute_dtype: the
        embedding of its previous token where ``use_token``, else its
        ``hidden`` (petals_tpu casts the float32 embedding the same way)."""
        h = _as_tensor(hidden, self.device, self.compute_dtype)
        tokens = _as_tensor(tokens, self.device, torch.long)
        use_token = _as_tensor(use_token, self.device, torch.bool)
        emb = self.family.client_embed(gen_params, tokens[:, None], self.cfg).to(self.compute_dtype)
        return torch.where(use_token[:, None, None], emb, h)

    def _head_sample(self, gen_params: dict, hidden: torch.Tensor, samp: dict) -> torch.Tensor:
        """The float32 head over each row's last position, then
        ``sample_tokens``: [n] int64 on the device."""
        logits = self.family.client_head(gen_params, hidden[:, -1:], self.cfg)[:, -1, :]
        return sample_tokens(logits, **samp)

    def _sampling_inputs(self, sampling_vecs: dict, device=None) -> tuple:
        """A ``sampling_vectors`` dict as the generation step's inputs, in
        ``SAMPLING_INPUTS`` order (``u`` from its seeds and draw indices)."""
        samp = sampling_tensors(sampling_vecs, device)
        return tuple(samp[name] for name in SAMPLING_INPUTS)

    @torch.no_grad()
    def sample_from_hidden(self, gen_params: dict, last_hidden, sampling: Optional[dict] = None) -> np.ndarray:
        """The next token of each row [batch] int32 (on the host) from a
        span output [batch, seq, hidden]: greedy unless a validated
        ``sampling`` dict is given. A pooled stream's first token."""
        h = _as_tensor(last_hidden, self.device)
        samp = sampling_tensors(sampling_vectors(h.shape[0], self.cfg.vocab_size, sampling), self.device)
        return self._head_sample(gen_params, h, samp).to(torch.int32).cpu().numpy()

    @torch.no_grad()
    def paged_gen_decode_step(self, gen_params: dict, hidden, tokens, use_token, pool_kv, positions, tables,
                              *, sampling_vecs: dict):
        """One decode step over a set of lanes with the client's leaves in
        it, PAGED layout: generating lanes (``use_token``) feed the
        embedding of their previous token, decode lanes their ``hidden``;
        after the block loop the float32 head and ``sample_tokens`` pick
        every lane's next token. On a CUDA device a replay of its step
        program, on the CPU the block loop.

        Args:
          gen_params: the client's float32 leaves (embed, norm, head) on
            the backend's device.
          hidden: [n_lanes, 1, hidden] (generating and idle lanes: filler).
          tokens: [n_lanes] the generating lanes' previous tokens (others 0).
          use_token: bool [n_lanes].
          pool_kv / positions / tables: as in ``paged_decode_step``.
          sampling_vecs: per-lane settings, ``sampling_vectors``' layout.

        Returns (out [n_lanes, 1, hidden], next tokens [n_lanes] int64, both
        on the device, pool_kv).
        """
        inputs = (_as_tensor(hidden, None, self.compute_dtype), _as_tensor(tokens, None, torch.long),
                  _as_tensor(use_token, None, torch.bool), _as_tensor(positions, None, torch.int32),
                  _as_tensor(tables, None, torch.int32), *self._sampling_inputs(sampling_vecs))

        with_fp = fp_ops.enabled()
        proj = self._fp_proj(with_fp)

        def step(h, tok, use, pos, tab, *samp):
            out, toks = self._paged_gen_decode_eager(gen_params, h, tok, use, pool_kv, pos, tab, samp)
            return (out, toks) if proj is None else (out, toks, fp_ops.fingerprint_rows_torch(out[:, -1], proj))

        n_lanes, max_pages = inputs[4].shape
        key = step_program_key("gen_decode", n_lanes, max_pages, 0, self.quant_type, self.kv_quant_type, pool_kv,
                               extra=tuple(gen_params.values())) + (with_fp,)
        out, toks = self._keep_fp(_replay(self._gen_program, key, step, inputs), 2)
        return out, toks, pool_kv

    def _paged_gen_decode_eager(self, gen_params, hidden, tokens, use_token, pool_kv, positions, tables, samp):
        """The generation step launched op by op (what the CPU runs, and
        what its step program captures). ``samp``: the sampling inputs in
        ``SAMPLING_INPUTS`` order."""
        h = self._gen_embed(gen_params, hidden, tokens, use_token)
        h, _ = self._paged_decode_eager(h, pool_kv, positions, tables)
        samp = {name: _as_tensor(x, self.device) for name, x in zip(SAMPLING_INPUTS, samp)}
        return h, self._head_sample(gen_params, h, samp)

    @torch.no_grad()
    def paged_spec_verify_step(self, gen_params: dict, tokens, pool_kv, positions, tables, *,
                               sampling_vecs: dict):
        """One speculative verify step over the lane pool, PAGED layout (the
        JAX package's ``paged_spec_verify_step``): on a CUDA device a replay
        of its step program, on the CPU the block loop.

        Args:
          gen_params: the client's float32 leaves on the backend's device.
          tokens: [n_lanes, S] (S = spec_k + 1): column 0 each lane's last
            committed token, columns 1.. its drafts (other lanes: anything;
            their sentinel position drops every write).
          pool_kv: (k, v) page pools, updated IN PLACE (S rows a lane).
          positions: int32 [n_lanes], where column 0 is written; idle
            sentinel = max_pages * page_size.
          tables: int32 [n_lanes, max_pages] block tables (-1 unallocated).
          sampling_vecs: per-lane settings, ``sampling_vectors``' layout.
            Row j of a lane samples with the uniform of draw ``draw_idx +
            j`` of its seed (``ops/threefry.py``), or with ``u`` [n_lanes,
            S] where the caller drew them ahead.

        Returns (g_hat [n_lanes, S] int32, n_emit [n_lanes] int32, both on
        the device, pool_kv): lane i commits exactly g_hat[i, :n_emit[i]].
        Rollback is position truncation: rows past what a lane commits stay
        in its pages, masked by every later step's kv_length and written
        over as the lane advances."""
        tokens = _as_tensor(tokens, None, torch.long)
        n_lanes, S = tokens.shape
        vec = dict(sampling_vecs)
        if "u" not in vec:
            vec["u"] = sampling_uniforms(vec, S)
        inputs = (tokens, _as_tensor(positions, None, torch.int32), _as_tensor(tables, None, torch.int32),
                  *self._sampling_inputs(vec))

        with_fp = fp_ops.enabled()
        proj = self._fp_proj(with_fp)

        def step(tok, pos, tab, *samp):
            return self._paged_spec_verify_eager(gen_params, tok, pool_kv, pos, tab, samp, proj)

        key = step_program_key("spec_verify", n_lanes, inputs[2].shape[1], S, self.quant_type, self.kv_quant_type,
                               pool_kv, extra=tuple(gen_params.values())) + (with_fp,)
        g_hat, n_emit = self._keep_fp(_replay(self._spec_program, key, step, inputs), 2)
        return g_hat, n_emit, pool_kv

    def _paged_spec_verify_eager(self, gen_params, tokens, pool_kv, positions, tables, samp, proj=None):
        """The verify step launched op by op (what the CPU runs, and what
        its step program captures): the S rows of every lane embedded and
        run through the block loop at per-lane positions, the float32 head
        on every row, then for each row j the fed token joins the seen mask
        (plain decode adds each fed token before the next draw; row 0's is
        already there) and ``sample_tokens`` picks the target's token with
        uniform column j. Draft j (tokens column j) is accepted while it
        equals the token sampled on row j - 1 and every draft before it was
        accepted; a lane emits n_accept + 1 tokens, at most S. With
        ``proj`` it also returns each lane's digest of its last emitted
        row (the verify twin of decode's last-row digest)."""
        tokens = _as_tensor(tokens, self.device, torch.long)
        S = tokens.shape[1]
        h = self.family.client_embed(gen_params, tokens, self.cfg).to(self.compute_dtype)
        h, _ = self._paged_decode_eager(h, pool_kv, positions, tables)
        logits = self.family.client_head(gen_params, h, self.cfg)  # [n_lanes, S, vocab] float32
        samp = {name: _as_tensor(x, self.device) for name, x in zip(SAMPLING_INPUTS, samp)}
        u, seen = samp.pop("u"), samp.pop("seen_mask")
        vocab_ids = torch.arange(logits.shape[-1], device=self.device)[None, :]
        emitted = []
        for j in range(S):
            seen = seen | (vocab_ids == tokens[:, j : j + 1])
            emitted.append(sample_tokens(logits[:, j], seen_mask=seen, u=u[:, j], **samp))
        g_hat = torch.stack(emitted, dim=1)
        match = (tokens[:, 1:] == g_hat[:, :-1]).to(torch.int32)
        n_accept = torch.cumprod(match, dim=1).sum(dim=1)
        n_emit = (n_accept + 1).clamp(max=S)
        if proj is None:
            return g_hat.to(torch.int32), n_emit.to(torch.int32)
        last_idx = (n_emit - 1).clamp(0, S - 1)[:, None, None].expand(-1, 1, h.shape[-1])
        fp = fp_ops.fingerprint_rows_torch(h.gather(1, last_idx)[:, 0], proj)
        return g_hat.to(torch.int32), n_emit.to(torch.int32), fp

    @torch.no_grad()
    def batched_gen_decode_step(self, gen_params: dict, hidden, tokens, use_token, pool_kv, positions,
                                *, sampling_vecs: dict):
        """``paged_gen_decode_step`` on the DENSE lane pool (pool_kv and
        positions as in ``batched_decode_step``): on a CUDA device a replay
        of its step program (captured when the pool opens), on the CPU the
        block loop. Returns (out [n_lanes, 1, hidden], next tokens [n_lanes]
        int64, pool_kv)."""
        inputs = (_as_tensor(hidden, None, self.compute_dtype), _as_tensor(tokens, None, torch.long),
                  _as_tensor(use_token, None, torch.bool), _as_tensor(positions, None, torch.int32),
                  *self._sampling_inputs(sampling_vecs))

        with_fp = fp_ops.enabled()
        proj = self._fp_proj(with_fp)

        def step(h, tok, use, pos, *samp):
            h = self._gen_embed(gen_params, h, tok, use)
            h, _ = self._dense_decode_eager(h, pool_kv, pos)
            samp = {name: _as_tensor(x, self.device) for name, x in zip(SAMPLING_INPUTS, samp)}
            toks = self._head_sample(gen_params, h, samp)
            return (h, toks) if proj is None else (h, toks, fp_ops.fingerprint_rows_torch(h[:, -1], proj))

        key = dense_program_key("batched_gen_decode", 0, self.quant_type, pool_kv, with_fp,
                                extra=tuple(gen_params.values()))
        out, toks = self._keep_fp(_replay(self._dense_gen_program, key, step, inputs), 2)
        return out, toks, pool_kv

    @torch.no_grad()
    def generate_tokens(self, gen_params: dict, last_hidden, kv, position: int, n_tokens: int, *,
                        sampling: Optional[dict] = None, active_adapter: Optional[str] = None):
        """Generate ``n_tokens`` on a private DENSE cache from
        ``last_hidden`` (the span output of the last fed token): greedy, or
        sampled under a validated ``sampling`` dict. The first token comes
        from ``last_hidden``; each later one is fed at the next position
        before the one after it is picked, and the last is never fed (the
        client loop's convention), so the cache gains n_tokens - 1 rows.
        Each later token is one generation step (``_private_gen_eager``: the
        embedding of the previous token, the span's decode step, the float32
        head and the pick): on a CUDA device a replay of its step program
        (the JAX package's ``server_gen``), keyed like the private decode
        step. The previous token and the seen-token mask come from the last
        step's outputs on the card; the uniforms (computed on the host) are
        an input; one sync at the end. ``active_adapter`` names the LoRA
        adapter applied (part of the key). Returns (tokens [batch, n_tokens]
        int32 on the host, kv)."""
        params = self.params_for(active_adapter)
        k_stack, v_stack = kv
        batch, n_tokens, position = k_stack.shape[1], int(n_tokens), int(position)
        if position + n_tokens - 1 > k_stack.shape[2]:
            raise ValueError(
                f"Generating {n_tokens} tokens at position {position} overflows "
                f"the allocated cache ({k_stack.shape[2]} tokens)"
            )
        sampled = sampling is not None
        h_last = _as_tensor(last_hidden, self.device)
        samp = ()
        if sampled:
            vec = sampling_vectors(batch, self.cfg.vocab_size, sampling)
            # draw i of the stream is draw offset + i
            draws = vec["draw_idx"][:, None].astype(np.int64) + np.arange(n_tokens)
            us = torch.from_numpy(uniform_for_draw(vec["seeds"][:, None], draws))
            vec["u"] = us[:, 0].numpy()
            samp = self._sampling_inputs(vec)
            tok = self._head_sample(gen_params, h_last, dict(zip(SAMPLING_INPUTS, (
                _as_tensor(x, self.device) for x in samp))))
            seen = samp[SAMPLING_INPUTS.index("seen_mask")].to(self.device)
        else:
            tok = torch.argmax(self.family.client_head(gen_params, h_last[:, -1:], self.cfg)[:, -1, :], dim=-1)
        tokens = [tok]

        def step(tok, pos, *state):
            return self._private_gen_eager(gen_params, (k_stack, v_stack), tok, pos, state, params=params)

        key = dense_program_key("server_gen", 0, self.quant_type, (k_stack, v_stack), sampled, active_adapter,
                                extra=tuple(gen_params.values()))
        for i in range(1, n_tokens):
            pos = torch.tensor(position + i - 1, dtype=torch.int32)
            inputs = (tok, pos)
            if sampled:
                # the settings, the mask of tokens seen so far and this draw
                inputs += (*samp[:5], seen, us[:, i])
            outs = _replay(self._private_gen_program, key, step, inputs)
            tok = outs[0]
            if sampled:
                seen = outs[1]
            tokens.append(tok)
        return torch.stack(tokens, dim=1).to(torch.int32).cpu().numpy(), kv

    def _private_gen_eager(self, gen_params: dict, kv, tok, position, state=(), params=None):
        """One private generation step, launched op by op (what the CPU
        runs, and what its program captures): the previous token's float32
        embedding cast to the cache's type, the dense decode step at
        ``position`` (a 0-dim tensor), the float32 head over its output and
        the next token: argmax, or with ``state`` (the sampling inputs in
        ``SAMPLING_INPUTS`` order) ``sample_tokens`` after the fed token joins
        the seen-token mask. Returns (next token [batch],) or (next token,
        the updated mask)."""
        k_stack, v_stack = kv
        tok = _as_tensor(tok, self.device, torch.long)
        h = self.family.client_embed(gen_params, tok[:, None], self.cfg).to(k_stack.dtype)
        (h,) = self._dense_step_eager(h, k_stack, v_stack, position, 1, params=params)
        if not state:
            logits = self.family.client_head(gen_params, h[:, -1:], self.cfg)[:, -1, :]
            return (torch.argmax(logits, dim=-1),)
        samp = {name: _as_tensor(x, self.device) for name, x in zip(SAMPLING_INPUTS, state)}
        seen = samp["seen_mask"].clone()
        # the value is a tensor on the card: a Python True would be copied
        # from the host, which a capture refuses
        seen.index_put_((torch.arange(seen.shape[0], device=self.device), tok),
                        torch.ones((), dtype=torch.bool, device=self.device))
        samp["seen_mask"] = seen
        return self._head_sample(gen_params, h, samp), seen

    def _linear_max_chunk(self, batch: int) -> int:
        """The longest chunk whose activations fit ``max_chunk_size_bytes``
        (the linear sizing of ``chunk_plan``)."""
        per_token = batch * self.compute_dtype.itemsize * (
            2 * self.hidden_size + getattr(self.cfg, "intermediate_size", 4 * self.hidden_size)
            + self.cfg.num_attention_heads * self.head_dim
        )
        return max(self.max_chunk_size_bytes // max(per_token, 1), 1)

    def chunk_plan(self, batch: int, total_seq: int, page_size: Optional[int] = None,
                   start: int = 0) -> Sequence[int]:
        """Split a long prefill so each chunk's attention footprint stays under
        max_chunk_size_bytes. Where an attention kernel runs, the [chunk, kv]
        logits are never materialized, so the footprint is the chunk's
        activations, linear in its length; plain attention materializes the
        logits, quadratic in the sequence. ``page_size`` aligns chunk ENDS to
        absolute page boundaries (whole-page writes, a partial tail page only
        on the final chunk); ``start`` is the absolute position of the first
        token.

        The rule: linear sizing on a CUDA device for a paged prefill (the
        paged kernels always run there) and for a dense cache with
        ``use_flash``. The JAX package also asks that the cache length be a
        multiple of 128, because its TPU kernel takes no other and ``attend``
        then falls back to the materializing path; the CUDA kernel serves any
        buffer length and a CUDA tensor never falls back, so that condition
        has no counterpart here. On the CPU the plain versions run and the
        sizing is quadratic."""
        if total_seq <= 1:
            return [total_seq]
        if self.device.type == "cuda" and (page_size or self.use_flash):
            max_chunk = self._linear_max_chunk(batch)
        else:
            denom = max(batch * self.cfg.num_attention_heads * total_seq * 4, 1)
            max_chunk = max(self.max_chunk_size_bytes // denom, 1)
        chunks = []
        remaining = total_seq
        pos = int(start)
        while remaining > 0:
            step = min(max_chunk, remaining)
            if page_size and step < remaining:
                end = pos + step
                aligned = end - end % page_size
                if aligned > pos:
                    step = aligned - pos
            chunks.append(step)
            remaining -= step
            pos += step
        return chunks
