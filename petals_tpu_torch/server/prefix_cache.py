"""Cross-session radix prefix tree (petals_tpu/server/prefix_cache.py):
identical prompt prefixes across sessions skip their prefill compute.

A server receives a prefill as HIDDEN STATES, a deterministic function of
the prompt prefix for a fixed span, so a prefix is identified by a hash
CHAIN over fixed-size token segments: key_i = H(key_{i-1}, bytes of segment
i). Every key commits to its whole ancestry, so the chain IS a radix tree:
two prompts that share j segments share exactly keys[0..j), and each node
links to its parent and children along the chains it was stored under. A
session's prefill probes its chain for the longest cached path, seeds its KV,
computes only the tail, and stores the new segments as a fresh branch.
Nodes are content-addressed (same segment bytes, same KV), never keyed by
session state, so a rollback cannot poison the store.

Residency, as in the JAX package:

- **HBM**: a node's k/v also live on the device, either as a pinned
  copy-on-write page run in the batcher's paged pool (a pooled hit adopts
  the pages by table reference: zero bytes copied) or as device tensors
  (``kd``/``vd``). A device tensor is always a COPY (``.clone()``): a slice
  of a session's cache would alias a buffer that the memory cache hands to
  the next session and that step programs write by address.
- **host**: CPU tensors k/v/out within the cache's own byte budget
  (``max_bytes``); a hit uploads them into the session's cache.
- **swapped**: with the batcher's ``HostSwapPool`` (``swap_pool``), a node
  pushed out of the host budget is DEMOTED rather than dropped: its bytes
  move from the cache's budget to the swap pool's (``kind="cache"``, at
  most ``CACHE_SWAP_FRAC`` of it, so preemption always finds room) and it
  sheds its HBM residency; the tensors stay where they are. A hit promotes
  it back to the host tier.

Eviction is leaf-first: device refs drop before host bytes, and a victim is
the host-tier leaf of the tenant with the largest dominant-resource share
(``usage_fn``, the ledger's), then with the fewest hits, then the least
recent use (``policy="radix"``); it is demoted when the swap tier has room,
else removed. ``policy="lru"`` is the flat insertion-order baseline.
Interior nodes are never removed while a descendant survives. Each node
records the tenant that stored it, and the cache bills every tenant its
resident bytes (host, device, swapped and pinned pages) through the
ledger's cache-residency channel (``ledger.set_cache_rates``).

Trust model: the cache is shared across all clients of a server by default
(a client can time whether a prompt prefix was served recently); the
handler's ``prefix_share_scope="peer"`` folds the requesting peer's proven
id into the salt, so each client only hits its own entries.

Each ``stats`` event also counts into ``petals_prefix_cache_events_total``
by event (hit, miss, evict, device_evict, demote, promote, swap_evict; the
batcher counts adopt), as petals_tpu's cache counts them.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from petals_tpu_torch.telemetry import instruments as tm

logger = logging.getLogger(__name__)

SEGMENT_TOKENS = 128

# the cache may reserve at most this fraction of the HostSwapPool for demoted
# nodes: session preemption and the prefix cache share ONE budget, and a cold
# cache must never make a live session unswappable
CACHE_SWAP_FRAC = 0.5

# device-tier promotion threshold: a host-resident node must be hit this many
# times before maybe_promote_device uploads it (a one-off hit does not pay
# for an HBM slot; the second hit predicts a third)
PROMOTE_MIN_HITS = int(os.environ.get("PETALS_TPU_PROMOTE_MIN_HITS", "2"))


def resolve_device_bytes(prefix_cache_bytes: int, prefix_device_bytes: int) -> int:
    """The HBM tier's size: ``PETALS_TPU_RADIX_DEVICE_FRAC`` (a fraction of
    the host budget, clamped to [0, 1]) overrides the configured byte count,
    so operators retune the device/host split from the environment."""
    frac = os.environ.get("PETALS_TPU_RADIX_DEVICE_FRAC")
    if frac is None:
        return prefix_device_bytes
    try:
        f = min(max(float(frac), 0.0), 1.0)
    except ValueError:
        logger.warning(f"Ignoring malformed PETALS_TPU_RADIX_DEVICE_FRAC={frac!r}")
        return prefix_device_bytes
    return int(f * max(prefix_cache_bytes, 0))


def _host_bytes(x) -> np.ndarray:
    """The bytes of a payload as the client sent them, in its own dtype (a
    bfloat16 tensor through an int16 view: numpy has no bfloat16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def segment_keys(hidden, salt: str) -> List[str]:
    """Hash-chain keys for every FULL segment of ``hidden`` [1, seq, h]
    (a tensor or an array), over its exact bytes: blake2b keyed by the span
    salt, so spans never cross-pollute. The keys equal petals_tpu's for the
    same payload."""
    arr = _host_bytes(hidden)
    keys = []
    prev = salt.encode()
    for s in range(arr.shape[1] // SEGMENT_TOKENS):
        seg = np.ascontiguousarray(arr[:, s * SEGMENT_TOKENS : (s + 1) * SEGMENT_TOKENS])
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(seg.tobytes())
        prev = h.digest()
        keys.append(prev.hex())
    return keys


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class RadixPrefixCache:
    """Radix tree of per-segment (k, v, out) nodes with host and HBM
    residency.

    The node store is an ``OrderedDict`` keyed by chain hash (insertion and
    touch order double as the flat-LRU order of ``policy="lru"``); the tree
    rides on per-node ``parent``/``children`` links. Host entries are CPU
    tensors: k/v [n_blocks, 1, SEGMENT_TOKENS, hkv, d], out [1,
    SEGMENT_TOKENS, hidden]. The DEVICE tier (``device_max_bytes``) keeps
    hot nodes' k/v on ``device`` as well: a hit whose whole path is
    device-resident seeds the session without a host-to-device transfer.
    Device entries are an optimization only: eviction drops them, the host
    copy stays."""

    def __init__(
        self,
        max_bytes: int,
        device_max_bytes: int = 0,
        *,
        policy: str = "radix",
        swap_pool=None,  # memory_cache.HostSwapPool, shared with session swap
        usage_fn: Optional[Callable[[Optional[str]], float]] = None,  # tenant -> dominant share
        ledger=None,  # telemetry.ledger.ResourceLedger: cache-residency billing
        swap_frac: float = CACHE_SWAP_FRAC,
        device=None,  # where promoted entries go (None: the CPU)
    ):
        if policy not in ("radix", "lru"):
            raise ValueError(f"policy must be 'radix' or 'lru', got {policy!r}")
        self.max_bytes = max_bytes
        self.device_max_bytes = device_max_bytes
        self.policy = policy
        self.swap_pool = swap_pool
        self.usage_fn = usage_fn
        self.ledger = ledger
        self.swap_frac = float(swap_frac)
        self.device = torch.device(device if device is not None else "cpu")
        self._store: "OrderedDict[str, dict]" = OrderedDict()
        self._bytes = 0  # host tier (swapped nodes charge the swap pool instead)
        self._dev_bytes = 0
        self._swap_bytes = 0  # the cache's share of swap_pool.bytes_in_use
        self._tick = 0  # logical clock for recency scoring
        # called from the event loop AND worker threads (maybe_promote_device
        # uploads off-loop): every mutation holds the mutex; get_entries
        # returns plain references, which stay valid across a concurrent
        # eviction (dict pops only)
        self._mutex = threading.RLock()
        self.stats = {
            "hits": 0, "misses": 0, "hit_tokens": 0, "stored_segments": 0,
            "evictions": 0, "demotions": 0, "promotions": 0,
            "swap_evictions": 0, "device_evictions": 0,
        }

    @property
    def current_bytes(self) -> int:
        return self._bytes

    @property
    def swap_bytes(self) -> int:
        return self._swap_bytes

    # ------------------------------------------------------------------ probe

    def probe(self, keys: Sequence[str]) -> int:
        """Longest cached path (in segments). Touches every node on the path
        (hit count and recency: the counters eviction scores by) and
        promotes swapped nodes on it back to the host tier, demoting colder
        nodes to make room."""
        with self._mutex:
            self._tick += 1
            n = 0
            path: List[str] = []
            for key in keys:
                entry = self._store.get(key)
                if entry is None:
                    break
                entry["hits"] += 1
                entry["last_use"] = self._tick
                self._store.move_to_end(key)
                path.append(key)
                n += 1
            if n and self.policy == "radix" and self.swap_pool is not None:
                protect = frozenset(keys)
                for key in path:
                    self._promote_host(key, protect)
            if n:
                self.stats["hits"] += 1
                tm.PREFIX_HIT.inc()
                self.stats["hit_tokens"] += n * SEGMENT_TOKENS
            else:
                self.stats["misses"] += 1
                tm.PREFIX_MISS.inc()
            self._bill()
            return n

    def get_entries(self, keys: Sequence[str], n: int) -> List[dict]:
        """Entry references for segments [0, n). Callers on the event loop
        resolve these right after ``probe``, with no await between: a
        concurrent put()'s eviction only pops dict slots, so held references
        stay valid where a later lookup could raise KeyError."""
        with self._mutex:
            return [self._store[k] for k in keys[:n]]

    @staticmethod
    def concat_entries(entries: Sequence[dict]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Concatenate resolved entries along the token axis: k/v [n_blocks,
        1, n * SEGMENT_TOKENS, hkv, d], out [1, n * SEGMENT_TOKENS, hidden]."""
        k = torch.cat([e["k"] for e in entries], dim=2)
        v = torch.cat([e["v"] for e in entries], dim=2)
        out = torch.cat([e["out"] for e in entries], dim=1)
        return k, v, out

    def get_range(self, keys: Sequence[str], n: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """get_entries + concat_entries in one call (single-threaded users)."""
        return self.concat_entries(self.get_entries(keys, n))

    # ------------------------------------------------------------------- put

    def put(
        self, keys: Sequence[str], first: int,
        k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        k_dev: Optional[torch.Tensor] = None, v_dev: Optional[torch.Tensor] = None,
        pages: Optional[Sequence[int]] = None, pages_pool=None, pages_epoch: int = 0,
        tenant: Optional[str] = None,
    ) -> None:
        """Store segments [first, len(keys)) from span-shaped tensors
        covering them: k/v [n_blocks, 1, tokens, hkv, d] and out [1, tokens,
        hidden] on the host, whose token axis starts at segment ``first``.
        ``k_dev``/``v_dev``, when given, are the same token range on the
        device; a copy of each segment's slice populates the device tier.

        ``pages``/``pages_pool``/``pages_epoch``: page-granular sharing for a
        paged batcher. ``pages`` are PINNED page indices (pin_lane_pages)
        covering the same token range; each segment's run rides on its entry
        so a later hit can adopt_pages the prefix with zero copies. Ownership
        transfers here: every incoming page reference is attached to an entry
        or unpinned before put returns, and attached pins are unpinned on
        eviction, demotion or clear.

        ``tenant`` is the storing peer: its residency bills to it through
        the ledger, and eviction takes the dominant tenant's nodes first."""
        with self._mutex:
            self._put_locked(keys, first, k, v, out, k_dev, v_dev, pages, pages_pool, pages_epoch, tenant)
            self._bill()

    def _put_locked(self, keys, first, k, v, out, k_dev, v_dev, pages, pages_pool, pages_epoch, tenant) -> None:
        self._tick += 1
        spp = 0
        if pages is not None and pages_pool is not None and pages_pool.page_size:
            spp = SEGMENT_TOKENS // pages_pool.page_size  # pages per segment

        def unpin_from(seg: int) -> None:
            if spp and pages[seg * spp:]:
                pages_pool.unpin_pages(pages[seg * spp:], pages_epoch)

        protect = frozenset(keys)
        for i, key in enumerate(keys[first:]):
            t0, t1 = i * SEGMENT_TOKENS, (i + 1) * SEGMENT_TOKENS
            j = first + i  # absolute segment index along the chain
            seg_pages = list(pages[i * spp : (i + 1) * spp]) if spp else None
            if key in self._store:
                entry = self._store[key]
                self._store.move_to_end(key)
                entry["last_use"] = self._tick
                # a re-store is evidence of heat: a swapped node about to
                # regain HBM residency comes back to the host tier first
                # (a swapped node holds no device refs and no pins)
                if entry.get("swapped"):
                    self._promote_host(key, protect)
                if not entry.get("swapped"):
                    # a hot entry first stored host-only (a paged store, or
                    # after a device eviction) gains HBM residency on its
                    # next device-capable store
                    if t1 <= k.shape[2]:
                        self._attach_device(entry, k_dev, v_dev, t0, t1)
                    if seg_pages and not self._attach_pages(entry, seg_pages, pages_pool, pages_epoch):
                        pages_pool.unpin_pages(seg_pages, pages_epoch)
                elif seg_pages:
                    pages_pool.unpin_pages(seg_pages, pages_epoch)
                continue
            if t1 > k.shape[2]:
                unpin_from(i)
                break
            entry = {
                "k": k[:, :, t0:t1].clone(),
                "v": v[:, :, t0:t1].clone(),
                "out": out[:, t0:t1].clone(),
            }
            entry_bytes = sum(_nbytes(a) for a in entry.values())
            if entry_bytes > self.max_bytes:
                unpin_from(i)
                return  # a single segment over budget: nothing fits
            if not self._make_room(entry_bytes, protect):
                # budget full of unevictable nodes: stop the whole chain here,
                # or a deeper segment would be an unreachable orphan
                unpin_from(i)
                return
            entry["bytes"] = entry_bytes
            parent = keys[j - 1] if j > 0 else None
            parent_entry = self._store.get(parent) if parent is not None else None
            entry["parent"] = parent if parent_entry is not None else None
            entry["children"] = set()
            entry["depth"] = parent_entry["depth"] + 1 if parent_entry is not None else 0
            entry["tenant"] = tenant
            entry["hits"] = 0
            entry["last_use"] = self._tick
            entry["swapped"] = False
            if parent_entry is not None:
                parent_entry["children"].add(key)
            self._attach_device(entry, k_dev, v_dev, t0, t1)
            if seg_pages:
                self._attach_pages(entry, seg_pages, pages_pool, pages_epoch)
            self._store[key] = entry
            self._bytes += entry_bytes
            self.stats["stored_segments"] += 1

    # -------------------------------------------------------------- residency

    def _tenant_share(self, shares: Dict, tenant: Optional[str]) -> float:
        """The dominant-resource share of ``tenant``, cached in ``shares``
        for one victim search (0.0 without a usage_fn: victim order is then
        economics alone)."""
        if tenant not in shares:
            share = 0.0
            if self.usage_fn is not None:
                try:
                    share = float(self.usage_fn(tenant))
                except Exception as e:
                    logger.warning(f"prefix-cache usage_fn failed for {tenant!r}: {e}")
            shares[tenant] = share
        return shares[tenant]

    def _host_leaf(self, entry: dict) -> bool:
        """Host-resident with no host-resident child: the bottom of the host
        tier under this node, where demotion and eviction work upward from
        (never stranding a hotter descendant below a removed ancestor)."""
        if entry.get("swapped"):
            return False
        for c in entry["children"]:
            ce = self._store.get(c)
            if ce is not None and not ce.get("swapped"):
                return False
        return True

    def _pick_victim(self, protect: frozenset, skip: set) -> Optional[str]:
        """Leaf-first economics victim: among host-tier leaves, the node of
        the most dominant tenant, then the fewest hits, then the least
        recent use. Every node is one segment, so comparing hit counts
        compares prefill saved per byte held."""
        best_key = None
        best_rank = None
        shares: Dict = {}
        for key, entry in self._store.items():
            if key in protect or key in skip or not self._host_leaf(entry):
                continue
            rank = (-self._tenant_share(shares, entry.get("tenant")), entry["hits"], entry["last_use"])
            if best_rank is None or rank < best_rank:
                best_key, best_rank = key, rank
        return best_key

    def _make_room(self, need: int, protect: frozenset) -> bool:
        """Free host-tier bytes until ``need`` fits. The flat policy evicts
        in store (LRU) order; radix demotes leaf-first into the swapped tier
        and removes a node outright only when it cannot demote and has no
        surviving descendant."""
        if self._bytes + need <= self.max_bytes:
            return True
        if self.policy != "radix":
            while self._bytes + need > self.max_bytes and self._store:
                self._evict_node(next(iter(self._store)))
            return self._bytes + need <= self.max_bytes
        skip: set = set()
        while self._bytes + need > self.max_bytes:
            victim = self._pick_victim(protect, skip)
            if victim is None:
                return False
            if self._demote_node(victim, protect):
                continue
            if any(c in self._store for c in self._store[victim]["children"]):
                # an interior node over swapped children: removing it would
                # orphan them, and it cannot demote: look further
                skip.add(victim)
                continue
            self._evict_node(victim)
        return True

    def _demote_node(self, key: str, protect: frozenset) -> bool:
        """host -> swapped: move the node's byte charge from the cache's
        budget into the swap pool's (the tensors stay where they are: the
        tier is an accounting boundary) and shed its HBM residency."""
        entry = self._store[key]
        if self.swap_pool is None or not self._swap_reserve(entry["bytes"], protect):
            return False
        self._drop_device(entry)
        self._unpin_entry(entry)
        entry["swapped"] = True
        self._bytes -= entry["bytes"]
        self._swap_bytes += entry["bytes"]
        self.stats["demotions"] += 1
        tm.PREFIX_DEMOTE.inc()
        return True

    def _swap_reserve(self, nbytes: int, protect: frozenset) -> bool:
        """Reserve cache-tagged swap bytes, evicting the coldest swapped
        nodes to stay within the cache's fraction of the shared budget."""
        cap = int(self.swap_frac * self.swap_pool.max_size_bytes)
        if nbytes > cap:
            return False
        while True:
            # the reservation belongs to the demoted node: _promote_host and
            # _evict_node free it
            if self._swap_bytes + nbytes <= cap and self.swap_pool.try_reserve(nbytes, kind="cache"):
                return True
            victim = self._pick_swapped_victim(protect)
            if victim is None:
                return False
            self._evict_node(victim)
            self.stats["swap_evictions"] += 1
            tm.PREFIX_SWAP_EVICT.inc()

    def _pick_swapped_victim(self, protect: frozenset) -> Optional[str]:
        """The coldest childless swapped node (the swapped tier's eviction
        order); ``protect`` keeps the chain being probed or stored."""
        best_key = None
        best_rank = None
        shares: Dict = {}
        for key, entry in self._store.items():
            if not entry.get("swapped") or key in protect:
                continue
            if any(c in self._store for c in entry["children"]):
                continue
            rank = (-self._tenant_share(shares, entry.get("tenant")), entry["hits"], entry["last_use"])
            if best_rank is None or rank < best_rank:
                best_key, best_rank = key, rank
        return best_key

    def _promote_host(self, key: str, protect: frozenset) -> bool:
        """swapped -> host on a hit: free the swap reservation and charge the
        cache's budget again, demoting colder nodes to make room. A failure
        is benign: the node still serves, from the swapped tier."""
        entry = self._store.get(key)
        if entry is None or not entry.get("swapped"):
            return False
        if not self._make_room(entry["bytes"], protect):
            return False
        self.swap_pool.free(entry["bytes"], kind="cache")
        self._swap_bytes -= entry["bytes"]
        entry["swapped"] = False
        self._bytes += entry["bytes"]
        self.stats["promotions"] += 1
        tm.PREFIX_PROMOTE.inc()
        return True

    def maybe_promote_device(self, keys: Sequence[str], n: int) -> int:
        """host -> HBM for hot hit-path nodes: upload k/v of every node on
        ``keys[:n]`` hit at least PROMOTE_MIN_HITS times that lacks device
        refs. The handler calls this OFF the event loop after a host-tier
        hit, so that the next session with this prefix seeds from the
        device. Returns the number promoted."""
        if self.device_max_bytes <= 0 or self.policy != "radix":
            return 0
        promoted = 0
        for key in list(keys[:n]):
            with self._mutex:
                entry = self._store.get(key)
                if entry is None or entry.get("swapped") or "kd" in entry or entry["hits"] < PROMOTE_MIN_HITS:
                    continue
                k_host, v_host = entry["k"], entry["v"]
            # the uploads run OUTSIDE the mutex: a concurrent probe must not
            # stall behind a host-to-device copy
            kd = k_host.to(self.device, copy=True)
            vd = v_host.to(self.device, copy=True)
            with self._mutex:
                entry = self._store.get(key)
                if entry is None or "kd" in entry or entry.get("swapped"):
                    continue
                dev_bytes = _nbytes(kd) + _nbytes(vd)
                if dev_bytes > self.device_max_bytes:
                    continue
                self._evict_device(self.device_max_bytes - dev_bytes)
                entry["kd"], entry["vd"] = kd, vd
                entry["dev_bytes"] = dev_bytes
                self._dev_bytes += dev_bytes
                promoted += 1
                self.stats["promotions"] += 1
                tm.PREFIX_PROMOTE.inc()
        if promoted:
            with self._mutex:
                self._bill()
        return promoted

    # ------------------------------------------------------------ device tier

    def _attach_device(self, entry: dict, k_dev, v_dev, t0: int, t1: int) -> None:
        """Keep a copy of the [t0, t1) token slice of the device tensors on
        ``entry`` (no-op without device tensors, budget, or when already
        resident)."""
        if k_dev is None or self.device_max_bytes <= 0 or "kd" in entry:
            return
        dev_bytes = 2 * _nbytes(k_dev[:, :, t0:t1])
        if dev_bytes <= self.device_max_bytes:
            self._evict_device(self.device_max_bytes - dev_bytes)
            entry["kd"] = k_dev[:, :, t0:t1].clone()
            entry["vd"] = v_dev[:, :, t0:t1].clone()
            entry["dev_bytes"] = dev_bytes
            self._dev_bytes += dev_bytes

    def _attach_pages(self, entry: dict, seg_pages, pool, epoch: int) -> bool:
        """Attach a pinned page run to ``entry``. Replaces a stale-epoch run;
        returns False when the entry already holds a live one (the caller
        unpins the incoming duplicate)."""
        if "pages" in entry:
            if entry.get("pages_epoch") == getattr(pool, "page_epoch", -1):
                return False
            self._unpin_entry(entry)  # stale epoch: the pins died with the pool
        entry["pages"] = list(seg_pages)
        entry["pages_pool"] = pool
        entry["pages_epoch"] = epoch
        return True

    def _unpin_entry(self, entry: dict) -> None:
        """Release an entry's page pins back to its batcher. A reset batcher
        ignores stale-epoch unpins; a closed one has no pins left to drop."""
        pages = entry.pop("pages", None)
        pool = entry.pop("pages_pool", None)
        epoch = entry.pop("pages_epoch", 0)
        if pages and pool is not None:
            pool.unpin_pages(pages, epoch)

    def _drop_device(self, entry: dict) -> None:
        """Drop one entry's device copies (the host copy stays)."""
        dev = entry.pop("dev_bytes", 0)
        if dev:
            entry.pop("kd", None)
            entry.pop("vd", None)
            self._dev_bytes -= dev
            self.stats["device_evictions"] += 1
            tm.PREFIX_DEVICE_EVICT.inc()

    def _evict_device(self, target_bytes: int) -> None:
        """Drop device copies until the tier fits ``target_bytes``; host
        copies stay, so this only downgrades hits. Flat policy drops
        oldest-first (store order); radix coldest-first."""
        if self._dev_bytes <= target_bytes:
            return
        entries = list(self._store.values())
        if self.policy == "radix":
            entries.sort(key=lambda e: (e["hits"], e["last_use"]))
        for entry in entries:
            if self._dev_bytes <= target_bytes:
                break
            self._drop_device(entry)

    # -------------------------------------------------------------- eviction

    def _evict_node(self, key: str) -> None:
        """Remove a node outright, releasing its HBM residency and its byte
        charge, and detach it from the tree."""
        entry = self._store.pop(key)
        self._drop_device(entry)
        self._unpin_entry(entry)
        if entry.get("swapped"):
            self.swap_pool.free(entry["bytes"], kind="cache")
            self._swap_bytes -= entry["bytes"]
        else:
            self._bytes -= entry["bytes"]
        parent = self._store.get(entry.get("parent"))
        if parent is not None:
            parent["children"].discard(key)
        self.stats["evictions"] += 1
        tm.PREFIX_EVICT.inc()

    def clear(self) -> None:
        """Drop every node (stats are kept: they describe the lifetime)."""
        with self._mutex:
            for entry in self._store.values():
                self._unpin_entry(entry)
                if entry.get("swapped") and self.swap_pool is not None:
                    self.swap_pool.free(entry["bytes"], kind="cache")
            self._store.clear()
            self._bytes = 0
            self._dev_bytes = 0
            self._swap_bytes = 0
            self._bill()

    # ------------------------------------------------------------------ views

    def worth_storing(
        self, keys: Sequence[str], first: int, est_entry_bytes: int,
        device_capable: bool = False, pages_pool=None,
    ) -> bool:
        """Whether a store pass would add anything (callers skip the
        device-to-host snapshot otherwise):

        - at least one novel key whose single entry fits the budget; or
        - ``device_capable`` and a key that lacks device refs; or
        - ``pages_pool`` given and a key without a live page run in THAT
          pool at its current epoch (a pool reset kills pins; the re-store
          re-pins them).
        """
        if est_entry_bytes > self.max_bytes:
            return False
        with self._mutex:
            tail = keys[first:]
            if any(k not in self._store for k in tail):
                return True
            if device_capable and self.device_max_bytes > 0:
                if any("kd" not in self._store[k] and not self._store[k].get("swapped") for k in tail):
                    return True
            if pages_pool is not None and getattr(pages_pool, "page_size", None):
                epoch = getattr(pages_pool, "page_epoch", -1)
                for k in tail:
                    entry = self._store[k]
                    if entry.get("swapped"):
                        continue
                    if (
                        entry.get("pages") is None
                        or entry.get("pages_pool") is not pages_pool
                        or entry.get("pages_epoch") != epoch
                    ):
                        return True
            return False

    def _bill(self) -> None:
        """Push each tenant's resident bytes (host, device, swapped, pinned
        pages) to the ledger as its new cache-residency rate. Called under
        the mutex at the end of every mutating operation."""
        if self.ledger is None:
            return
        by_tenant: Dict[Optional[str], float] = {}
        for entry in self._store.values():
            nbytes = entry["bytes"] + entry.get("dev_bytes", 0)
            pages = entry.get("pages")
            if pages:
                nbytes += len(pages) * int(getattr(entry.get("pages_pool"), "page_nbytes", 0) or 0)
            tenant = entry.get("tenant")
            by_tenant[tenant] = by_tenant.get(tenant, 0.0) + nbytes
        try:
            self.ledger.set_cache_rates(by_tenant)
        except Exception as e:
            logger.warning(f"prefix-cache ledger billing failed: {e}")

    def summary(self) -> dict:
        """petals_tpu's summary keys."""
        with self._mutex:
            page_bytes = 0
            swapped = 0
            max_depth = 0
            for e in self._store.values():
                if e.get("swapped"):
                    swapped += 1
                pages = e.get("pages")
                if pages:
                    page_bytes += len(pages) * int(getattr(e.get("pages_pool"), "page_nbytes", 0) or 0)
                max_depth = max(max_depth, e.get("depth", 0))
            return {
                "policy": self.policy,
                "segments": len(self._store),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "host_segments": len(self._store) - swapped,
                "swap_segments": swapped,
                "swap_bytes": self._swap_bytes,
                "device_segments": sum(1 for e in self._store.values() if "kd" in e),
                "device_bytes": self._dev_bytes,
                "device_max_bytes": self.device_max_bytes,
                "page_segments": sum(1 for e in self._store.values() if "pages" in e),
                "page_bytes": page_bytes,
                "hbm_bytes": self._dev_bytes + page_bytes,
                "max_depth": max_depth,
                **self.stats,
            }


# the handler constructs ``PrefixCache``; the radix tree IS the prefix cache,
# with the flat behaviour behind policy="lru"
PrefixCache = RadixPrefixCache
