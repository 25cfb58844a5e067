"""Swarm health monitor (the port's copy of petals_tpu/utils/health.py): the
in-framework analogue of health.petals.dev, with the reachability API and
the integrity canary prober.

``HealthMonitor`` joins the swarm as a query-only DHT client, discovers hosted
models from the ptu.models registry (utils/dht_utils.declare_model), and
serves a minimal dependency-free HTTP API:

  GET /api/v1/state                    — full swarm snapshot (JSON)
  GET /api/v1/metrics                  — swarm-wide telemetry aggregate: per-server
                                         digests (tok/s, TTFT/step percentiles, swap
                                         pressure from ServerInfo.telemetry) plus
                                         swarm totals
  GET /api/v1/is_reachable/<peer_hex>  — dial-back probe of a peer's announced
                                         contact address (the reachability API)
  GET /                                — human-readable coverage table

``canary_probe`` replays a seeded golden input (``ptu.probe``) against
every replica of each multi-replica span and quarantines fingerprint
outliers by quorum (telemetry/integrity.py), whatever package the replicas
run: a petals_tpu server and a port server of one span answer the same
probe with digests held to the same tolerance.

Run it with ``python -m petals_tpu_torch.cli.run_health --initial_peers ...``.
"""

from __future__ import annotations

import asyncio
import html
import json
import logging
import time
from typing import Dict, Optional

from petals_tpu_torch.data_structures import PeerID, ServerState, make_uid
from petals_tpu_torch.dht.node import DHTNode
from petals_tpu_torch.ops import fingerprint as fp_ops
from petals_tpu_torch.telemetry.flight import FlightRecorder
from petals_tpu_torch.telemetry.integrity import CanaryProber, get_quarantine
from petals_tpu_torch.utils.asyncio_utils import log_exception_callback
from petals_tpu_torch.utils.dht_utils import compute_spans, get_remote_module_infos, list_models

logger = logging.getLogger(__name__)


def _f(value, default: float = 0.0) -> float:
    """Best-effort float: announce digests come from OTHER servers (possibly
    older versions, possibly hostile) — a malformed field must degrade to the
    default, never poison the whole aggregate row."""
    try:
        return float(value)
    except (TypeError, ValueError):
        return default


def _i(value, default: int = 0) -> int:
    try:
        return int(float(value))
    except (TypeError, ValueError, OverflowError):
        return default


def _d(value) -> dict:
    return value if isinstance(value, dict) else {}


def integrity_quorum(servers: dict) -> list:
    """Announce-level integrity quorum over one model's server rows: replicas
    of the SAME span whose self-probe ``digest_hex`` disagrees with a strict
    majority of their span-mates are suspects.

    Exact hex comparison — same golden seed, same blocks, same weights must
    digest identically on homogeneous replicas. On heterogeneous fleets
    (mixed accelerators, mixed quantization) the tolerance-based canary
    prober is authoritative; this rollup only surfaces candidates, it never
    quarantines on its own."""
    by_span: Dict[tuple, Dict[str, str]] = {}
    for peer, s in servers.items():
        integ = _d(s.get("integrity"))
        digest = integ.get("self_digest")
        blocks = s.get("blocks")
        if not digest or not isinstance(blocks, (list, tuple)) or len(blocks) != 2:
            continue
        key = (tuple(blocks), integ.get("fp_seed"), s.get("quant_type"))
        by_span.setdefault(key, {})[peer] = str(digest)
    suspects = []
    for _span, digests in by_span.items():
        if len(digests) < 3:
            continue  # no strict majority possible — nothing attributable
        counts: Dict[str, int] = {}
        for d in digests.values():
            counts[d] = counts.get(d, 0) + 1
        majority_digest, majority_n = max(counts.items(), key=lambda kv: kv[1])
        if majority_n * 2 > len(digests):
            suspects.extend(
                peer for peer, d in digests.items() if d != majority_digest
            )
    return sorted(suspects)


class HealthMonitor:
    def __init__(
        self,
        initial_peers,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        update_period: float = 15.0,
        canary_period: float = 0.0,
    ):
        self.initial_peers = list(initial_peers)
        self.host, self._requested_port = host, port
        self.update_period = update_period
        # integrity canary cadence; 0 disables the probe loop
        self.canary_period = canary_period
        self.dht: Optional[DHTNode] = None
        self._http: Optional[asyncio.AbstractServer] = None
        self._refresh_task: Optional[asyncio.Task] = None
        self._canary_task: Optional[asyncio.Task] = None
        self._canary_round = 0
        self._canary_reports: list = []
        self._state: dict = {"updated_at": None, "models": {}}
        self._addr_book: dict = {}
        # divergence evidence of the canary rounds
        self._flight = FlightRecorder()

    @property
    def port(self) -> int:
        assert self._http is not None, "monitor not started"
        return self._http.sockets[0].getsockname()[1]

    async def start(self) -> None:
        self.dht = await DHTNode.create(initial_peers=self.initial_peers, client_mode=True)
        await self.refresh()
        self._refresh_task = asyncio.create_task(self._refresh_loop())
        self._refresh_task.add_done_callback(
            log_exception_callback(logger, "health refresh loop")
        )
        if self.canary_period > 0:
            self._canary_task = asyncio.create_task(self._canary_loop())
            self._canary_task.add_done_callback(
                log_exception_callback(logger, "canary probe loop")
            )
        self._http = await asyncio.start_server(self._serve_http, self.host, self._requested_port)
        logger.info(f"Health monitor at http://{self.host}:{self.port}/")

    async def stop(self) -> None:
        for task in (self._refresh_task, self._canary_task):
            if task is None:
                continue
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        self._refresh_task = self._canary_task = None
        if self._http is not None:
            self._http.close()
            await self._http.wait_closed()
        if self.dht is not None:
            await self.dht.shutdown()

    # ------------------------------------------------------------------ state

    async def refresh(self) -> dict:
        models = await list_models(self.dht)
        snapshot: Dict[str, dict] = {}
        for prefix, meta in sorted(models.items()):
            num_blocks = meta["num_blocks"]
            uids = [make_uid(prefix, i) for i in range(num_blocks)]
            infos, addr_book = await get_remote_module_infos(self.dht, uids)
            self._addr_book.update(addr_book)
            spans = compute_spans(infos, min_state=ServerState.JOINING)
            covered = [info is not None and any(
                s.state == ServerState.ONLINE for s in info.servers.values()
            ) for info in infos]
            servers = {}
            for peer_id, span in spans.items():
                info = span.server_info
                servers[peer_id.to_string()] = {
                    "state": info.state.name,
                    "blocks": [span.start, span.end],
                    "throughput": info.throughput,
                    "inference_rps": info.inference_rps,
                    "cache_tokens_left": info.cache_tokens_left,
                    "version": info.version,
                    "quant_type": info.quant_type,
                    "public_name": info.public_name,
                    # disaggregated serving phase tier (None/absent on
                    # pre-tier servers renders as generalist)
                    "phase_tier": getattr(info, "phase_tier", None),
                    "relayed": bool(getattr(self._addr_book.get(peer_id), "relayed", False)),
                    # lane-pool / scheduler occupancy (busy lanes, free pages,
                    # suspended sessions, swap bytes, preemptions) — lets
                    # operators and clients spot loaded servers at a glance
                    "pool": info.pool,
                    # compact telemetry digest (tok/s over the announce window,
                    # TTFT/step percentiles, swap bytes, failure counters) —
                    # the per-server input to the /api/v1/metrics aggregate
                    "telemetry": info.telemetry,
                    # compiled-program observatory digest (programs, compile
                    # seconds, anomalies): nonzero anomalies = the server is
                    # recompiling in steady state
                    "compile_stats": info.compile_stats,
                    # integrity observatory digest (self-probe fingerprint hex
                    # + quarantine flag): replicas of the same span announcing
                    # different self-digests are quorum suspects
                    "integrity": getattr(info, "integrity", None),
                }
            snapshot[prefix] = {
                "public_name": meta.get("public_name"),
                "model_type": meta.get("model_type"),
                "num_blocks": num_blocks,
                "blocks_covered": sum(covered),
                "healthy": all(covered),
                "servers": servers,
            }
        self._state = {"updated_at": time.time(), "models": snapshot}
        return self._state

    async def _refresh_loop(self) -> None:
        while True:
            await asyncio.sleep(self.update_period)
            try:
                await self.refresh()
            except Exception as e:
                logger.warning(f"Health refresh failed: {e}")

    # ------------------------------------------------------------ canary

    async def canary_probe(self, *, tokens: int = 4) -> list:
        """One integrity canary round: replay a seeded golden input
        (``ptu.probe``) against every replica of each multi-replica span
        and quarantine fingerprint outliers by quorum
        (telemetry.integrity.CanaryProber). The seed varies per round so a
        corrupting replica cannot replay a previously honest digest.
        Returns the per-span reports (also kept, bounded, on the monitor)."""
        self._canary_round += 1
        seed = (fp_ops.fp_seed() * 1_000_003 + self._canary_round) & 0x7FFFFFFF
        reports = []
        for prefix, model in self._state["models"].items():
            # digests only compare within one (span, quant) group: different
            # blocks digest differently by construction, and quantization
            # sets the tolerance regime
            groups: Dict[tuple, list] = {}
            for peer, s in (model.get("servers") or {}).items():
                if str(s.get("state")).upper() != "ONLINE":
                    continue
                blocks = s.get("blocks") or []
                if len(blocks) != 2:
                    continue
                groups.setdefault(
                    (int(blocks[0]), int(blocks[1]), s.get("quant_type")), []
                ).append(peer)
            for (start, end, quant), peers in sorted(groups.items()):
                if len(peers) < 2:
                    continue  # nothing to compare against
                digests: Dict[str, list] = {}
                for peer in peers:
                    try:
                        digests[peer] = await self._probe_peer(
                            peer, seed=seed, tokens=tokens
                        )
                    except Exception as e:
                        logger.debug(f"canary probe failed on {peer}: {e}")
                        digests[peer] = None
                prober = CanaryProber(
                    lambda p, _fb, _nb: digests.get(p), quarantine=get_quarantine(), flight=self._flight,
                )
                report = prober.probe_span(
                    (start, end - start), peers, quant=str(quant or "none")
                )
                report["model"] = prefix
                report["round"] = self._canary_round
                reports.append(report)
        self._canary_reports = (self._canary_reports + reports)[-64:]
        return reports

    async def _probe_peer(self, peer_str: str, *, seed: int, tokens: int) -> list:
        peer_id = PeerID.from_string(peer_str)
        addr = self._addr_book.get(peer_id)
        if addr is None:
            raise RuntimeError("no announced address")
        client = await self.dht.pool.get_addr(addr)
        reply = await asyncio.wait_for(
            client.call("ptu.probe", {"seed": seed, "tokens": tokens}), 10.0
        )
        return list(reply["fp"])

    async def _canary_loop(self) -> None:
        while True:
            await asyncio.sleep(self.canary_period)
            try:
                await self.canary_probe()
            except Exception as e:
                logger.warning(f"Canary round failed: {e}")

    async def is_reachable(self, peer_hex: str) -> dict:
        """Dial-back probe: can WE open (and authenticate) a connection to the
        peer's announced contact address right now?"""
        try:
            peer_id = PeerID.from_string(peer_hex)
        except Exception:
            return {"ok": False, "error": "bad peer id"}
        addr = self._addr_book.get(peer_id)
        if addr is None:
            return {"ok": False, "error": "no announced address"}
        try:
            client = await self.dht.pool.get_addr(addr)
            await asyncio.wait_for(client.call("dht.ping", {}), 5.0)
            return {"ok": True, "addr": addr.to_string(), "relayed": addr.relayed}
        except Exception as e:
            return {"ok": False, "addr": addr.to_string(), "error": str(e)}

    def metrics_summary(self) -> dict:
        """Swarm-wide telemetry rollup over the last refresh snapshot.

        Throughputs (tok/s, tokens, swap bytes, failure counts) SUM across
        servers; latency percentiles take the worst server (max) — a mean of
        p99s is statistically meaningless and hides the straggler that is
        actually hurting tail latency."""
        per_model: Dict[str, dict] = {}
        for prefix, model in self._state["models"].items():
            servers = {}
            agg = {
                "tok_s": 0.0,
                "tokens_total": 0,
                "ttft_p99_ms_max": None,
                "step_p99_ms_max": None,
                "swap_out_bytes": 0,
                "swap_in_bytes": 0,
                "preemptions": 0,
                "alloc_failed": 0,
                "lanes": 0,
                "busy_lanes": 0,
                "servers_reporting": 0,
                "compiled_programs": 0,
                "compile_anomalies": 0,
                "compile_s": 0.0,
                # resource-ledger rollup: swarm totals plus the merged
                # top-consumer table across every server's announced digest
                "ledger_page_s": 0.0,
                "ledger_compute_s": 0.0,
                "ledger_sessions": 0,
                "noisy_neighbor_events": 0,
                "top_consumers": [],
                # integrity observatory rollup: servers announcing their own
                # quarantine, plus announce-level quorum suspects (replicas
                # of one span whose self-probe digests disagree)
                "quarantined_servers": 0,
                "integrity_suspects": [],
                # disaggregated serving rollup: per-tier replica counts and
                # the swarm's prefill->decode handoff volume (bytes + the
                # announce-window bytes/s rate), summed from the digests
                "tiers": {"generalist": 0, "prefill": 0, "decode": 0},
                "handoff_bytes": 0,
                "handoff_bytes_s": 0.0,
            }
            consumers: Dict[str, dict] = {}
            for peer, s in model["servers"].items():
                # Per-field tolerant folding: older servers announce digests
                # missing newer keys (ledger, compile_stats), and a hostile
                # peer can announce garbage types. Each field degrades to its
                # zero/None independently — the server's row is ALWAYS kept,
                # and one bad field never poisons the rest of the aggregate.
                digest = s.get("telemetry")
                pool = _d(s.get("pool"))
                agg["lanes"] += _i(pool.get("lanes"))
                agg["busy_lanes"] += _i(pool.get("busy_lanes"))
                compile_stats = s.get("compile_stats")
                if isinstance(compile_stats, dict):
                    agg["compiled_programs"] += _i(compile_stats.get("programs"))
                    agg["compile_anomalies"] += _i(compile_stats.get("anomalies"))
                    agg["compile_s"] += _f(compile_stats.get("compile_s"))
                integ = _d(s.get("integrity"))
                if integ.get("quarantined"):
                    agg["quarantined_servers"] += 1
                tier = s.get("phase_tier")
                tier = tier if tier in ("prefill", "decode") else "generalist"
                agg["tiers"][tier] += 1
                servers[peer] = {
                    "public_name": s.get("public_name"),
                    "blocks": s.get("blocks"),
                    "phase_tier": tier,
                    "telemetry": digest,
                    "pool": pool or None,
                    "compile_stats": compile_stats,
                    "integrity": integ or None,
                }
                if not isinstance(digest, dict):
                    continue
                agg["servers_reporting"] += 1
                agg["tok_s"] += _f(digest.get("tok_s"))
                agg["tokens_total"] += _i(digest.get("tokens_total"))
                agg["swap_out_bytes"] += _i(digest.get("swap_out_bytes"))
                agg["swap_in_bytes"] += _i(digest.get("swap_in_bytes"))
                agg["preemptions"] += _i(digest.get("preemptions"))
                agg["alloc_failed"] += _i(digest.get("alloc_failed"))
                agg["handoff_bytes"] += _i(digest.get("handoff_bytes"))
                agg["handoff_bytes_s"] = round(
                    agg["handoff_bytes_s"] + _f(digest.get("handoff_bytes_s")), 1
                )
                for src, dst in (("ttft_p99_ms", "ttft_p99_ms_max"),
                                 ("step_p99_ms", "step_p99_ms_max")):
                    value = digest.get(src)
                    if isinstance(value, (int, float)) and not isinstance(value, bool):
                        prev = agg[dst]
                        agg[dst] = value if prev is None else max(prev, value)
                ledger = _d(digest.get("ledger"))
                if ledger:
                    agg["ledger_page_s"] += _f(ledger.get("page_s"))
                    agg["ledger_compute_s"] += _f(ledger.get("compute_s"))
                    agg["ledger_sessions"] += _i(ledger.get("sessions"))
                    agg["noisy_neighbor_events"] += _i(ledger.get("noisy"))
                    top = ledger.get("top")
                    for entry in top if isinstance(top, (list, tuple)) else []:
                        try:
                            tenant, share, page_s = entry[0], float(entry[1]), float(entry[2])
                        except (TypeError, ValueError, IndexError):
                            continue
                        row = consumers.setdefault(
                            str(tenant), {"page_s": 0.0, "share_max": 0.0, "servers": 0}
                        )
                        row["page_s"] = round(row["page_s"] + page_s, 3)
                        row["share_max"] = max(row["share_max"], share)
                        row["servers"] += 1
            agg["integrity_suspects"] = integrity_quorum(model["servers"])
            agg["top_consumers"] = sorted(
                ({"peer": tenant, **row} for tenant, row in consumers.items()),
                key=lambda r: -r["page_s"],
            )[:10]
            agg["occupancy"] = (agg["busy_lanes"] / agg["lanes"]) if agg["lanes"] else None
            per_model[prefix] = {"aggregate": agg, "servers": servers}
        summary = {"updated_at": self._state["updated_at"], "models": per_model}
        try:
            summary["integrity"] = {
                "canary_rounds": self._canary_round,
                "reports": self._canary_reports[-10:],
                "quarantined": get_quarantine().snapshot(),
            }
        except Exception:
            pass  # the rollup must not die on the observatory
        return summary

    # ------------------------------------------------------------------ http

    async def _serve_http(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            request_line = await asyncio.wait_for(reader.readline(), 10.0)
            parts = request_line.decode("latin-1").split()
            path = parts[1] if len(parts) >= 2 else "/"
            while True:  # drain headers
                line = await asyncio.wait_for(reader.readline(), 10.0)
                if line in (b"\r\n", b"\n", b""):
                    break
            if path == "/api/v1/state":
                body, ctype = json.dumps(self._state, indent=2).encode(), "application/json"
                status = "200 OK"
            elif path == "/api/v1/metrics":
                body = json.dumps(self.metrics_summary(), indent=2).encode()
                ctype, status = "application/json", "200 OK"
            elif path.startswith("/api/v1/is_reachable/"):
                result = await self.is_reachable(path.rsplit("/", 1)[1])
                body, ctype = json.dumps(result).encode(), "application/json"
                status = "200 OK"
            elif path == "/":
                body, ctype = self._render_html().encode(), "text/html; charset=utf-8"
                status = "200 OK"
            else:
                body, ctype, status = b"not found", "text/plain", "404 Not Found"
            writer.write(
                f"HTTP/1.0 {status}\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode() + body
            )
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError):
            pass
        finally:
            writer.close()

    def _render_html(self) -> str:
        rows = []
        for prefix, model in self._state["models"].items():
            status = "✅ healthy" if model["healthy"] else (
                f"⚠️ {model['blocks_covered']}/{model['num_blocks']} blocks"
            )
            rows.append(
                f"<h2>{html.escape(model.get('public_name') or prefix)} "
                f"<small>({model['num_blocks']} blocks, {html.escape(str(model.get('model_type')))}"
                f")</small> — {status}</h2><table border=1 cellpadding=4>"
                "<tr><th>server</th><th>state</th><th>tier</th><th>blocks</th><th>throughput</th>"
                "<th>cache tokens left</th><th>load</th><th>tok/s</th><th>p99 TTFT</th>"
                "<th>swap</th><th>handoff</th><th>frag</th><th>compiled</th><th>integrity</th>"
                "<th>quant</th><th>via relay</th></tr>"
            )
            suspects = set(integrity_quorum(model["servers"]))
            for peer, s in model["servers"].items():
                pool = s.get("pool") if isinstance(s.get("pool"), dict) else None
                if pool:
                    load = f"{pool.get('busy_lanes', 0)}/{pool.get('lanes', 0)} lanes"
                    if pool.get("suspended"):
                        load += f", {pool['suspended']} swapped"
                    if pool.get("pages_free") is not None:
                        load += f", {pool['pages_free']} pages free"
                else:
                    load = "—"
                digest = s.get("telemetry") if isinstance(s.get("telemetry"), dict) else {}
                tok_s = digest.get("tok_s")
                tok_s_cell = f"{tok_s:.1f}" if isinstance(tok_s, (int, float)) else "—"
                ttft = digest.get("ttft_p99_ms")
                ttft_cell = f"{ttft:.0f} ms" if isinstance(ttft, (int, float)) else "—"
                swap_bytes = _i(digest.get("swap_out_bytes")) + _i(digest.get("swap_in_bytes"))
                swap_cell = f"{swap_bytes / 2**20:.1f} MiB" if swap_bytes else "—"
                tier = s.get("phase_tier")
                tier_cell = html.escape(str(tier)) if tier in ("prefill", "decode") else "generalist"
                handoff_bytes = _i(digest.get("handoff_bytes"))
                handoff_rate = _f(digest.get("handoff_bytes_s"))
                handoff_cell = (
                    f"{handoff_bytes / 2**20:.1f} MiB ({handoff_rate / 2**10:.0f} KiB/s)"
                    if handoff_bytes
                    else "—"
                )
                frag = digest.get("frag")
                frag_cell = f"{frag:.2f}" if isinstance(frag, (int, float)) else "—"
                cs = s.get("compile_stats") if isinstance(s.get("compile_stats"), dict) else {}
                if cs:
                    compiled_cell = f"{_i(cs.get('programs'))}p"
                    anomalies = _i(cs.get("anomalies"))
                    if anomalies:
                        compiled_cell += f" / ⚠️ {anomalies} anomalies"
                else:
                    compiled_cell = "—"
                integ = s.get("integrity") if isinstance(s.get("integrity"), dict) else {}
                if integ.get("quarantined"):
                    integrity_cell = "🚫 quarantined"
                elif peer in suspects:
                    integrity_cell = "⚠️ digest outlier"
                elif integ.get("self_digest"):
                    integrity_cell = f"✅ <code>{html.escape(str(integ['self_digest'])[:8])}</code>"
                else:
                    integrity_cell = "—"
                throughput = s.get("throughput")
                throughput_cell = (
                    f"{throughput:.1f}"
                    if isinstance(throughput, (int, float)) and not isinstance(throughput, bool)
                    else "—"
                )
                blocks = s.get("blocks") or ["?", "?"]
                rows.append(
                    f"<tr><td><code>{peer[:12]}…</code> {html.escape(s.get('public_name') or '')}</td>"
                    f"<td>{html.escape(str(s.get('state')))}</td><td>{tier_cell}</td>"
                    f"<td>[{blocks[0]}, {blocks[1]})</td>"
                    f"<td>{throughput_cell}</td><td>{s.get('cache_tokens_left')}</td>"
                    f"<td>{html.escape(load)}</td>"
                    f"<td>{tok_s_cell}</td><td>{ttft_cell}</td><td>{swap_cell}</td>"
                    f"<td>{handoff_cell}</td>"
                    f"<td>{frag_cell}</td><td>{compiled_cell}</td><td>{integrity_cell}</td>"
                    f"<td>{html.escape(str(s.get('quant_type')))}</td><td>{'yes' if s.get('relayed') else 'no'}</td></tr>"
                )
            rows.append("</table>")
        updated = self._state["updated_at"]
        return (
            "<!doctype html><title>petals_tpu swarm health</title>"
            "<h1>petals_tpu swarm health</h1>"
            f"<p>updated {time.strftime('%H:%M:%S', time.localtime(updated)) if updated else 'never'}"
            f" · <a href='/api/v1/state'>JSON</a> · <a href='/api/v1/metrics'>metrics</a></p>"
            + "".join(rows or ["<p>no models announced</p>"])
        )
