"""Where a decode step through a chain of two port servers spends its time,
on one NVIDIA GPU.

    python3 scripts/time_swarm_chain.py

Serves chip_smoke.py's 8 Mistral-7B-shaped bf16 blocks (random weights from
its seed) as phase 12 does: a port DHT bootstrap on 127.0.0.1, server A on
blocks [0, 4) and server B on [4, 8), reached through an identity-proving
connection pool at the addresses the directory holds, A's reply fed into B
at each step. Each setting below runs sessions of the given prompts and
then DECODE_STEPS decode steps each, after a warm-up session, and prints
the client's decode round trip (median, max), each hop's compute and queue
time as the servers report them (``step_meta``), the batcher's largest
batch, and the Ed25519 signatures made and checked in this process while
the steps ran:

- ``one process, announce 2 s, 2 sessions``: chip_smoke.py phase 12's
  setting (both servers and the client in this process);
- the same with an announce every 3600 s: no announce, and so no signing,
  while the steps run;
- the same with one session: no step waits on the other session's hop;
- ``two processes``: A and B each in a process of its own
  (``python -m petals_tpu_torch.cli.run_server``), announce every 3600 s,
  with two sessions and then one.

First it times one signature and one check of a 512-byte message with the
Ed25519 the identity uses (``cryptography`` where it is installed) and with
the pure-Python RFC 8032 copy. The signature counts are read only where the
identity uses the copy (``cryptography``'s classes cannot be wrapped).
Servers are given ``--throughput 1``: the probe is not what is timed. The
card's name and power limit are printed first; the last line is a JSON
object of every number.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402

HALF = smoke.SWARM_HALF
DECODE_STEPS = 64  # ~3 s of steps: a 2-second announce period falls inside
SETTINGS = (
    # (name, servers in their own processes, announce period s, prompts)
    ("one process, announce 2 s, 2 sessions", False, 2.0, smoke.SWARM_PROMPTS),
    ("one process, announce 3600 s, 2 sessions", False, 3600.0, smoke.SWARM_PROMPTS),
    ("one process, announce 3600 s, 1 session", False, 3600.0, smoke.SWARM_PROMPTS[:1]),
    ("two processes, announce 3600 s, 2 sessions", True, 3600.0, smoke.SWARM_PROMPTS),
    ("two processes, announce 3600 s, 1 session", True, 3600.0, smoke.SWARM_PROMPTS[:1]),
)
SIGNATURE_REPS = 20
START_TIMEOUT_S = 300.0


def count_signatures() -> dict:
    """Wrap the identity's Ed25519 sign and verify with counters of calls and
    seconds (only the pure-Python copy's classes can be wrapped)."""
    from petals_tpu_torch.dht import identity

    counts = {"sign": [0, 0.0], "verify": [0, 0.0]}
    for cls, name in ((identity.Ed25519PrivateKey, "sign"), (identity.Ed25519PublicKey, "verify")):
        if not cls.__module__.endswith("_ed25519_fallback"):
            return {}

        def timed(self, *args, _original=getattr(cls, name), _name=name):
            t0 = time.perf_counter()
            try:
                return _original(self, *args)
            finally:
                counts[_name][0] += 1
                counts[_name][1] += time.perf_counter() - t0

        setattr(cls, name, timed)
    return counts


def time_signatures() -> dict:
    """Median ms of one sign and one verify of a 512-byte message, with the
    Ed25519 the identity uses and with the pure-Python copy."""
    from petals_tpu_torch.dht import _ed25519_fallback as fallback
    from petals_tpu_torch.dht.identity import Ed25519PrivateKey

    message = bytes(range(256)) * 2
    result = {"implementation": Ed25519PrivateKey.__module__}
    for label, cls in (("used", Ed25519PrivateKey), ("fallback", fallback.Ed25519PrivateKey)):
        key = cls.generate()
        public = key.public_key()
        signs, checks = [], []
        for _ in range(SIGNATURE_REPS):
            t0 = time.perf_counter()
            sig = key.sign(message)
            t1 = time.perf_counter()
            public.verify(sig, message)  # raises on a bad signature
            signs.append(t1 - t0)
            checks.append(time.perf_counter() - t1)
        result[f"{label}_sign_ms"] = statistics.median(signs) * 1e3
        result[f"{label}_verify_ms"] = statistics.median(checks) * 1e3
    return result


def server_args(ckpt, peers, period, first):
    return [ckpt, "--host", "127.0.0.1", "--initial_peers", *peers, "--update_period", str(period),
            "--throughput", "1", "--first_block", str(first), "--num_blocks", str(HALF)]


async def connect_chain(peers, prefix, pool):
    """(rpc client, uids) of A and B, from the directory once both are ONLINE."""
    from petals_tpu_torch.data_structures import CHAIN_DELIMITER, make_uid
    from petals_tpu_torch.utils.dht_utils import compute_spans

    deadline = time.perf_counter() + START_TIMEOUT_S
    while True:
        infos, addr_book = await smoke._read_directory(peers, prefix, smoke.SPAN)
        spans = sorted(compute_spans(infos).items(), key=lambda item: item[1].start)
        if [(s.start, s.end) for _, s in spans] == [(0, HALF), (HALF, smoke.SPAN)]:
            break
        if time.perf_counter() > deadline:
            raise AssertionError(f"the directory holds {[(s.start, s.end) for _, s in spans]}")
        await asyncio.sleep(0.5)
    chain = []
    for pid, span in spans:
        client = await pool.get_addr(addr_book[pid])
        if await client.wait_authenticated() != pid:
            raise AssertionError("a server did not prove its announced peer id")
        chain.append((client, CHAIN_DELIMITER.join(make_uid(prefix, i) for i in range(span.start, span.end))))
    return chain


async def drive(chain, prompts, n_steps, seed, hsz):
    """Sessions through the chain; per decode step the client's round trip
    and each hop's (compute_s, queue_s) from its step_meta."""
    from petals_tpu_torch.rpc.serialization import deserialize_array, serialize_array

    gen = torch.Generator().manual_seed(seed)
    inputs = [
        [torch.randn(1, n, hsz, generator=gen).to(torch.bfloat16)]
        + [torch.randn(1, 1, hsz, generator=gen).to(torch.bfloat16) for _ in range(n_steps)]
        for n in prompts
    ]

    async def session(steps):
        streams = []
        for client, uids in chain:
            stream = await client.open_stream("ptu.inference")
            await stream.send({"uids": uids, "max_length": steps[0].shape[1] + n_steps, "batch_size": 1})
            if not (await stream.recv(timeout=120))["session_open"]:
                raise AssertionError("a chain session did not open")
            streams.append(stream)
        trips, hops = [], []
        for i, h in enumerate(steps):
            t0 = time.perf_counter()
            metas = []
            for stream in streams:
                await stream.send({"tensors": {"hidden": serialize_array(h)}})
                reply = await stream.recv(timeout=300)
                h = deserialize_array(reply["tensors"]["hidden"])
                metas.append((reply["step_meta"]["compute_s"], reply["step_meta"]["queue_s"]))
            if i:
                trips.append(time.perf_counter() - t0)
                hops.append(metas)
        if not torch.isfinite(h.float()).all():
            raise AssertionError("a chain reply is not finite")
        for stream in streams:
            await stream.end()
        return trips, hops

    results = await asyncio.gather(*(session(s) for s in inputs))
    return [t for r in results for t in r[0]], [m for r in results for m in r[1]]


async def timed_run(chain, prompts, counts, hsz):
    await drive(chain, (64,), 2, smoke.SEED + 5, hsz)  # warm-up
    for c in counts.values():
        c[0], c[1] = 0, 0.0
    t0 = time.perf_counter()
    trips, hops = await drive(chain, prompts, DECODE_STEPS, smoke.SEED + 12, hsz)
    window = time.perf_counter() - t0
    ms = lambda xs: [x * 1e3 for x in xs]  # noqa: E731
    return {
        "decode_round_trip_ms": {"median": statistics.median(ms(trips)), "max": max(ms(trips)), "n": len(trips)},
        "hop_compute_ms_median": [statistics.median(ms(h[k][0] for h in hops)) for k in range(len(chain))],
        "hop_queue_ms_median": [statistics.median(ms(h[k][1] for h in hops)) for k in range(len(chain))],
        "window_s": window,
        "signatures_in_window": {k: {"calls": c[0], "seconds": c[1]} for k, c in counts.items()},
    }


async def one_process(ckpt, period, prompts, counts):
    from petals_tpu_torch.cli.run_server import build_parser, build_server
    from petals_tpu_torch.dht import DHTNode, Identity
    from petals_tpu_torch.rpc.pool import ConnectionPool

    boot = await DHTNode.create(host="127.0.0.1")
    peers = [boot.own_addr.to_string()]
    pool, servers = ConnectionPool(identity=Identity.generate()), []
    try:
        for first in (0, HALF):
            server = build_server(build_parser().parse_args(server_args(ckpt, peers, period, first)))
            await server.start()
            servers.append(server)
        chain = await connect_chain(peers, servers[0].dht_prefix, pool)
        before = [dict(s.batcher.stats) for s in servers]
        result = await timed_run(chain, prompts, counts, servers[0].cfg.hidden_size)
        result["max_batch"] = [s.batcher.stats["max_batch"] for s in servers]
        result["batched_steps"] = [s.batcher.stats["batched_steps"] - b["batched_steps"] for s, b in zip(servers, before)]
        return result
    finally:
        for server in servers:
            await server.shutdown()
        await pool.close()
        await boot.shutdown()


async def two_processes(ckpt, period, prompts, counts, log_dir):
    from petals_tpu_torch.dht import DHTNode, Identity
    from petals_tpu_torch.rpc.pool import ConnectionPool
    from petals_tpu_torch.server.server import default_dht_prefix

    boot = await DHTNode.create(host="127.0.0.1")
    peers = [boot.own_addr.to_string()]
    pool, procs = ConnectionPool(identity=Identity.generate()), []
    env = dict(os.environ, PYTHONPATH=REPO)
    try:
        for first in (0, HALF):
            err = open(os.path.join(log_dir, f"server-{first}.log"), "w")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "petals_tpu_torch.cli.run_server", *server_args(ckpt, peers, period, first)],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=err, text=True,
            ))
        for proc in procs:  # each prints its address once it serves
            line = await asyncio.wait_for(asyncio.to_thread(proc.stdout.readline), START_TIMEOUT_S)
            if not line:
                raise AssertionError(f"a server process exited with {proc.wait()} (logs in {log_dir})")
        chain = await connect_chain(peers, default_dht_prefix(ckpt), pool)
        from petals_tpu_torch.server.from_pretrained import get_block_config

        return await timed_run(chain, prompts, counts, get_block_config(ckpt)[1].hidden_size)
    finally:
        await pool.close()
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
        for proc in procs:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        await boot.shutdown()


def main() -> int:
    if not torch.cuda.is_available():
        print("time_swarm_chain: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    smoke.log(smi)
    device = torch.device("cuda", 0)
    signatures = time_signatures()
    smoke.log(f"Ed25519 on one 512-byte message, median of {SIGNATURE_REPS}: the identity's "
              f"({signatures['implementation']}) signs in {signatures['used_sign_ms']:.3f} ms and verifies in "
              f"{signatures['used_verify_ms']:.3f} ms; the pure-Python copy signs in "
              f"{signatures['fallback_sign_ms']:.3f} ms and verifies in {signatures['fallback_verify_ms']:.3f} ms")
    counts = count_signatures()
    smoke.build()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    results = {}
    with tempfile.TemporaryDirectory(prefix="chain-ckpt-", dir=os.path.join(REPO, "build")) as ckpt:
        smoke.write_checkpoint(ckpt, device)
        log_dir = tempfile.mkdtemp(prefix="chain-logs-", dir=os.path.join(REPO, "build"))
        for name, separate, period, prompts in SETTINGS:
            t0 = time.perf_counter()
            if separate:
                result = asyncio.run(two_processes(ckpt, period, prompts, counts, log_dir))
            else:
                result = asyncio.run(one_process(ckpt, period, prompts, counts))
            smoke.free_card()
            trip = result["decode_round_trip_ms"]
            smoke.log(
                f"{name}: decode round trip median {trip['median']:.3f} ms, max {trip['max']:.3f} ms over "
                f"{trip['n']} steps; hop compute median {[round(x, 3) for x in result['hop_compute_ms_median']]} ms, "
                f"queue {[round(x, 3) for x in result['hop_queue_ms_median']]} ms; max batch "
                f"{result.get('max_batch', 'not read')}; signatures in this process over the "
                f"{result['window_s']:.2f} s of steps {result['signatures_in_window']} ({smi}); "
                f"setting done in {time.perf_counter() - t0:.1f} s")
            results[name] = result
    smoke.log(json.dumps({"device": smi, "signatures": signatures, "settings": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
