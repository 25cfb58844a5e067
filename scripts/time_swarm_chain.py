"""Where a decode step through a chain of two port servers spends its time,
on one NVIDIA GPU.

    python3 scripts/time_swarm_chain.py [--only SUBSTRING]

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

Then the port's own client (``petals_tpu_torch.client``) generates
CLIENT_NEW greedy tokens from chip_smoke.py's 300-token prompt over the same
chain, on a sibling of the checkpoint whose config says 8 layers, with the
servers announcing every 2 s as in the smoke:

- ``port client, one process``: chip_smoke.py phase 13's layout (both
  servers on a loop thread of this process, the client on its own);
- ``port client, two processes``: A and B each in a process of its own.

For these it prints the per-token round trip the client sees (median,
max), the time to the first token and the client's embed and head time a
token. ``--only`` runs the settings whose name holds the substring.

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
CLIENT_SETTINGS = (
    # (name, servers in their own processes)
    ("port client, one process", False),
    ("port client, two processes", True),
)
CLIENT_NEW = 64
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
            "--throughput", "1", *span_args(first)]


def span_args(first):
    return ["--first_block", str(first), "--num_blocks", str(HALF)]


def start_server_processes(ckpt, peers, period, log_dir):
    """A and B, each ``python -m petals_tpu_torch.cli.run_server`` in a
    process of its own; returns once each has printed its address."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = []
    for first in (0, HALF):
        err = open(os.path.join(log_dir, f"server-{first}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "petals_tpu_torch.cli.run_server", *server_args(ckpt, peers, period, first)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=err, text=True,
        ))
    return procs


async def wait_for_servers(procs, log_dir):
    for proc in procs:  # each prints its address once it serves
        line = await asyncio.wait_for(asyncio.to_thread(proc.stdout.readline), START_TIMEOUT_S)
        if not line:
            raise AssertionError(f"a server process exited with {proc.wait()} (logs in {log_dir})")


def stop_server_processes(procs):
    for proc in procs:
        proc.send_signal(signal.SIGTERM)
    for proc in procs:
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


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
    try:
        procs = start_server_processes(ckpt, peers, period, log_dir)
        await wait_for_servers(procs, log_dir)
        chain = await connect_chain(peers, default_dht_prefix(ckpt), pool)
        from petals_tpu_torch.server.from_pretrained import get_block_config

        return await timed_run(chain, prompts, counts, get_block_config(ckpt)[1].hidden_size)
    finally:
        await pool.close()
        stop_server_processes(procs)
        await boot.shutdown()


def client_generate(model, rec):
    """CLIENT_NEW greedy tokens from a seeded CLIENT_PROMPT-token prompt,
    checked for its length; the recorded session's numbers."""
    gen = torch.Generator().manual_seed(smoke.SEED + 13)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, smoke.CLIENT_PROMPT), generator=gen).numpy()
    out = model.generate(prompt, max_new_tokens=CLIENT_NEW)
    if out.shape != (1, smoke.CLIENT_PROMPT + CLIENT_NEW):
        raise AssertionError(f"the client generated {out.shape}")
    return [(rec.sessions[-1], "greedy", out, smoke.CLIENT_PROMPT)]


def client_numbers(rec, streams):
    ms = lambda xs: [x * 1e3 for x in xs]  # noqa: E731
    trips = ms(streams[0][0]["step_s"][1:])
    return {
        "decode_round_trip_ms": {"median": statistics.median(trips), "max": max(trips), "n": len(trips)},
        "ttft_ms": rec.ttft_s[0] * 1e3,
        "embed_ms_median": statistics.median(ms(rec.embed_s)),
        "head_ms_median": statistics.median(ms(rec.head_s)),
    }


def client_two_processes(ckpt, device, smi, log_dir):
    """The port client in this process, A and B in processes of their own."""
    from petals_tpu_torch.client import AutoDistributedModelForCausalLM
    from petals_tpu_torch.client.runtime import SwarmRuntime
    from petals_tpu_torch.dht import DHTNode, Identity
    from petals_tpu_torch.rpc.pool import ConnectionPool
    from petals_tpu_torch.server.server import default_dht_prefix

    loop = SwarmRuntime()  # the bootstrap's loop; the client runs its own
    boot, procs = None, []
    try:
        boot = loop.run(DHTNode.create(host="127.0.0.1"), smoke.LOOP_TIMEOUT_S)
        peers = [boot.own_addr.to_string()]
        procs = start_server_processes(ckpt, peers, smoke.SWARM_UPDATE_PERIOD, log_dir)
        pool = ConnectionPool(identity=Identity.generate())
        try:
            loop.run(wait_for_servers(procs, log_dir), START_TIMEOUT_S + 60)
            loop.run(connect_chain(peers, default_dht_prefix(ckpt), pool), START_TIMEOUT_S + 60)
        finally:
            loop.run(pool.close(), smoke.LOOP_TIMEOUT_S)
        model = AutoDistributedModelForCausalLM.from_pretrained(ckpt, initial_peers=peers, device=device)
        try:
            rec = smoke.ClientRecorder(model)
            # a warm-up at the measured prompt's length: a fresh server
            # process pays its first-call costs (cuBLAS plans, module loads)
            # on the first chunk of each shape
            model.generate(torch.randint(0, model.cfg.vocab_size, (1, smoke.CLIENT_PROMPT)).numpy(), max_new_tokens=2)
            for record in (rec.sessions, rec.embed_s, rec.head_s, rec.ttft_s):
                record.clear()
            return client_numbers(rec, client_generate(model, rec))
        finally:
            model.close()
    finally:
        stop_server_processes(procs)
        if boot is not None:
            loop.run(boot.shutdown(), smoke.LOOP_TIMEOUT_S)
        loop.shutdown()


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--only", default="", help="run only the settings whose name holds this substring")
    only = parser.parse_args().only
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
            if only not in name:
                continue
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
        cut = smoke.cut_checkpoint(ckpt, os.path.join(ckpt, f"mistral-7b-{smoke.SPAN}-layers"), smoke.SPAN)
        for name, separate in CLIENT_SETTINGS:
            if only not in name:
                continue
            t0 = time.perf_counter()
            if separate:
                result = client_two_processes(cut, device, smi, log_dir)
            else:
                rec, streams, _, _ = smoke.drive_client(name, cut, device, smi, [span_args(0), span_args(HALF)],
                                                        client_generate)
                result = client_numbers(rec, streams)
            smoke.free_card()
            trip = result["decode_round_trip_ms"]
            smoke.log(
                f"{name}: per-token round trip the client sees median {trip['median']:.3f} ms, max "
                f"{trip['max']:.3f} ms over {trip['n']} steps; time to the first token {result['ttft_ms']:.1f} ms; "
                f"client embed {result['embed_ms_median']:.3f} ms, head {result['head_ms_median']:.3f} ms a token "
                f"({smi}); setting done in {time.perf_counter() - t0:.1f} s")
            results[name] = result
    smoke.log(json.dumps({"device": smi, "signatures": signatures, "settings": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
