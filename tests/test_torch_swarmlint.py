"""swarmlint (petals_tpu.analysis) over the port: every rule but the two
that only mean something under jax (``tracer-safety``, ``no-untracked-jit``)
finds nothing in petals_tpu_torch/ that a pragma with a reason does not
suppress, the interprocedural passes included."""

import os

import pytest

from petals_tpu.analysis import ALL_RULE_NAMES, check_project, unsuppressed

import petals_tpu_torch

PACKAGE_DIR = os.path.dirname(petals_tpu_torch.__file__)
JAX_ONLY = ("tracer-safety", "no-untracked-jit")
PORT_RULES = [r for r in ALL_RULE_NAMES if r not in JAX_ONLY]


@pytest.fixture(scope="module")
def project_findings():
    return check_project([PACKAGE_DIR], rules=PORT_RULES)


def _show(findings):
    return "\n".join(f"{os.path.relpath(f.path, PACKAGE_DIR)}:{f.line} [{f.rule}] {f.message}" for f in findings)


@pytest.mark.parametrize("rule", PORT_RULES)
def test_port_has_no_unsuppressed_finding(project_findings, rule):
    bad = [f for f in unsuppressed(project_findings) if f.rule == rule]
    assert not bad, _show(bad)


def test_every_pragma_gives_its_reason(project_findings):
    suppressed = [f for f in project_findings if f.suppressed]
    assert suppressed  # the ownership transfers and the pool-wide reset are annotated
    assert all(f.suppress_reason.strip() for f in suppressed), _show([f for f in suppressed if not f.suppress_reason])


def test_ensure_open_cancelled_in_its_warm_up_warms_again(tmp_path):
    """C15: a pool whose step-program warm-up is cancelled is not published:
    its memory goes back to the budget, and the next ensure_open allocates
    and warms again (before the repair the cancelled pool counted as open
    with its programs never captured)."""
    import asyncio

    import torch

    from petals_tpu_torch.server.server import Server
    from tests.utils import make_tiny_llama

    path = make_tiny_llama(str(tmp_path / "model"), n_layers=2)
    server = Server(path, first_block=0, num_blocks=2, device="cpu", compute_dtype=torch.float32, throughput=1.0,
                    batch_lanes=2, batch_max_length=64, page_size=16, prefix_cache_bytes=0)
    server.identity = None
    server._load_span()
    batcher = server.batcher
    warms = []

    async def scenario():
        started, release = asyncio.Event(), asyncio.Event()

        async def stub_warm(pool_kv):
            warms.append(pool_kv)
            started.set()
            if len(warms) == 1:
                await release.wait()  # cancelled here

        batcher._warm_programs = stub_warm
        server.queue.start()
        try:
            opening = asyncio.create_task(batcher.ensure_open())
            await started.wait()
            assert batcher.memory_cache.bytes_left < batcher.memory_cache.max_size_bytes  # allocated
            opening.cancel()
            with pytest.raises(asyncio.CancelledError):
                await opening
            assert batcher._handles is None and batcher._pages is None  # never published
            assert batcher.memory_cache.bytes_left == batcher.memory_cache.max_size_bytes  # released
            await batcher.ensure_open()
            assert batcher._handles is not None and len(warms) == 2  # warmed again
            await batcher.close()
        finally:
            server.queue.shutdown()

    asyncio.run(scenario())
