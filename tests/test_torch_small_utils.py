"""The port's small utilities against petals_tpu's: the wire skeleton of
``pack_args_kwargs`` (torch tensors as the arrays), the shared constants,
``sample_up_to``, ``shield_and_wait`` and the logger names."""

import asyncio
import logging
import random

import numpy as np
import pytest
import torch

from petals_tpu import constants as jconst
from petals_tpu.utils import packaging as jpack
from petals_tpu.utils import random_utils as jrand
from petals_tpu_torch import constants as pconst
from petals_tpu_torch.utils import asyncio_utils, misc
from petals_tpu_torch.utils import logging as plog
from petals_tpu_torch.utils import packaging as ppack
from petals_tpu_torch.utils import random_utils as prand

CASES = [
    ((1, "a"), {}),
    ((np.arange(3),), {"k": None, "flag": True}),
    (([np.ones(2), (np.zeros(1), 2.5)],), {"nested": {"x": 4, "y": [b"raw", np.eye(2)]}}),
    ((), {"only": (np.arange(4), np.arange(5), {"deep": [np.zeros(3)]})}),
]


@pytest.mark.parametrize("index", range(len(CASES)))
def test_pack_skeleton_equals_petals_tpu(index):
    args, kwargs = CASES[index]
    j_arrays, j_struct = jpack.pack_args_kwargs(*args, **kwargs)
    def convert(obj):
        if isinstance(obj, np.ndarray):
            return torch.from_numpy(obj)
        if isinstance(obj, tuple):
            return tuple(convert(v) for v in obj)
        if isinstance(obj, list):
            return [convert(v) for v in obj]
        if isinstance(obj, dict):
            return {k: convert(v) for k, v in obj.items()}
        return obj

    p_arrays, p_struct = ppack.pack_args_kwargs(*convert(args), **convert(kwargs))
    assert p_struct == j_struct
    assert all(isinstance(a, torch.Tensor) for a in p_arrays)
    assert [a.numpy().tolist() for a in p_arrays] == [np.asarray(a).tolist() for a in j_arrays]
    back_args, back_kwargs = ppack.unpack_args_kwargs(p_arrays, p_struct)
    assert ppack.pack_args_kwargs(*back_args, **back_kwargs)[1] == p_struct
    with pytest.raises(ValueError):
        ppack.unpack_args_kwargs(p_arrays[:-1] if p_arrays else [torch.zeros(1)], p_struct)


def test_pack_refuses_what_petals_tpu_refuses():
    for bad in ({"__tensor__": 1}, object()):
        with pytest.raises((TypeError, ValueError)):
            jpack.pack_args_kwargs(bad)
        with pytest.raises((TypeError, ValueError)):
            ppack.pack_args_kwargs(bad)


def test_constants_and_dtypes():
    for name in ("SAFE_INDEX", "SAFE_SINGLE", "BIN_INDEX", "BIN_SINGLE", "PUBLIC_INITIAL_PEERS", "REACHABILITY_API_URL"):
        assert getattr(pconst, name) == getattr(jconst, name)
    assert sorted(pconst.DTYPE_MAP) == sorted(jconst.DTYPE_MAP)
    assert pconst.DTYPE_NAMES[torch.bfloat16] == "bfloat16"
    assert misc.dtype_bytes(torch.bfloat16) == 2 and misc.dtype_bytes(np.float32) == 4
    assert misc.dtype_bytes(torch.zeros(1, dtype=torch.int8)) == 1
    assert misc.is_dummy(misc.DUMMY) and not misc.is_dummy(np.zeros(2))


@pytest.mark.parametrize("k", [0, 2, 5, 9])
def test_sample_up_to_draws_as_petals_tpu(k):
    population = list(range(7))
    random.seed(11)
    want = jrand.sample_up_to(population, k)
    random.seed(11)
    assert prand.sample_up_to(population, k) == want


def test_shield_and_wait_finishes_then_reraises():
    done = []

    async def work():
        await asyncio.sleep(0.05)
        done.append(True)
        return 1

    async def scenario():
        task = asyncio.create_task(asyncio_utils.shield_and_wait(work()))
        await asyncio.sleep(0.01)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task

    asyncio.run(scenario())
    assert done == [True]  # the inner work ran to its end


def test_loggers_are_the_ports():
    assert plog.get_logger("x").name == "petals_tpu_torch.x"
    assert plog.get_logger("petals_tpu_torch.server").name == "petals_tpu_torch.server"
    assert logging.getLogger("petals_tpu_torch").propagate  # records reach the root until a CLI sets up logs
