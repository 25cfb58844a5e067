"""The port's ``run_server`` takes every flag of petals_tpu's, with the same
default, multi-host serving's ``--coordinator_address`` and ``--num_hosts``
included; the port's own extra is ``--device``. Its ``run_worker`` takes
every flag of petals_tpu's ``run_worker`` with the same default, and
``--device`` besides."""

import argparse
import unittest.mock as mock

import pytest

from petals_tpu.cli.run_server import build_parser as jax_parser
from petals_tpu_torch.cli.run_server import build_parser as port_parser
from petals_tpu_torch.cli.run_worker import build_parser as port_worker_parser

A14_FLAGS = set()  # every flag of petals_tpu's run_server is ported


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


class _Captured(Exception):
    pass


def _jax_worker_parser() -> argparse.ArgumentParser:
    """petals_tpu's run_worker builds its parser inside ``main()``: the
    parser is caught at its ``parse_args``, before anything runs."""
    from petals_tpu.cli import run_worker

    seen = {}

    def capture(self, *args, **kwargs):
        seen["parser"] = self
        raise _Captured

    with mock.patch.object(argparse.ArgumentParser, "parse_args", capture):
        with pytest.raises(_Captured):
            run_worker.main()
    return seen["parser"]


JAX_ACTIONS, PORT_ACTIONS = _actions(jax_parser()), _actions(port_parser())
JAX_WORKER, PORT_WORKER = _actions(_jax_worker_parser()), _actions(port_worker_parser())


def _same_flag(want, got, dest):
    assert got is not None, f"--{dest} is missing from the port's parser"
    assert got.default == want.default
    assert set(want.option_strings) <= set(got.option_strings)
    assert type(got) is type(want)  # store / store_true alike
    assert got.required == want.required
    if want.choices is not None and dest not in ("dtype",):
        assert set(want.choices) <= set(got.choices)


@pytest.mark.parametrize("dest", sorted(set(JAX_ACTIONS) - A14_FLAGS))
def test_flag_exists_with_petals_tpu_default(dest):
    _same_flag(JAX_ACTIONS[dest], PORT_ACTIONS.get(dest), dest)


def test_only_the_a14_flags_and_device_differ():
    assert set(JAX_ACTIONS) - set(PORT_ACTIONS) == A14_FLAGS == set()
    assert set(PORT_ACTIONS) - set(JAX_ACTIONS) == {"device"}


@pytest.mark.parametrize("dest", sorted(JAX_WORKER))
def test_run_worker_flag_exists_with_petals_tpu_default(dest):
    _same_flag(JAX_WORKER[dest], PORT_WORKER.get(dest), dest)


def test_run_worker_adds_only_device():
    assert set(PORT_WORKER) - set(JAX_WORKER) == {"device"}
    assert set(JAX_WORKER) - set(PORT_WORKER) == set()
