"""The port's ``run_server`` takes every flag of petals_tpu's, with the same
default, but the two that belong to multi-host serving (ROADMAP A14c); the
port's own extra is ``--device``."""

import pytest

from petals_tpu.cli.run_server import build_parser as jax_parser
from petals_tpu_torch.cli.run_server import build_parser as port_parser

A14_FLAGS = {"coordinator_address", "num_hosts"}


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


JAX_ACTIONS, PORT_ACTIONS = _actions(jax_parser()), _actions(port_parser())


@pytest.mark.parametrize("dest", sorted(set(JAX_ACTIONS) - A14_FLAGS))
def test_flag_exists_with_petals_tpu_default(dest):
    want, got = JAX_ACTIONS[dest], PORT_ACTIONS.get(dest)
    assert got is not None, f"--{dest} is missing from the port's run_server"
    assert got.default == want.default
    assert set(want.option_strings) <= set(got.option_strings)
    assert type(got) is type(want)  # store / store_true alike
    if want.choices is not None and dest not in ("dtype",):
        assert set(want.choices) <= set(got.choices)


def test_only_the_a14_flags_and_device_differ():
    assert set(JAX_ACTIONS) - set(PORT_ACTIONS) == A14_FLAGS
    assert set(PORT_ACTIONS) - set(JAX_ACTIONS) == {"device"}
