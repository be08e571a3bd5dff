"""The other two long chaos campaigns on the port alone
(tests/torch_chaos_parity.py ``check_on_port``; tests/test_torch_chaos_long.py
has the first two). A file of their own, so the test runner's workers
share the four."""

import pytest

from torch_chaos_parity import LONG, check_on_port, daemons


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    yield from daemons(tmp_path_factory, pkgs=("port",))


@pytest.mark.parametrize("name", LONG[::3])  # manager-failover, session-reconnect-storm
def test_the_long_campaign_passes_on_the_port(port, name):
    check_on_port(port, name)
