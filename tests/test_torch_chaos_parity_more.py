"""The other four short chaos campaigns run on both packages
(tests/torch_chaos_parity.py ``check_campaign``): the same verdicts
expectation by expectation, the same steps per action, latencies within
their bounds. A file of their own, so the test runner's workers share the
nine."""

import pytest

from torch_chaos_parity import SHORT, check_campaign, daemons


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    yield from daemons(tmp_path_factory)


@pytest.mark.parametrize("name", SHORT[5:])
def test_the_campaign_gives_the_reference_s_verdicts(pair, name):
    check_campaign(pair, name)
