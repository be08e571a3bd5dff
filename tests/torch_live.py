"""A live port daemon with its local API, for the reference's HTTP, SDK and
CLI tests run on the port (tests/torch_ref_tests.py ``port_tests``).

``port_host`` (module scope, autouse where imported) makes every port
``Server`` of the module bind 127.0.0.1 (``TPUD_LISTEN_HOST``, which the
daemons the module spawns inherit too), and every reference ``Server`` as
well, puts the port on its mock GPUs
(eight H100 SXM) and stubs the outside probes (no socket to a public
address, no provider lookup, no subprocess of the host checks).
``live_server`` is the port's twin of tests/conftest.py:125-142: a
``Server`` on the mock, port 0, no TLS, ``network-latency`` disabled; it
overrides conftest's fixture in a module that imports it.

``REF_TO_PORT`` are the (reference, port) text pairs a reference test
module needs to speak about the port: the mock's environment variable, the
injector's fields and flags, component, gauge and catalog names (the Xid
analogs of tests/test_torch_daemon_slice.py: Xid 79 for a lost chip, Xid
48, a double-bit ECC error, for an uncorrectable HBM error), the kmsg line
the injector writes, and ``tpu_info``, which is ``gpu_info`` with one
entry per GPU.
"""

from __future__ import annotations

import logging

import pytest

from gpud_tpu_torch.config import default_config
from gpud_tpu_torch.server.server import Server

from torch_fakes import probe_stubs
from torch_parity import COMPONENTS, GAUGES

ERROR_NAMES = {
    "tpu_hbm_ecc_uncorrectable": "gpu_ecc_xid48",
    "tpu_chip_lost": "gpu_fallen_off_bus",
    "tpu_power_fault": "gpu_power_fault",
}

REF_TO_PORT = [
    ("TPUD_TPU_MOCK_ALL_SUCCESS", "TPUD_GPU_MOCK_ALL_SUCCESS"),
    ("tpu_error_name", "gpu_error_name"),
    ("chip_id", "gpu_id"),
    ("--chip-id", "--gpu-id"),
    ("TPU-ERR: tpu_chip_lost chip=0", "GPU-ERR: gpu_fallen_off_bus gpu=0"),
    ('"chip=2"', '"gpu=2"'),
    ('(chip 2)', '(GPU 2)'),
    ('tag="tpu"', 'tag="gpu"'),
    ('"accelerator-tpu" in', '"accelerator-gpu" in'),
    ('mi.tpu_info.chip_count', 'len(mi.gpu_info.gpus)'),
    ('mi.tpu_info', 'mi.gpu_info'),
    ('mi["tpu_info"]["chip_count"]', 'len(mi["gpu_info"]["gpus"])'),
    *sorted(ERROR_NAMES.items()),
    *sorted((a, b) for a, b in COMPONENTS.items() if a != b),
    *sorted((a, b) for a, b in GAUGES.items() if a != b),
]


@pytest.fixture(scope="module", autouse=True)
def port_host():
    import gpud_tpu.log as ref_log
    from gpud_tpu_torch import host, log as port_log, netutil
    from gpud_tpu_torch.components import host_extra
    from gpud_tpu_torch.providers import detect

    from aiohttp import web

    mp = pytest.MonkeyPatch()
    mp.setenv("TPUD_GPU_MOCK_ALL_SUCCESS", "1")
    mp.setenv("TPUD_LISTEN_HOST", "127.0.0.1")
    # the reference's listener binds 0.0.0.0 (server.py:695): its servers
    # these modules start for comparison bind 127.0.0.1 too
    site = web.TCPSite
    mp.setattr(web, "TCPSite", lambda runner, _host, port, **kw: site(runner, "127.0.0.1",
                                                                         port, **kw))
    for module, name, stub in probe_stubs(netutil, detect, host, host_extra):
        mp.setattr(module, name, stub)
    # each package's CLI binds one handler of the shared "tpud" logger to
    # sys.stderr, once per process: bind them here to pytest's stream, not
    # in a test to its capsys stream, which closes after it (every later
    # record then prints a logging error, slowing the tests that follow),
    # and leave the logger as the module found it
    tpud = logging.getLogger("tpud")
    saved = (tpud.handlers[:], tpud.level, ref_log._configured, port_log._configured)
    ref_log.setup()
    port_log.setup()
    yield
    tpud.handlers[:] = saved[0]
    tpud.setLevel(saved[1])
    ref_log._configured, port_log._configured = saved[2], saved[3]
    mp.undo()


def live_config(tmp, **kw):
    kmsg = tmp / "kmsg.fixture"
    kmsg.write_text("")
    kw.setdefault("data_dir", str(tmp / "data"))
    kw.setdefault("port", 0)
    kw.setdefault("tls", False)
    kw.setdefault("kmsg_path", str(kmsg))
    kw.setdefault("components_disabled", ["network-latency"])  # egress-blocked
    kw.setdefault("endpoint", "")
    kw.setdefault("token", "")
    return default_config(**kw)


@pytest.fixture(scope="module")
def live_server(port_host, tmp_path_factory):
    s = Server(config=live_config(tmp_path_factory.mktemp("live-server")))
    s.start()
    yield s
    s.stop()
