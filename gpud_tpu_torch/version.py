"""Version info; the port of ``gpud_tpu/version.py`` (reference:
version/version.go — ldflags-injected there; here a plain module constant,
overridable via env for self-update tests)."""

import os

__version__ = os.environ.get("TPUD_VERSION_OVERRIDE", "0.1.0")
