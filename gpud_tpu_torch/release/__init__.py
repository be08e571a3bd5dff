"""Release distribution signing (the port of ``gpud_tpu/release/``)."""
