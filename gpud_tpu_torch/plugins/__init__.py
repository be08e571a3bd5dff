"""Custom plugins: specs and the checks they run (the port of
``gpud_tpu/plugins/``)."""
