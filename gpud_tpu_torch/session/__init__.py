"""The agent side of the control-plane session; the port of
``gpud_tpu/session/``: the wire codec (``wire``), the durable outbox and
the circuit breaker (``outbox``), and the frame they deliver
(``session.Frame``). The transport itself is not ported yet."""
