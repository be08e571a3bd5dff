"""The agent side of the control-plane session; the port of
``gpud_tpu/session/``: the transport (``session.Session``: the v1 ndjson
streams on ``http.client``, keep-alive, backoff, auth parking, peer
failover), the gRPC tunnel of protocol v2 (``v2``), the request dispatcher
(``dispatch``), the wire codec (``wire``), and the durable outbox and the
circuit breaker (``outbox``)."""
