"""The fleet manager tier (the port of ``gpud_tpu/manager/``): the control
plane, the sharded fleet rollup store and its exposition, and the agent's
side of the manager's packages. Peer federation is not ported yet."""
