"""The agent's side of the fleet manager's packages (the port of
``gpud_tpu/manager/packages.py``); the manager tier itself is not ported
yet."""
