"""Runnable scripts of the port (``python -m
webaudio_modem_tpu_torch.examples.<name>``), the counterparts of the
repository's ``examples/``: the farm transport demo, the on-card farm
endurance run and the ARQ latency probe.  Each runs on the card unless
``--device cpu`` is given."""
