"""Modem models of the port: configuration, FSKCore and ModemFarm.

Import the submodules directly (``webaudio_modem_tpu_torch.models.farm``);
this package imports nothing on its own.
"""
