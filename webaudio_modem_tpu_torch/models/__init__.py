"""Modem models of the port: configuration, FSKCore, PSKCore,
SoftModemCore, ModemFarm, the V.21 duplex link and checkpoints.

The names below are exported lazily (``from webaudio_modem_tpu_torch
.models import PSKCore`` imports ``models.psk`` then), so importing this
package imports nothing on its own and the ops modules that import
``models.config`` form no import cycle with it.
"""

_EXPORTS = {
    "FSKConfig": "config", "FSKParams": "config", "FSKCore": "fsk",
    "ModemFarm": "farm", "PSKConfig": "psk", "PSKCore": "psk",
    "DEFAULT_PSK_CONFIG": "psk", "SoftModemCore": "soft_modem",
    "V21Station": "v21", "V21Duplex": "v21", "v21_config": "v21",
    "save_state": "checkpoint", "load_state": "checkpoint",
    "dumps_state": "checkpoint", "loads_state": "checkpoint",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
