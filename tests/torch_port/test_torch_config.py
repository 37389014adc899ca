"""The port's FSKParams derivation equals the reference's, field by field."""

import dataclasses

import pytest

from torch_port_helpers import CONFIGS, configs
from webaudio_modem_tpu.models import config as jax_config_mod
from webaudio_modem_tpu_torch.models import config as port_config_mod


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_params_fields_equal(name):
    pc, jc, pp, jp = configs(**CONFIGS[name])
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    port_fields = [f.name for f in dataclasses.fields(pp)]
    assert port_fields == [f.name for f in dataclasses.fields(jp)]
    for field in port_fields:
        if field == "config":
            continue
        assert getattr(pp, field) == getattr(jp, field), field
    assert pp.stop_bit_position == jp.stop_bit_position
    if name == "ds_over_256":
        assert pp.ds_samples_per_bit > 256


def test_from_dict_camel_case():
    d = {"baudRate": 300, "markFrequency": 1270, "spaceFrequency": 1070,
         "preamblePattern": [0x55], "parity": "odd"}
    assert dataclasses.asdict(port_config_mod.FSKConfig.from_dict(d)) == \
        dataclasses.asdict(jax_config_mod.FSKConfig.from_dict(d))
