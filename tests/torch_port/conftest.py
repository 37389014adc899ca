"""Settings for the port's CPU differential tests, and the fixture of its
``card`` tests (``cuda_device``: skips with the reason where no CUDA card
is present, decided when the test runs).

The tier-1 suite runs several pytest workers at once, so each worker's
torch is pinned to one intra-op thread; the ops here are on tiny [B]
vectors where threads only add contention.  The port's facades do not
warm the quality calibration in the background here (as tests/conftest.py
pins the JAX package's): each build runs K1's plain version over a whole
clean frame; test_torch_quality.py covers the warm path explicitly.
"""

import pytest
import torch

from webaudio_modem_tpu_torch.ops import fsk_demod

torch.set_num_threads(1)
fsk_demod.AUTO_WARM_QUALITY = False


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
