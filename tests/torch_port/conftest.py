"""Settings for the port's CPU differential tests.

The tier-1 suite runs several pytest workers at once, so each worker's
torch is pinned to one intra-op thread; the ops here are on tiny [B]
vectors where threads only add contention.
"""

import torch

torch.set_num_threads(1)
