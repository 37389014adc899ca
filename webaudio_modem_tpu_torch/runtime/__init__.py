"""The port's streaming runtime: the chunked modulator, the realtime
processor, the in-memory data channels, the simulated audio graph and
the hard farm hubs, ``FarmLoopbackHub`` (host playout) and
``DeviceFarmHub`` (the wire on the card), whose ``FarmDataChannel``s
carry thousands of ARQ sessions (``webaudio_modem_tpu/runtime``).  The
soft hubs, ``SoftFarmHub`` and ``BlindSoftFarmHub``, are not ported yet
(ROADMAP queue 1, item 12)."""

from webaudio_modem_tpu_torch.runtime.chunked_modulator import (  # noqa: F401
    ChunkedModulator,
    ChunkResult,
)
from webaudio_modem_tpu_torch.runtime.processor import (  # noqa: F401
    FSKProcessor,
)
from webaudio_modem_tpu_torch.runtime.audio_graph import (  # noqa: F401
    AudioGraph,
)
from webaudio_modem_tpu_torch.runtime.data_channel import (  # noqa: F401
    LoopbackDataChannel,
    QueueDataChannel,
    make_loopback_pair,
)
from webaudio_modem_tpu_torch.runtime.farm_channel import (  # noqa: F401
    FarmDataChannel,
    FarmLoopbackHub,
)
from webaudio_modem_tpu_torch.runtime.device_hub import (  # noqa: F401
    DeviceFarmHub,
)
