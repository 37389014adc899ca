"""The port's streaming runtime: the chunked modulator, the realtime
processor, the in-memory data channels, the simulated audio graph and
the farm hubs, whose ``FarmDataChannel``s carry thousands of ARQ
sessions: ``FarmLoopbackHub`` (host playout), ``DeviceFarmHub`` (the
hard wire on the card), ``SoftFarmHub`` (the soft-FEC wire, scheduled
window decodes) and ``BlindSoftFarmHub`` (the soft-FEC wire, blind
acquisition) (``webaudio_modem_tpu/runtime``)."""

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
from webaudio_modem_tpu_torch.runtime.soft_hub import (  # noqa: F401
    BlindSoftFarmHub,
    SoftFarmHub,
)
