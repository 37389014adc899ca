"""The port's streaming runtime: the chunked modulator, the realtime
processor, the in-memory data channels and the simulated audio graph
(``webaudio_modem_tpu/runtime``).  The farm hubs are not ported yet
(ROADMAP queue 1, item 9)."""

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
