"""Hand-written Hopper kernels of the port and their plain versions.

Each kernel module holds a wrapper (``fsk_seq.seq``,
``fsk_framing.stage_d_compact`` (K2) and ``fsk_framing.stage_d`` (K8),
``viterbi.decode``,
``align.aligned_wsum``, ``cumsum0.csum0``, ``psk_seq.seq``,
``crc16.crc_rows`` and ``crc16.pack_bodies``, ``sync_peak.sync_peak``)
and its plain PyTorch
version (``*_plain``).  A
wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel built from ``csrc/`` or raises.  Importing these
modules builds nothing: ``_build.library(name)`` runs nvcc, for every
source not built yet, the first time a kernel is launched.
"""
