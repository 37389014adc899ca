"""Plain references of the benchmark's configurations, in plain PyTorch.

Nothing here imports the program.  A modem's answer is the bytes that
were sent, so a configuration's reference is its transmit side: how
bytes become frames and frames become audio (``uart_fsk``, ``fec_fsk``),
the channel (``channel``), and the comparison of what the program
decoded with what was sent (``compare``).
"""
