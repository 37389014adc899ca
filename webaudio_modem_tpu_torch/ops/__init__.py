"""DSP ops of the port: modulator, demodulator and Hopper kernels."""
