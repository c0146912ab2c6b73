"""pyspectrogram_tpu — JAX PSD/STI spectrogram framework.

A from-scratch JAX/XLA re-design of the capabilities of
jswoboda/PySpectrogram (a PyQt5 Digital RF spectrogram viewer): Digital RF
HDF5 ingest, STFT/PSD/STI compute on the GPU, streaming, display
preparation, filtering/reconstruction, and thin CLI/GUI clients over one
array-in/array-out public API.
"""

__version__ = "0.1.0"

from pyspectrogram_tpu.utils import SpectrogramConfig, TerminateReason  # noqa: F401
