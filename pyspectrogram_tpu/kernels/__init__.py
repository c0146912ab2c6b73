from pyspectrogram_tpu.kernels.gemm_fft import make_gemm_fft, make_plan

__all__ = [
    "make_gemm_fft",
    "make_plan",
]
