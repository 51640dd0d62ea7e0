"""opencl_fft_tpu — an accelerator audio-DSP framework in JAX.

A ground-up JAX/XLA rebuild of the capability surface of vlazzarini's
OpenCL FFT/convolution library (see SURVEY.md for the complete component
map): power-of-two complex and real FFTs, uniform partitioned fast
convolution (LTI and time-varying), direct time-domain convolution, a
streaming opcode-equivalent layer, a native C++ host runtime, and (dp, tp)
mesh scale-out — all functional, jit-first, and deterministic.

Layer guide:
  ops/       functional compute core (split-complex FFT, rfft packing,
             pconv/dconv engines) — use this in new code
  api        class-based parity surface (Clcfft/Clrfft/Clpconv/Cldconv)
  stream     opcode-level processors (clfft/clrfft/clconv/cltvconv)
  models     batched engines (Convolver, TVConvolver, BatchedFFT)
  parallel   jax.sharding mesh + shard_map scale-out
  runtime    native C++ SPSC ring / block accumulator (ctypes)
  utils      errors, logging, devices, checkpoint, profiling
"""

from .api import Clcfft, Clrfft, Clpconv, Cldconv
from .ops.fft import cfft, fft, ifft, fft_split, cfft_split
from .ops.rfft import rfft, irfft, rfft_split, irfft_split
from .ops.pconv import (PconvConfig, PconvState, pconv_init, pconv_step,
                        pconv_step_tv, pconv_stream, pconv_stream_tv,
                        push_ir, convolve, convolve_oneshot, pconv_chunk,
                        pconv_chunk_tv, XfadeState, pconv_begin_xfade,
                        pconv_step_xfade)
from .ops.stft import stft, istft, spectrogram
from .ops.dconv import (DconvConfig, DconvState, dconv_init, dconv_step,
                        dconv_step_tv, dconv_stream, convolve_direct)
from .stream import (ClfftProcessor, ClrfftProcessor, ClconvProcessor,
                     CltvconvProcessor)
from .models.convolver import (Convolver, TVConvolver, BatchedFFT,
                               MatrixConvolver)
from .models.lowlatency import ZeroLatencyConvolver
from .ops.fft import set_fast_math, exact_precision
from .utils.errors import Status, error_string, FftError
from .utils.numerics import np2

__version__ = "0.1.0"

__all__ = [
    "Clcfft", "Clrfft", "Clpconv", "Cldconv",
    "cfft", "fft", "ifft", "fft_split", "cfft_split",
    "rfft", "irfft", "rfft_split", "irfft_split",
    "PconvConfig", "PconvState", "pconv_init", "pconv_step", "pconv_step_tv",
    "pconv_stream", "pconv_stream_tv", "push_ir", "convolve",
    "convolve_oneshot", "pconv_chunk", "pconv_chunk_tv", "XfadeState",
    "pconv_begin_xfade", "pconv_step_xfade", "stft", "istft",
    "spectrogram",
    "DconvConfig", "DconvState", "dconv_init", "dconv_step", "dconv_step_tv",
    "dconv_stream", "convolve_direct",
    "ClfftProcessor", "ClrfftProcessor", "ClconvProcessor", "CltvconvProcessor",
    "Convolver", "TVConvolver", "BatchedFFT", "MatrixConvolver",
    "ZeroLatencyConvolver",
    "set_fast_math", "exact_precision",
    "Status", "error_string", "FftError", "np2",
]
