"""tpufft — generic-radix N-dimensional FFT in JAX.

A from-scratch JAX rebuild of the capabilities of martinvuyk/hackathon-fft
(a Mojo CPU/GPU mixed-radix Stockham FFT library): any prime radix,
forward/inverse, real and complex input, ND transforms, explicit plans,
autodiff, and multi-device execution over device meshes.

Complex data is split re/im float planes inside the transforms
(``SplitComplex``). Every axis runs a pure-jnp mixed-radix Stockham (or
Bluestein's chirp-z for large prime factors), which XLA compiles for the
GPU or CPU; a native C++ engine (native/) covers host execution. See
README.md for the architecture and PARITY.md for the reference component
map.
"""

from .config import PlanConfig
from .core import SplitComplex
from .planner import (default_bases, digit_reverse, factorize,
                      next_fast_len, prev_fast_len, stage_schedule)
from .api import (
    Plan, PrecisionDowngradeWarning, plan_fft,
    fft, ifft, rfft, irfft,
    fft2, ifft2, rfft2, irfft2,
    fftn, ifftn, rfftn, irfftn,
    hfft, ihfft, hfft2, ihfft2, hfftn, ihfftn,
    fftfreq, rfftfreq, fftshift, ifftshift,
)
from .realtrans import (
    dct, idct, dst, idst, dctn, idctn, dstn, idstn,
)
from .fhtlog import fht, ifht, fhtoffset
from .backend import set_workers, get_workers, scipy_backend
from .signal import (FilterPlan, correlate, envelope, fftconvolve, hilbert,
                     hilbert2, oaconvolve, plan_filter, resample)
from .sigtools import (choose_conv_method, convolve, convolve2d,
                       correlate2d, correlation_lags, deconvolve,
                       detrend, medfilt, medfilt2d, order_filter,
                       savgol_filter, vectorstrength, wiener)
from .czt import CZT, ZoomFFT, czt, czt_points, zoom_fft
from .spectral import (check_COLA, check_NOLA, coherence, csd, get_window,
                       istft, periodogram, spectrogram, stft, welch, lombscargle,
)
from .shorttime import ShortTimeFFT, closest_STFT_dual_window
from .multirate import decimate, resample_poly, upfirdn
from .iir import filtfilt, lfilter, sosfilt, sosfiltfilt
from .design import (
    firwin, firwin2, firwin_2d, firls, remez, minimum_phase,
    gammatone, kaiser_beta, kaiser_atten, kaiserord,
    buttap, cheb1ap, cheb2ap, ellipap, besselap,
    lp2lp_zpk, lp2hp_zpk, lp2bp_zpk, lp2bs_zpk, bilinear, bilinear_zpk,
    lp2lp, lp2hp, lp2bp, lp2bs,
    iirfilter, butter, cheby1, cheby2, ellip, bessel,
    iirnotch, iirpeak, iircomb, iirdesign,
    buttord, cheb1ord, cheb2ord, ellipord, band_stop_obj,
    zpk2tf, tf2zpk, zpk2sos, tf2sos, sos2tf, sos2zpk, normalize,
    freqz, freqz_zpk, sosfreqz, freqz_sos, group_delay,
    freqs, freqs_zpk, findfreqs, lfilter_zi, sosfilt_zi,
    residue, residuez, invres, invresz, unique_roots, lfiltic,
)
from .sigtools import savgol_coeffs
from .ltisys import (lti, dlti, TransferFunction, ZerosPolesGain, StateSpace,
                  tf2ss, ss2tf, zpk2ss, ss2zpk, abcd_normalize,
                  cont2discrete, lsim, impulse, step, freqresp, bode,
                  dlsim, dimpulse, dstep, dfreqresp, dbode,
                  place_poles, BadCoefficients)
from .peaks import (argrelextrema, argrelmax, argrelmin, find_peaks,
                    find_peaks_cwt, peak_prominences, peak_widths)
from .bsplines import (gauss_spline, cspline1d, qspline1d,
                       cspline1d_eval, qspline1d_eval, cspline2d,
                       qspline2d, spline_filter, sepfir2d,
                       symiirorder1, symiirorder2)
from .waveforms import (chirp, gausspulse, max_len_seq, sawtooth, square,
                        sweep_poly, unit_impulse)
from . import ndimage
from . import windows

__version__ = "0.4.0"

__all__ = [
    "PlanConfig", "Plan", "PrecisionDowngradeWarning", "SplitComplex",
    "plan_fft",
    "fft", "ifft", "rfft", "irfft",
    "fft2", "ifft2", "rfft2", "irfft2",
    "fftn", "ifftn", "rfftn", "irfftn",
    "hfft", "ihfft", "hfft2", "ihfft2", "hfftn", "ihfftn",
    "dct", "idct", "dst", "idst",
    "dctn", "idctn", "dstn", "idstn",
    "fht", "ifht", "fhtoffset",
    "FilterPlan", "plan_filter", "fftconvolve",
    "hilbert", "resample", "correlate", "oaconvolve", "envelope",
    "convolve", "convolve2d", "correlate2d",
    "CZT", "ZoomFFT", "czt", "zoom_fft", "czt_points",
    "ShortTimeFFT", "closest_STFT_dual_window",
    "stft", "istft", "spectrogram", "periodogram", "welch", "csd",
    "coherence", "get_window", "check_NOLA", "check_COLA",
    "lombscargle",
    "upfirdn", "resample_poly", "decimate", "sosfilt", "sosfiltfilt",
    "lfilter", "filtfilt", "savgol_filter",
    "hilbert2", "detrend", "deconvolve", "wiener", "correlation_lags",
    "choose_conv_method", "savgol_coeffs",
    "firwin", "firwin2", "firwin_2d", "firls", "remez", "minimum_phase",
    "gammatone",
    "kaiser_beta", "kaiser_atten", "kaiserord",
    "buttap", "cheb1ap", "cheb2ap", "ellipap", "besselap",
    "lp2lp_zpk", "lp2hp_zpk", "lp2bp_zpk", "lp2bs_zpk",
    "lp2lp", "lp2hp", "lp2bp", "lp2bs",
    "bilinear", "bilinear_zpk",
    "iirfilter", "butter", "cheby1", "cheby2", "ellip", "bessel",
    "iirnotch", "iirpeak", "iircomb", "iirdesign",
    "buttord", "cheb1ord", "cheb2ord", "ellipord", "band_stop_obj",
    "zpk2tf", "tf2zpk", "zpk2sos", "tf2sos", "sos2tf", "sos2zpk",
    "normalize", "freqz", "freqz_zpk", "sosfreqz", "freqz_sos",
    "group_delay", "freqs", "freqs_zpk", "findfreqs",
    "residue", "residuez", "invres", "invresz", "unique_roots",
    "lfiltic", "order_filter", "medfilt", "medfilt2d", "vectorstrength",
    "lfilter_zi", "sosfilt_zi",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift",
    "lti", "dlti", "TransferFunction", "ZerosPolesGain", "StateSpace",
    "tf2ss", "ss2tf", "zpk2ss", "ss2zpk", "abcd_normalize",
    "cont2discrete", "lsim", "impulse", "step", "freqresp", "bode",
    "dlsim", "dimpulse", "dstep", "dfreqresp", "dbode",
    "place_poles", "BadCoefficients",
    "find_peaks", "find_peaks_cwt", "peak_prominences", "peak_widths",
    "argrelmin", "argrelmax", "argrelextrema",
    "gauss_spline", "cspline1d", "qspline1d", "cspline1d_eval",
    "qspline1d_eval", "cspline2d", "qspline2d", "spline_filter",
    "sepfir2d", "symiirorder1", "symiirorder2",
    "chirp", "sweep_poly", "gausspulse", "square", "sawtooth",
    "unit_impulse", "max_len_seq",
    "set_workers", "get_workers", "scipy_backend", "ndimage", "windows",
    "default_bases", "digit_reverse", "factorize", "next_fast_len",
    "prev_fast_len", "stage_schedule",
    "__version__",
]
