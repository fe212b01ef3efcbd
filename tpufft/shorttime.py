"""ShortTimeFFT: the modern scipy.signal class-based STFT interface.

scipy.signal.ShortTimeFFT parity (scipy/signal/_short_time_fft.py): a
window/hop/fs object with sliding-window FFT (`stft`), overlap-add
inverse (`istft`) through the canonical dual window, spectrogram, the
full index bookkeeping (p_min/p_max/k_min/k_max, border markers,
extent), the four fft_modes, and 'magnitude'/'psd' scaling.

Design (tpufft conventions, not a translation of scipy's loops):
* Index conventions match scipy exactly: the p-th slice covers samples
  ``p*hop - m_num_mid + [0, m_num)``; ``phase_shift`` is a circular roll
  of the mfft-padded windowed slice by ``(phase_shift + m_num_mid) %
  m_num`` before the FFT (verified numerically against scipy, this
  build).
* Framing is one vectorized gather over a padded copy of the signal; the
  batch of frames then goes through tpufft's own transforms
  (:func:`tpufft.api.rfft` / :func:`fft`). numpy input returns numpy and
  executes on the host backend — scipy-exact (1e-12-class) when jax x64
  is enabled, float32 with a :class:`PrecisionDowngradeWarning`
  otherwise. jax input runs on the device through the same transforms
  and returns device arrays.
* The overlap-add inverse is a single scatter-add (``np.add.at`` /
  ``jnp .at[].add``) of all dual-windowed inverse frames — no per-slice
  Python loop on device.
* The canonical dual window solves the OLA identity
  ``sum_p w[k-p*hop] d[k-p*hop] = 1`` via ``d = w / DD`` with
  ``DD[k] = sum_j |w[k - j*hop]|^2`` (host f64 plan-time math, same
  discipline as twiddle tables).

The reference (martinvuyk/hackathon-fft) has no short-time layer; this
class is the index-exact scipy-compatible surface on top of the same
transform core as tpufft.spectral.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from . import api
from .core import SplitComplex

__all__ = ["ShortTimeFFT", "closest_STFT_dual_window"]

_FFT_MODES = ("twosided", "centered", "onesided", "onesided2X")
_PAD_KIND = {"zeros": "constant", "edge": "edge", "even": "reflect",
             "odd": "reflect"}


def _canonical_dual(win: np.ndarray, hop: int) -> np.ndarray:
    """d = win / DD, DD[k] = sum_j |win[k - j*hop]|^2 (all in-range j).

    Derivation: the frame operator of a hop-shifted window system is
    diagonal in sample space with entries DD[k]; the canonical dual is
    its inverse applied to the window (Groechenig, "Foundations of
    Time-Frequency Analysis", ch. 5). The invertibility guard below
    (a relative-resolution threshold on DD) intentionally matches
    scipy.signal._short_time_fft._calc_dual_canonical_window so that
    the invertible/ValueError boundary is bit-identical to the scipy
    class this module is parity-tested against.
    """
    w2 = (win.real ** 2 + win.imag ** 2).astype(np.float64)
    DD = w2.copy()
    for j in range(hop, len(win), hop):
        DD[j:] += w2[:-j]
        DD[:-j] += w2[j:]
    relative_resolution = np.finfo(w2.dtype).resolution * DD.max()
    if not np.all(DD >= relative_resolution):
        raise ValueError("short-time FFT is not invertible: the window "
                         "overlap-add has (near-)zeros")
    return win / DD


def closest_STFT_dual_window(win, hop: int, desired_dual=None, *,
                             scaled: bool = True):
    """Dual window of ``alpha*win`` closest to ``desired_dual``
    (scipy.signal.closest_STFT_dual_window-compatible; scipy
    _short_time_fft.py is the parity target).

    Derivation (independent of scipy's implementation): a window system
    shifted by ``hop`` has a diagonal frame operator, so "d is a dual of
    w" decouples into one linear constraint per residue class
    ``r = k mod hop``: ``<w_r, d_r> = 1``. The closest d to a desired u
    under one inner-product constraint per class is the affine
    projection ``d_r = u_r + (1 - c_r) / n_r * w_r`` with
    ``c_r = <w_r, u_r>`` and ``n_r = ||w_r||^2``. With ``scaled=True``
    the target is ``alpha*u`` with alpha free; the residual is then
    exactly ``sum_r |1 - alpha*c_r|^2 / n_r`` (the mismatch lives
    entirely along w within each class), minimized by
    ``alpha = (sum conj(c_r)/n_r) / (sum |c_r|^2/n_r)``.
    """
    win = np.atleast_1d(np.asarray(win))
    if win.ndim != 1 or win.size == 0:
        raise ValueError("win must be a non-empty 1-D array")
    if not (np.issubdtype(win.dtype, np.floating)
            or np.issubdtype(win.dtype, np.complexfloating)):
        win = win.astype(np.float64)
    m = win.shape[0]
    hop = int(hop)
    if not 1 <= hop <= m:
        raise ValueError(f"hop={hop} must be in [1, len(win)={m}]")
    if desired_dual is None:
        u = np.ones(m, dtype=win.dtype)
    else:
        u = np.atleast_1d(np.asarray(desired_dual))
        if u.shape != win.shape:
            raise ValueError("desired_dual must be 1-D of the same "
                             "length as win")
    cdtype = np.result_type(win.dtype, u.dtype, np.float64)
    w = win.astype(cdtype)
    u = u.astype(cdtype)

    cls = np.arange(m) % hop
    n_r = np.zeros(hop, np.float64)           # ||w_r||^2 per class
    np.add.at(n_r, cls, (w.real ** 2 + w.imag ** 2)
              if np.iscomplexobj(w) else w ** 2)
    c_r = np.zeros(hop, cdtype)               # <w_r, u_r> per class
    np.add.at(c_r, cls, np.conj(w) * u)

    # a residue class with zero window energy admits no dual at all
    if not np.all(n_r > np.finfo(np.float64).tiny):
        raise ValueError("closest dual window is undefined: the window "
                         "has a hop-residue class with zero energy")
    if scaled:
        denom = np.sum((c_r.real ** 2 + c_r.imag ** 2) / n_r)
        if denom < np.finfo(np.float64).tiny:
            raise ValueError("closest dual window is undefined: "
                             "desired_dual is orthogonal to the window "
                             "in every hop-residue class")
        alpha = np.sum(np.conj(c_r) / n_r) / denom
    else:
        alpha = 1.0
    d = alpha * u + ((1.0 - alpha * c_r) / n_r)[cls] * w
    if not np.iscomplexobj(win) and not np.iscomplexobj(u):
        alpha = float(np.real(alpha))
        d = np.real(d) if np.iscomplexobj(d) else d
    return d, alpha


def _is_jax(x) -> bool:
    return isinstance(x, (jax.Array, SplitComplex))


class ShortTimeFFT:
    """scipy.signal.ShortTimeFFT-compatible short-time FFT object."""

    def __init__(self, win, hop: int, fs: float, *, fft_mode="onesided",
                 mfft=None, dual_win=None, phase_shift=0, scale_to=None,
                 config=None):
        win = np.asarray(win)
        if win.ndim != 1 or win.size == 0:
            raise ValueError("win must be a non-empty 1-D array")
        if not np.all(np.isfinite(win)):
            raise ValueError("win must be finite")
        self._win = win.astype(np.complex128 if np.iscomplexobj(win)
                               else np.float64)
        hop = int(hop)
        if hop < 1:
            raise ValueError("hop must be a positive integer")
        self._hop = hop
        if not fs > 0:
            raise ValueError("fs must be positive")
        self._fs = float(fs)
        self._mfft = int(mfft) if mfft is not None else win.size
        if self._mfft < win.size:
            raise ValueError("mfft must be at least len(win)")
        if fft_mode not in _FFT_MODES:
            raise ValueError(f"fft_mode must be one of {_FFT_MODES}")
        self._fft_mode = fft_mode
        if phase_shift is not None:
            phase_shift = int(phase_shift)
            if not -self._mfft < phase_shift < self._mfft:
                raise ValueError("phase_shift must be None or an int in "
                                 "(-mfft, mfft)")
        self._phase_shift = phase_shift
        if dual_win is not None:
            dual_win = np.asarray(dual_win)
            dual_win = dual_win.astype(np.complex128
                                       if np.iscomplexobj(dual_win)
                                       else np.float64)
            if dual_win.shape != win.shape:
                raise ValueError("dual_win must have the same shape as win")
        self._dual_win = dual_win
        self._scaling = None
        self._config = config          # PlanConfig of the transforms
        if scale_to is not None:
            self.scale_to(scale_to)
        if fft_mode == "onesided2X" and self._scaling is None:
            raise ValueError("fft_mode='onesided2X' requires scaling "
                             "('magnitude' or 'psd'); pass scale_to=")

    # -- constructors ------------------------------------------------
    @classmethod
    def from_window(cls, win_param, fs: float, nperseg: int,
                    noverlap: int, *, symmetric_win: bool = False,
                    fft_mode="onesided", mfft=None, phase_shift=0,
                    scale_to=None):
        from .spectral import get_window
        win = get_window(win_param, int(nperseg),
                         fftbins=not symmetric_win)
        return cls(win, hop=int(nperseg) - int(noverlap), fs=fs,
                   fft_mode=fft_mode, mfft=mfft, phase_shift=phase_shift,
                   scale_to=scale_to)

    @classmethod
    def from_dual(cls, dual_win, hop: int, fs: float, **kwargs):
        win = _canonical_dual(np.asarray(dual_win, np.float64), int(hop))
        return cls(win, hop=hop, fs=fs,
                   dual_win=np.asarray(dual_win, np.float64), **kwargs)

    @classmethod
    def from_win_equals_dual(cls, desired_win, hop: int, fs: float, *,
                             scale_to=None, **kwargs):
        """Window equal to its own dual (scipy-exact, incl. the
        'unitary' scaling only this constructor can set: win /= sqrt(
        mfft), dual *= sqrt(mfft)). Normalizing each hop-residue class
        of the window to unit norm is the closed form: the OLA diagonal
        DD[k] is constant on each class and equals that class's squared
        norm."""
        desired_win = np.asarray(desired_win)
        if desired_win.ndim != 1 or desired_win.size == 0:
            raise ValueError("desired_win must be a non-empty 1-D array")
        if np.issubdtype(desired_win.dtype, np.integer):
            raise ValueError("desired_win cannot be of integer type — "
                             "cast to float or complex")
        if not np.all(np.isfinite(desired_win)):
            raise ValueError("desired_win must have finite entries")
        hop = int(hop)
        if not 1 <= hop <= desired_win.size:
            raise ValueError(f"hop={hop} is not an integer in "
                             f"[1, {desired_win.size}]")
        if scale_to not in ("magnitude", "psd", "unitary", None):
            raise ValueError(f"scale_to={scale_to!r} not in "
                             "('magnitude', 'psd', 'unitary', None)")
        win = desired_win.astype(np.complex128
                                 if np.iscomplexobj(desired_win)
                                 else np.float64)
        mfft = kwargs.get("mfft") or win.size
        s_fac = math.sqrt(mfft) if scale_to == "unitary" else 1.0
        relative_resolution = (np.finfo(win.real.dtype).resolution
                               * np.max(np.abs(win)))
        for m in range(hop):
            a = np.linalg.norm(win[m::hop])
            if not a > relative_resolution:
                raise ValueError("desired_win cannot be normalized to "
                                 "equal its dual (a hop-residue class "
                                 "of the overlap-add is zero)")
            win[m::hop] /= a
        sft = cls(win / s_fac, hop=hop, fs=fs, dual_win=win * s_fac,
                  scale_to=None if scale_to == "unitary" else scale_to,
                  **kwargs)
        if scale_to == "unitary":
            sft._scaling = "unitary"
        return sft

    # -- basic properties ---------------------------------------------
    win = property(lambda self: self._win)
    hop = property(lambda self: self._hop)
    fs = property(lambda self: self._fs)
    T = property(lambda self: 1.0 / self._fs)
    mfft = property(lambda self: self._mfft)
    fft_mode = property(lambda self: self._fft_mode)
    phase_shift = property(lambda self: self._phase_shift)
    scaling = property(lambda self: self._scaling)
    m_num = property(lambda self: self._win.size)
    m_num_mid = property(lambda self: self._win.size // 2)
    delta_t = property(lambda self: self._hop / self._fs)
    delta_f = property(lambda self: self._fs / self._mfft)
    onesided_fft = property(
        lambda self: self._fft_mode in ("onesided", "onesided2X"))

    @property
    def f_pts(self) -> int:
        return (self._mfft // 2 + 1 if self.onesided_fft else self._mfft)

    @property
    def f(self) -> np.ndarray:
        if self.onesided_fft:
            return api.rfftfreq(self._mfft, self.T)
        fr = api.fftfreq(self._mfft, self.T)
        return np.fft.fftshift(fr) if self._fft_mode == "centered" else fr

    @property
    def dual_win(self) -> np.ndarray:
        if self._dual_win is None:
            self._dual_win = _canonical_dual(self._win.real
                                             if not np.iscomplexobj(self._win)
                                             else self._win, self._hop)
        return self._dual_win

    @property
    def invertible(self) -> bool:
        try:
            self.dual_win
        except ValueError:
            return False
        return True

    @property
    def fac_magnitude(self) -> float:
        return 1.0 / abs(self._win.sum())

    @property
    def fac_psd(self) -> float:
        return 1.0 / math.sqrt(
            self._fs * float(np.sum(np.abs(self._win) ** 2)))

    def scale_to(self, scaling: str):
        """Scale win (and dual) for 'magnitude' or 'psd' calibration."""
        if scaling not in ("magnitude", "psd"):
            raise ValueError("scaling must be 'magnitude' or 'psd'")
        if self._scaling == scaling:
            return
        s = self.fac_psd if scaling == "psd" else self.fac_magnitude
        self._win = self._win * s
        if self._dual_win is not None:
            self._dual_win = self._dual_win / s
        self._scaling = scaling

    # -- index bookkeeping (scipy-exact, see module docstring) ---------
    # The border loops below are zero-aware: a window with zero head or
    # tail coefficients (periodic hann starts at 0) contributes nothing
    # there, and scipy's slice accounting skips such non-contributing
    # placements. The loop bounds and slice conventions intentionally
    # mirror scipy.signal._short_time_fft so the integer surface is
    # bit-identical to the class this module is parity-tested against;
    # each loop runs at most O(m_num/hop) iterations.
    @property
    def _w2(self) -> np.ndarray:
        w = self._win
        return (w.real ** 2 + w.imag ** 2)

    @functools.cached_property
    def _border_min(self) -> tuple:
        """(k_min, p_min): leftmost nonzero sample / slice index.

        Slide slice 0 (window start at -m_num_mid) left by hop until the
        next placement would keep no nonzero coefficient over t >= 0
        (scipy's slice convention: the tail ``w2[k_next:]``)."""
        w2 = self._w2
        k, p = -self.m_num_mid, 0
        while True:
            k_next = k - self._hop
            if k_next + self.m_num <= 0 or not w2[k_next:].any():
                return k, -p
            k, p = k_next, p + 1

    @property
    def p_min(self) -> int:
        return self._border_min[1]

    @property
    def k_min(self) -> int:
        return self._border_min[0]

    def _border_max(self, n: int) -> tuple:
        """(k_max, p_max) for an n-sample signal: slide the window right
        from the last slice centered inside the signal until the next
        placement keeps no nonzero coefficient over t < n (the head
        ``w2[:n - k_next]`` in scipy's convention)."""
        m2p = self.m_num - self.m_num_mid
        if not n >= m2p:
            raise ValueError(f"n must be >= ceil(m_num/2) = {m2p}")
        w2 = self._w2
        q = n // self._hop
        k = q * self._hop - self.m_num_mid
        while True:
            k_next = k + self._hop
            if k_next >= n or not w2[:n - k_next].any():
                return k + self.m_num, q + 1
            k, q = k_next, q + 1

    def p_max(self, n: int) -> int:
        return self._border_max(n)[1]

    def k_max(self, n: int) -> int:
        return self._border_max(n)[0]

    def p_num(self, n: int) -> int:
        return self.p_max(n) - self.p_min

    @property
    def lower_border_end(self) -> tuple:
        """(sample, slice) of the first point unaffected by left padding.

        Tracks the first NONZERO window coefficient (m0): placements
        whose nonzero support starts at or after t=0 are unaffected."""
        w2 = self._w2
        m0 = int(np.flatnonzero(w2)[0])
        k, q = -self.m_num_mid + m0, 0
        while k <= self._hop:
            if k + self._hop >= 0:
                return (k + self.m_num, q + 1)
            k, q = k + self._hop, q + 1
        return (0, max(self.p_min, 0))

    def upper_border_begin(self, n: int) -> tuple:
        """(sample, slice) of the first slice affected by right padding.

        Walk slices right-to-left from the first slice past the signal
        end until one fits (or only its zero tail sticks out)."""
        m2p = self.m_num - self.m_num_mid
        if not n >= m2p:
            raise ValueError(f"n must be >= ceil(m_num/2) = {m2p}")
        w2 = self._w2
        q2 = n // self._hop + 1
        q1 = max((n - self.m_num) // self._hop - 1, -1)
        for q_ in range(q2, q1, -1):
            k_ = q_ * self._hop + m2p
            if k_ <= n or not w2[n - k_:].any():
                return ((q_ + 1) * self._hop - self.m_num_mid, q_ + 1)
        return (0, 0)

    def p_range(self, n: int, p0=None, p1=None) -> tuple:
        p_max = self.p_max(n)
        p0 = self.p_min if p0 is None else int(p0)
        p1 = p_max if p1 is None else int(p1)
        if not (self.p_min <= p0 < p1 <= p_max):
            raise ValueError(f"need p_min={self.p_min} <= p0 < p1 <= "
                             f"p_max={p_max}, got p0={p0}, p1={p1}")
        return p0, p1

    def nearest_k_p(self, k: int, left: bool = True) -> int:
        p = k // self._hop if left else -(-k // self._hop)
        return p * self._hop

    def t(self, n: int, p0=None, p1=None, k_offset: int = 0) -> np.ndarray:
        if not (isinstance(n, (int, np.integer)) and n > 0):
            raise ValueError(f"n={n} is not a positive integer")
        p0, p1 = self.p_range(n, p0, p1)
        return (np.arange(p0, p1) * self._hop + k_offset) * self.T

    def extent(self, n: int, axes_seq: str = "tf",
               center_bins: bool = False) -> tuple:
        if axes_seq not in ("tf", "ft"):
            raise ValueError("axes_seq must be 'tf' or 'ft'")
        if self._fft_mode in ("onesided", "onesided2X"):
            q0, q1 = 0, self.f_pts
        elif self._fft_mode == "centered":
            q0 = -(self._mfft // 2)
            q1 = q0 + self._mfft
        else:
            raise ValueError("extent requires fft_mode in ('centered', "
                             "'onesided', 'onesided2X') — a twosided "
                             "frequency axis has no contiguous extent")
        p0, p1 = self.p_min, self.p_max(n)
        if center_bins:
            t0, t1 = self.delta_t * (p0 - 0.5), self.delta_t * (p1 - 0.5)
            f0, f1 = self.delta_f * (q0 - 0.5), self.delta_f * (q1 - 0.5)
        else:
            t0, t1 = self.delta_t * p0, self.delta_t * p1
            f0, f1 = self.delta_f * q0, self.delta_f * q1
        return (t0, t1, f0, f1) if axes_seq == "tf" else (f0, f1, t0, t1)

    # -- transforms ----------------------------------------------------
    def _padded(self, x, p0: int, p1: int, k_offset: int, padding: str):
        """(padded signal copy, index of slice p0's first sample)."""
        if padding not in _PAD_KIND:
            raise ValueError(f"padding must be one of {tuple(_PAD_KIND)}")
        xp = jnp if _is_jax(x) else np
        n = x.shape[-1]
        k_lo = p0 * self._hop - self.m_num_mid + k_offset
        k_hi = (p1 - 1) * self._hop - self.m_num_mid + self.m_num \
            + k_offset
        pad_l, pad_r = max(0, -k_lo), max(0, k_hi - n)
        pad_width = [(0, 0)] * (x.ndim - 1) + [(pad_l, pad_r)]
        kind = _PAD_KIND[padding]
        kwargs = {}
        if padding == "odd":
            kwargs["reflect_type"] = "odd"
        if padding in ("even", "odd") and n == 1:
            kind = "edge"                       # reflect needs >= 2 samples
        xpad = xp.pad(x, pad_width, mode=kind, **kwargs)
        return xpad, k_lo + pad_l

    def _frames(self, x, p0: int, p1: int, k_offset: int, padding: str):
        """(..., p1-p0, m_num) slice gather over a padded signal copy."""
        xpad, start = self._padded(x, p0, p1, k_offset, padding)
        idx = (start
               + self._hop * np.arange(p1 - p0)[:, None]
               + np.arange(self.m_num)[None, :])
        return xpad[..., idx]

    def _win_mod(self) -> np.ndarray:
        """conj(win), zero-padded to mfft and phase-rolled (host f64).

        Elementwise products commute with a shared permutation, so
        (pad+roll frame) * _win_mod equals scipy's window-then-pad-then-
        roll order — and lets complex windows ride the split-plane
        device path as two real multiplies."""
        w = np.conj(self._win)
        wp = np.zeros(self._mfft, dtype=w.dtype)
        wp[:self.m_num] = w
        if self._phase_shift is not None:
            p_s = (self._phase_shift + self.m_num_mid) % self.m_num
            if p_s:
                wp = np.roll(wp, -p_s)
        return wp

    def _fft_frames(self, fr):
        """_fft_func: conj window, phase roll, mode-specific FFT."""
        xp = jnp if _is_jax(fr) else np
        pad = self._mfft - self.m_num
        if pad:
            fr = xp.pad(fr, [(0, 0)] * (fr.ndim - 1) + [(0, pad)])
        if self._phase_shift is not None:
            p_s = (self._phase_shift + self.m_num_mid) % self.m_num
            if p_s:
                fr = xp.roll(fr, -p_s, axis=-1)
        wm = self._win_mod()
        fr = fr * (wm if xp is np else jnp.asarray(wm))
        if self.onesided_fft:
            X = api.rfft(fr, self._mfft, config=self._config)
            if xp is np and isinstance(X, jax.Array):
                # numpy in -> numpy out (the CPU backend has complex
                # dtypes, so the api returns a jax array there); copy —
                # the onesided2X branch below mutates in place
                X = np.array(X)
            if self._fft_mode == "onesided2X":
                fac = math.sqrt(2) if self._scaling == "psd" else 2.0
                sl = slice(1, -1 if self._mfft % 2 == 0 else None)
                if isinstance(X, SplitComplex):
                    re = X.re.at[..., sl].multiply(fac)
                    im = X.im.at[..., sl].multiply(fac)
                    X = SplitComplex(re, im)
                elif isinstance(X, jax.Array):
                    X = X.at[..., sl].multiply(fac)
                else:
                    if not X.flags.writeable:
                        X = X.copy()
                    X[..., sl] *= fac
            return X
        X = api.fft(fr, self._mfft, config=self._config)
        if xp is np and isinstance(X, jax.Array):
            X = np.asarray(X)
        if self._fft_mode == "centered":
            sh = self._mfft // 2
            if isinstance(X, SplitComplex):
                X = SplitComplex(jnp.roll(X.re, sh, axis=-1),
                                 jnp.roll(X.im, sh, axis=-1))
            else:
                X = xp.roll(X, sh, axis=-1)
        return X

    def _ifft_frames(self, X):
        """Inverse of _fft_frames, returning m_num samples per slice."""
        is_split = isinstance(X, SplitComplex)
        xp = jnp if (is_split or _is_jax(X)) else np
        if self.onesided_fft:
            if self._fft_mode == "onesided2X":
                fac = math.sqrt(2) if self._scaling == "psd" else 2.0
                sl = slice(1, -1 if self._mfft % 2 == 0 else None)
                if is_split:
                    X = SplitComplex(X.re.at[..., sl].divide(fac),
                                     X.im.at[..., sl].divide(fac))
                elif xp is np:
                    X = X.copy()
                    X[..., sl] /= fac
                else:
                    X = X.at[..., sl].divide(fac)
            fr = api.irfft(X, self._mfft, config=self._config)
        else:
            if self._fft_mode == "centered":
                sh = -(self._mfft // 2)
                if is_split:
                    X = SplitComplex(jnp.roll(X.re, sh, axis=-1),
                                     jnp.roll(X.im, sh, axis=-1))
                else:
                    X = xp.roll(X, sh, axis=-1)
            fr = api.ifft(X, self._mfft, config=self._config)
        if xp is np and isinstance(fr, jax.Array):
            # numpy in -> numpy out (see _fft_frames)
            fr = np.asarray(fr)
        if self._phase_shift is not None:
            p_s = (self._phase_shift + self.m_num_mid) % self.m_num
            if isinstance(fr, SplitComplex):
                fr = SplitComplex(jnp.roll(fr.re, p_s, axis=-1),
                                  jnp.roll(fr.im, p_s, axis=-1))
            else:
                fr = xp.roll(fr, p_s, axis=-1)
        if isinstance(fr, SplitComplex):
            return SplitComplex(fr.re[..., :self.m_num],
                                fr.im[..., :self.m_num])
        return fr[..., :self.m_num]

    def stft(self, x, p0=None, p1=None, *, k_offset: int = 0,
             padding: str = "zeros", axis: int = -1):
        """Short-time FFT: (..., f_pts, p1-p0) with the f/t axes last."""
        return self.stft_detrend(x, None, p0, p1, k_offset=k_offset,
                                 padding=padding, axis=axis)

    def stft_detrend(self, x, detr, p0=None, p1=None, *,
                     k_offset: int = 0, padding: str = "zeros",
                     axis: int = -1):
        xp = jnp if _is_jax(x) else np
        if isinstance(x, SplitComplex):
            raise ValueError("complex device input: pass planes through "
                             "fft_mode='twosided' as a complex jax array "
                             "on a complex-capable backend")
        x = xp.asarray(x)
        if np.issubdtype(np.dtype(x.dtype), np.complexfloating) \
                and self.onesided_fft:
            raise ValueError("complex input requires fft_mode 'twosided' "
                             "or 'centered'")
        if x.shape[axis] < self.m_num - self.m_num_mid:
            raise ValueError(f"axis length {x.shape[axis]} is shorter "
                             f"than a single window placement "
                             f"({self.m_num - self.m_num_mid})")
        if axis not in (-1, x.ndim - 1):
            x = xp.moveaxis(x, axis, -1)
        if detr is not None and not callable(detr) \
                and detr not in ("linear", "constant"):
            raise ValueError("detr must be 'linear', 'constant', or "
                             "a callable")
        p0, p1 = self.p_range(x.shape[-1], p0, p1)
        fr = self._frames(x, p0, p1, k_offset, padding)
        if detr is not None:
            if callable(detr):
                fr = detr(fr)
            else:
                from .sigtools import detrend as _detrend
                fr = _detrend(fr, type=detr, axis=-1)
        X = self._fft_frames(fr)

        # (..., p, f) -> (..., f, p); then the frequency axis replaces
        # the data axis (scipy: time slices always trail)
        def _place(a, ap):
            a = ap.swapaxes(a, -1, -2)
            if x.ndim > 1:
                a = ap.moveaxis(a, -2, axis if axis >= 0 else axis - 1)
            return a

        if isinstance(X, SplitComplex):
            return SplitComplex(_place(X.re, jnp), _place(X.im, jnp))
        return _place(X, jnp if _is_jax(X) else np)

    def spectrogram(self, x, y=None, detr=None, *, p0=None, p1=None,
                    k_offset: int = 0, padding: str = "zeros",
                    axis: int = -1):
        """Sx * conj(Sy) (or |Sx|^2 when y is None)."""
        Sx = self.stft_detrend(x, detr, p0, p1, k_offset=k_offset,
                               padding=padding, axis=axis)
        if y is None:
            if isinstance(Sx, SplitComplex):
                return Sx.re * Sx.re + Sx.im * Sx.im
            xp = jnp if _is_jax(Sx) else np
            return xp.real(Sx * xp.conj(Sx))
        Sy = self.stft_detrend(y, detr, p0, p1, k_offset=k_offset,
                               padding=padding, axis=axis)
        if isinstance(Sx, SplitComplex):
            return SplitComplex(Sx.re * Sy.re + Sx.im * Sy.im,
                                Sx.im * Sy.re - Sx.re * Sy.im)
        xp = jnp if _is_jax(Sx) else np
        return Sx * xp.conj(Sy)

    def istft(self, S, k0: int = 0, k1=None, *, f_axis: int = -2,
              t_axis: int = -1):
        """Inverse short-time FFT by dual-window overlap-add."""
        is_split = isinstance(S, SplitComplex)
        xp = jnp if (is_split or _is_jax(S)) else np
        ndim = len(S.shape)
        fa = f_axis % ndim
        ta = t_axis % ndim
        if fa == ta:
            raise ValueError("f_axis and t_axis must differ")
        if S.shape[fa] != self.f_pts:
            raise ValueError(f"S.shape[f_axis]={S.shape[fa]} != "
                             f"f_pts={self.f_pts}")
        if (fa, ta) != (ndim - 2, ndim - 1):
            if is_split:
                S = SplitComplex(jnp.moveaxis(S.re, (fa, ta), (-2, -1)),
                                 jnp.moveaxis(S.im, (fa, ta), (-2, -1)))
            else:
                S = xp.moveaxis(S, (fa, ta), (-2, -1))
        q_num = S.shape[-1]
        n_min = self.m_num - self.m_num_mid
        if q_num < self.p_num(n_min):
            raise ValueError(f"S needs at least {self.p_num(n_min)} "
                             f"slices, got {q_num}")
        k_max = (self.p_min + q_num - 1) * self._hop - self.m_num_mid \
            + self.m_num
        k1 = k_max if k1 is None else int(k1)
        if not (self.k_min <= k0 < k1 <= k_max):
            raise ValueError(f"need k_min={self.k_min} <= k0 < k1 <= "
                             f"{k_max}, got k0={k0}, k1={k1}")
        if k1 - k0 < n_min:
            raise ValueError(f"k1 - k0 = {k1 - k0} must be at least half "
                             f"the window length ({n_min})")
        # (..., f, p) -> (..., p, f) -> inverse frames (..., p, m_num)
        if is_split:
            S = SplitComplex(jnp.swapaxes(S.re, -1, -2),
                             jnp.swapaxes(S.im, -1, -2))
        else:
            S = xp.swapaxes(S, -1, -2)
        fr = self._ifft_frames(S)
        dual = self.dual_win
        if isinstance(fr, SplitComplex):
            if np.iscomplexobj(dual):
                dr, di = jnp.asarray(dual.real), jnp.asarray(dual.imag)
                contrib_re = fr.re * dr - fr.im * di
                contrib_im = fr.re * di + fr.im * dr
            else:
                d = jnp.asarray(dual)
                contrib_re, contrib_im = fr.re * d, fr.im * d
        else:
            contrib_re = fr * (dual if xp is np else xp.asarray(dual))
            contrib_im = None
        # scatter-add all slices at once
        k_slice = (self.p_min + np.arange(q_num)) * self._hop \
            - self.m_num_mid
        idx = k_slice[:, None] + np.arange(self.m_num)[None, :] - k0
        L = k1 - k0
        valid = (idx >= 0) & (idx < L)
        idxc = np.clip(idx, 0, L - 1)

        def ola(contrib):
            contrib = contrib * (valid if xp is np
                                 else jnp.asarray(valid))
            out_shape = contrib.shape[:-2] + (L,)
            if xp is np:
                out = np.zeros(out_shape, contrib.dtype)
                np.add.at(out, (Ellipsis,) + (idxc,), contrib)
                return out
            out = jnp.zeros(out_shape, contrib.dtype)
            return out.at[..., idxc].add(contrib)

        out_re = ola(contrib_re)
        out_im = None if contrib_im is None else ola(contrib_im)
        if xp is np and out_im is None and np.iscomplexobj(out_re) \
                and self._fft_mode in ("onesided", "onesided2X"):
            out_re = out_re.real

        # scipy axis contract: for batched S the reconstructed time axis
        # lands where the frequency axis was (or the time axis if f was
        # last); 1-D output stays 1-D
        out_ndim = ndim - 1
        if out_ndim > 1:
            dst = fa if fa < out_ndim else ta
            mv = jnp.moveaxis if xp is jnp else np.moveaxis
            out_re = mv(out_re, -1, dst)
            out_im = None if out_im is None else mv(out_im, -1, dst)
        if out_im is not None:
            return SplitComplex(out_re, out_im)
        return out_re
