"""scipy.fft interop: worker control and the uarray backend object.

Two pieces of ``scipy.fft`` surface the reference library has no analog
for (PARITY.md "beyond parity"):

- ``set_workers``/``get_workers``: scipy's thread-count context manager.
  Here it controls the native C++ CPU engine's OpenMP team (the only
  host-threaded execution path — XLA's device dispatch is async and does
  not scale with host threads). Default 0 = the engine's own default (all
  cores, OpenMP runtime policy), matching the library's standing behavior.

- ``ScipyBackend``: a ``scipy.fft.set_backend`` target. With

      import scipy.fft, tpufft
      with scipy.fft.set_backend(tpufft.scipy_backend()):
          scipy.fft.fft(x)            # runs through tpufft

  every scipy.fft call whose name tpufft implements (fft family, real
  transforms, DCT/DST, fht, helper functions) is served by this library;
  unknown names return NotImplemented so uarray falls back to scipy's own
  implementation. scipy-only kwargs (``workers``, ``overwrite_x``,
  ``plan``) are accepted: ``workers`` maps to :func:`set_workers` for the
  duration of the call, the others are validated no-ops (scipy's own
  pocketfft treats ``plan`` the same way).
"""

from __future__ import annotations

import contextlib
import threading

_state = threading.local()

__all__ = ["set_workers", "get_workers", "scipy_backend", "ScipyBackend"]


def get_workers() -> int:
    """Current worker-thread count for the native CPU engine (0 = engine
    default: one OpenMP thread per core)."""
    return getattr(_state, "workers", 0)


@contextlib.contextmanager
def set_workers(workers: int):
    """scipy.fft.set_workers analog: pin the native CPU engine's OpenMP
    team size within the context. Negative counts mean "all cores"
    (scipy's -1 convention); 0 restores the engine default."""
    workers = int(workers)
    if workers < 0:
        workers = 0  # engine default = all cores, scipy's -1 semantics
    prev = get_workers()
    _state.workers = workers
    try:
        yield
    finally:
        _state.workers = prev


class ScipyBackend:
    """uarray backend serving scipy.fft calls with tpufft implementations."""

    __ua_domain__ = "numpy.scipy.fft"

    @staticmethod
    def __ua_function__(method, args, kwargs):
        import tpufft

        fn = getattr(tpufft, method.__name__, None)
        if fn is None:
            return NotImplemented
        kwargs = dict(kwargs)
        workers = kwargs.pop("workers", None)
        kwargs.pop("overwrite_x", None)  # tpufft never writes in place
        if kwargs.pop("plan", None) is not None:
            return NotImplemented  # precomputed plans are plan_fft's job
        if kwargs.pop("orthogonalize", None) is not None:
            return NotImplemented  # semantics-changing: let scipy serve it
        with contextlib.ExitStack() as stack:
            if workers is not None:
                stack.enter_context(set_workers(workers))
            return fn(*args, **kwargs)


def scipy_backend() -> type[ScipyBackend]:
    """The backend object to hand to ``scipy.fft.set_backend``."""
    return ScipyBackend
