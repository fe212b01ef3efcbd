"""Peak finding: local extrema, prominences, widths, and the full
find_peaks filter chain.

Beyond reference parity (the reference, martinvuyk/hackathon-fft, stops
at raw transforms); scipy parity targets are
scipy/signal/_peak_finding.py (find_peaks, peak_prominences,
peak_widths, argrelmin/argrelmax/argrelextrema).

Everything here is index bookkeeping over a 1-D host array — O(n)
scalar scans with data-dependent control flow, which is exactly what
does NOT belong on an accelerator (no static shapes, no matrix work).
Implemented as straightforward numpy/Python from the standard
definitions; the parity tests pin exact index/property equality with
scipy on adversarial inputs (plateaus, borders, equal heights).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["find_peaks", "find_peaks_cwt", "peak_prominences",
           "peak_widths", "argrelmin", "argrelmax", "argrelextrema"]


# ---------------------------------------------------------------------------
# Relative extrema (comparator within an +-order neighborhood)


def _boolrelextrema(data: np.ndarray, comparator, axis: int = 0,
                    order: int = 1, mode: str = "clip") -> np.ndarray:
    if int(order) != order or order < 1:
        raise ValueError("Order must be an int >= 1")
    order = int(order)
    datalen = data.shape[axis]
    locs = np.arange(0, datalen)
    results = np.ones(data.shape, dtype=bool)
    main = data.take(locs, axis=axis, mode=mode)
    for shift in range(1, order + 1):
        plus = data.take(locs + shift, axis=axis, mode=mode)
        minus = data.take(locs - shift, axis=axis, mode=mode)
        results &= comparator(main, plus)
        results &= comparator(main, minus)
        if ~results.any():
            return results
    return results


def argrelextrema(data, comparator, axis: int = 0, order: int = 1,
                  mode: str = "clip"):
    """Indices of relative extrema under ``comparator``
    (scipy.signal.argrelextrema-compatible): points that compare true
    against EVERY neighbor within ``order`` samples on both sides;
    boundaries handled by ``mode`` ('clip' or 'wrap')."""
    data = np.asarray(data)
    results = _boolrelextrema(data, comparator, axis, order, mode)
    return np.nonzero(results)


def argrelmax(data, axis: int = 0, order: int = 1, mode: str = "clip"):
    """Indices of relative maxima (scipy.signal.argrelmax-compatible;
    strictly greater than all neighbors in range, so plateau tops do
    NOT qualify — use find_peaks for plateau handling)."""
    return argrelextrema(data, np.greater, axis, order, mode)


def argrelmin(data, axis: int = 0, order: int = 1, mode: str = "clip"):
    """Indices of relative minima (scipy.signal.argrelmin-compatible)."""
    return argrelextrema(data, np.less, axis, order, mode)


# ---------------------------------------------------------------------------
# Local maxima with plateau handling (find_peaks' base detector)


def _local_maxima_1d(x: np.ndarray):
    """Midpoints and edges of all strict local maxima, treating flat
    tops as one peak at the plateau midpoint (rounded down)."""
    n = x.shape[0]
    midpoints = []
    left_edges = []
    right_edges = []
    i = 1
    i_max = n - 1
    while i < i_max:
        if x[i - 1] < x[i]:
            i_ahead = i + 1
            # walk over a possible plateau
            while i_ahead < i_max and x[i_ahead] == x[i]:
                i_ahead += 1
            if x[i_ahead] < x[i]:
                left = i
                right = i_ahead - 1
                midpoints.append((left + right) // 2)
                left_edges.append(left)
                right_edges.append(right)
                i = i_ahead
                continue
        i += 1
    return (np.array(midpoints, np.intp), np.array(left_edges, np.intp),
            np.array(right_edges, np.intp))


def _select_by_peak_distance(peaks: np.ndarray, priority: np.ndarray,
                             distance: float) -> np.ndarray:
    """Greedy keep-highest-first thinning: any peak closer than
    ``distance`` to an already-kept higher peak is dropped."""
    peaks_size = peaks.shape[0]
    distance_ = math.ceil(distance)
    keep = np.ones(peaks_size, bool)
    # iterate highest priority first; argsort is stable so equal heights
    # resolve by position, like scipy
    for j in np.argsort(priority)[::-1]:
        if not keep[j]:
            continue
        k = j - 1
        while 0 <= k and peaks[j] - peaks[k] < distance_:
            keep[k] = False
            k -= 1
        k = j + 1
        while k < peaks_size and peaks[k] - peaks[j] < distance_:
            keep[k] = False
            k += 1
    return keep


# ---------------------------------------------------------------------------
# Prominences and widths


def _arg_x_peaks(x, peaks):
    x = np.asarray(x, np.float64)
    if x.ndim != 1:
        raise ValueError("x must be a 1-D array")
    peaks = np.asarray(peaks)
    if peaks.size and not np.issubdtype(peaks.dtype, np.integer):
        raise TypeError("peaks must be integer indices")
    peaks = peaks.astype(np.intp, copy=False)
    if peaks.ndim != 1:
        raise ValueError("peaks must be a 1-D array")
    if peaks.size and (peaks.min() < 0 or peaks.max() >= x.shape[0]):
        raise ValueError("a peak index is out of range for x")
    return x, peaks


def peak_prominences(x, peaks, wlen=None):
    """Prominence of each peak (scipy.signal.peak_prominences-
    compatible): height above the higher of the two key saddles.

    Algorithm (the standard topographic definition): extend a window
    from the peak left/right until the signal exceeds the peak height
    or the (optional ``wlen``-limited) border; the minima of the two
    stretches are the bases; prominence = peak - max(base values)."""
    x, peaks = _arg_x_peaks(x, peaks)
    if wlen is not None:
        if wlen <= 1:
            raise ValueError("wlen must be larger than 1")
        wlen = int(math.ceil(wlen))    # scipy: any value > 1 rounds up
    prominences = np.empty(peaks.shape[0], np.float64)
    left_bases = np.empty(peaks.shape[0], np.intp)
    right_bases = np.empty(peaks.shape[0], np.intp)
    for pi, peak in enumerate(peaks):
        i_min = 0
        i_max = x.shape[0] - 1
        if wlen is not None:
            # even wlen rounds up to the odd window centered on the peak
            i_min = max(peak - wlen // 2, i_min)
            i_max = min(peak + wlen // 2, i_max)
        # left stretch
        i = left_bases[pi] = peak
        left_min = x[peak]
        while i_min <= i and x[i] <= x[peak]:
            if x[i] < left_min:
                left_min = x[i]
                left_bases[pi] = i
            i -= 1
        # right stretch
        i = right_bases[pi] = peak
        right_min = x[peak]
        while i <= i_max and x[i] <= x[peak]:
            if x[i] < right_min:
                right_min = x[i]
                right_bases[pi] = i
            i += 1
        prominences[pi] = x[peak] - max(left_min, right_min)
    return prominences, left_bases, right_bases


def peak_widths(x, peaks, rel_height: float = 0.5, prominence_data=None,
                wlen=None):
    """Width of each peak at a relative height
    (scipy.signal.peak_widths-compatible): intersection points of the
    horizontal line at ``peak_height - prominence*rel_height`` with the
    signal, linearly interpolated, bounded by the prominence bases."""
    x, peaks = _arg_x_peaks(x, peaks)
    if rel_height < 0:
        raise ValueError("rel_height must be >= 0")
    if prominence_data is None:
        prominence_data = peak_prominences(x, peaks, wlen)
    prominences, left_bases, right_bases = prominence_data
    prominences = np.asarray(prominences, np.float64)
    left_bases = np.asarray(left_bases, np.intp)
    right_bases = np.asarray(right_bases, np.intp)
    if not (prominences.shape == left_bases.shape == right_bases.shape
            == peaks.shape):
        raise ValueError("prominence_data is invalid for peaks")
    widths = np.empty(peaks.shape[0], np.float64)
    width_heights = np.empty(peaks.shape[0], np.float64)
    left_ips = np.empty(peaks.shape[0], np.float64)
    right_ips = np.empty(peaks.shape[0], np.float64)
    for pi, peak in enumerate(peaks):
        i_min = left_bases[pi]
        i_max = right_bases[pi]
        if not 0 <= i_min <= peak <= i_max < x.shape[0]:
            raise ValueError("prominence data is invalid for peak "
                             f"{int(peak)}")
        height = width_heights[pi] = x[peak] - prominences[pi] * rel_height
        # left intersection
        i = peak
        while i_min < i and height < x[i]:
            i -= 1
        left_ip = float(i)
        if x[i] < height:
            left_ip += (height - x[i]) / (x[i + 1] - x[i])
        # right intersection
        i = peak
        while i < i_max and height < x[i]:
            i += 1
        right_ip = float(i)
        if x[i] < height:
            right_ip -= (height - x[i]) / (x[i - 1] - x[i])
        widths[pi] = right_ip - left_ip
        left_ips[pi] = left_ip
        right_ips[pi] = right_ip
    return widths, width_heights, left_ips, right_ips


# ---------------------------------------------------------------------------
# find_peaks filter chain


def _unpack_condition_args(interval, x, peaks):
    try:
        imin, imax = interval
    except (TypeError, ValueError):
        imin, imax = (interval, None)
    if isinstance(imin, np.ndarray):
        if imin.size != x.size:
            raise ValueError("array size of lower interval border must "
                             "match x")
        imin = imin[peaks]
    if isinstance(imax, np.ndarray):
        if imax.size != x.size:
            raise ValueError("array size of upper interval border must "
                             "match x")
        imax = imax[peaks]
    return imin, imax


def _select_by_property(value, pmin, pmax) -> np.ndarray:
    keep = np.ones(value.size, bool)
    if pmin is not None:
        keep &= pmin <= value
    if pmax is not None:
        keep &= value <= pmax
    return keep


def _select_by_peak_threshold(x, peaks, tmin, tmax):
    stacked = np.vstack([x[peaks] - x[peaks - 1], x[peaks] - x[peaks + 1]])
    keep = np.ones(peaks.size, bool)
    if tmin is not None:
        keep &= tmin <= np.min(stacked, axis=0)
    if tmax is not None:
        keep &= np.max(stacked, axis=0) <= tmax
    return keep, stacked[0], stacked[1]


def find_peaks(x, height=None, threshold=None, distance=None,
               prominence=None, width=None, wlen=None,
               rel_height: float = 0.5, plateau_size=None):
    """Find local maxima subject to property filters
    (scipy.signal.find_peaks-compatible): plateau-aware strict maxima,
    filtered in scipy's documented order — plateau_size, height,
    threshold, distance, prominence, width — with every evaluated
    property returned in the properties dict."""
    x = np.asarray(x, np.float64)
    if x.ndim != 1:
        raise ValueError("x must be a 1-D array")
    if distance is not None and distance < 1:
        raise ValueError("distance must be greater or equal to 1")

    peaks, left_edges, right_edges = _local_maxima_1d(x)
    properties = {}

    if plateau_size is not None:
        pmin, pmax = _unpack_condition_args(plateau_size, x, peaks)
        plateau_sizes = right_edges - left_edges + 1
        keep = _select_by_property(plateau_sizes, pmin, pmax)
        peaks = peaks[keep]
        properties["plateau_sizes"] = plateau_sizes[keep]
        properties["left_edges"] = left_edges[keep]
        properties["right_edges"] = right_edges[keep]

    if height is not None:
        hmin, hmax = _unpack_condition_args(height, x, peaks)
        properties["peak_heights"] = x[peaks]
        keep = _select_by_property(properties["peak_heights"], hmin, hmax)
        peaks = peaks[keep]
        properties = {k: v[keep] for k, v in properties.items()}

    if threshold is not None:
        tmin, tmax = _unpack_condition_args(threshold, x, peaks)
        keep, left_t, right_t = _select_by_peak_threshold(
            x, peaks, tmin, tmax)
        peaks = peaks[keep]
        properties["left_thresholds"] = left_t
        properties["right_thresholds"] = right_t
        properties = {k: v[keep] for k, v in properties.items()}

    if distance is not None:
        keep = _select_by_peak_distance(peaks, x[peaks], distance)
        peaks = peaks[keep]
        properties = {k: v[keep] for k, v in properties.items()}

    if prominence is not None or width is not None:
        properties.update(zip(
            ["prominences", "left_bases", "right_bases"],
            peak_prominences(x, peaks, wlen)))

    if prominence is not None:
        pmin, pmax = _unpack_condition_args(prominence, x, peaks)
        keep = _select_by_property(properties["prominences"], pmin, pmax)
        peaks = peaks[keep]
        properties = {k: v[keep] for k, v in properties.items()}

    if width is not None:
        properties.update(zip(
            ["widths", "width_heights", "left_ips", "right_ips"],
            peak_widths(x, peaks, rel_height,
                        (properties["prominences"],
                         properties["left_bases"],
                         properties["right_bases"]))))
        wmin, wmax = _unpack_condition_args(width, x, peaks)
        keep = _select_by_property(properties["widths"], wmin, wmax)
        peaks = peaks[keep]
        properties = {k: v[keep] for k, v in properties.items()}

    return peaks, properties


# ---------------------------------------------------------------------------
# Wavelet-based peak finding (scipy parity target:
# scipy/signal/_peak_finding.py find_peaks_cwt + the ricker wavelet
# scipy removed from its public namespace in 1.15)


def _ricker(points, a: float) -> np.ndarray:
    """Ricker (Mexican-hat) wavelet: the classical
    2 / (sqrt(3a) pi^(1/4)) (1 - (t/a)^2) exp(-t^2 / (2 a^2))."""
    A = 2 / (np.sqrt(3 * a) * np.pi ** 0.25)
    t = np.arange(0, points) - (points - 1.0) / 2
    return A * (1 - (t / a) ** 2) * np.exp(-(t ** 2) / (2 * a ** 2))


def _cwt(data: np.ndarray, wavelet, widths) -> np.ndarray:
    """Continuous wavelet transform rows: same-mode convolution of the
    signal with the CONJ-REVERSED scaled wavelet (i.e. correlation with
    the wavelet — scipy's convention, which matters for asymmetric or
    complex custom wavelets), window capped at 10 widths. The window
    length is passed to the wavelet as the raw float min(10*w, N),
    matching scipy's arange-based sizing for fractional widths; the
    output dtype follows the wavelet's."""
    rows = []
    for w in widths:
        npts = np.min([10 * w, len(data)])
        ker = np.conj(wavelet(npts, w)[::-1])
        row = np.convolve(data, ker, mode="same")
        # complex wavelets: the ridge/SNR machinery works on the real
        # part (scipy's behavior — its relextrema/percentile stages
        # would reject complex rows)
        rows.append(row.real if np.iscomplexobj(row) else row)
    return np.asarray(rows)


def _identify_ridge_lines(matr: np.ndarray, max_distances, gap_thresh):
    """Connect per-row relative maxima of the CWT into ridge lines,
    walking from the largest scale down; a line tolerates up to
    ``gap_thresh`` consecutive rows without a connected maximum
    (Du, Kibbe, Lin 2006 — the algorithm scipy implements)."""
    if len(max_distances) < matr.shape[0]:
        raise ValueError("max_distances must have at least as many "
                         "rows as matr")
    all_max_cols = _boolrelextrema(matr, np.greater, axis=1, order=1)
    has_relmax = np.nonzero(all_max_cols.any(axis=1))[0]
    if len(has_relmax) == 0:
        return []
    start_row = has_relmax[-1]
    # each line: [rows, cols, gap_number]
    ridge_lines = [[[start_row], [col], 0]
                   for col in np.nonzero(all_max_cols[start_row])[0]]
    final_lines = []
    rows = np.arange(start_row - 1, -1, -1)
    cols = np.arange(matr.shape[1])
    for row in rows:
        this_max_cols = cols[all_max_cols[row]]
        # increment all gaps; connections below reset them
        for line in ridge_lines:
            line[2] += 1
        prev_ridge_cols = np.array([line[1][-1] for line in ridge_lines])
        for col in this_max_cols:
            # attach to the closest previous ridge column within range,
            # else start a new line
            if len(prev_ridge_cols) > 0:
                diffs = np.abs(col - prev_ridge_cols)
                closest = np.argmin(diffs)
            else:
                diffs = None
            if diffs is not None and diffs[closest] <= \
                    max_distances[row]:
                line = ridge_lines[closest]
                line[1].append(col)
                line[0].append(row)
                line[2] = 0
            else:
                ridge_lines.append([[row], [col], 0])
        # retire lines whose gap exceeded the threshold
        for ind in range(len(ridge_lines) - 1, -1, -1):
            line = ridge_lines[ind]
            if line[2] > gap_thresh:
                final_lines.append(line)
                del ridge_lines[ind]
    out_lines = []
    for line in final_lines + ridge_lines:
        sortargs = np.array(np.argsort(line[0]))
        rows_l = np.zeros_like(sortargs)
        cols_l = np.zeros_like(sortargs)
        rows_l[sortargs] = line[0]
        cols_l[sortargs] = line[1]
        out_lines.append([rows_l, cols_l])
    return out_lines


def _filter_ridge_lines(cwt_mat, ridge_lines, window_size=None,
                        min_length=None, min_snr=1, noise_perc=10):
    num_points = cwt_mat.shape[1]
    if min_length is None:
        min_length = np.ceil(cwt_mat.shape[0] / 4)
    if window_size is None:
        window_size = np.ceil(num_points / 20)
    window_size = int(window_size)
    hf_window, odd = divmod(window_size, 2)
    # noise level: percentile of |smallest-scale row| in a window
    # NOTE: the percentile runs over the SIGNED smallest-scale row
    # (scipy's convention) — the low percentile of an oscillating row
    # is typically a NEGATIVE trough, and the abs() wraps the whole
    # SNR ratio below, so the effective noise level is that trough's
    # magnitude, not the small-|value| floor
    row_one = cwt_mat[0, :]
    noises = np.empty_like(row_one)
    for ind in range(num_points):
        window_start = max(ind - hf_window, 0)
        window_end = min(ind + hf_window + odd, num_points)
        noises[ind] = np.percentile(row_one[window_start:window_end],
                                    noise_perc)

    def filt_func(line):
        if len(line[0]) < min_length:
            return False
        snr = abs(cwt_mat[line[0][0], line[1][0]] / noises[line[1][0]])
        return snr >= min_snr

    return list(filter(filt_func, ridge_lines))


def find_peaks_cwt(vector, widths, wavelet=None, max_distances=None,
                   gap_thresh=None, min_length=None, min_snr: float = 1,
                   noise_perc: float = 10, window_size=None):
    """Wavelet-ridge peak detection (scipy.signal.find_peaks_cwt-
    compatible): CWT against Ricker wavelets over ``widths``, connect
    per-scale maxima into ridge lines, keep lines that are long enough
    and whose smallest-scale SNR clears ``min_snr``."""
    widths = np.atleast_1d(np.asarray(widths))
    if gap_thresh is None:
        gap_thresh = np.ceil(widths[0])
    if max_distances is None:
        max_distances = widths / 4.0
    if wavelet is None:
        wavelet = _ricker
    vector = np.asarray(vector)
    cwt_dat = _cwt(vector, wavelet, widths)
    ridge_lines = _identify_ridge_lines(cwt_dat, max_distances,
                                        gap_thresh)
    filtered = _filter_ridge_lines(cwt_dat, ridge_lines,
                                   window_size=window_size,
                                   min_length=min_length,
                                   min_snr=min_snr,
                                   noise_perc=noise_perc)
    max_locs = np.asarray([x[1][0] for x in filtered])
    max_locs.sort()
    return max_locs
