// tpufft native CPU engine: mixed-radix Stockham autosort FFT.
//
// The C++ counterpart of the framework's split-plane execution model and
// the role the reference's Mojo CPU backend plays (fft/fft/_ndim_fft_cpu.mojo:
// _CPUPlan/_run_cpu_nd_fft) plus its native benchmark harness
// (cufft-benchmark-main/cufft_benchmark.cu): a host-side engine used as
// (a) the CPU execution backend behind tpufft.native, and (b) the
// vendor-independent host baseline the device numbers are compared against.
//
// Design (not a translation): split re/im planes end-to-end (matching the
// library's SplitComplex data model instead of interleaved complex), per-length plan cache with
// host-precomputed double-precision twiddles, Stockham ping-pong stages in
// contiguous scratch, OpenMP over batch rows, strided axes handled by
// gather->transform->scatter through thread-local scratch.
//
// C ABI only; bound from Python via ctypes (tpufft/native.py).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

namespace {

constexpr double kTau = 6.283185307179586476925286766559;

// Phase profiler (TPUFFT_PROF=1): nanosecond accumulators read/reset via
// tpufft_prof_read(). Timer pairs sit at phase granularity (per batch
// group / four-step pass), so the overhead is negligible when enabled and
// a single branch when not.
enum ProfPhase {
  kProfGather = 0,
  kProfTransform,
  kProfScatter,
  kProfFsP1Copy,
  kProfFsP1Fft,
  kProfFsP1Tw,
  kProfFsP2Fft,
  kProfFsP2Scatter,
  kProfLGather,
  kProfLTransform,
  kProfLScatter,
  kProfPhases
};
std::atomic<int64_t> g_prof_ns[kProfPhases];

inline bool prof_on() {
  static const bool on = std::getenv("TPUFFT_PROF") != nullptr;
  return on;
}

struct ProfTimer {
  int phase;
  std::chrono::steady_clock::time_point t0;
  explicit ProfTimer(int p) : phase(p) {
    if (prof_on()) t0 = std::chrono::steady_clock::now();
  }
  ~ProfTimer() {
    if (prof_on()) {
      auto dt = std::chrono::steady_clock::now() - t0;
      g_prof_ns[phase].fetch_add(
          std::chrono::duration_cast<std::chrono::nanoseconds>(dt).count(),
          std::memory_order_relaxed);
    }
  }
};

struct Stage {
  int64_t radix;
  int64_t m;  // twiddle groups: n / (radix * s)
  int64_t s;  // cumulative product of prior radices
  // twiddle tables, laid out [j * m + p], j in [radix), p in [m)
  std::vector<double> tw_re;
  std::vector<double> tw_im;
  // radix DFT matrix [j * radix + b]
  std::vector<double> w_re;
  std::vector<double> w_im;
};

struct Plan {
  int64_t n = 0;
  bool inverse = false;
  std::vector<Stage> stages;
};

std::vector<int64_t> factorize(int64_t n) {
  std::vector<int64_t> f;
  for (int64_t d = 2; d * d <= n; d += (d == 2 ? 1 : 2)) {
    while (n % d == 0) {
      f.push_back(d);
      n /= d;
    }
  }
  if (n > 1) f.push_back(n);
  return f;
}

// Radix policy: power-of-two content becomes 16/8/4/2 stages (the batch
// path has constant-folded butterflies for those — adds, ±i plane swaps
// and a few w16 constants, no dense DFT multiplies); odd factors are
// greedily merged toward <=16 for the generic load-once stage (same policy
// as tpufft/planner.py). Radix-16 is only emitted for batch-path plans
// (``vec16``): the scalar transform_1d path runs every radix as a dense
// accumulation, where r=16 costs 16 cmuls/point and loses to 8/8 — so the
// two paths get separately cached plans (the vec16 flag is part of the
// plan-cache key).
std::vector<int64_t> choose_radices(int64_t n, bool vec16,
                                    int64_t max_radix = 16) {
  std::vector<int64_t> f = factorize(n);
  int twos = 0;
  std::vector<int64_t> odd;
  for (int64_t v : f) {
    if (v == 2) ++twos; else odd.push_back(v);
  }
  // 3s and 5s stay UNMERGED: the dedicated radix-3/5 butterflies cost
  // ~r adds + O(1) muls per element where the generic load-once stage
  // pays r complex MACs — a split [3,5] pair (8 cmac-equivalents over
  // two L1-resident passes) beats one generic radix-15 (15 cmacs).
  // Merging only ever produced 9/15 (the sole odd pairs <= 16), so no
  // other composites are affected.
  (void)max_radix;
  std::sort(odd.begin(), odd.end());
  if (vec16) {
    // pick the 16/8/4/2 mix minimizing (stage count, radix-2 passes, #16s)
    int best_k = 0, best_cost = 1 << 30;
    for (int k = 0; 4 * k <= twos; ++k) {
      int rem = twos - 4 * k;
      int stages = k + rem / 3 + (rem % 3 ? 1 : 0);
      int cost = stages * 16 + (rem % 3 == 1 ? 8 : 0) + k;
      if (cost < best_cost) { best_cost = cost; best_k = k; }
    }
    for (int k = 0; k < best_k; ++k) odd.push_back(16);
    twos -= 4 * best_k;
  }
  while (twos >= 3) { odd.push_back(8); twos -= 3; }
  if (twos == 2) odd.push_back(4);
  if (twos == 1) odd.push_back(2);
  std::sort(odd.rbegin(), odd.rend());
  return odd;
}

Plan build_plan(int64_t n, bool inverse, bool vec16) {
  Plan plan;
  plan.n = n;
  plan.inverse = inverse;
  if (n <= 1) return plan;
  const double sign = inverse ? 1.0 : -1.0;
  int64_t s = 1;
  for (int64_t r : choose_radices(n, vec16)) {
    Stage st;
    st.radix = r;
    st.s = s;
    st.m = n / (r * s);
    st.w_re.resize(r * r);
    st.w_im.resize(r * r);
    for (int64_t j = 0; j < r; ++j) {
      for (int64_t b = 0; b < r; ++b) {
        double th = sign * kTau * double((j * b) % r) / double(r);
        st.w_re[j * r + b] = std::cos(th);
        st.w_im[j * r + b] = std::sin(th);
      }
    }
    st.tw_re.resize(r * st.m);
    st.tw_im.resize(r * st.m);
    const double den = double(r * st.m);
    for (int64_t j = 0; j < r; ++j) {
      for (int64_t p = 0; p < st.m; ++p) {
        double th = sign * kTau * double(j * p) / den;
        st.tw_re[j * st.m + p] = std::cos(th);
        st.tw_im[j * st.m + p] = std::sin(th);
      }
    }
    plan.stages.push_back(std::move(st));
    s *= r;
  }
  return plan;
}

// vec16: plan for the vectorized lane-batch path (radix-16 allowed).
const Plan& cached_plan(int64_t n, bool inverse, bool vec16 = false) {
  static std::mutex mu;
  static std::unordered_map<int64_t, Plan> cache;
  std::lock_guard<std::mutex> lock(mu);
  int64_t key = (n * 2 + (inverse ? 1 : 0)) * 2 + (vec16 ? 1 : 0);
  auto it = cache.find(key);
  if (it == cache.end())
    it = cache.emplace(key, build_plan(n, inverse, vec16)).first;
  return it->second;
}

// One length-n Stockham transform on contiguous split planes in `a`,
// ping-ponging with `b`; result left in `a`. Scale fused into last stage.
// Accumulation is done in T (f32 doubles the SIMD width; radix fan-in is
// small so the rounding stays ~1 ulp * log n); tables are f64-computed.
template <typename T>
void transform_1d(const Plan& plan, T* a_re, T* a_im, T* b_re, T* b_im,
                  double scale, std::vector<T>& pscratch) {
  const int64_t n = plan.n;
  if (plan.stages.empty()) {
    if (scale != 1.0) {
      for (int64_t i = 0; i < n; ++i) {
        a_re[i] = T(a_re[i] * scale);
        a_im[i] = T(a_im[i] * scale);
      }
    }
    return;
  }
  T* cur_re = a_re;
  T* cur_im = a_im;
  T* nxt_re = b_re;
  T* nxt_im = b_im;
  const size_t n_stages = plan.stages.size();
  for (size_t t = 0; t < n_stages; ++t) {
    const Stage& st = plan.stages[t];
    const int64_t r = st.radix, m = st.m, s = st.s;
    const double stage_scale = (t + 1 == n_stages) ? scale : 1.0;
    // in viewed (r, m, s) at b*(m*s) + p*s + q
    // out viewed (m, r, s) at p*(r*s) + j*s + q
    if (s == 1 && m >= 8) {
      // First-stage regime: q is trivial but p is the contiguous axis of
      // the input (in[b*m + p]) — block over p so the b-accumulation
      // vectorizes across a p-tile, then write the tile out transposed.
      constexpr int64_t PB = 32;
      if ((int64_t)pscratch.size() < 2 * r * PB) pscratch.resize(2 * r * PB);
      T* acc_re = pscratch.data();
      T* acc_im = pscratch.data() + r * PB;
      for (int64_t p0 = 0; p0 < m; p0 += PB) {
        const int64_t pb = std::min(PB, m - p0);
        for (int64_t j = 0; j < r; ++j) {
          T* ar = acc_re + j * PB;
          T* ai = acc_im + j * PB;
          {
            const T wr = T(st.w_re[j * r + 0]);
            const T wi = T(st.w_im[j * r + 0]);
            const T* xr = cur_re + p0;
            const T* xi = cur_im + p0;
            for (int64_t p = 0; p < pb; ++p) {
              ar[p] = wr * xr[p] - wi * xi[p];
              ai[p] = wr * xi[p] + wi * xr[p];
            }
          }
          for (int64_t b = 1; b < r; ++b) {
            const T wr = T(st.w_re[j * r + b]);
            const T wi = T(st.w_im[j * r + b]);
            const T* xr = cur_re + b * m + p0;
            const T* xi = cur_im + b * m + p0;
            for (int64_t p = 0; p < pb; ++p) {
              ar[p] += wr * xr[p] - wi * xi[p];
              ai[p] += wr * xi[p] + wi * xr[p];
            }
          }
        }
        // twiddle + transposed store: out[(p0+p)*r + j]
        for (int64_t j = 0; j < r; ++j) {
          const T* ar = acc_re + j * PB;
          const T* ai = acc_im + j * PB;
          for (int64_t p = 0; p < pb; ++p) {
            const T twr = T(st.tw_re[j * m + p0 + p] * stage_scale);
            const T twi = T(st.tw_im[j * m + p0 + p] * stage_scale);
            nxt_re[(p0 + p) * r + j] = twr * ar[p] - twi * ai[p];
            nxt_im[(p0 + p) * r + j] = twr * ai[p] + twi * ar[p];
          }
        }
      }
    } else {
      for (int64_t p = 0; p < m; ++p) {
        for (int64_t j = 0; j < r; ++j) {
          const T twr = T(st.tw_re[j * m + p] * stage_scale);
          const T twi = T(st.tw_im[j * m + p] * stage_scale);
          T* out_re = nxt_re + p * (r * s) + j * s;
          T* out_im = nxt_im + p * (r * s) + j * s;
          {
            const T wr = T(st.w_re[j * r + 0]);
            const T wi = T(st.w_im[j * r + 0]);
            const T* xr = cur_re + p * s;
            const T* xi = cur_im + p * s;
            for (int64_t q = 0; q < s; ++q) {
              out_re[q] = wr * xr[q] - wi * xi[q];
              out_im[q] = wr * xi[q] + wi * xr[q];
            }
          }
          for (int64_t b = 1; b < r; ++b) {
            const T wr = T(st.w_re[j * r + b]);
            const T wi = T(st.w_im[j * r + b]);
            const T* xr = cur_re + b * (m * s) + p * s;
            const T* xi = cur_im + b * (m * s) + p * s;
            for (int64_t q = 0; q < s; ++q) {
              out_re[q] += wr * xr[q] - wi * xi[q];
              out_im[q] += wr * xi[q] + wi * xr[q];
            }
          }
          // fused twiddle application
          for (int64_t q = 0; q < s; ++q) {
            const T vr = out_re[q], vi = out_im[q];
            out_re[q] = twr * vr - twi * vi;
            out_im[q] = twr * vi + twi * vr;
          }
        }
      }
    }
    std::swap(cur_re, nxt_re);
    std::swap(cur_im, nxt_im);
  }
  if (cur_re != a_re) {
    std::memcpy(a_re, cur_re, sizeof(T) * n);
    std::memcpy(a_im, cur_im, sizeof(T) * n);
  }
}

// GCC/Clang vector type of V lanes of T. The aligned(sizeof(T)) makes every
// access an unaligned load/store (buffers are only element-aligned), and
// vector variables live in SIMD registers — the array-of-T formulation this
// replaces kept accumulators in memory and ran ~10x slower (measured 6.5 vs
// 67 GFLOP/s on the radix-31 stage at V=16).
template <typename T, int V>
struct VecOf {
  typedef T type
      __attribute__((vector_size(sizeof(T) * V), aligned(sizeof(T))));
};

// Batch-vectorized transform: V transforms at once, data laid out (n, V)
// so every stage's inner loop runs over the V contiguous "lanes" — the CPU
// SIMD counterpart of a batch-minor layout.
//
// Radix-2/4/8 stages run as constant-folded butterflies (pure vector
// adds, ±i plane swaps, one 1/sqrt2 constant — the phasor-specialization
// idea of the reference, fft/fft/_utils.mojo:291-372, at vector-lane
// granularity): ~Sum(r) complex MACs/element drop to ~log2(n) adds, and
// each input is loaded once per stage instead of r times. Other radices
// use a load-once generic stage (inputs gathered to locals, then the
// dense radix-r accumulation from SIMD-register accumulators).
// Returns true when the result landed in the b planes (odd stage count) —
// callers read from there instead of paying a full copy-back pass.
template <typename T, int V>
bool transform_batch_v(const Plan& plan, T* a_re, T* a_im, T* b_re, T* b_im,
                       double scale, std::vector<T>& gscratch) {
  const int64_t n = plan.n;
  T* cur_re = a_re;
  T* cur_im = a_im;
  T* nxt_re = b_re;
  T* nxt_im = b_im;
  const size_t n_stages = plan.stages.size();
  if (n_stages == 0) {  // n == 1: identity transform, scale still applies
    if (scale != 1.0) {
      for (int64_t i = 0; i < n * V; ++i) {
        a_re[i] = T(a_re[i] * scale);
        a_im[i] = T(a_im[i] * scale);
      }
    }
    return false;
  }
  typedef typename VecOf<T, V>::type Tv;
  const T isq2 = T(0.70710678118654752440);
  const T isign = plan.inverse ? T(1) : T(-1);  // sign of i in the kernel
  for (size_t t = 0; t < n_stages; ++t) {
    const Stage& st = plan.stages[t];
    const int64_t r = st.radix, m = st.m, s = st.s;
    const double stage_scale = (t + 1 == n_stages) ? scale : 1.0;
    // per-stage f32 W table (generic path)
    if ((int64_t)gscratch.size() < 2 * r * r) gscratch.resize(2 * r * r);
    T* wre_f = gscratch.data();
    T* wim_f = gscratch.data() + r * r;
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 8 && r != 16) {
      for (int64_t e = 0; e < r * r; ++e) {
        wre_f[e] = T(st.w_re[e]);
        wim_f[e] = T(st.w_im[e]);
      }
    }
    for (int64_t p = 0; p < m; ++p) {
      // twiddles for this p (independent of q): tw[j] * stage_scale
      T twr[32], twi[32];
      for (int64_t j = 0; j < r && j < 32; ++j) {
        twr[j] = T(st.tw_re[j * m + p] * stage_scale);
        twi[j] = T(st.tw_im[j * m + p] * stage_scale);
      }
      const Tv* xin = (const Tv*)(cur_re) + p * s;
      const Tv* yin = (const Tv*)(cur_im) + p * s;
      Tv* xout = (Tv*)(nxt_re) + p * r * s;
      Tv* yout = (Tv*)(nxt_im) + p * r * s;
      const int64_t bstep = m * s;   // input b-stride (Tv units)
      const int64_t jstep = s;       // output j-stride (Tv units)
      if (r == 4) {
        for (int64_t q = 0; q < s; ++q) {
          const Tv ar = xin[q], ai = yin[q];
          const Tv br = xin[bstep + q], bi = yin[bstep + q];
          const Tv cr = xin[2 * bstep + q], ci = yin[2 * bstep + q];
          const Tv dr = xin[3 * bstep + q], di = yin[3 * bstep + q];
          const Tv t0r = ar + cr, t0i = ai + ci;
          const Tv t1r = ar - cr, t1i = ai - ci;
          const Tv t2r = br + dr, t2i = bi + di;
          // i*sign*(b - d)
          const Tv t3r = -isign * (bi - di), t3i = isign * (br - dr);
          const Tv y0r = t0r + t2r, y0i = t0i + t2i;
          const Tv y1r = t1r + t3r, y1i = t1i + t3i;
          const Tv y2r = t0r - t2r, y2i = t0i - t2i;
          const Tv y3r = t1r - t3r, y3i = t1i - t3i;
          xout[q] = twr[0] * y0r - twi[0] * y0i;
          yout[q] = twr[0] * y0i + twi[0] * y0r;
          xout[jstep + q] = twr[1] * y1r - twi[1] * y1i;
          yout[jstep + q] = twr[1] * y1i + twi[1] * y1r;
          xout[2 * jstep + q] = twr[2] * y2r - twi[2] * y2i;
          yout[2 * jstep + q] = twr[2] * y2i + twi[2] * y2r;
          xout[3 * jstep + q] = twr[3] * y3r - twi[3] * y3i;
          yout[3 * jstep + q] = twr[3] * y3i + twi[3] * y3r;
        }
      } else if (r == 2) {
        for (int64_t q = 0; q < s; ++q) {
          const Tv ar = xin[q], ai = yin[q];
          const Tv br = xin[bstep + q], bi = yin[bstep + q];
          const Tv y0r = ar + br, y0i = ai + bi;
          const Tv y1r = ar - br, y1i = ai - bi;
          xout[q] = twr[0] * y0r - twi[0] * y0i;
          yout[q] = twr[0] * y0i + twi[0] * y0r;
          xout[jstep + q] = twr[1] * y1r - twi[1] * y1i;
          yout[jstep + q] = twr[1] * y1i + twi[1] * y1r;
        }
      } else if (r == 8) {
        for (int64_t q = 0; q < s; ++q) {
          Tv xr[8], xi[8];
          for (int b = 0; b < 8; ++b) {
            xr[b] = xin[b * bstep + q];
            xi[b] = yin[b * bstep + q];
          }
          // radix-8 butterfly (i-mult = plane swap; w8 = (1 -+ i)/sqrt2)
          const Tv a0r = xr[0] + xr[4], a0i = xi[0] + xi[4];
          const Tv a1r = xr[0] - xr[4], a1i = xi[0] - xi[4];
          const Tv a2r = xr[2] + xr[6], a2i = xi[2] + xi[6];
          const Tv a3r = xr[2] - xr[6], a3i = xi[2] - xi[6];
          const Tv a4r = xr[1] + xr[5], a4i = xi[1] + xi[5];
          const Tv a5r = xr[1] - xr[5], a5i = xi[1] - xi[5];
          const Tv a6r = xr[3] + xr[7], a6i = xi[3] + xi[7];
          const Tv a7r = xr[3] - xr[7], a7i = xi[3] - xi[7];
          const Tv b0r = a0r + a2r, b0i = a0i + a2i;
          const Tv b1r = a0r - a2r, b1i = a0i - a2i;
          const Tv b2r = a4r + a6r, b2i = a4i + a6i;
          const Tv b3r = a4r - a6r, b3i = a4i - a6i;
          const Tv ib3r = -isign * b3i, ib3i = isign * b3r;
          const Tv ia3r = -isign * a3i, ia3i = isign * a3r;
          const Tv ia7r = -isign * a7i, ia7i = isign * a7r;
          const Tv c1r = a1r + ia3r, c1i = a1i + ia3i;
          const Tv c2r = a1r - ia3r, c2i = a1i - ia3i;
          const Tv d1r = a5r + ia7r, d1i = a5i + ia7i;
          const Tv d2r = a5r - ia7r, d2i = a5i - ia7i;
          // e1 = d1 * (1 + i*sign)/sqrt2 ; e2 = d2 * (-1 + i*sign)/sqrt2
          const Tv e1r = isq2 * (d1r - isign * d1i);
          const Tv e1i = isq2 * (d1i + isign * d1r);
          const Tv e2r = isq2 * (-d2r - isign * d2i);
          const Tv e2i = isq2 * (-d2i + isign * d2r);
          Tv yr[8], yi[8];
          yr[0] = b0r + b2r; yi[0] = b0i + b2i;
          yr[4] = b0r - b2r; yi[4] = b0i - b2i;
          yr[2] = b1r + ib3r; yi[2] = b1i + ib3i;
          yr[6] = b1r - ib3r; yi[6] = b1i - ib3i;
          yr[1] = c1r + e1r; yi[1] = c1i + e1i;
          yr[5] = c1r - e1r; yi[5] = c1i - e1i;
          yr[3] = c2r + e2r; yi[3] = c2i + e2i;
          yr[7] = c2r - e2r; yi[7] = c2i - e2i;
          for (int j = 0; j < 8; ++j) {
            xout[j * jstep + q] = twr[j] * yr[j] - twi[j] * yi[j];
            yout[j * jstep + q] = twr[j] * yi[j] + twi[j] * yr[j];
          }
        }
      } else if (r == 16) {
        // Constant-folded radix-16 as 4x4 Cooley-Tukey: radix-4 over the
        // slow digit, w16 twiddles (constants c1/s1/1/sqrt2, i-swaps), then
        // radix-4 over the fast digit. One pass replaces an 8+2 pair.
        const T c1 = T(0.92387953251128675613);  // cos(pi/8)
        const T s1 = T(0.38268343236508977173);  // sin(pi/8)
        for (int64_t q = 0; q < s; ++q) {
          Tv xr[16], xi[16];
          for (int b = 0; b < 16; ++b) {
            xr[b] = xin[b * bstep + q];
            xi[b] = yin[b * bstep + q];
          }
          // DFT4 on slots {i0, i0+st, i0+2st, i0+3st}, results in place
          auto dft4 = [&](int i0, int st_) {
            const Tv t0r = xr[i0] + xr[i0 + 2 * st_];
            const Tv t0i = xi[i0] + xi[i0 + 2 * st_];
            const Tv t1r = xr[i0] - xr[i0 + 2 * st_];
            const Tv t1i = xi[i0] - xi[i0 + 2 * st_];
            const Tv t2r = xr[i0 + st_] + xr[i0 + 3 * st_];
            const Tv t2i = xi[i0 + st_] + xi[i0 + 3 * st_];
            const Tv t3r = -isign * (xi[i0 + st_] - xi[i0 + 3 * st_]);
            const Tv t3i = isign * (xr[i0 + st_] - xr[i0 + 3 * st_]);
            xr[i0] = t0r + t2r; xi[i0] = t0i + t2i;
            xr[i0 + st_] = t1r + t3r; xi[i0 + st_] = t1i + t3i;
            xr[i0 + 2 * st_] = t0r - t2r; xi[i0 + 2 * st_] = t0i - t2i;
            xr[i0 + 3 * st_] = t1r - t3r; xi[i0 + 3 * st_] = t1i - t3i;
          };
          // multiply slot e by w16^e (wi pre-multiplied by isign)
          auto cm = [&](int sl, T wr, T wi) {
            const Tv vr = xr[sl], vi = xi[sl];
            xr[sl] = wr * vr - wi * vi;
            xi[sl] = wr * vi + wi * vr;
          };
          // stage A: over the slow digit n1 (stride 4); slot 4*k1+n2 then
          // holds A[n2][k1]
          for (int n2 = 0; n2 < 4; ++n2) dft4(n2, 4);
          // w16^{n2*k1} twiddles (exponent = (slot>>2)*(slot&3))
          const T rt = isq2;
          cm(4 + 1, c1, isign * s1);            // k1=1,n2=1: w16^1
          cm(4 + 2, rt, isign * rt);            // k1=1,n2=2: w16^2
          cm(4 + 3, s1, isign * c1);            // k1=1,n2=3: w16^3
          cm(8 + 1, rt, isign * rt);            // k1=2,n2=1: w16^2
          cm(8 + 2, T(0), isign);               // k1=2,n2=2: w16^4 = i^sign
          cm(8 + 3, -rt, isign * rt);           // k1=2,n2=3: w16^6
          cm(12 + 1, s1, isign * c1);           // k1=3,n2=1: w16^3
          cm(12 + 2, -rt, isign * rt);          // k1=3,n2=2: w16^6
          cm(12 + 3, -c1, -isign * s1);         // k1=3,n2=3: w16^9
          // stage B: over the fast digit n2 (stride 1); slot 4*k1+k2 then
          // holds X[k1 + 4*k2]
          for (int k1 = 0; k1 < 4; ++k1) dft4(4 * k1, 1);
          for (int k1 = 0; k1 < 4; ++k1) {
            for (int k2 = 0; k2 < 4; ++k2) {
              const int j = k1 + 4 * k2, sl = 4 * k1 + k2;
              xout[j * jstep + q] = twr[j] * xr[sl] - twi[j] * xi[sl];
              yout[j * jstep + q] = twr[j] * xi[sl] + twi[j] * xr[sl];
            }
          }
        }
      } else if (r == 3) {
        // radix-3: y0 = x0 + t1; y1/y2 = (x0 - t1/2) +- i*isign*s3*(x1-x2)
        const T c3 = T(-0.5);
        const T s3 = T(0.86602540378443864676);  // sin(2*pi/3)
        for (int64_t q = 0; q < s; ++q) {
          const Tv x0r = xin[q], x0i = yin[q];
          const Tv x1r = xin[bstep + q], x1i = yin[bstep + q];
          const Tv x2r = xin[2 * bstep + q], x2i = yin[2 * bstep + q];
          const Tv t1r = x1r + x2r, t1i = x1i + x2i;
          const Tv t2r = x0r + c3 * t1r, t2i = x0i + c3 * t1i;
          const Tv t3r = -isign * s3 * (x1i - x2i);
          const Tv t3i = isign * s3 * (x1r - x2r);
          const Tv y0r = x0r + t1r, y0i = x0i + t1i;
          const Tv y1r = t2r + t3r, y1i = t2i + t3i;
          const Tv y2r = t2r - t3r, y2i = t2i - t3i;
          xout[q] = twr[0] * y0r - twi[0] * y0i;
          yout[q] = twr[0] * y0i + twi[0] * y0r;
          xout[jstep + q] = twr[1] * y1r - twi[1] * y1i;
          yout[jstep + q] = twr[1] * y1i + twi[1] * y1r;
          xout[2 * jstep + q] = twr[2] * y2r - twi[2] * y2i;
          yout[2 * jstep + q] = twr[2] * y2i + twi[2] * y2r;
        }
      } else if (r == 5) {
        // radix-5 via the conjugate-pair split: y_{1,4} and y_{2,3} each
        // share one (a, b) pair — 8 real muls per output pair where the
        // generic stage pays 5 complex MACs per output
        const T c51 = T(0.30901699437494742410);   // cos(2*pi/5)
        const T c52 = T(-0.80901699437494742410);  // cos(4*pi/5)
        const T s51 = T(0.95105651629515357212);   // sin(2*pi/5)
        const T s52 = T(0.58778525229247312917);   // sin(4*pi/5)
        for (int64_t q = 0; q < s; ++q) {
          const Tv x0r = xin[q], x0i = yin[q];
          const Tv x1r = xin[bstep + q], x1i = yin[bstep + q];
          const Tv x2r = xin[2 * bstep + q], x2i = yin[2 * bstep + q];
          const Tv x3r = xin[3 * bstep + q], x3i = yin[3 * bstep + q];
          const Tv x4r = xin[4 * bstep + q], x4i = yin[4 * bstep + q];
          const Tv t1r = x1r + x4r, t1i = x1i + x4i;
          const Tv t2r = x2r + x3r, t2i = x2i + x3i;
          const Tv t3r = x1r - x4r, t3i = x1i - x4i;
          const Tv t4r = x2r - x3r, t4i = x2i - x3i;
          const Tv y0r = x0r + t1r + t2r, y0i = x0i + t1i + t2i;
          const Tv a1r = x0r + c51 * t1r + c52 * t2r;
          const Tv a1i = x0i + c51 * t1i + c52 * t2i;
          const Tv b1r = s51 * t3r + s52 * t4r;
          const Tv b1i = s51 * t3i + s52 * t4i;
          const Tv a2r = x0r + c52 * t1r + c51 * t2r;
          const Tv a2i = x0i + c52 * t1i + c51 * t2i;
          const Tv b2r = s52 * t3r - s51 * t4r;
          const Tv b2i = s52 * t3i - s51 * t4i;
          const Tv y1r = a1r - isign * b1i, y1i = a1i + isign * b1r;
          const Tv y4r = a1r + isign * b1i, y4i = a1i - isign * b1r;
          const Tv y2r = a2r - isign * b2i, y2i = a2i + isign * b2r;
          const Tv y3r = a2r + isign * b2i, y3i = a2i - isign * b2r;
          xout[q] = twr[0] * y0r - twi[0] * y0i;
          yout[q] = twr[0] * y0i + twi[0] * y0r;
          xout[jstep + q] = twr[1] * y1r - twi[1] * y1i;
          yout[jstep + q] = twr[1] * y1i + twi[1] * y1r;
          xout[2 * jstep + q] = twr[2] * y2r - twi[2] * y2i;
          yout[2 * jstep + q] = twr[2] * y2i + twi[2] * y2r;
          xout[3 * jstep + q] = twr[3] * y3r - twi[3] * y3i;
          yout[3 * jstep + q] = twr[3] * y3i + twi[3] * y3r;
          xout[4 * jstep + q] = twr[4] * y4r - twi[4] * y4i;
          yout[4 * jstep + q] = twr[4] * y4i + twi[4] * y4r;
        }
      } else {
        // generic radix: dense accumulation in SIMD-register accumulators
        for (int64_t q = 0; q < s; ++q) {
          for (int64_t j = 0; j < r; ++j) {
            const T tjr = (j < 32) ? twr[j]
                                   : T(st.tw_re[j * m + p] * stage_scale);
            const T tji = (j < 32) ? twi[j]
                                   : T(st.tw_im[j * m + p] * stage_scale);
            const T* wr_row = wre_f + j * r;
            const T* wi_row = wim_f + j * r;
            Tv acc_re = wr_row[0] * xin[q] - wi_row[0] * yin[q];
            Tv acc_im = wr_row[0] * yin[q] + wi_row[0] * xin[q];
            for (int64_t b = 1; b < r; ++b) {
              const T wr = wr_row[b], wi = wi_row[b];
              const Tv xr = xin[b * bstep + q], xi = yin[b * bstep + q];
              acc_re += wr * xr - wi * xi;
              acc_im += wr * xi + wi * xr;
            }
            xout[j * jstep + q] = tjr * acc_re - tji * acc_im;
            yout[j * jstep + q] = tjr * acc_im + tji * acc_re;
          }
        }
      }
    }
    std::swap(cur_re, nxt_re);
    std::swap(cur_im, nxt_im);
  }
  return cur_re != a_re;
}

// Four-step split n = na * nb for the lane-batch path: two L1-resident
// tiny-transform passes over the (n, V) scratch replace log_r(n) full
// Stockham passes (the 64KB-per-plane working set streams through L1 once
// per stage; for n = 1024 that is 4 passes of 256KB — the measured
// transform bottleneck). Pass 1: strided columns p, na-point transforms,
// inter-factor twiddle folded into the store. Pass 2: contiguous blocks,
// nb-point transforms, scale folded, natural-order strided store.
int64_t fourstep_split(int64_t n) {
  // n <= 2048 measured FASTER direct ([16,8,8] Stockham: 257 ms transform
  // vs 328 four-step on (100000,1024) — the per-column memcpy/twiddle
  // overhead beats the locality win); the four-step's value is extending
  // the lane-batch path past the scratch-bound 2048 ceiling.
  // TPUFFT_FS_MIN overrides the crossover for A/B profiling.
  static const int64_t fs_min = [] {
    const char* e = std::getenv("TPUFFT_FS_MIN");
    return e ? std::atoll(e) : 2048;
  }();
  if (n <= fs_min || n > 16384) return 0;
  int64_t best = 0, best16 = 0;
  for (int64_t d = 2; d * d <= n; ++d) {
    if (n % d == 0) {
      best = d;  // largest divisor <= sqrt(n)
      if (d % 16 == 0) best16 = d;
    }
  }
  // Prefer a 16-multiple na even when a larger split exists: it unlocks
  // the ka-major pass-2 (in-place region ping-pong, digit transpose fused
  // into the caller's scatter) — worth more than a balanced split.
  if (best16 != 0 && n / best16 <= 2048) best = best16;
  if (best == 0) return 0;                  // prime
  if (best > 2048 || n / best > 2048) return 0;
  return best;
}

struct FourStepTw {
  std::vector<double> re, im;  // [ka * nb + p]
};

const FourStepTw& fourstep_twiddle(int64_t na, int64_t nb, bool inverse) {
  static std::mutex mu;
  static std::unordered_map<int64_t, FourStepTw> cache;
  std::lock_guard<std::mutex> lock(mu);
  int64_t key = (na * 100000 + nb) * 2 + (inverse ? 1 : 0);
  auto it = cache.find(key);
  if (it == cache.end()) {
    FourStepTw tw;
    const double sign = inverse ? 1.0 : -1.0;
    const double den = double(na * nb);
    tw.re.resize(na * nb);
    tw.im.resize(na * nb);
    for (int64_t ka = 0; ka < na; ++ka) {
      for (int64_t p = 0; p < nb; ++p) {
        double th = sign * kTau * double(ka) * double(p) / den;
        tw.re[ka * nb + p] = std::cos(th);
        tw.im[ka * nb + p] = std::sin(th);
      }
    }
    it = cache.emplace(key, std::move(tw)).first;
  }
  return it->second;
}

// a/b: (n, V) scratch planes. Returns a result code: bit 0 = result in
// the b planes; bit 1 = result is KA-MAJOR digit-permuted (element
// kp*na+ka of the transform lives at position ka*nb+kp — the caller's
// scatter applies the transpose, saving a full strided store pass).
// tiny: 4 * max(na, nb) * V elements of per-thread sub-transform scratch.
template <typename T, int V>
int transform_batch_fourstep(int64_t n, int64_t na, bool inverse,
                             double scale, T* a_re, T* a_im, T* b_re,
                             T* b_im, std::vector<T>& tiny,
                             std::vector<T>& gscratch) {
  const int64_t nb = n / na;
  const Plan& plan_a = cached_plan(na, inverse, true);
  const Plan& plan_b = cached_plan(nb, inverse, true);
  const FourStepTw& tw = fourstep_twiddle(na, nb, inverse);
  const int64_t tlen = std::max(na, nb) * V;
  if ((int64_t)tiny.size() < 4 * tlen) tiny.resize(4 * tlen);
  T* t_re = tiny.data();
  T* t_im = tiny.data() + tlen;
  T* u_re = tiny.data() + 2 * tlen;
  T* u_im = tiny.data() + 3 * tlen;
  // pass 1: columns p (rows {a * nb + p}), na-point, twiddle at store,
  // in place (the row set per p is closed). NOTE a V*4-lane column-block
  // variant (contiguous 4-column gathers + one wide transform) was tried
  // and REVERTED: 64-lane GCC vectors spill the radix-16 body's register
  // file (19 vs 8.5 ms on (100, 16384)).
  for (int64_t p = 0; p < nb; ++p) {
    {
      ProfTimer pt(kProfFsP1Copy);
      for (int64_t a = 0; a < na; ++a) {
        std::memcpy(t_re + a * V, a_re + (a * nb + p) * V, sizeof(T) * V);
        std::memcpy(t_im + a * V, a_im + (a * nb + p) * V, sizeof(T) * V);
      }
    }
    bool in_u;
    {
      ProfTimer pt(kProfFsP1Fft);
      in_u = transform_batch_v<T, V>(plan_a, t_re, t_im, u_re, u_im, 1.0,
                                     gscratch);
    }
    const T* sr0 = in_u ? u_re : t_re;
    const T* si0 = in_u ? u_im : t_im;
    ProfTimer pt(kProfFsP1Tw);
    for (int64_t ka = 0; ka < na; ++ka) {
      const T wr = T(tw.re[ka * nb + p]);
      const T wi = T(tw.im[ka * nb + p]);
      T* dr = a_re + (ka * nb + p) * V;
      T* di = a_im + (ka * nb + p) * V;
      const T* sr = sr0 + ka * V;
      const T* si = si0 + ka * V;
      for (int v = 0; v < V; ++v) {
        dr[v] = wr * sr[v] - wi * si[v];
        di[v] = wr * si[v] + wi * sr[v];
      }
    }
  }
  // pass 2, ka-major fast path (na % 16 == 0, required so the caller's
  // 16-wide vector scatter can absorb the digit transpose): each block
  // transforms IN PLACE, ping-ponging its own [ka*nb, (ka+1)*nb) region
  // of a against the same region of b — no tiny copy, no strided store.
  if (na % 16 == 0) {
    bool in_b = false;
    ProfTimer pt(kProfFsP2Fft);
    for (int64_t ka = 0; ka < na; ++ka) {
      const int64_t off = ka * nb * V;
      in_b = transform_batch_v<T, V>(plan_b, a_re + off, a_im + off,
                                     b_re + off, b_im + off, scale,
                                     gscratch);
    }
    return in_b ? 3 : 2;
  }
  // pass 2, general: contiguous blocks [ka * nb, (ka+1) * nb), nb-point
  // with the norm scale, natural-order strided store into b
  for (int64_t ka = 0; ka < na; ++ka) {
    bool in_u;
    {
      ProfTimer pt(kProfFsP2Fft);
      std::memcpy(t_re, a_re + ka * nb * V, sizeof(T) * nb * V);
      std::memcpy(t_im, a_im + ka * nb * V, sizeof(T) * nb * V);
      in_u = transform_batch_v<T, V>(plan_b, t_re, t_im, u_re, u_im, scale,
                                     gscratch);
    }
    const T* sr0 = in_u ? u_re : t_re;
    const T* si0 = in_u ? u_im : t_im;
    ProfTimer pt(kProfFsP2Scatter);
    for (int64_t kp = 0; kp < nb; ++kp) {
      std::memcpy(b_re + (kp * na + ka) * V, sr0 + kp * V, sizeof(T) * V);
      std::memcpy(b_im + (kp * na + ka) * V, si0 + kp * V, sizeof(T) * V);
    }
  }
  return 1;
}

// In-register 16x16 f32 transpose: 4 rounds of two-source lane shuffles
// (vpermt2ps on AVX-512; GCC lowers __builtin_shuffle portably elsewhere).
// Output vector j holds column bitrev4(j) — callers index through
// kTr16Perm. Replaces the scalar gather/scatter transposes around the
// lane-batch transform, which dominated (100000, 1024): 4 planes x n x V
// scalar load/store pairs per group vs n/16 x 64 shuffles.
static const int kTr16Perm[16] = {0, 8,  4, 12, 2, 10, 6, 14,
                                  1, 9,  5, 13, 3, 11, 7, 15};

#if defined(__AVX512F__)
// Shared AVX-512 de/interleave permutes for 16-complex (32-float) rows:
// even/odd lanes of two loads extract the re/im planes; lo/hi re-pair
// them back into interleaved order. One definition — the gather,
// scatter, split and combine paths all index through these.
alignas(64) static const int kDeintEven[16] = {0, 2, 4, 6, 8, 10, 12, 14,
                                               16, 18, 20, 22, 24, 26, 28,
                                               30};
alignas(64) static const int kDeintOdd[16] = {1, 3, 5, 7, 9, 11, 13, 15,
                                              17, 19, 21, 23, 25, 27, 29,
                                              31};
alignas(64) static const int kIntLo[16] = {0, 16, 1, 17, 2, 18, 3, 19,
                                           4, 20, 5, 21, 6, 22, 7, 23};
alignas(64) static const int kIntHi[16] = {8, 24, 9, 25, 10, 26, 11, 27,
                                           12, 28, 13, 29, 14, 30, 15, 31};
#endif

template <typename Tv>
static inline void transpose16(Tv (&r)[16]) {
  typedef int32_t Iv __attribute__((vector_size(64)));
  static const Iv LO1 = {0, 16, 1, 17, 2, 18, 3, 19,
                         4, 20, 5, 21, 6, 22, 7, 23};
  static const Iv HI1 = {8,  24, 9,  25, 10, 26, 11, 27,
                         12, 28, 13, 29, 14, 30, 15, 31};
  static const Iv LO2 = {0, 1, 16, 17, 2, 3, 18, 19,
                         4, 5, 20, 21, 6, 7, 22, 23};
  static const Iv HI2 = {8,  9,  24, 25, 10, 11, 26, 27,
                         12, 13, 28, 29, 14, 15, 30, 31};
  static const Iv LO4 = {0, 1, 2, 3, 16, 17, 18, 19,
                         4, 5, 6, 7, 20, 21, 22, 23};
  static const Iv HI4 = {8,  9,  10, 11, 24, 25, 26, 27,
                         12, 13, 14, 15, 28, 29, 30, 31};
  static const Iv LO8 = {0, 1, 2,  3,  4,  5,  6,  7,
                         16, 17, 18, 19, 20, 21, 22, 23};
  static const Iv HI8 = {8,  9,  10, 11, 12, 13, 14, 15,
                         24, 25, 26, 27, 28, 29, 30, 31};
  Tv t[16];
  for (int i = 0; i < 16; i += 2) {
    t[i] = __builtin_shuffle(r[i], r[i + 1], LO1);
    t[i + 1] = __builtin_shuffle(r[i], r[i + 1], HI1);
  }
  Tv u[16];
  for (int g = 0; g < 16; g += 4) {
    for (int i = g; i < g + 2; ++i) {
      u[i] = __builtin_shuffle(t[i], t[i + 2], LO2);
      u[i + 2] = __builtin_shuffle(t[i], t[i + 2], HI2);
    }
  }
  Tv w[16];
  for (int g = 0; g < 16; g += 8) {
    for (int i = g; i < g + 4; ++i) {
      w[i] = __builtin_shuffle(u[i], u[i + 4], LO4);
      w[i + 4] = __builtin_shuffle(u[i], u[i + 4], HI4);
    }
  }
  for (int i = 0; i < 8; ++i) {
    r[i] = __builtin_shuffle(w[i], w[i + 8], LO8);
    r[i + 8] = __builtin_shuffle(w[i], w[i + 8], HI8);
  }
}

// Contiguous batched transforms via the lane-batch path for modest n.
//
// ES_IN / ES_OUT are the element strides of the IO layouts: 1 = split
// planes (in_im an independent pointer), 2 = interleaved complex
// (in_im = in_re + 1) — the numpy-facing layout. Folding the
// de/re-interleave into the gather/scatter removes the standalone
// complex<->planes conversion passes entirely (they cost as much as the
// transform itself on gather-bound shapes: 157 + 71 ms around a ~700 ms
// (1000000, 93) transform). `dist_*` stays in units of COMPLEX elements.
template <typename T, int ES_IN = 1, int ES_OUT = 1>
int fft_batched_v(const T* in_re, const T* in_im, T* out_re, T* out_im,
                  int64_t count, int64_t n, int64_t dist_in, int64_t dist_out,
                  bool inverse, double scale, int nthreads) {
  constexpr int V = 16;
  // The 16x16 in-register transpose gather/scatter (and the radix-16
  // stages that pair with it) win for rows n >= 256 regardless of the
  // row-to-row step's alignment (unaligned vector moves are cheap;
  // interleaved A/B: n=480 232 vs 303 ms scalar, n=1080 162 vs 254,
  // n=256 ~tie), while short rows lose to the scalar row-sequential
  // loops (n=93: 803 vs 927, n=128: 260 vs 270). Only the AVX-512
  // streaming stores need real 64B alignment — gated separately below.
#if defined(__AVX512F__)
  constexpr bool kVecIO = true;  // interleaved IO has AVX-512 de/interleave
#else
  constexpr bool kVecIO = ES_IN == 1 && ES_OUT == 1;
#endif
  const bool use_vec = sizeof(T) == 4 && n >= 256 && kVecIO;
  const Plan& plan = cached_plan(n, inverse, use_vec);
  const int64_t na_fs = fourstep_split(n);
#ifdef _OPENMP
  if (nthreads > 0) omp_set_num_threads(nthreads);
#pragma omp parallel
#endif
  {
    std::vector<T> sa_re(n * V), sa_im(n * V), sb_re(n * V), sb_im(n * V);
    std::vector<T> s1a_re(n), s1a_im(n), s1b_re(n), s1b_im(n), pscratch;
    std::vector<T> gscratch, tiny;
    const int64_t groups = count / V;
#ifdef _OPENMP
#pragma omp for schedule(static) nowait
#endif
    for (int64_t g = 0; g < groups; ++g) {
      const T* src_re = in_re + g * V * dist_in * ES_IN;
      const T* src_im = in_im + g * V * dist_in * ES_IN;
      // gather-transpose V rows -> (n, V); scalar from i0 (vector path
      // covers [0, nb), the scalar loop its tail — or everything when the
      // vector transpose doesn't pay, see use_vec)
      const auto gather_scalar = [&](int64_t i0) {
        for (int64_t v = 0; v < V; ++v) {
          const T* rr = src_re + v * dist_in * ES_IN;
          const T* ri = src_im + v * dist_in * ES_IN;
          for (int64_t i = i0; i < n; ++i) {
            sa_re[i * V + v] = rr[i * ES_IN];
            sa_im[i * V + v] = ri[i * ES_IN];
          }
        }
      };
      ProfTimer* gt = prof_on() ? new ProfTimer(kProfGather) : nullptr;
      if constexpr (sizeof(T) == 4) {
        if (use_vec) {
          typedef typename VecOf<T, V>::type Tv;
          const int64_t nb = n - n % 16;
          if constexpr (ES_IN == 1) {
            for (int64_t i0 = 0; i0 < nb; i0 += 16) {
              for (int p = 0; p < 2; ++p) {
                const T* src = p ? src_im : src_re;
                T* dst = p ? sa_im.data() : sa_re.data();
                Tv blk[16];
                for (int v = 0; v < V; ++v)
                  blk[v] = *(const Tv*)(src + v * dist_in + i0);
                transpose16(blk);
                for (int j = 0; j < 16; ++j)
                  *(Tv*)(dst + (i0 + kTr16Perm[j]) * V) = blk[j];
              }
            }
            gather_scalar(nb);
          } else {
#if defined(__AVX512F__)
            // Interleaved rows: 32 consecutive floats hold 16 complex.
            // BOTH planes come from the same two loads at the row's re
            // base (even lanes = re, odd = im) — loading at the im
            // base (+1) instead would read 4 bytes past the buffer on
            // the final row.
            const __m512i vevn = _mm512_load_si512(kDeintEven);
            const __m512i vodd = _mm512_load_si512(kDeintOdd);
            for (int64_t i0 = 0; i0 < nb; i0 += 16) {
              Tv blkR[16], blkI[16];
              for (int v = 0; v < V; ++v) {
                const float* q =
                    (const float*)(src_re + v * dist_in * 2 + 2 * i0);
                const __m512 a = _mm512_loadu_ps(q);
                const __m512 b = _mm512_loadu_ps(q + 16);
                blkR[v] = (Tv)_mm512_permutex2var_ps(a, vevn, b);
                blkI[v] = (Tv)_mm512_permutex2var_ps(a, vodd, b);
              }
              transpose16(blkR);
              transpose16(blkI);
              for (int j = 0; j < 16; ++j) {
                *(Tv*)(sa_re.data() + (i0 + kTr16Perm[j]) * V) = blkR[j];
                *(Tv*)(sa_im.data() + (i0 + kTr16Perm[j]) * V) = blkI[j];
              }
            }
            gather_scalar(nb);
#else
            gather_scalar(0);
#endif
          }
        } else {
          gather_scalar(0);
        }
      } else {
        gather_scalar(0);
      }
      delete gt;
      const T* res_re = sa_re.data();
      const T* res_im = sa_im.data();
      int res_code;
      {
        ProfTimer pt(kProfTransform);
        res_code =
            na_fs ? transform_batch_fourstep<T, V>(
                        n, na_fs, inverse, scale, sa_re.data(), sa_im.data(),
                        sb_re.data(), sb_im.data(), tiny, gscratch)
                  : (transform_batch_v<T, V>(plan, sa_re.data(),
                                             sa_im.data(), sb_re.data(),
                                             sb_im.data(), scale, gscratch)
                         ? 1
                         : 0);
      }
      if (res_code & 1) {  // odd stage count / four-step: result in b
        res_re = sb_re.data();
        res_im = sb_im.data();
      }
      // ka-major four-step result: transform element i = kp*na+ka sits at
      // res position ka*nb+kp — fold the digit transpose into the scatter
      const bool dperm = res_code >= 2;
      const int64_t pna = na_fs, pnb = na_fs ? n / na_fs : 0;
      ProfTimer st(kProfScatter);
      const auto scatter_scalar = [&](int64_t i0) {
        for (int64_t v = 0; v < V; ++v) {
          T* wr = out_re + (g * V + v) * dist_out * ES_OUT;
          T* wi = out_im + (g * V + v) * dist_out * ES_OUT;
          for (int64_t i = i0; i < n; ++i) {
            const int64_t si = dperm ? (i % pna) * pnb + i / pna : i;
            wr[i * ES_OUT] = res_re[si * V + v];
            wi[i * ES_OUT] = res_im[si * V + v];
          }
        }
      };
      if constexpr (sizeof(T) == 4) {
        if (use_vec) {
          typedef typename VecOf<T, V>::type Tv;
          T* dst_re = out_re + g * V * dist_out * ES_OUT;
          T* dst_im = out_im + g * V * dist_out * ES_OUT;
          const int64_t nb = n - n % 16;
#if defined(__AVX512F__)
          // Non-temporal stores skip the read-for-ownership and keep the
          // 400MB-class output streams out of L2 (the Stockham ping-pong
          // scratch stays resident): scatter measured 203 -> ~100 ms on
          // (100000, 1024). They require truly 64B-aligned store
          // targets: base pointers AND the row-to-row step (use_vec no
          // longer implies the latter).
          const bool stream =
              ES_OUT == 1
                  ? (((reinterpret_cast<uintptr_t>(dst_re) |
                       reinterpret_cast<uintptr_t>(dst_im)) & 63) == 0 &&
                     (dist_out & 15) == 0)
                  // interleaved: dst_im = dst_re + 1 by construction; the
                  // combined 32-float row stores only need dst_re's phase
                  : ((reinterpret_cast<uintptr_t>(dst_re) & 63) == 0 &&
                     ((dist_out * 2) & 15) == 0);
#else
          const bool stream = false;
#endif
          if constexpr (ES_OUT == 1) {
            for (int64_t i0 = 0; i0 < nb; i0 += 16) {
              // digit-permuted source: the 16 consecutive outputs i0+j
              // share kp (pna % 16 == 0 guarantees it) and step ka by 1,
              // i.e. source positions step by pnb — a strided 16-gather
              // absorbed by the transpose the scatter does anyway
              const int64_t sb = dperm ? (i0 % pna) * pnb + i0 / pna : i0;
              const int64_t ss = dperm ? pnb : 1;
              for (int pl = 0; pl < 2; ++pl) {
                const T* src = pl ? res_im : res_re;
                T* dst = pl ? dst_im : dst_re;
                Tv blk[16];
                for (int j = 0; j < 16; ++j)
                  blk[j] = *(const Tv*)(src + (sb + j * ss) * V);
                transpose16(blk);
#if defined(__AVX512F__)
                if (stream) {
                  for (int j = 0; j < 16; ++j)
                    _mm512_stream_ps(dst + kTr16Perm[j] * dist_out + i0,
                                     (__m512)blk[j]);
                  continue;
                }
#endif
                for (int j = 0; j < 16; ++j)
                  *(Tv*)(dst + kTr16Perm[j] * dist_out + i0) = blk[j];
              }
            }
          } else {
#if defined(__AVX512F__)
            // Interleaved output: transpose both planes, then each row j
            // interleaves into 32 consecutive floats — a pure streaming
            // write pattern (no strided plane stores at all).
            const __m512i vl = _mm512_load_si512(kIntLo);
            const __m512i vh = _mm512_load_si512(kIntHi);
            for (int64_t i0 = 0; i0 < nb; i0 += 16) {
              const int64_t sb = dperm ? (i0 % pna) * pnb + i0 / pna : i0;
              const int64_t ss = dperm ? pnb : 1;
              Tv blkR[16], blkI[16];
              for (int j = 0; j < 16; ++j) {
                blkR[j] = *(const Tv*)(res_re + (sb + j * ss) * V);
                blkI[j] = *(const Tv*)(res_im + (sb + j * ss) * V);
              }
              transpose16(blkR);
              transpose16(blkI);
              for (int j = 0; j < 16; ++j) {
                float* q = (float*)(dst_re + kTr16Perm[j] * dist_out * 2 +
                                    2 * i0);
                const __m512 lo = _mm512_permutex2var_ps(
                    (__m512)blkR[j], vl, (__m512)blkI[j]);
                const __m512 hi = _mm512_permutex2var_ps(
                    (__m512)blkR[j], vh, (__m512)blkI[j]);
                if (stream) {
                  _mm512_stream_ps(q, lo);
                  _mm512_stream_ps(q + 16, hi);
                } else {
                  _mm512_storeu_ps(q, lo);
                  _mm512_storeu_ps(q + 16, hi);
                }
              }
            }
#endif
          }
#if defined(__AVX512F__)
          if (stream) _mm_sfence();
#endif
          scatter_scalar(nb);
        } else {
          scatter_scalar(0);
        }
      } else {
        scatter_scalar(0);
      }
    }
    // remainder rows: per-transform path
#ifdef _OPENMP
#pragma omp single
#endif
    {
      const Plan& splan = cached_plan(n, inverse);  // scalar-path radices
      for (int64_t c = groups * V; c < count; ++c) {
        if constexpr (ES_IN == 1) {
          std::memcpy(s1a_re.data(), in_re + c * dist_in, sizeof(T) * n);
          std::memcpy(s1a_im.data(), in_im + c * dist_in, sizeof(T) * n);
        } else {
          const T* rr = in_re + c * dist_in * ES_IN;
          const T* ri = in_im + c * dist_in * ES_IN;
          for (int64_t i = 0; i < n; ++i) {
            s1a_re[i] = rr[i * ES_IN];
            s1a_im[i] = ri[i * ES_IN];
          }
        }
        transform_1d(splan, s1a_re.data(), s1a_im.data(), s1b_re.data(),
                     s1b_im.data(), scale, pscratch);
        if constexpr (ES_OUT == 1) {
          std::memcpy(out_re + c * dist_out, s1a_re.data(), sizeof(T) * n);
          std::memcpy(out_im + c * dist_out, s1a_im.data(), sizeof(T) * n);
        } else {
          T* wr = out_re + c * dist_out * ES_OUT;
          T* wi = out_im + c * dist_out * ES_OUT;
          for (int64_t i = 0; i < n; ++i) {
            wr[i * ES_OUT] = s1a_re[i];
            wi[i * ES_OUT] = s1a_im[i];
          }
        }
      }
    }
  }
  return 0;
}

// V CONSECUTIVE lines (line-to-line distance 1 element) along a strided
// axis, V at a time: element i of lines v..v+V-1 is the contiguous run
// src[i*stride + v .. +V], so the gather into the (n, V) lane layout is a
// vector copy per i instead of n*V scalar loads. This is what makes
// non-minor ND axes run at lane-batch speed: an axis with suffix product
// `inner` yields `inner` consecutive lines per prefix index.
template <typename T>
int fft_lines_batched_v(const T* in_re, const T* in_im, T* out_re,
                        T* out_im, int64_t count, int64_t n, int64_t stride,
                        bool inverse, double scale, int nthreads) {
  constexpr int V = 16;
  const Plan& plan = cached_plan(n, inverse, true);
  const int64_t na_fs = fourstep_split(n);
#ifdef _OPENMP
  if (nthreads > 0) omp_set_num_threads(nthreads);
#pragma omp parallel
#endif
  {
    std::vector<T> sa_re(n * V), sa_im(n * V), sb_re(n * V), sb_im(n * V);
    std::vector<T> gscratch, tiny;
    const int64_t groups = count / V;
#ifdef _OPENMP
#pragma omp for schedule(static) nowait
#endif
    for (int64_t g = 0; g < groups; ++g) {
      const T* src_re = in_re + g * V;
      const T* src_im = in_im + g * V;
      {
        ProfTimer pt(kProfLGather);
        for (int64_t i = 0; i < n; ++i) {
          std::memcpy(&sa_re[i * V], src_re + i * stride, sizeof(T) * V);
          std::memcpy(&sa_im[i * V], src_im + i * stride, sizeof(T) * V);
        }
      }
      // long n (> the scratch-bound direct ceiling): the same L1-resident
      // four-step the contiguous path uses — without it, non-minor axes
      // like 3840/4320 fell to the per-line scalar path (measured 4x
      // slower than PocketFFT on (1, 3840, 2160))
      int res_code;
      {
        ProfTimer pt(kProfLTransform);
        res_code =
            na_fs ? transform_batch_fourstep<T, V>(
                        n, na_fs, inverse, scale, sa_re.data(), sa_im.data(),
                        sb_re.data(), sb_im.data(), tiny, gscratch)
                  : (transform_batch_v<T, V>(plan, sa_re.data(),
                                             sa_im.data(), sb_re.data(),
                                             sb_im.data(), scale, gscratch)
                         ? 1
                         : 0);
      }
      const T* res_re = (res_code & 1) ? sb_re.data() : sa_re.data();
      const T* res_im = (res_code & 1) ? sb_im.data() : sa_im.data();
      T* dst_re = out_re + g * V;
      T* dst_im = out_im + g * V;
      ProfTimer st(kProfLScatter);
      if (res_code >= 2) {
        // ka-major four-step result: iterate (kp, ka) so the digit
        // transpose rides the scatter's existing per-line copies
        const int64_t pna = na_fs, pnb = n / na_fs;
        int64_t i = 0;
        for (int64_t kp = 0; kp < pnb; ++kp) {
          for (int64_t ka = 0; ka < pna; ++ka, ++i) {
            const int64_t si = ka * pnb + kp;
            std::memcpy(dst_re + i * stride, res_re + si * V,
                        sizeof(T) * V);
            std::memcpy(dst_im + i * stride, res_im + si * V,
                        sizeof(T) * V);
          }
        }
      } else {
        for (int64_t i = 0; i < n; ++i) {
          std::memcpy(dst_re + i * stride, res_re + i * V, sizeof(T) * V);
          std::memcpy(dst_im + i * stride, res_im + i * V, sizeof(T) * V);
        }
      }
    }
    // remainder lines: per-line scalar path
#ifdef _OPENMP
#pragma omp single
#endif
    {
      std::vector<T> s1a_re(n), s1a_im(n), s1b_re(n), s1b_im(n), pscratch;
      const Plan& splan = cached_plan(n, inverse);  // scalar-path radices
      for (int64_t c = groups * V; c < count; ++c) {
        const T* rr = in_re + c;
        const T* ri = in_im + c;
        for (int64_t i = 0; i < n; ++i) {
          s1a_re[i] = rr[i * stride];
          s1a_im[i] = ri[i * stride];
        }
        transform_1d(splan, s1a_re.data(), s1a_im.data(), s1b_re.data(),
                     s1b_im.data(), scale, pscratch);
        T* wr = out_re + c;
        T* wi = out_im + c;
        for (int64_t i = 0; i < n; ++i) {
          wr[i * stride] = s1a_re[i];
          wi[i * stride] = s1a_im[i];
        }
      }
    }
  }
  return 0;
}

template <typename T>
int fft_strided(const T* in_re, const T* in_im, T* out_re, T* out_im,
                int64_t count, int64_t n, int64_t stride, int64_t dist_in,
                int64_t dist_out, bool inverse, double scale, int nthreads) {
  if (n < 1 || count < 0) return 1;
  // lane-batch path: contiguous transforms, small length (where the
  // per-transform path cannot vectorize its tiny m/s loops) or a
  // four-step-splittable longer one, enough batch
  if (stride == 1 && (n <= 2048 || fourstep_split(n)) && count >= 64) {
    return fft_batched_v<T>(in_re, in_im, out_re, out_im, count, n, dist_in,
                            dist_out, inverse, scale, nthreads);
  }
  // consecutive-lines lane batch (ND non-minor axes): lines advance by one
  // element while the transform walks `stride` — vector loads, no gather;
  // long lengths go through the same four-step as the contiguous path
  if (stride != 1 && dist_in == 1 && dist_out == 1 &&
      (n <= 2048 || fourstep_split(n)) && count >= 16) {
    return fft_lines_batched_v<T>(in_re, in_im, out_re, out_im, count, n,
                                  stride, inverse, scale, nthreads);
  }
  const Plan& plan = cached_plan(n, inverse);
#ifdef _OPENMP
  if (nthreads > 0) omp_set_num_threads(nthreads);
#pragma omp parallel
#endif
  {
    std::vector<T> sa_re(n), sa_im(n), sb_re(n), sb_im(n), pscratch;
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
    for (int64_t c = 0; c < count; ++c) {
      const T* src_re = in_re + c * dist_in;
      const T* src_im = in_im + c * dist_in;
      if (stride == 1) {
        std::memcpy(sa_re.data(), src_re, sizeof(T) * n);
        std::memcpy(sa_im.data(), src_im, sizeof(T) * n);
      } else {
        for (int64_t i = 0; i < n; ++i) {
          sa_re[i] = src_re[i * stride];
          sa_im[i] = src_im[i * stride];
        }
      }
      transform_1d(plan, sa_re.data(), sa_im.data(), sb_re.data(),
                   sb_im.data(), scale, pscratch);
      T* dst_re = out_re + c * dist_out;
      T* dst_im = out_im + c * dist_out;
      if (stride == 1) {
        std::memcpy(dst_re, sa_re.data(), sizeof(T) * n);
        std::memcpy(dst_im, sa_im.data(), sizeof(T) * n);
      } else {
        for (int64_t i = 0; i < n; ++i) {
          dst_re[i * stride] = sa_re[i];
          dst_im[i * stride] = sa_im[i];
        }
      }
    }
  }
  return 0;
}

// ND transform over the trailing `rank-1` axes of a (batch, d1, ..., dk)
// tensor (batch excluded), axis-by-axis via strided 1D transforms — the
// same per-axis schedule as the reference CPU executor (_run_cpu_nd_fft)
// but with strided access in place of materialized transposes.
template <typename T>
int fft_nd(const T* in_re, const T* in_im, T* out_re, T* out_im,
           const int64_t* dims, int rank, bool inverse, double scale,
           int nthreads, bool skip_minor = false) {
  if (rank < 2) return 1;
  if (skip_minor && rank < 3) return 1;  // nothing left to do
  int64_t total = 1;
  for (int i = 0; i < rank; ++i) total *= dims[i];
  // work in-place in `out` after one copy
  if (out_re != in_re) std::memcpy(out_re, in_re, sizeof(T) * total);
  if (out_im != in_im) std::memcpy(out_im, in_im, sizeof(T) * total);

  // strides (row-major)
  std::vector<int64_t> stride(rank);
  stride[rank - 1] = 1;
  for (int i = rank - 2; i >= 0; --i) stride[i] = stride[i + 1] * dims[i + 1];

  // skip_minor: the minor axis was already transformed by an
  // interleaved-input lane-batch pass (tpufft_fft_c2p_*)
  for (int ax = rank - 1 - (skip_minor ? 1 : 0); ax >= 1; --ax) {
    const int64_t n = dims[ax];
    const double ax_scale = (ax == 1) ? scale : 1.0;
    const int64_t st = stride[ax];
    // iterate over all lines along `ax`: total/n lines. Lines enumerate as
    // (outer, inner): outer over prefix dims, inner over suffix dims.
    const int64_t inner = st;                  // product of dims after ax
    const int64_t outer = total / (n * inner); // product of dims before ax
    if (inner == 1) {
      int rc = fft_strided<T>(out_re, out_im, out_re, out_im, outer, n, 1, n,
                              n, inverse, ax_scale, nthreads);
      if (rc) return rc;
    } else {
      // lines: base = o * n * inner + i; stride st = inner
      for (int64_t o = 0; o < outer; ++o) {
        const int64_t base = o * n * inner;
        int rc = fft_strided<T>(out_re + base, out_im + base, out_re + base,
                                out_im + base, inner, n, inner, 1, 1, inverse,
                                ax_scale, nthreads);
        if (rc) return rc;
      }
    }
  }
  return 0;
}

// Interleaved-complex <-> split-plane conversion. The engine's data model
// is split planes (the same contract as the jnp path's SplitComplex), but
// numpy users hand us interleaved complex buffers; converting through
// numpy costs FOUR strided passes (x.real copy, x.imag copy, out.real
// assign, out.imag assign — measured 327 + 381 ms around a ~700 ms
// (1000000, 93) transform). One fused pass each way reads the interleaved
// buffer once for both planes; -O3 -march=native vectorizes the stride-2
// pattern with permute ops, and OpenMP splits the range on multicore.
// 16-aligned per-thread range [lo, hi) covering ALL of [0, n): a plain
// (n/nt) chunk rounded to 16 drops the tail whenever n%nt != 0 lands on
// a 16 boundary, and covers NOTHING when n < nt (chunk == 0) — confirmed
// element-drop on multicore. Ceil-divide before rounding.
static inline void thread_range16(int64_t n, int64_t& lo, int64_t& hi) {
#ifdef _OPENMP
  const int64_t nt = omp_get_num_threads(), t = omp_get_thread_num();
  const int64_t chunk = (((n + nt - 1) / nt) + 15) & ~int64_t(15);
  lo = std::min<int64_t>(n, t * chunk);
  hi = std::min<int64_t>(n, lo + chunk);
#else
  lo = 0;
  hi = n;
#endif
}

template <typename T>
void split_c2p(const T* inter, T* re, T* im, int64_t n, int nthreads) {
#ifdef _OPENMP
  if (nthreads > 0) omp_set_num_threads(nthreads);
#pragma omp parallel
#endif
  {
    int64_t lo, hi;
    thread_range16(n, lo, hi);
    int64_t i = lo;
#if defined(__AVX512F__)
    if constexpr (sizeof(T) == 4) {
      // Even/odd-lane deinterleave of 32 floats (16 complex) per step.
      const __m512i ve = _mm512_load_si512(kDeintEven);
      const __m512i vo = _mm512_load_si512(kDeintOdd);
      // Non-temporal plane stores skip the read-for-ownership — a third
      // of the pass's traffic — when both targets sit on the same 64B
      // phase (numpy's large allocations are 64B-aligned in practice).
      const bool stream =
          ((reinterpret_cast<uintptr_t>(re + lo) |
            reinterpret_cast<uintptr_t>(im + lo)) & 63) == 0;
      if (stream) {
        for (; i + 16 <= hi; i += 16) {
          const __m512 a = _mm512_loadu_ps((const float*)inter + 2 * i);
          const __m512 b =
              _mm512_loadu_ps((const float*)inter + 2 * i + 16);
          _mm512_stream_ps((float*)re + i,
                           _mm512_permutex2var_ps(a, ve, b));
          _mm512_stream_ps((float*)im + i,
                           _mm512_permutex2var_ps(a, vo, b));
        }
      } else {
        for (; i + 16 <= hi; i += 16) {
          const __m512 a = _mm512_loadu_ps((const float*)inter + 2 * i);
          const __m512 b =
              _mm512_loadu_ps((const float*)inter + 2 * i + 16);
          _mm512_storeu_ps((float*)re + i,
                           _mm512_permutex2var_ps(a, ve, b));
          _mm512_storeu_ps((float*)im + i,
                           _mm512_permutex2var_ps(a, vo, b));
        }
      }
    }
#endif
    for (; i < hi; ++i) {
      re[i] = inter[2 * i];
      im[i] = inter[2 * i + 1];
    }
  }
#if defined(__AVX512F__)
  if constexpr (sizeof(T) == 4) _mm_sfence();
#endif
}

template <typename T>
void combine_p2c(const T* re, const T* im, T* inter, int64_t n,
                 int nthreads) {
#ifdef _OPENMP
  if (nthreads > 0) omp_set_num_threads(nthreads);
#pragma omp parallel
#endif
  {
    int64_t lo, hi;
    thread_range16(n, lo, hi);
    int64_t i = lo;
#if defined(__AVX512F__)
    if constexpr (sizeof(T) == 4) {
      const __m512i vl = _mm512_load_si512(kIntLo);
      const __m512i vh = _mm512_load_si512(kIntHi);
      // Scalar head until the interleaved write target is 64B-aligned so
      // the body can use non-temporal stores: the 2x-sized output stream
      // is pure write traffic, and skipping its read-for-ownership is a
      // third of the pass's bytes.
      for (; i < hi &&
             ((reinterpret_cast<uintptr_t>(inter + 2 * i) & 63) != 0);
           ++i) {
        inter[2 * i] = re[i];
        inter[2 * i + 1] = im[i];
      }
      for (; i + 16 <= hi; i += 16) {
        const __m512 a = _mm512_loadu_ps((const float*)re + i);
        const __m512 b = _mm512_loadu_ps((const float*)im + i);
        _mm512_stream_ps((float*)inter + 2 * i,
                         _mm512_permutex2var_ps(a, vl, b));
        _mm512_stream_ps((float*)inter + 2 * i + 16,
                         _mm512_permutex2var_ps(a, vh, b));
      }
    }
#endif
    for (; i < hi; ++i) {
      inter[2 * i] = re[i];
      inter[2 * i + 1] = im[i];
    }
  }
#if defined(__AVX512F__)
  if constexpr (sizeof(T) == 4) _mm_sfence();
#endif
}

}  // namespace

extern "C" {

int tpufft_split_c2p_f32(const float* inter, float* re, float* im,
                         int64_t n, int nthreads) {
  split_c2p<float>(inter, re, im, n, nthreads);
  return 0;
}

int tpufft_split_c2p_f64(const double* inter, double* re, double* im,
                         int64_t n, int nthreads) {
  split_c2p<double>(inter, re, im, n, nthreads);
  return 0;
}

int tpufft_combine_p2c_f32(const float* re, const float* im, float* inter,
                           int64_t n, int nthreads) {
  combine_p2c<float>(re, im, inter, n, nthreads);
  return 0;
}

int tpufft_combine_p2c_f64(const double* re, const double* im,
                           double* inter, int64_t n, int nthreads) {
  combine_p2c<double>(re, im, inter, n, nthreads);
  return 0;
}

int tpufft_fft_strided_f32(const float* in_re, const float* in_im,
                           float* out_re, float* out_im, int64_t count,
                           int64_t n, int64_t stride, int64_t dist_in,
                           int64_t dist_out, int inverse, double scale,
                           int nthreads) {
  return fft_strided<float>(in_re, in_im, out_re, out_im, count, n, stride,
                            dist_in, dist_out, inverse != 0, scale, nthreads);
}

int tpufft_fft_strided_f64(const double* in_re, const double* in_im,
                           double* out_re, double* out_im, int64_t count,
                           int64_t n, int64_t stride, int64_t dist_in,
                           int64_t dist_out, int inverse, double scale,
                           int nthreads) {
  return fft_strided<double>(in_re, in_im, out_re, out_im, count, n, stride,
                             dist_in, dist_out, inverse != 0, scale, nthreads);
}

// Interleaved-complex batched 1D (numpy's native layout): the
// de/re-interleave rides inside the gather/scatter — no conversion
// passes. Returns 2 when the shape isn't lane-batch eligible; the caller
// then falls back to the split-plane path.
int tpufft_fft_c64(const float* in, float* out, int64_t count, int64_t n,
                   int64_t dist_in, int64_t dist_out, int inverse,
                   double scale, int nthreads) {
  if (!(n >= 1 && count >= 64 && (n <= 2048 || fourstep_split(n))))
    return 2;
  return fft_batched_v<float, 2, 2>(in, in + 1, out, out + 1, count, n,
                                    dist_in, dist_out, inverse != 0, scale,
                                    nthreads);
}

int tpufft_fft_c128(const double* in, double* out, int64_t count, int64_t n,
                    int64_t dist_in, int64_t dist_out, int inverse,
                    double scale, int nthreads) {
  if (!(n >= 1 && count >= 64 && (n <= 2048 || fourstep_split(n))))
    return 2;
  return fft_batched_v<double, 2, 2>(in, in + 1, out, out + 1, count, n,
                                     dist_in, dist_out, inverse != 0, scale,
                                     nthreads);
}

int tpufft_fft_nd_f32(const float* in_re, const float* in_im, float* out_re,
                      float* out_im, const int64_t* dims, int rank,
                      int inverse, double scale, int nthreads) {
  return fft_nd<float>(in_re, in_im, out_re, out_im, dims, rank, inverse != 0,
                       scale, nthreads);
}

int tpufft_fft_nd_f64(const double* in_re, const double* in_im,
                      double* out_re, double* out_im, const int64_t* dims,
                      int rank, int inverse, double scale, int nthreads) {
  return fft_nd<double>(in_re, in_im, out_re, out_im, dims, rank, inverse != 0,
                        scale, nthreads);
}

// Minor-axis lane-batch transform reading interleaved complex input and
// writing split planes — the first pass of an ND transform fused with the
// input deinterleave. Pair with tpufft_fft_nd_*(..., skip_minor) via
// tpufft_fft_nd_skipminor_*. Returns 2 when not lane-batch eligible.
int tpufft_fft_c2p_f32(const float* inter, float* out_re, float* out_im,
                       int64_t count, int64_t n, int inverse, double scale,
                       int nthreads) {
  if (!(n >= 1 && count >= 64 && (n <= 2048 || fourstep_split(n))))
    return 2;
  return fft_batched_v<float, 2, 1>(inter, inter + 1, out_re, out_im, count,
                                    n, n, n, inverse != 0, scale, nthreads);
}

int tpufft_fft_c2p_f64(const double* inter, double* out_re, double* out_im,
                       int64_t count, int64_t n, int inverse, double scale,
                       int nthreads) {
  if (!(n >= 1 && count >= 64 && (n <= 2048 || fourstep_split(n))))
    return 2;
  return fft_batched_v<double, 2, 1>(inter, inter + 1, out_re, out_im, count,
                                     n, n, n, inverse != 0, scale, nthreads);
}

int tpufft_fft_nd_skipminor_f32(float* re, float* im, const int64_t* dims,
                                int rank, int inverse, double scale,
                                int nthreads) {
  return fft_nd<float>(re, im, re, im, dims, rank, inverse != 0, scale,
                       nthreads, /*skip_minor=*/true);
}

int tpufft_fft_nd_skipminor_f64(double* re, double* im, const int64_t* dims,
                                int rank, int inverse, double scale,
                                int nthreads) {
  return fft_nd<double>(re, im, re, im, dims, rank, inverse != 0, scale,
                        nthreads, /*skip_minor=*/true);
}

int tpufft_prof_read(double* out_ms, int k) {
  // Copy up to k phase accumulators (milliseconds) and reset THOSE k.
  // Phase order (kProfPhases = 11 — size the buffer from the return
  // value, not this list): gather, transform, scatter, fs-p1-copy,
  // fs-p1-fft, fs-p1-tw, fs-p2-fft, fs-p2-scatter, lines-gather,
  // lines-transform, lines-scatter. Returns the full phase count; a
  // caller passing k < kProfPhases leaves the remaining accumulators
  // running (they are NOT reset).
  for (int i = 0; i < k && i < kProfPhases; ++i) {
    out_ms[i] = g_prof_ns[i].exchange(0, std::memory_order_relaxed) * 1e-6;
  }
  return kProfPhases;
}

int tpufft_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
