// host_dsp: the host-side DSP hot paths of the data pipeline and the
// conversion front end, in C++: the polyphase resampler and pYIN's banded
// Viterbi decode. The port's own copy of native/src/vcvits_native.cc's
// vn_resample_out_len, vn_resample and vn_pyin_viterbi, with a plain C
// interface bound by ctypes (vcvits_tpu_torch/dsp/host_dsp.py). The NumPy
// versions in dsp/resample.py and dsp/pitch.py are the plain versions the
// tests hold these to.
//
// Build (ops/_host_build.py:build_host does this at first use):
//   g++ -O3 -std=c++17 -fPIC -shared -pthread -o build/host_dsp/libhost_dsp.so host_dsp.cc

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

struct KernelBank {
  std::vector<double> kernels;  // [new_freq, ktotal]
  int width = 0;
  int ktotal = 0;
};

// Hann-windowed sinc bank, the math of dsp/resample.py:_kernel_bank
// (torchaudio's sinc_interp_hann, lowpass_filter_width 6, rolloff 0.99).
KernelBank build_bank(int orig, int new_, int lowpass_width = 6, double rolloff = 0.99) {
  KernelBank b;
  const double base_freq = std::min(orig, new_) * rolloff;
  b.width = static_cast<int>(std::ceil(lowpass_width * orig / base_freq));
  b.ktotal = 2 * b.width + orig;
  b.kernels.resize(static_cast<size_t>(new_) * b.ktotal);
  for (int i = 0; i < new_; ++i) {
    for (int j = 0; j < b.ktotal; ++j) {
      const double idx = static_cast<double>(j - b.width) / orig;
      double t = (-static_cast<double>(i) / new_ + idx) * base_freq;
      t = std::max(-static_cast<double>(lowpass_width),
                   std::min(static_cast<double>(lowpass_width), t));
      const double window = std::pow(std::cos(t * kPi / lowpass_width / 2.0), 2.0);
      const double tp = t * kPi;
      const double sinc = (tp == 0.0) ? 1.0 : std::sin(tp) / tp;
      b.kernels[static_cast<size_t>(i) * b.ktotal + j] = sinc * window * (base_freq / orig);
    }
  }
  return b;
}

int64_t gcd_i(int64_t a, int64_t c) { return c == 0 ? a : gcd_i(c, a % c); }

}  // namespace

extern "C" {

// Output length of hd_resample: ceil(n * new / orig) after gcd reduction.
int64_t hd_resample_out_len(int64_t n, int orig_sr, int new_sr) {
  if (orig_sr == new_sr) return n;
  const int64_t g = gcd_i(orig_sr, new_sr);
  const int64_t orig = orig_sr / g, new_ = new_sr / g;
  return (n * new_ + orig - 1) / orig;
}

// Polyphase resample of float32 `in` [n] into `out` [out_cap]; returns the
// number of samples written (min(out_len, out_cap)). Sums in float64.
int64_t hd_resample(const float* in, int64_t n, int orig_sr, int new_sr, float* out,
                    int64_t out_cap) {
  if (orig_sr == new_sr) {
    const int64_t m = std::min(n, out_cap);
    std::memcpy(out, in, sizeof(float) * m);
    return m;
  }
  const int64_t g = gcd_i(orig_sr, new_sr);
  const int orig = static_cast<int>(orig_sr / g);
  const int new_ = static_cast<int>(new_sr / g);
  const KernelBank bank = build_bank(orig, new_);

  const int64_t n_blocks = n / orig + 1;
  const int64_t out_len = std::min(hd_resample_out_len(n, orig_sr, new_sr), out_cap);

  // the input with `width` zeros before it and width + orig after
  std::vector<double> x(static_cast<size_t>(n + 2 * bank.width + orig), 0.0);
  for (int64_t i = 0; i < n; ++i) x[bank.width + i] = in[i];

  auto worker = [&](int64_t b0, int64_t b1) {
    for (int64_t blk = b0; blk < b1; ++blk) {
      const double* seg = x.data() + blk * orig;
      for (int i = 0; i < new_; ++i) {
        const int64_t oi = blk * new_ + i;
        if (oi >= out_len) break;
        const double* k = bank.kernels.data() + static_cast<size_t>(i) * bank.ktotal;
        double acc = 0.0;
        for (int j = 0; j < bank.ktotal; ++j) acc += seg[j] * k[j];
        out[oi] = static_cast<float>(acc);
      }
    }
  };
  const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  const unsigned n_threads =
      static_cast<unsigned>(std::min<int64_t>(hw, std::max<int64_t>(1, n_blocks / 256)));
  if (n_threads <= 1) {
    worker(0, n_blocks);
  } else {
    std::vector<std::thread> ts;
    const int64_t per = (n_blocks + n_threads - 1) / n_threads;
    for (unsigned t = 0; t < n_threads; ++t) {
      const int64_t b0 = t * per, b1 = std::min<int64_t>(n_blocks, b0 + per);
      if (b0 < b1) ts.emplace_back(worker, b0, b1);
    }
    for (auto& t : ts) t.join();
  }
  return out_len;
}

// pYIN's Viterbi over (voiced | unvoiced) x pitch-bin states with a banded
// triangular pitch transition. log_obs [T, 2 * n_bins]; log_tri [width],
// the log-weights of offsets -width/2 .. width/2; states_out [T].
void hd_pyin_viterbi(const double* log_obs, int64_t T, int n_bins, int width,
                     const double* log_tri, double log_stay, double log_switch,
                     int32_t* states_out) {
  const int half = width / 2;
  const int S = 2 * n_bins;
  std::vector<double> delta(log_obs, log_obs + S);
  // start unvoiced and uniform (librosa's p_init); voiced at log of the
  // smallest normal double, as the NumPy version's log(0 + tiny)
  const double log_tiny = std::log(std::numeric_limits<double>::min());
  for (int s = 0; s < n_bins; ++s) delta[s] += log_tiny;
  for (int s = n_bins; s < S; ++s) delta[s] += std::log(1.0 / n_bins);

  std::vector<int32_t> psi(static_cast<size_t>(T) * S, 0);
  std::vector<double> best_v(n_bins), best_u(n_bins), nd(S);
  std::vector<int32_t> arg_v(n_bins), arg_u(n_bins);

  auto banded = [&](const double* d, double* best, int32_t* arg) {
    for (int b = 0; b < n_bins; ++b) {
      double mx = -1e300;
      int am = b;
      const int j0 = std::max(0, b - half), j1 = std::min(n_bins - 1, b + half);
      for (int j = j0; j <= j1; ++j) {
        const double cand = d[j] + log_tri[j - b + half];
        if (cand > mx) {
          mx = cand;
          am = j;
        }
      }
      best[b] = mx;
      arg[b] = am;
    }
  };

  for (int64_t t = 1; t < T; ++t) {
    banded(delta.data(), best_v.data(), arg_v.data());
    banded(delta.data() + n_bins, best_u.data(), arg_u.data());
    const double* obs = log_obs + t * S;
    int32_t* ps = psi.data() + t * S;
    for (int b = 0; b < n_bins; ++b) {
      const double fv = best_v[b] + log_stay;
      const double fu = best_u[b] + log_switch;
      if (fv >= fu) {
        nd[b] = fv + obs[b];
        ps[b] = arg_v[b];
      } else {
        nd[b] = fu + obs[b];
        ps[b] = arg_u[b] + n_bins;
      }
      const double fu2 = best_u[b] + log_stay;
      const double fv2 = best_v[b] + log_switch;
      if (fu2 >= fv2) {
        nd[n_bins + b] = fu2 + obs[n_bins + b];
        ps[n_bins + b] = arg_u[b] + n_bins;
      } else {
        nd[n_bins + b] = fv2 + obs[n_bins + b];
        ps[n_bins + b] = arg_v[b];
      }
    }
    delta.swap(nd);
  }

  int32_t s = 0;
  double mx = -1e300;
  for (int i = 0; i < S; ++i) {
    if (delta[i] > mx) {
      mx = delta[i];
      s = i;
    }
  }
  states_out[T - 1] = s;
  for (int64_t t = T - 1; t > 0; --t) {
    s = psi[static_cast<size_t>(t) * S + s];
    states_out[t - 1] = s;
  }
}

}  // extern "C"
